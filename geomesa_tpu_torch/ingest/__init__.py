"""Multi-core ingest: splits, the staged pipeline, and the sharded sort.

The port's copy of geomesa_tpu/ingest (docs/ingest.md). The package absorbs the split logic that lived in
``geomesa_tpu_torch.io.ingest`` (which remains as the sequential-commit
compatibility surface) and adds the staged, bounded-queue pipeline that
overlaps parse / key-encoding / sorting / publishing across host cores.
"""

from geomesa_tpu_torch.ingest.pipeline import (  # noqa: F401
    BulkLoader,
    IngestError,
    IngestResult,
    PipelineConfig,
    ingest_files,
)
from geomesa_tpu_torch.ingest.sort import (  # noqa: F401
    SortRun,
    merge_runs,
    shard_runs,
    sort_chunk,
)
# NOTE: SPLIT_BYTES is deliberately NOT re-exported — patching a
# re-exported int is a silent no-op; the canonical knob lives in
# geomesa_tpu_torch.ingest.splits (and io.ingest keeps its own legacy copy,
# read at call time). Pass split_bytes= explicitly to plan_splits /
# ingest_files instead.
from geomesa_tpu_torch.ingest.splits import (  # noqa: F401
    ConverterConfig,
    Split,
    SplitFailure,
    plan_splits,
    run_split,
    run_split_guarded,
)
