"""Parallel converter ingest: the sequential-commit distributed-ingest
path (compatibility surface).

Reference: distributed MapReduce ingest (geomesa-jobs/src/
main/scala/org/locationtech/geomesa/jobs/mapreduce/ —
``ConverterInputFormat`` splits inputs, mappers run the converter,
``GeoMesaOutputFormat`` writes; driven by tools/ingest/IngestCommand.scala
which picks local vs distributed mode). Parsing fans out over a process
pool (one "mapper" per input split) while the parent process stays the
only writer. The port's copy of geomesa_tpu/io/ingest.py.

The split machinery (byte-range splits, the picklable converter config,
the guarded worker) now lives in :mod:`geomesa_tpu_torch.ingest.splits`; this
module keeps the original *sequential-commit* path — each split's batch
goes through ``store.write`` as it arrives, with the store's normal
incremental compaction cadence. The staged multi-core pipeline
(:mod:`geomesa_tpu_torch.ingest.pipeline`) is the bulk-load path: deferred
single compaction, sharded sort, atomic publish. Use this one when you
want per-split incremental visibility; use the pipeline for throughput.

Worker failures surface as :class:`~geomesa_tpu_torch.ingest.IngestError` with
the worker-side traceback, and per-split parse-error counts aggregate into
``IngestResult.split_errors`` ordered by split index (deterministic across
worker counts and completion orders).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from geomesa_tpu_torch.ingest.pipeline import (
    IngestError,
    IngestResult,
    raise_split_failure,
    rebase_ids,
)
from geomesa_tpu_torch.ingest.splits import (  # noqa: F401 (compat re-exports)
    ConverterConfig,
    Split,
    SplitFailure,
    feed_in_split_order,
    run_split_guarded,
)
from geomesa_tpu_torch.ingest import splits as _splits

# a split per ~32 MB keeps task granularity reasonable for big files.
# Kept as a module-level knob here (tests/config patch it); the canonical
# default lives in geomesa_tpu_torch.ingest.splits.
SPLIT_BYTES = _splits.SPLIT_BYTES


def plan_splits(
    paths: Sequence[str], fmt: str, split_bytes: int | None = None
) -> list[Split]:
    """Input files -> mapper splits (see ingest.splits.plan_splits).
    Defaults to THIS module's patchable ``SPLIT_BYTES``."""
    if split_bytes is None:
        split_bytes = SPLIT_BYTES  # read at call time so tests/config can tune
    return _splits.plan_splits(paths, fmt, split_bytes)


def _run_split(cfg: ConverterConfig, split: Split):
    """Mapper: parse one split -> (FeatureCollection, n_errors)."""
    return _splits.run_split(cfg, split)


def ingest_files(
    store,
    converter,
    paths: Sequence[str],
    workers: Optional[int] = None,
    id_prefix_splits: bool = True,
) -> IngestResult:
    """Convert ``paths`` with a pool of worker processes and write the
    results to ``store`` split by split. ``workers=0/1`` runs in-process
    (the reference's local ingest mode). ``id_prefix_splits`` namespaces
    running-index feature ids per split so converters without an id
    expression don't collide across splits."""
    cfg = ConverterConfig.of(converter)
    type_name = converter.sft.name
    splits = plan_splits(paths, converter.fmt)
    result = IngestResult(splits=len(splits))
    if workers is None:
        workers = min(len(splits), os.cpu_count() or 1)

    # running-index rebase: seed from the store ONCE (a features() call
    # concatenates all chunks — doing it per split would be quadratic),
    # then track the count locally; this writer is the only one
    base = (
        len(store.features(type_name))
        if id_prefix_splits and converter.id_field is None
        else 0
    )

    def commit(res):
        nonlocal base
        idx, fc, errors, reasons, _parse_s, failure = res
        if failure is not None:
            raise_split_failure(failure, splits)
        result.split_errors.append(errors)
        result.errors += errors
        result.add_reasons(reasons)
        if len(fc) == 0:
            return
        if id_prefix_splits and converter.id_field is None:
            fc = rebase_ids(fc, base)
            base += len(fc)
        result.written += store.write(type_name, fc)

    tasks = [(cfg, sp, i) for i, sp in enumerate(splits)]
    if workers <= 1 or len(splits) <= 1:
        for t in tasks:
            commit(run_split_guarded(t))
        return result

    import multiprocessing as mp

    ctx = mp.get_context("fork")
    with ctx.Pool(workers) as pool:
        # imap streams results in SPLIT order: commits overlap conversion,
        # only ~workers results are in flight (not the whole dataset), and
        # error aggregation is deterministic whatever order workers finish
        feed_in_split_order(pool, tasks, commit)
    return result
