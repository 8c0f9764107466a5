"""geomesa_tpu_torch.obs: the observability core.

The port's copy of the structured-tracing surface of geomesa_tpu/obs
(:mod:`~geomesa_tpu_torch.obs.trace`): spans with thread-local
propagation through the query path (plan, range decomposition, dispatch,
scan, decode) and the fold, a bounded trace ring, the slow-query log and
the Chrome trace-event export (``DataStore.dump_trace``). The live
histograms live in :mod:`geomesa_tpu_torch.metrics`. Estimate
accountability (:mod:`~geomesa_tpu_torch.obs.accuracy`): every executed
plan records the sketch's estimated rows beside the rows it matched;
per-index error windows flag stale stats and may trigger an automatic
``analyze_stats``.
"""

from geomesa_tpu_torch.obs.accuracy import EstimateAccuracy, error_factor

from geomesa_tpu_torch.obs.trace import (
    Span,
    Trace,
    TraceBuffer,
    Tracer,
    install,
    phase_breakdown,
    span,
    tracer,
)

__all__ = [
    "Span",
    "Trace",
    "TraceBuffer",
    "Tracer",
    "EstimateAccuracy",
    "error_factor",
    "install",
    "phase_breakdown",
    "span",
    "tracer",
]
