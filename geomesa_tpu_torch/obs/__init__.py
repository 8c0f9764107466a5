"""geomesa_tpu_torch.obs: the observability layer.

The port's copy of geomesa_tpu/obs:

- **structured tracing** (:mod:`~geomesa_tpu_torch.obs.trace`): spans
  with thread-local propagation through the query path (plan, range
  decomposition, scheduler admission/queue/dispatch, scan, decode) and
  the fold, a bounded trace ring, the slow-query log and the Chrome
  trace-event export (``DataStore.dump_trace``). The live histograms
  live in :mod:`geomesa_tpu_torch.metrics`.
- **SLO tracking** (:mod:`~geomesa_tpu_torch.obs.slo`): declarative
  objectives over sliding windows with burn rates, served by
  ``DataStore.slo_report()``.
- **the ops plane** (:mod:`~geomesa_tpu_torch.obs.ops`): a threaded
  loopback HTTP endpoint (``DataStore.serve_ops``) with ``/metrics``, the
  composite ``/health`` verdict, ``/stats``, the debug surfaces, and a
  TelemetryRecorder writing bounded history rings.
- **estimate accountability** (:mod:`~geomesa_tpu_torch.obs.accuracy`):
  every executed plan records the sketch's estimated rows beside the rows
  it matched; per-index error windows flag stale stats and may trigger an
  automatic ``analyze_stats``.
"""

from geomesa_tpu_torch.obs.accuracy import EstimateAccuracy, error_factor
from geomesa_tpu_torch.obs.ops import (
    HealthMonitor,
    OpsServer,
    TelemetryRecorder,
    ops_report,
    stats_payload,
)
from geomesa_tpu_torch.obs.slo import SloObjective, SloTracker, default_objectives
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
    "HealthMonitor",
    "OpsServer",
    "SloObjective",
    "SloTracker",
    "TelemetryRecorder",
    "default_objectives",
    "error_factor",
    "install",
    "ops_report",
    "phase_breakdown",
    "span",
    "stats_payload",
    "tracer",
]
