"""Metrics registry: counters, gauges, timers, histograms.

The port's copy of geomesa_tpu/metrics.py (reference geomesa-metrics,
MicrometerSetup.scala: dropwizard/micrometer registries). It keeps one process-local registry with
the same instrument kinds; ``snapshot()`` is the scrape surface for
any exporter (prometheus text rendering included for parity with the
reference's default registry).

The :class:`Histogram` instrument (docs/observability.md) is the live
latency surface the mean-only :class:`Timer` cannot provide: fixed
log-spaced buckets (sqrt-2 growth from 1 µs, so every bucket is within
~41% of its neighbors), one index add per observation, and quantiles
computed only at snapshot/scrape time — so "what is query p99 right
now" is answerable from the registry without offline post-processing.
Histograms render as proper Prometheus ``histogram`` families
(cumulative ``_bucket{le=…}`` including ``+Inf``, ``_sum``, ``_count``);
timers keep their summary + ``_seconds_max`` gauge exposition unchanged.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Timer:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def update(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.max_s = max(self.max_s, seconds)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


# histogram bucket upper edges: 1 µs growing by sqrt(2) — 64 finite
# buckets cover 1 µs .. ~50 min, so one fixed ladder serves every
# latency this system records (cache probes to fold pauses) with a
# worst-case quantile error of one bucket width (~41%, i.e. half a
# power of two). A 65th overflow bucket catches anything larger.
HIST_EDGES: tuple = tuple(1e-6 * (2.0 ** (i / 2.0)) for i in range(64))
_N_BUCKETS = len(HIST_EDGES) + 1  # + overflow (+Inf)


@dataclass
class Histogram:
    """Fixed-log-bucket latency histogram: ``record`` is one bisect plus
    one index add (lock-cheap on the hot path); quantiles are computed
    on demand from a snapshot, never maintained online."""

    counts: list = field(default_factory=lambda: [0] * _N_BUCKETS)
    count: int = 0
    sum_s: float = 0.0

    def record(self, seconds: float) -> None:
        self.counts[bisect_left(HIST_EDGES, seconds)] += 1
        self.count += 1
        self.sum_s += seconds

    def quantile(self, q: float) -> float:
        """The q-quantile (0..1) with linear interpolation inside the
        bucket — within one bucket width of the exact order statistic."""
        if self.count == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = HIST_EDGES[i - 1] if i > 0 else 0.0
                hi = HIST_EDGES[i] if i < len(HIST_EDGES) else HIST_EDGES[-1] * 2.0
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return HIST_EDGES[-1] * 2.0  # pragma: no cover - unreachable

    @property
    def mean_s(self) -> float:
        return self.sum_s / self.count if self.count else 0.0


class MetricsRegistry:
    """Process-local metrics: counter / gauge / timer by dotted name.

    Thread-safe: one lock covers counters, gauges and timers — a bare
    ``defaultdict`` ``+=`` is a read-modify-write that loses increments
    under concurrent callers, and ``snapshot()``/``render_prometheus()``
    iterate dicts that can resize mid-update. The ``time()``
    contextmanager stays lock-free around the timed body; only the final
    :meth:`timer_update` takes the lock."""

    def __init__(self):
        from geomesa_tpu_torch.lockwitness import witness

        self._lock = witness(threading.Lock(), "MetricsRegistry._lock")
        self.counters: dict[str, int] = defaultdict(int)    # guarded-by: _lock
        self.gauges: dict[str, float] = {}                  # guarded-by: _lock
        self.timers: dict[str, Timer] = defaultdict(Timer)  # guarded-by: _lock
        self.histograms: dict[str, Histogram] = defaultdict(Histogram)  # guarded-by: _lock
        # optional observation hook (the SLO tracker wires itself here):
        # called AFTER the registry lock is released, so the hook's own
        # lock (SloTracker._lock, rank 78) never nests under the
        # innermost registry lock (rank 80)
        self.observer = None

    def counter(self, name: str, inc: int = 1) -> None:
        with self._lock:
            self.counters[name] += inc

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def counter_value(self, name: str) -> int:
        """Current value of one counter (0 when never incremented) —
        locked read for callers asserting on strategy counters
        (geomesa.join.*, tests, bench gates)."""
        with self._lock:
            return self.counters.get(name, 0)

    def timer_update(self, name: str, seconds: float) -> None:
        """Record one timed duration (the locked half of :meth:`time`;
        also the entry point for callers that measured the span
        themselves, e.g. DataStore.record_query)."""
        with self._lock:
            self.timers[name].update(seconds)

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timer_update(name, time.perf_counter() - t0)

    def observe(self, name: str, seconds: float) -> None:
        """Record one observation (in seconds) into a histogram — the
        live-quantile instrument for hot-path latencies (query latency,
        queue wait, fold slice pause, WAL fsync, flush stages). The
        locked work is one bisect + index add; the attached observer
        hook (SLO tracking) runs after the lock is released."""
        with self._lock:
            self.histograms[name].record(seconds)
            obs = self.observer
        if obs is not None:
            obs(name, seconds)

    def histogram_quantile(self, name: str, q: float) -> float:
        """The q-quantile (0..1) of one histogram, computed from a
        locked snapshot of its buckets (0.0 when never observed)."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                return 0.0
            counts, count = list(h.counts), h.count
        snap = Histogram(counts=counts, count=count)
        return snap.quantile(q)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timers": {
                    k: {"count": t.count, "mean_s": t.mean_s, "max_s": t.max_s}
                    for k, t in self.timers.items()
                },
                "histograms": {
                    k: {
                        "count": h.count,
                        "mean_s": h.mean_s,
                        "p50_s": h.quantile(0.50),
                        "p99_s": h.quantile(0.99),
                    }
                    for k, h in self.histograms.items()
                },
            }

    def render_prometheus(self) -> str:
        """Prometheus text exposition of the registry. Timers emit
        ``_seconds_count`` / ``_seconds_sum`` / ``_seconds_max`` so both
        mean latency and the p-worst observation are scrapeable.
        Histograms emit spec-correct ``histogram`` families: CUMULATIVE
        ``_bucket{le=…}`` samples (every non-empty bucket plus the
        mandatory ``+Inf``, whose value equals ``_count``), ``_sum`` and
        ``_count`` — so ``histogram_quantile()`` works in PromQL
        unmodified."""
        with self._lock:
            counters = sorted(self.counters.items())
            gauges = sorted(self.gauges.items())
            timers = sorted(
                (k, t.count, t.total_s, t.max_s) for k, t in self.timers.items()
            )
            hists = sorted(
                (k, list(h.counts), h.count, h.sum_s)
                for k, h in self.histograms.items()
            )
        lines = []
        for k, v in counters:
            lines.append(f"# TYPE {_prom(k)} counter")
            lines.append(f"{_prom(k)} {v}")
        for k, v in gauges:
            lines.append(f"# TYPE {_prom(k)} gauge")
            lines.append(f"{_prom(k)} {v}")
        for k, count, total_s, max_s in timers:
            base = _prom(k)
            lines.append(f"# TYPE {base}_seconds summary")
            lines.append(f"{base}_seconds_count {count}")
            lines.append(f"{base}_seconds_sum {total_s}")
            # the max is its OWN gauge family: strict OpenMetrics parsers
            # allow only _sum/_count/quantile samples inside a summary
            lines.append(f"# TYPE {base}_seconds_max gauge")
            lines.append(f"{base}_seconds_max {max_s}")
        for k, counts, count, sum_s in hists:
            base = _prom(k)
            lines.append(f"# TYPE {base}_seconds histogram")
            cum = 0
            for i, c in enumerate(counts[:-1]):
                if c == 0:
                    continue  # sparse: empty interior buckets add nothing
                cum += c
                lines.append(
                    f'{base}_seconds_bucket{{le="{_le(HIST_EDGES[i])}"}} {cum}'
                )
            lines.append(f'{base}_seconds_bucket{{le="+Inf"}} {count}')
            lines.append(f"{base}_seconds_sum {sum_s}")
            lines.append(f"{base}_seconds_count {count}")
        return "\n".join(lines) + "\n"


def _prom(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _le(edge: float) -> str:
    """Bucket upper-edge label: shortest round-trippable decimal, so
    scrapes stay stable across runs and parsers re-read the exact
    float."""
    return repr(edge)


# process-global fallback registry: components that run without a
# configured store registry (streaming listener sweeps, quarantine events
# during load) still record their error counters somewhere scrapeable
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """The process-global fallback MetricsRegistry."""
    return _GLOBAL


def resolve(metrics: MetricsRegistry | None) -> MetricsRegistry:
    """The given registry, or the process-global fallback when None."""
    return _GLOBAL if metrics is None else metrics
