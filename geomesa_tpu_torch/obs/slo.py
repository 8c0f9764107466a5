"""SLO tracking: declarative objectives over sliding windows.

The port's copy of geomesa_tpu/obs/slo.py. An :class:`SloObjective`
states what good looks like for one histogram metric —
"``geomesa.query.scan`` p99 ≤ 250 ms over 5 minutes, with a 1% error
budget". The :class:`SloTracker` subscribes to a ``MetricsRegistry``
(the ``observer`` hook, invoked after the registry lock is released), so
every histogram observation in the process — query latency, fold slice
pauses, a tenant's served wall — feeds the windows without
per-call-site wiring.

Windows are rings of interval sub-histograms (``geomesa.obs.slo.slices``
slices over ``geomesa.obs.slo.window.s``): an observation lands in the
current slice's buckets (the registry's own
:data:`~geomesa_tpu_torch.metrics.HIST_EDGES` ladder, so a windowed
quantile is the registry's quantile over the window); reads sum the live
slices, so the window slides with bounded memory and at most one slice
of staleness. Each slice also counts threshold violations, so the report
carries a **burn rate**: the violating fraction over the window divided
by the error budget (1.0 burns the budget exactly as fast as it accrues;
past 1 the objective breaches if the window's behavior continues).

``DataStore.slo_report()`` serves :meth:`SloTracker.report` verbatim —
the payload ``/health`` carries.

Locking: ``SloTracker._lock`` (hot) guards the windows. Observations
arrive under arbitrary store locks (the fold holds the store's write
lock), so nothing blocking runs under it and it acquires no other lock.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from dataclasses import dataclass
from typing import Sequence

from geomesa_tpu_torch import conf
from geomesa_tpu_torch.metrics import HIST_EDGES, Histogram


@dataclass(frozen=True)
class SloObjective:
    """One declarative objective over a histogram metric."""

    name: str           # report key, e.g. "query_p99"
    metric: str         # histogram name, e.g. "geomesa.query.scan"
    quantile: float     # evaluated quantile, e.g. 0.99
    threshold_s: float  # objective: quantile(metric) <= threshold_s
    budget: float = 0.01  # allowed fraction of observations over threshold


def default_objectives() -> list[SloObjective]:
    """The knob-configured default objectives (a 0 ms knob drops its
    objective): query latency, fold-slice pause, WAL fsync, standing-query
    alert latency, replica staleness and tile fetch, each at p99 — the
    reference's six, under its names, whether or not the port records
    the metric yet (an objective nothing observes reports count 0, ok)."""
    out = []
    q = float(conf.OBS_SLO_QUERY_P99_MS.get())
    if q > 0:
        out.append(SloObjective("query_p99", "geomesa.query.scan", 0.99, q / 1e3))
    f = float(conf.OBS_SLO_FOLD_P99_MS.get())
    if f > 0:
        out.append(SloObjective("fold_slice_p99", "geomesa.stream.fold.slice", 0.99, f / 1e3))
    w = float(conf.OBS_SLO_WAL_P99_MS.get())
    if w > 0:
        out.append(SloObjective("wal_fsync_p99", "geomesa.stream.wal.fsync", 0.99, w / 1e3))
    s = float(conf.OBS_SLO_STANDING_P99_MS.get())
    if s > 0:
        out.append(SloObjective("standing_alert_p99", "geomesa.standing.latency", 0.99, s / 1e3))
    r = float(conf.OBS_SLO_REPLICA_STALENESS_P99_MS.get())
    if r > 0:
        out.append(SloObjective(
            "replica_staleness_p99", "geomesa.replica.staleness.ms", 0.99, r / 1e3,
        ))
    t = float(conf.OBS_SLO_TILES_P99_MS.get())
    if t > 0:
        out.append(SloObjective("tiles_p99", "geomesa.tiles.fetch", 0.99, t / 1e3))
    return out


class _Window:
    """Sliding window for one objective: a ring of per-slice bucket
    arrays and violation counters, rotated by wall time."""

    __slots__ = ("slices", "slice_s", "counts", "bad", "n", "epoch")

    def __init__(self, slices: int, slice_s: float, now: float):
        self.slices = max(int(slices), 1)
        self.slice_s = max(float(slice_s), 1e-3)
        self.counts = [[0] * (len(HIST_EDGES) + 1) for _ in range(self.slices)]
        self.bad = [0] * self.slices
        self.n = [0] * self.slices
        self.epoch = int(now / self.slice_s)

    def _rotate(self, now: float) -> int:
        epoch = int(now / self.slice_s)
        gap = epoch - self.epoch
        if gap < 0:
            # the clock went backwards (an NTP step, or a caller driving
            # virtual time): restart the whole window rather than serve
            # slices stamped from the future
            gap = self.slices
        if gap > 0:
            for k in range(1, min(gap, self.slices) + 1):
                i = (epoch - k + 1) % self.slices
                self.counts[i] = [0] * (len(HIST_EDGES) + 1)
                self.bad[i] = 0
                self.n[i] = 0
            self.epoch = epoch
        return epoch % self.slices

    def record(self, seconds: float, threshold_s: float, now: float) -> None:
        i = self._rotate(now)
        self.counts[i][bisect_left(HIST_EDGES, seconds)] += 1
        self.n[i] += 1
        if seconds > threshold_s:
            self.bad[i] += 1

    def summed(self, now: float) -> tuple:
        self._rotate(now)
        total = [0] * (len(HIST_EDGES) + 1)
        for row in self.counts:
            for j, c in enumerate(row):
                if c:
                    total[j] += c
        return total, sum(self.n), sum(self.bad)


class SloTracker:
    """Evaluates a set of objectives over sliding windows; wire it to a
    registry with :meth:`attach` (or ``DataStore.attach_slo``)."""

    def __init__(self, objectives: "Sequence[SloObjective] | None" = None,
                 window_s: "float | None" = None,
                 slices: "int | None" = None):
        from geomesa_tpu_torch.lockwitness import witness

        self.objectives = list(objectives if objectives is not None else default_objectives())
        self.window_s = float(window_s if window_s is not None else conf.OBS_SLO_WINDOW_S.get())
        n_slices = int(slices if slices is not None else conf.OBS_SLO_SLICES.get())
        self._by_metric: dict[str, list[SloObjective]] = {}
        for o in self.objectives:
            self._by_metric.setdefault(o.metric, []).append(o)
        self._lock = witness(threading.Lock(), "SloTracker._lock")
        now = time.time()
        self._windows = {  # guarded-by: _lock
            o.name: _Window(n_slices, self.window_s / max(n_slices, 1), now)
            for o in self.objectives
        }

    def attach(self, metrics) -> "SloTracker":
        """Subscribe to a registry's histogram observations (the
        ``observer`` hook, invoked outside the registry lock). A registry
        already observed by ANOTHER tracker fans out to both — two stores
        sharing one registry must not detach each other's windows;
        re-attaching the same tracker stays idempotent."""
        prev = getattr(metrics, "observer", None)
        if prev is None or prev == self.observe:
            metrics.observer = self.observe
        else:
            def fanout(name, seconds, _prev=prev, _mine=self.observe):
                _prev(name, seconds)
                _mine(name, seconds)

            metrics.observer = fanout
        return self

    def observe(self, metric: str, seconds: float, now: "float | None" = None) -> None:
        objs = self._by_metric.get(metric)
        if not objs:
            return
        t = time.time() if now is None else now
        with self._lock:
            for o in objs:
                self._windows[o.name].record(seconds, o.threshold_s, t)

    def report(self, now: "float | None" = None) -> dict:
        """The ``/health`` payload: per objective the windowed quantile,
        threshold, violation counts, burn rate and verdict; ``status`` is
        "ok" only when every populated objective meets its target."""
        t = time.time() if now is None else now
        rows = []
        ok_all = True
        with self._lock:
            summed = {o.name: self._windows[o.name].summed(t) for o in self.objectives}
        for o in self.objectives:
            counts, n, bad = summed[o.name]
            q = Histogram(counts=list(counts), count=n).quantile(o.quantile)
            frac = bad / n if n else 0.0
            burn = frac / o.budget if o.budget > 0 else 0.0
            ok = n == 0 or q <= o.threshold_s
            ok_all = ok_all and ok
            rows.append({
                "objective": o.name,
                "metric": o.metric,
                "quantile": o.quantile,
                "threshold_ms": round(o.threshold_s * 1e3, 3),
                "window_s": self.window_s,
                "count": n,
                "violations": bad,
                "violating_fraction": round(frac, 6),
                "budget": o.budget,
                "burn_rate": round(burn, 3),
                "value_ms": round(q * 1e3, 3),
                "ok": ok,
            })
        return {
            "status": "ok" if ok_all else "breach",
            "window_s": self.window_s,
            "objectives": rows,
        }
