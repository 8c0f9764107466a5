"""Planner estimate accountability: estimated vs actual rows, per index.

The port's copy of geomesa_tpu/obs/accuracy.py. The planner's row
estimates come from the ``stats`` sketches (the coordinate marginals and
the z-prefix sketch), and a sketch reflects only the writes it has
observed: updates, deletes and folds drift it. This module measures how
far:

- every executed plan carries ``estimated_rows`` (the sketch estimate,
  resolved at plan time) and ``actual_rows`` (the rows the scan matched
  after refinement);
- ``DataStore.record_query`` feeds the pair here and into the
  ``geomesa.plan.estimate.error`` histogram (the symmetric error factor:
  ``max(r, 1/r)`` of the +1-smoothed estimated/actual ratio; 1.0 is a
  perfect estimate, 4.0 is off by 4x in either direction);
- :meth:`EstimateAccuracy.stale` flags any (type, index) whose p90 error
  factor exceeds ``geomesa.plan.estimate.stale.p90`` over at least
  ``geomesa.plan.estimate.min.count`` samples, and the optional
  ``geomesa.plan.estimate.auto.analyze`` hook re-sketches the type once
  per trip (the window resets after, so one trip fires one analyze).

Locking: ``EstimateAccuracy._lock`` guards the per-(type, index) error
histograms. Records arrive on every query's record path, possibly under
the store's write lock (``modify_features`` queries inside it), so only
arithmetic runs under it and it acquires no other lock.
"""

from __future__ import annotations

import threading
import time

from geomesa_tpu_torch import conf
from geomesa_tpu_torch.metrics import Histogram


def error_factor(estimated: float, actual: float) -> float:
    """Symmetric misestimate factor of one (estimated, actual) pair:
    ``max(r, 1/r)`` of the +1-smoothed ratio, so over- and
    under-estimates score alike and zero rows never divide."""
    r = (float(estimated) + 1.0) / (float(actual) + 1.0)
    return r if r >= 1.0 else 1.0 / r


class _IndexWindow:
    """One (type, index)'s accumulated error factors since the last
    reset (a reset = an analyze_stats, which invalidates the history)."""

    __slots__ = ("hist", "worst", "last_t")

    def __init__(self):
        self.hist = Histogram()
        self.worst = 1.0
        self.last_t = 0.0


class EstimateAccuracy:
    """Per-(type, index) estimate-vs-actual accounting for one store."""

    def __init__(self):
        from geomesa_tpu_torch.lockwitness import witness

        self._lock = witness(threading.Lock(), "EstimateAccuracy._lock")
        self._windows: dict = {}  # guarded-by: _lock
        self._analyzing: set = set()  # guarded-by: _lock

    def record(self, type_name: str, index_name: str,
               estimated: float, actual: float) -> float:
        """Record one executed plan's pair; returns the error factor
        (also the value the caller observes into the registry
        histogram, OUTSIDE this lock)."""
        err = error_factor(estimated, actual)
        key = (type_name, index_name or "full")
        with self._lock:
            w = self._windows.get(key)
            if w is None:
                w = self._windows[key] = _IndexWindow()
            w.hist.record(err)
            if err > w.worst:
                w.worst = err
            w.last_t = time.time()
        return err

    def report(self) -> dict:
        """Per-index accuracy rows: sample count, p50/p90 error
        factors, worst observed."""
        with self._lock:
            snap = [
                (k, list(w.hist.counts), w.hist.count, w.worst)
                for k, w in sorted(self._windows.items())
            ]
        rows = []
        for (tname, iname), counts, count, worst in snap:
            h = Histogram(counts=counts, count=count)
            rows.append({
                "type": tname,
                "index": iname,
                "count": count,
                # the factor is >= 1 by construction; the histogram's
                # in-bucket interpolation can dip just under — clamp
                "p50_error": max(round(h.quantile(0.50), 3), 1.0),
                "p90_error": max(round(h.quantile(0.90), 3), 1.0),
                "worst_error": round(worst, 3),
            })
        return {"indexes": rows}

    def stale(self, threshold: "float | None" = None,
              min_count: "int | None" = None) -> list:
        """(type, index, p90) triples whose p90 error factor exceeds
        the staleness threshold over at least ``min_count`` samples —
        the sketches no longer describe the data and an
        ``analyze_stats`` is due. Empty when detection is disabled
        (threshold 0)."""
        if threshold is None:
            threshold = float(conf.PLAN_ESTIMATE_STALE_P90.get())
        if min_count is None:
            min_count = int(conf.PLAN_ESTIMATE_MIN_COUNT.get())
        if threshold <= 0:
            return []
        with self._lock:
            snap = [
                (k, list(w.hist.counts), w.hist.count)
                for k, w in sorted(self._windows.items())
            ]
        out = []
        for (tname, iname), counts, count in snap:
            if count < max(int(min_count), 1):
                continue
            p90 = Histogram(counts=counts, count=count).quantile(0.90)
            if p90 > threshold:
                out.append((tname, iname, round(p90, 3)))
        return out

    def claim_analyze(self, type_name: str) -> bool:
        """Atomically claim one type's auto-analyze trip: True for
        exactly ONE caller until :meth:`reset` releases the claim. N
        serving threads recording misestimates on the same stale type
        race here — without the claim, each would fire its own
        write-locked ``analyze_stats`` back to back."""
        with self._lock:
            if type_name in self._analyzing:
                return False
            self._analyzing.add(type_name)
            return True

    def reset(self, type_name: "str | None" = None) -> None:
        """Drop accumulated windows (all, or one type's) and release
        any auto-analyze claim: the history describes the OLD sketches
        — after an ``analyze_stats`` the fresh sketches must earn
        their own record."""
        with self._lock:
            if type_name is None:
                self._windows.clear()
                self._analyzing.clear()
            else:
                for key in [k for k in self._windows if k[0] == type_name]:
                    del self._windows[key]
                self._analyzing.discard(type_name)

    def sample_count(self) -> int:
        """Total recorded pairs across every window (coverage
        accounting: recorded pairs / executed scans)."""
        with self._lock:
            return sum(w.hist.count for w in self._windows.values())
