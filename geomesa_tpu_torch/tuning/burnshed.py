"""SLO-burn-driven admission shedding.

The port's copy of geomesa_tpu/tuning/burnshed.py. The scheduler sheds on
physical pressure (a full queue, a deadline that cannot survive the batch
window); an SLO burning its error budget is an earlier signal. This gate
watches the attached :class:`~geomesa_tpu_torch.obs.slo.SloTracker`'s burn
rate for one objective and, while it burns past threshold, sheds the
low-priority slice of incoming work: tenants whose DRR weight sits
strictly below the heaviest weight (a store with uniform weights sheds
nothing, so burn shedding never starves an undifferentiated workload).

Engagement is hysteretic: engage when burn > ``threshold``, release only
when burn <= ``release``.

Concurrency: the scheduler calls the gate on its submit path before
``QueryScheduler._cond`` is taken, and the gate holds no lock of its own:
its whole state is one tuple swapped atomically. The refresh reads the
SLO tracker and the tenant registry (their own locks, never nested) and is
throttled, so a hot submit path costs a monotonic clock read.
"""

from __future__ import annotations

import time
from typing import Optional


class BurnShed:
    """Admission gate fed by SLO burn rate + tenant weights. Built and
    wired by :class:`~geomesa_tpu_torch.tuning.manager.TuningManager`; the
    scheduler only calls :meth:`should_shed`."""

    def __init__(
        self,
        store,
        objective: str = "query_p99",
        threshold: float = 2.0,
        release: float = 1.0,
        refresh_s: float = 0.05,
    ):
        self.store = store
        self.objective = objective
        self.threshold = float(threshold)
        self.release = float(release)
        self.refresh_s = float(refresh_s)
        # (burn_rate, engaged, weights_snapshot, max_weight) — swapped
        # whole; the ONLY mutable state besides the refresh clock
        self._state: "tuple[float, bool, dict, float]" = (0.0, False, {}, 0.0)
        self._next_refresh = 0.0

    # -- sensing ----------------------------------------------------------
    def _burn(self, now) -> float:
        slo = getattr(self.store, "slo", None)
        if slo is None:
            return 0.0
        for row in slo.report(now)["objectives"]:
            if row.get("objective") == self.objective:
                return float(row.get("burn_rate") or 0.0)
        return 0.0

    def refresh(self, now=None) -> None:
        """Re-read burn + weights if the throttle window elapsed.
        ``now`` is a test seam passed through to ``SloTracker.report``;
        the throttle always uses the monotonic clock."""
        mono = time.monotonic()
        if mono < self._next_refresh and now is None:
            return
        self._next_refresh = mono + self.refresh_s
        burn = self._burn(now)
        _, engaged, _, _ = self._state
        if engaged:
            engaged = burn > self.release  # release hysteresis
        else:
            engaged = burn > self.threshold
        weights: dict = {}
        max_w = 0.0
        if engaged:
            sched = getattr(self.store, "scheduler", None)
            tenants = getattr(sched, "tenants", None)
            if tenants is not None:
                weights = tenants.weights()
                if weights:
                    max_w = max(weights.values())
        self._state = (burn, engaged, weights, max_w)

    # -- the submit-path read --------------------------------------------
    def should_shed(self, tenant: Optional[str], now=None) -> Optional[str]:
        """Reason string when this tenant's work should shed under the
        current burn, else None. Called with no lock held."""
        self.refresh(now)
        burn, engaged, weights, max_w = self._state
        if not engaged or not weights:
            return None
        from geomesa_tpu_torch.serving.tenancy import PUBLIC_TENANT

        tid = tenant if tenant is not None else PUBLIC_TENANT
        w = weights.get(tid)
        if w is None:
            # never-seen tenant: default weight (matches the registry's
            # lazy materialization — it would get this weight on first
            # touch)
            from geomesa_tpu_torch import conf

            w = float(conf.TENANT_DEFAULT_WEIGHT.get())
        if w >= max_w:
            return None  # top-priority work always admits
        return (
            f"slo burn {burn:.2f}x > {self.threshold:.2f}x on "
            f"{self.objective}: tenant {tid!r} weight {w:g} below max {max_w:g}"
        )

    def report(self) -> dict:
        burn, engaged, weights, max_w = self._state
        return {
            "objective": self.objective,
            "threshold": self.threshold,
            "release": self.release,
            "burn": round(burn, 4),
            "engaged": engaged,
            "max_weight": max_w,
            "weights": dict(weights),
        }
