"""Multi-tenant fairness state for the serving tier.

The port's copy of geomesa_tpu/serving/tenancy.py. The scheduler
(serving/scheduler.py) turns N concurrent callers into fused device
launches; this module turns it into a *service* for callers that do not
cooperate: one tenant flooding the admission queue must not starve the
rest. The :class:`TenantRegistry` gives the scheduler what it needs:

- **identity**: a tenant is keyed on its visibility auths (sorted,
  comma-joined) unless the caller names one, so isolation follows the
  security boundary by default;
- **quota**: a per-tenant admission cap (``geomesa.tenant.queue.max``)
  checked BEFORE the shared queue bound — a flooding tenant sheds at its
  own quota while other tenants' queues stay open;
- **weight**: the deficit-round-robin share (``configure``, default
  ``geomesa.tenant.default.weight``) the scheduler's drain uses to fill
  each micro-batch from backlogged tenants in proportion;
- **accounting**: per-tenant submitted/shed/served/cache-hit/error
  counters, queue-wait and served-wall aggregates, and a per-tenant
  :class:`~geomesa_tpu_torch.obs.slo.SloTracker` window evaluating the
  ``geomesa.tenant.slo.p99.ms`` objective over that tenant's own
  traffic; ``report()`` is the reference's ``/tenants`` payload.

Locking: ``TenantRegistry._lock`` guards only the tenant table and its
plain counters. It is a LEAF: nothing else is acquired under it, and the
scheduler never touches it while holding ``QueryScheduler._cond`` —
quota reads happen before admission takes the condition, and the
dispatcher snapshots weights before its drain. Per-tenant SLO
observations take each tenant's own ``SloTracker._lock`` AFTER this lock
is released.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from geomesa_tpu_torch import conf

#: tenant id for requests carrying no auths and no explicit tenant — the
#: anonymous pool shares one queue and one quota
PUBLIC_TENANT = "public"

#: the histogram each per-tenant SLO objective evaluates (also observed
#: into the store registry as the cross-tenant series)
TENANT_WALL_METRIC = "geomesa.tenant.query_wall"


class _Tenant:
    """One tenant's fairness and accounting state (every field mutates
    under ``TenantRegistry._lock`` except the tracker, which carries its
    own lock)."""

    __slots__ = (
        "id", "weight", "queue_max", "submitted", "shed", "served",
        "cache_hits", "errors", "wait_s_sum", "wait_s_max", "wall_s_sum",
        "tracker",
    )

    def __init__(self, tenant_id: str, weight: float, queue_max: int, tracker):
        self.id = tenant_id
        self.weight = weight
        self.queue_max = queue_max
        self.submitted = 0
        self.shed = 0
        self.served = 0
        self.cache_hits = 0
        self.errors = 0
        self.wait_s_sum = 0.0
        self.wait_s_max = 0.0
        self.wall_s_sum = 0.0
        self.tracker = tracker


class TenantRegistry:
    """Per-tenant quotas, weights, SLO windows and accounting for one
    served store. Thread-safe; tenants materialize on first contact."""

    def __init__(self, metrics=None,
                 default_weight: "float | None" = None,
                 queue_max: "int | None" = None,
                 slo_p99_ms: "float | None" = None):
        from geomesa_tpu_torch.lockwitness import witness
        from geomesa_tpu_torch.metrics import resolve

        self.metrics = resolve(metrics)
        self.default_weight = float(
            default_weight if default_weight is not None else conf.TENANT_DEFAULT_WEIGHT.get()
        )
        self.default_queue_max = int(
            queue_max if queue_max is not None else conf.TENANT_QUEUE_MAX.get()
        )
        self.slo_p99_ms = float(
            slo_p99_ms if slo_p99_ms is not None else conf.TENANT_SLO_P99_MS.get()
        )
        self._lock = witness(threading.Lock(), "TenantRegistry._lock")
        self._tenants: dict[str, _Tenant] = {}  # guarded-by: _lock

    # -- identity ---------------------------------------------------------
    @staticmethod
    def tenant_of(auths, explicit: Optional[str] = None) -> str:
        """A request's tenant id: an explicit name wins, else the sorted
        auths (the security boundary doubles as the fairness boundary),
        else the shared public pool."""
        if explicit:
            return str(explicit)
        if auths:
            return ",".join(sorted(str(a) for a in auths))
        return PUBLIC_TENANT

    # -- configuration ----------------------------------------------------
    def configure(self, tenant_id: str, weight: "float | None" = None,
                  queue_max: "int | None" = None) -> None:
        """Pin a tenant's DRR weight and/or admission quota (both default
        from the knobs for unconfigured tenants)."""
        t = self._get(tenant_id)
        with self._lock:
            if weight is not None:
                t.weight = max(float(weight), 1e-3)
            if queue_max is not None:
                t.queue_max = max(int(queue_max), 0)

    def _get(self, tenant_id: str) -> _Tenant:
        with self._lock:
            t = self._tenants.get(tenant_id)
            if t is None:
                t = self._tenants[tenant_id] = _Tenant(
                    tenant_id, self.default_weight, self.default_queue_max,
                    self._new_tracker(),
                )
            return t

    def _new_tracker(self):
        from geomesa_tpu_torch.obs.slo import SloObjective, SloTracker

        if self.slo_p99_ms <= 0:
            return None
        return SloTracker(objectives=[SloObjective(
            name="tenant_query_p99", metric=TENANT_WALL_METRIC,
            quantile=0.99, threshold_s=self.slo_p99_ms / 1e3,
        )])

    # -- what the scheduler reads (never under its condition) -------------
    def queue_cap(self, tenant_id: str) -> int:
        return self._get(tenant_id).queue_max

    def weights(self) -> dict:
        """Snapshot of per-tenant DRR weights for one drain pass."""
        with self._lock:
            return {t.id: t.weight for t in self._tenants.values()}

    # -- accounting (called with no other lock held) ----------------------
    def note_submitted(self, tenant_id: str) -> None:
        t = self._get(tenant_id)
        with self._lock:
            t.submitted += 1
        self.metrics.counter("geomesa.tenant.submitted")

    def note_shed(self, tenant_id: str) -> None:
        t = self._get(tenant_id)
        with self._lock:
            t.shed += 1
        self.metrics.counter("geomesa.tenant.shed")

    def note_cache_hit(self, tenant_id: str) -> None:
        t = self._get(tenant_id)
        with self._lock:
            t.cache_hits += 1

    def note_error(self, tenant_id: str) -> None:
        t = self._get(tenant_id)
        with self._lock:
            t.errors += 1

    def note_wait(self, tenant_id: str, wait_s: float) -> None:
        """Queue-wait attribution, recorded by the dispatcher at dispatch
        (outside the scheduler condition)."""
        t = self._get(tenant_id)
        with self._lock:
            t.wait_s_sum += wait_s
            t.wait_s_max = max(t.wait_s_max, wait_s)
        self.metrics.observe("geomesa.tenant.queue_wait", wait_s)

    def note_served(self, tenant_id: str, wall_s: float, now: "float | None" = None) -> None:
        """A query answered for this tenant: feeds the tenant's own SLO
        window and the cross-tenant wall histogram."""
        t = self._get(tenant_id)
        with self._lock:
            t.served += 1
            t.wall_s_sum += wall_s
            tracker = t.tracker
        if tracker is not None:
            tracker.observe(TENANT_WALL_METRIC, wall_s, now=time.time() if now is None else now)
        self.metrics.observe("geomesa.tenant.query_wall", wall_s)

    # -- the report -------------------------------------------------------
    def report(self) -> dict:
        with self._lock:
            snap = [
                (t.id, t.weight, t.queue_max, t.submitted, t.shed, t.served,
                 t.cache_hits, t.errors, t.wait_s_sum, t.wait_s_max, t.wall_s_sum,
                 t.tracker)
                for t in self._tenants.values()
            ]
        rows = []
        snap.sort(key=lambda r: r[0])  # tenant ids are unique
        for (tid, weight, qmax, sub, shed, served, hits, errs, wsum, wmax, wallsum,
             tracker) in snap:
            rows.append({
                "tenant": tid,
                "weight": weight,
                "queue_max": qmax,
                "submitted": sub,
                "shed": shed,
                "served": served,
                "cache_hits": hits,
                "errors": errs,
                "queue_wait_ms_mean": round(wsum / served * 1e3, 3) if served else 0.0,
                "queue_wait_ms_max": round(wmax * 1e3, 3),
                "wall_ms_mean": round(wallsum / served * 1e3, 3) if served else 0.0,
                "slo": tracker.report() if tracker is not None else None,
            })
        return {
            "default_weight": self.default_weight,
            "default_queue_max": self.default_queue_max,
            "slo_p99_ms": self.slo_p99_ms,
            "tenants": rows,
        }
