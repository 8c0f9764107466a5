"""Query guards and interceptors: reject or rewrite dangerous queries
before they scan.

The port's copy of geomesa_tpu/planning/guards.py (reference planning/
guard/: FullTableScanQueryGuard.scala:39-48, TemporalQueryGuard.scala,
GraduatedQueryGuard.scala; QueryInterceptor.scala, hooked at
QueryPlanner.scala:155). Guards inspect the *plan* (chosen strategy +
extracted values) and raise QueryGuardError; interceptors rewrite the
filter before planning.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable

from geomesa_tpu_torch.filter.extract import extract_geometries, extract_intervals, geometry_bounds
from geomesa_tpu_torch.filter.predicates import Filter, Include
from geomesa_tpu_torch.planning.planner import QueryGuardError, QueryPlan

WHOLE_WORLD_AREA = 360.0 * 180.0


def _union_area(boxes) -> float:
    """Exact union area of axis-aligned boxes via coordinate compression
    (OR'd boxes may overlap; summing would double-count and falsely trip
    the guard)."""
    import numpy as np

    b = np.asarray(list(boxes), dtype=np.float64).reshape(-1, 4)
    xs = np.unique(np.concatenate([b[:, 0], b[:, 2]]))
    ys = np.unique(np.concatenate([b[:, 1], b[:, 3]]))
    if len(xs) < 2 or len(ys) < 2:
        return 0.0
    cx = (xs[:-1] + xs[1:]) / 2
    cy = (ys[:-1] + ys[1:]) / 2
    covered = np.zeros((len(cy), len(cx)), dtype=bool)
    for x0, y0, x1, y1 in b:
        covered |= (
            ((cx >= x0) & (cx <= x1))[None, :] & ((cy >= y0) & (cy <= y1))[:, None]
        )
    wx = np.diff(xs)[None, :]
    wy = np.diff(ys)[:, None]
    return float((covered * wx * wy).sum())


def _practical_span(intervals) -> int:
    """Total queried milliseconds, with intervals open above (e.g. the
    `dtg >= now-ttl` an AgeOffInterceptor appends) clamped to the wall
    clock: the guard bounds *scannable history*, and no history exists
    past now — an astronomically-open upper endpoint must not reject a
    bounded-below recency query."""
    import time

    now = int(time.time() * 1000)
    total = 0
    for iv in intervals:
        hi = min(iv.hi, max(now, iv.lo))
        total += max(hi - iv.lo, 0)
    return total


@runtime_checkable
class QueryInterceptor(Protocol):
    """Rewrites a filter before planning (reference QueryInterceptor SPI).
    Return the (possibly unchanged) filter, or raise QueryGuardError."""

    def rewrite(self, type_name: str, f: Filter) -> Filter: ...


@runtime_checkable
class QueryGuard(Protocol):
    """Inspects a finished plan; raises QueryGuardError to reject it."""

    def guard(self, plan: QueryPlan, sft) -> None: ...


class FullTableScanGuard:
    """Reject plans that fall through to a full-table scan (reference
    FullTableScanQueryGuard.scala:39-48). Include — an explicit
    "everything" query — is allowed, matching the reference."""

    def guard(self, plan: QueryPlan, sft) -> None:
        if plan.strategy == "full-scan" and not isinstance(plan.filter, Include):
            raise QueryGuardError(
                f"query on {plan.type_name!r} requires a full-table scan, "
                "which is disabled"
            )


@dataclass
class AgeOffInterceptor:
    """Hide features older than ``ttl_ms`` from every query (reference
    AgeOffFilter/AgeOffIterator, geomesa-accumulo/.../iterators/
    AgeOffIterator.scala: rows past their TTL stop being visible before
    compaction physically removes them). Queries rewrite with an extra
    dtg >= now-ttl conjunct — the planner's z3 window then prunes the
    expired rows at scan time; DataStore.age_off() is the physical
    removal.

    Scope: only schemas whose time attribute is named ``dtg_field``
    (``applies_to``, consulted by DataStore.apply_interceptors) — a
    store hosting an atemporal or differently-named type must not have
    its queries rewritten against a missing column. ``type_name``
    restricts the TTL to one feature type."""

    ttl_ms: int
    dtg_field: str = "dtg"
    type_name: "str | None" = None
    now_ms: "int | None" = None  # fixed clock for tests; None = wall clock

    def applies_to(self, sft) -> bool:
        if self.type_name is not None and sft.name != self.type_name:
            return False
        return sft.dtg_field == self.dtg_field

    def rewrite(self, type_name: str, f: Filter) -> Filter:
        import time

        from geomesa_tpu_torch.filter.predicates import And, Cmp

        now = self.now_ms if self.now_ms is not None else int(time.time() * 1000)
        cutoff = Cmp(self.dtg_field, ">=", now - self.ttl_ms)
        return cutoff if isinstance(f, Include) else And((f, cutoff))


@dataclass
class TemporalQueryGuard:
    """Require a bounded temporal constraint no longer than ``max_ms``
    (reference TemporalQueryGuard, configured there and here by the
    `geomesa.guard.temporal.max.duration` property). Applies only to
    schemas with a time attribute. The guard is opt-in, exactly like
    the reference: install it via ``DataStore(guards=[...])``; leaving
    ``max_ms`` unset resolves the property tier (environment-
    overridable), the same idiom as ServingConfig/PipelineConfig."""

    max_ms: "int | None" = None

    def __post_init__(self):
        if self.max_ms is None:
            from geomesa_tpu_torch.conf import GUARD_TEMPORAL_MAX

            self.max_ms = int(GUARD_TEMPORAL_MAX.get())

    @staticmethod
    def from_properties() -> "TemporalQueryGuard":
        return TemporalQueryGuard()

    def guard(self, plan: QueryPlan, sft) -> None:
        if sft.dtg_field is None or plan.ids is not None:
            return
        intervals = extract_intervals(plan.filter, sft.dtg_field)
        if intervals.disjoint:
            return
        if not intervals.values:
            raise QueryGuardError(
                f"query on {plan.type_name!r} requires a temporal filter on "
                f"{sft.dtg_field!r}"
            )
        span = _practical_span(intervals.values)
        if span > self.max_ms:
            raise QueryGuardError(
                f"temporal filter spans {span}ms, over the {self.max_ms}ms limit"
            )


@dataclass
class SizeBound:
    """One graduated tier: queries within ``area_deg2`` (None = any extent)
    may span at most ``max_duration_ms`` (None = unbounded)."""

    area_deg2: float | None
    max_duration_ms: int | None


@dataclass
class GraduatedQueryGuard:
    """Stricter duration limits for larger spatial extents (reference
    GraduatedQueryGuard: small boxes may query long histories, wide boxes
    only short ones). ``bounds`` must be ordered smallest-area first."""

    bounds: Sequence[SizeBound]

    def guard(self, plan: QueryPlan, sft) -> None:
        if plan.ids is not None or sft.geom_field is None:
            return
        geoms = extract_geometries(plan.filter, sft.geom_field)
        if geoms.disjoint:
            return
        if geoms.values:
            area = _union_area(geometry_bounds(geoms))
        else:
            area = WHOLE_WORLD_AREA
        limit = None
        for b in self.bounds:
            if b.area_deg2 is None or area <= b.area_deg2:
                limit = b.max_duration_ms
                break
        if limit is None:
            return
        if sft.dtg_field is None:
            return
        intervals = extract_intervals(plan.filter, sft.dtg_field)
        if intervals.disjoint:
            return
        if not intervals.values:
            raise QueryGuardError(
                f"queries over {area:.1f} deg^2 require a temporal filter"
            )
        span = _practical_span(intervals.values)
        if span > limit:
            raise QueryGuardError(
                f"queries over {area:.1f} deg^2 may span at most {limit}ms "
                f"(got {span}ms)"
            )
