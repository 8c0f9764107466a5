"""Decomposition of filter trees into indexable values.

The port's copy of the geometry, interval and id extraction of
geomesa_tpu/filter/extract.py (reference geomesa-filter
FilterHelper.scala:100-130 and FilterValues.scala): AND intersects, OR
unions, and each extraction says whether it is *exact* or needs the
full filter re-applied after the index scan.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Generic, Sequence, TypeVar

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.filter.predicates import (
    And,
    BBox,
    Between,
    Cmp,
    Contains,
    During,
    DWithin,
    Exclude,
    Filter,
    IdFilter,
    In,
    Include,
    Intersects,
    Not,
    Or,
    Within,
)

T = TypeVar("T")

# epoch-millis bounds used for one-sided temporal predicates
MIN_MS = 0
MAX_MS = np.iinfo(np.int64).max // 2


@dataclass
class FilterValues(Generic[T]):
    """Extracted values plus exactness flags (reference FilterValues).

    - ``values``: the extracted constraints (geometries or intervals); their
      union covers everything the filter can match on this property.
    - ``precise``: the values exactly express the filter's constraint on the
      property (no residual filtering needed for it).
    - ``disjoint``: the filter is unsatisfiable on this property (e.g. an
      AND of non-overlapping boxes) — the query can return empty.
    """

    values: list = field(default_factory=list)
    precise: bool = True
    disjoint: bool = False

    @property
    def empty(self) -> bool:
        return not self.values and not self.disjoint

    @staticmethod
    def nothing() -> "FilterValues":
        return FilterValues(values=[], precise=True)

    @staticmethod
    def disjoint_() -> "FilterValues":
        return FilterValues(values=[], disjoint=True)


def _references_prop(f: Filter, prop: str) -> bool:
    """Does any predicate in the tree constrain ``prop``?"""
    if isinstance(f, (And, Or)):
        return any(_references_prop(c, prop) for c in f.filters)
    if isinstance(f, Not):
        return _references_prop(f.filter, prop)
    return getattr(f, "prop", None) == prop


def _imprecise_children(parts, children, prop) -> bool:
    """True when some child contributed no extractable values but still
    constrains the property (e.g. a NOT branch): the combined values are
    then a superset, not exact."""
    return any(
        not p.values and not p.disjoint and _references_prop(c, prop)
        for p, c in zip(parts, children)
    )


# ---------------------------------------------------------------------------
# geometry extraction
# ---------------------------------------------------------------------------


def _predicate_geometry(f: Filter, prop: str):
    """(geometry, precise) for a single spatial predicate on prop, else None."""
    if isinstance(f, BBox) and f.prop == prop:
        return geo.box(f.xmin, f.ymin, f.xmax, f.ymax), True
    if isinstance(f, (Intersects, Within)) and f.prop == prop:
        return f.geom, True
    if isinstance(f, Contains) and f.prop == prop:
        # feature contains query geom -> feature's extent must overlap it;
        # ranges from the geom's bounds are a superset, not exact
        return f.geom, False
    if isinstance(f, DWithin) and f.prop == prop:
        return geo.box(*f.bounds), False
    return None


def extract_geometries(f: Filter, prop: str) -> FilterValues:
    """Geometries constraining ``prop``, unioned across ORs, intersected
    (by bbox) across ANDs. Reference FilterHelper.extractGeometries."""
    if isinstance(f, (Include, Exclude, IdFilter)):
        return FilterValues.nothing()
    single = _predicate_geometry(f, prop)
    if single is not None:
        g, precise = single
        return FilterValues(values=[g], precise=precise)
    if isinstance(f, And):
        all_parts = [extract_geometries(c, prop) for c in f.filters]
        if any(p.disjoint for p in all_parts):
            return FilterValues.disjoint_()
        # a child constraining prop without extractable values (e.g. NOT)
        # makes the extraction a superset, not exact
        imprecise = _imprecise_children(all_parts, f.filters, prop)
        parts = [p for p in all_parts if p.values]
        if not parts:
            return FilterValues.nothing()
        # AND of spatial constraints: intersect via bbox intersection; keep
        # the exact geometry when one side is a covering box of the other
        out = parts[0]
        for p in parts[1:]:
            out = _intersect_geom_values(out, p)
            if out.disjoint:
                return out
        if imprecise:
            out = FilterValues(values=out.values, precise=False)
        return out
    if isinstance(f, Or):
        parts = [extract_geometries(c, prop) for c in f.filters]
        if any(p.empty for p in parts):
            # some branch is unconstrained on prop -> no usable extraction
            return FilterValues.nothing()
        vals: list = []
        precise = True
        for p in parts:
            if p.disjoint:
                continue
            vals.extend(p.values)
            precise &= p.precise
        return FilterValues(values=vals, precise=precise)
    if isinstance(f, Not):
        return FilterValues.nothing()
    return FilterValues.nothing()


def _intersect_geom_values(a: FilterValues, b: FilterValues) -> FilterValues:
    out: list = []
    precise = a.precise and b.precise
    for ga in a.values:
        for gb in b.values:
            ba, bb = np.array(ga.bounds()), np.array(gb.bounds())
            if not bool(geo.bbox_intersects(ba, bb)):
                continue
            inter = (
                max(ba[0], bb[0]),
                max(ba[1], bb[1]),
                min(ba[2], bb[2]),
                min(ba[3], bb[3]),
            )
            # keep the non-box geometry when the other is its covering box
            if _is_box(ga) and not _is_box(gb):
                out.append(gb if _box_covers(ba, bb) else geo.box(*inter))
                precise &= _box_covers(ba, bb)
            elif _is_box(gb) and not _is_box(ga):
                out.append(ga if _box_covers(bb, ba) else geo.box(*inter))
                precise &= _box_covers(bb, ba)
            else:
                out.append(geo.box(*inter))
                precise &= _is_box(ga) and _is_box(gb)
    if not out:
        return FilterValues.disjoint_()
    return FilterValues(values=out, precise=precise)


def _is_box(g: geo.Geometry) -> bool:
    if not isinstance(g, geo.Polygon) or g.holes:
        return False
    ring = g.shell
    if len(ring) != 5:
        return False
    xs, ys = set(ring[:, 0].tolist()), set(ring[:, 1].tolist())
    return len(xs) == 2 and len(ys) == 2


def _box_covers(outer: np.ndarray, inner: np.ndarray) -> bool:
    return bool(
        outer[0] <= inner[0]
        and outer[1] <= inner[1]
        and outer[2] >= inner[2]
        and outer[3] >= inner[3]
    )


def geometry_bounds(fv: FilterValues) -> list[tuple[float, float, float, float]]:
    """Bounding boxes of extracted geometries, clipped to the world."""
    out = []
    for g in fv.values:
        x0, y0, x1, y1 = g.bounds()
        out.append(
            (max(x0, -180.0), max(y0, -90.0), min(x1, 180.0), min(y1, 90.0))
        )
    return out


# ---------------------------------------------------------------------------
# interval extraction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Interval:
    """[lo, hi) epoch millis."""

    lo: int
    hi: int

    def intersect(self, other: "Interval") -> "Interval | None":
        lo, hi = max(self.lo, other.lo), min(self.hi, other.hi)
        return Interval(lo, hi) if lo < hi else None


def _predicate_interval(f: Filter, prop: str):
    if isinstance(f, During) and f.prop == prop:
        return Interval(f.lo_ms, f.hi_ms), True
    if isinstance(f, Between) and f.prop == prop and _is_ms(f.lo) and _is_ms(f.hi):
        return Interval(int(f.lo), int(f.hi) + 1), True  # BETWEEN is inclusive
    if isinstance(f, Cmp) and f.prop == prop and _is_ms(f.value):
        v = int(f.value)
        if f.op == "<":
            return Interval(MIN_MS, v), True
        if f.op == "<=":
            return Interval(MIN_MS, v + 1), True
        if f.op == ">":
            return Interval(v + 1, MAX_MS), True
        if f.op == ">=":
            return Interval(v, MAX_MS), True
        if f.op == "=":
            return Interval(v, v + 1), True
    return None


def _is_ms(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def extract_intervals(f: Filter, prop: str) -> FilterValues:
    """Time intervals constraining ``prop``. Reference extractIntervals."""
    if isinstance(f, (Include, Exclude, IdFilter)):
        return FilterValues.nothing()
    single = _predicate_interval(f, prop)
    if single is not None:
        iv, precise = single
        if iv.lo >= iv.hi:
            return FilterValues.disjoint_()
        return FilterValues(values=[iv], precise=precise)
    if isinstance(f, And):
        all_parts = [extract_intervals(c, prop) for c in f.filters]
        if any(p.disjoint for p in all_parts):
            return FilterValues.disjoint_()
        imprecise = _imprecise_children(all_parts, f.filters, prop)
        parts = [p for p in all_parts if p.values]
        if not parts:
            return FilterValues.nothing()
        out = parts[0]
        for p in parts[1:]:
            merged = []
            for a in out.values:
                for b in p.values:
                    iv = a.intersect(b)
                    if iv:
                        merged.append(iv)
            if not merged:
                return FilterValues.disjoint_()
            out = FilterValues(values=merged, precise=out.precise and p.precise)
        if imprecise:
            out = FilterValues(values=out.values, precise=False)
        return out
    if isinstance(f, Or):
        parts = [extract_intervals(c, prop) for c in f.filters]
        if any(p.empty for p in parts):
            return FilterValues.nothing()
        vals: list = []
        precise = True
        for p in parts:
            if p.disjoint:
                continue
            vals.extend(p.values)
            precise &= p.precise
        return FilterValues(values=_merge_intervals(vals), precise=precise)
    return FilterValues.nothing()


def _merge_intervals(ivs: Sequence[Interval]) -> list[Interval]:
    if not ivs:
        return []
    ivs = sorted(ivs, key=lambda i: (i.lo, i.hi))
    out = [ivs[0]]
    for iv in ivs[1:]:
        if iv.lo <= out[-1].hi:
            out[-1] = Interval(out[-1].lo, max(out[-1].hi, iv.hi))
        else:
            out.append(iv)
    return out


# ---------------------------------------------------------------------------
# id extraction
# ---------------------------------------------------------------------------


def extract_ids(f: Filter) -> FilterValues:
    """Feature ids from IdFilter terms (AND intersects, OR unions)."""
    if isinstance(f, IdFilter):
        return FilterValues(values=sorted(set(f.ids)), precise=True)
    if isinstance(f, And):
        parts = [extract_ids(c) for c in f.filters]
        parts = [p for p in parts if p.values or p.disjoint]
        if not parts:
            return FilterValues.nothing()
        ids = set(parts[0].values)
        for p in parts[1:]:
            ids &= set(p.values)
        return FilterValues(values=sorted(ids)) if ids else FilterValues.disjoint_()
    if isinstance(f, Or):
        parts = [extract_ids(c) for c in f.filters]
        if any(p.empty for p in parts):
            return FilterValues.nothing()
        ids: set = set()
        for p in parts:
            ids |= set(p.values)
        return FilterValues(values=sorted(ids))
    return FilterValues.nothing()


# ---------------------------------------------------------------------------
# attribute bounds extraction (for the attribute index)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Bounds:
    """Closed-open attribute value bounds; None = unbounded."""

    lo: object
    hi: object
    lo_inclusive: bool = True
    hi_inclusive: bool = True


def extract_attribute_bounds(f: Filter, prop: str) -> FilterValues:
    """Value bounds on an attribute (reference: extractAttributeBounds)."""
    if isinstance(f, Cmp) and f.prop == prop:
        v = f.value
        if f.op == "=":
            return FilterValues(values=[Bounds(v, v)])
        if f.op == "<":
            return FilterValues(values=[Bounds(None, v, hi_inclusive=False)])
        if f.op == "<=":
            return FilterValues(values=[Bounds(None, v)])
        if f.op == ">":
            return FilterValues(values=[Bounds(v, None, lo_inclusive=False)])
        if f.op == ">=":
            return FilterValues(values=[Bounds(v, None)])
        return FilterValues.nothing()  # <> is not indexable
    if isinstance(f, Between) and f.prop == prop:
        return FilterValues(values=[Bounds(f.lo, f.hi)])
    if isinstance(f, In) and f.prop == prop:
        return FilterValues(values=[Bounds(v, v) for v in f.values])
    if isinstance(f, And):
        all_parts = [extract_attribute_bounds(c, prop) for c in f.filters]
        if any(p.disjoint for p in all_parts):
            return FilterValues.disjoint_()
        imprecise = _imprecise_children(all_parts, f.filters, prop)
        parts = [p for p in all_parts if p.values]
        if not parts:
            return FilterValues.nothing()
        out = parts[0]
        for p in parts[1:]:
            merged = []
            for a in out.values:
                for b in p.values:
                    m = _intersect_bounds(a, b)
                    if m:
                        merged.append(m)
            if not merged:
                return FilterValues.disjoint_()
            out = FilterValues(values=merged, precise=out.precise and p.precise)
        if imprecise:
            out = FilterValues(values=out.values, precise=False)
        return out
    if isinstance(f, Or):
        parts = [extract_attribute_bounds(c, prop) for c in f.filters]
        if any(p.empty for p in parts):
            return FilterValues.nothing()
        vals: list = []
        precise = True
        for p in parts:
            vals.extend(p.values)
            precise &= p.precise
        return FilterValues(values=vals, precise=precise)
    return FilterValues.nothing()


def _intersect_bounds(a: Bounds, b: Bounds) -> Bounds | None:
    lo, lo_inc = a.lo, a.lo_inclusive
    if b.lo is not None and (lo is None or b.lo > lo or (b.lo == lo and not b.lo_inclusive)):
        lo, lo_inc = b.lo, b.lo_inclusive
    hi, hi_inc = a.hi, a.hi_inclusive
    if b.hi is not None and (hi is None or b.hi < hi or (b.hi == hi and not b.hi_inclusive)):
        hi, hi_inc = b.hi, b.hi_inclusive
    if lo is not None and hi is not None:
        if lo > hi or (lo == hi and not (lo_inc and hi_inc)):
            return None
    return Bounds(lo, hi, lo_inc, hi_inc)
