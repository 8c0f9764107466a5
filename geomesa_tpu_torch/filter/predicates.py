"""Filter predicate AST with vectorized (columnar) evaluation.

The port's copy of geomesa_tpu/filter/predicates.py:
``Filter.evaluate(batch)`` returns a boolean mask over a whole batch of
features. This host path is the exactness reference the device scan
mask is refined against, and the fallback for predicates the device
cannot run. Geometry columns in a batch are a ``PointColumn`` (point
schemas) or a ``PackedGeometryColumn`` (extents: every XZ hit refines
here, rectangles by vectorized box algebra).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from geomesa_tpu_torch import geometry as geo


@dataclass(frozen=True)
class PointColumn:
    """Struct-of-arrays geometry column for point features."""

    x: np.ndarray
    y: np.ndarray

    def __len__(self) -> int:
        return len(self.x)


GeometryColumn = "PointColumn | geo.PackedGeometryColumn"


class Filter:
    """Base predicate. Subclasses are frozen dataclasses."""

    def evaluate(self, batch: Mapping[str, object]) -> np.ndarray:
        """Boolean mask over the batch (dict: attr name -> column)."""
        raise NotImplementedError

    # -- algebra sugar ---------------------------------------------------
    def __and__(self, other: "Filter") -> "Filter":
        return And((self, other))

    def __or__(self, other: "Filter") -> "Filter":
        return Or((self, other))

    def __invert__(self) -> "Filter":
        return Not(self)


def _batch_len(batch: Mapping[str, object]) -> int:
    for v in batch.values():
        return len(v)
    return 0


def _column(batch: Mapping[str, object], prop: str) -> np.ndarray:
    try:
        return batch[prop]
    except KeyError:
        raise KeyError(f"no column {prop!r} in batch (have {list(batch)})")


@dataclass(frozen=True)
class Include(Filter):
    """Matches everything (ECQL INCLUDE)."""

    def evaluate(self, batch):
        return np.ones(_batch_len(batch), dtype=bool)


@dataclass(frozen=True)
class Exclude(Filter):
    """Matches nothing (ECQL EXCLUDE)."""

    def evaluate(self, batch):
        return np.zeros(_batch_len(batch), dtype=bool)


INCLUDE = Include()
EXCLUDE = Exclude()


# ---------------------------------------------------------------------------
# spatial
# ---------------------------------------------------------------------------


def _ulp_out(x0: float, y0: float, x1: float, y1: float):
    """Bounds widened one f32 ulp outward — matching the widening the
    packed column applied to its stored bboxes, so bbox prefilters built
    on >=/<= comparisons stay conservative."""
    lo = np.nextafter(np.array([x0, y0], dtype=np.float32), -np.inf).astype(np.float64)
    hi = np.nextafter(np.array([x1, y1], dtype=np.float32), np.inf).astype(np.float64)
    return float(lo[0]), float(lo[1]), float(hi[0]), float(hi[1])


def _eval_spatial(col, fn_points, fn_geom, candidates=None) -> np.ndarray:
    """Exact per-geometry evaluation over a packed column, restricted to
    ``candidates`` (a bool mask from a vectorized bbox prefilter — rows
    outside it are definitively False)."""
    if isinstance(col, PointColumn):
        return fn_points(col.x, col.y)
    if isinstance(col, geo.PackedGeometryColumn):
        out = np.zeros(len(col), dtype=bool)
        rows = range(len(col)) if candidates is None else np.nonzero(candidates)[0]
        for i in rows:
            out[i] = fn_geom(col.geometry(int(i)))
        return out
    raise TypeError(f"not a geometry column: {type(col)}")


def _per_geom_vertex_counts(col: "geo.PackedGeometryColumn", vertex_mask):
    """How many of each geometry's pool vertices satisfy ``vertex_mask``
    ([total_verts] bool) — the cumsum reduction over the contiguous
    per-geometry coord slices."""
    csum = np.concatenate([[0], np.cumsum(vertex_mask)])
    first_ring = col.part_ring_offsets[col.geom_part_offsets].astype(np.int64)
    bounds_ix = col.ring_offsets[first_ring].astype(np.int64)
    return csum[bounds_ix[1:]] - csum[bounds_ix[:-1]]


@dataclass(frozen=True)
class BBox(Filter):
    """BBOX(prop, xmin, ymin, xmax, ymax) — geometry interacts with the box.

    Reference: the `bbox` spatial op extracted by FilterHelper
    (geomesa-filter/.../FilterHelper.scala:100-130).
    """

    prop: str
    xmin: float
    ymin: float
    xmax: float
    ymax: float

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        return (self.xmin, self.ymin, self.xmax, self.ymax)

    def evaluate(self, batch):
        col = _column(batch, self.prop)
        if isinstance(col, PointColumn):
            return (
                (col.x >= self.xmin)
                & (col.x <= self.xmax)
                & (col.y >= self.ymin)
                & (col.y <= self.ymax)
            )
        if isinstance(col, geo.PackedGeometryColumn):
            q = np.array(self.bounds)
            bx = geo.box(*self.bounds)
            return _packed_box_intersects(col, q, bx)
        raise TypeError(f"not a geometry column: {type(col)}")


def _packed_box_intersects(
    col: "geo.PackedGeometryColumn", q: np.ndarray, g: "geo.Geometry"
) -> np.ndarray:
    """Geometry-intersects-axis-aligned-box over a packed column.

    Rectangle features (geometry == bbox: footprints, tiles, extents)
    resolve exactly with vectorized f64 bbox algebra; only non-rectangle
    candidates fall to per-geometry exact tests."""
    rough = geo.bbox_intersects(col.bboxes.astype(np.float64), q)
    bmask, bb = col.box_info()
    out = (
        bmask
        & (bb[:, 0] <= q[2]) & (bb[:, 2] >= q[0])
        & (bb[:, 1] <= q[3]) & (bb[:, 3] >= q[1])
    )
    hard = rough & ~bmask
    n_hard = int(hard.sum())
    if 0 < n_hard <= 64:
        # a handful of non-rect candidates (e.g. a few odd polygons in a
        # mostly-rectangle column): the per-geometry loop beats scanning
        # the whole coords pool
        for i in np.nonzero(hard)[0]:
            out[i] = geo.intersects(col.geometry(int(i)), g)
    elif n_hard:
        # vectorized accept tier for arbitrary (non-rectangle) geometries:
        # the query here is ALWAYS an axis-aligned rect (both call sites
        # gate on is_rectangle), so any geometry VERTEX inside it proves
        # intersection. Each geometry's coords are one contiguous pool
        # slice; a cumsum turns the per-vertex test into per-geometry
        # counts. Only vertex-free overlaps (rect fully inside the
        # geometry, or pure edge crossings) fall to the per-geometry loop.
        c = col.coords
        inb = (
            (c[:, 0] >= q[0]) & (c[:, 0] <= q[2])
            & (c[:, 1] >= q[1]) & (c[:, 1] <= q[3])
        )
        any_vertex = _per_geom_vertex_counts(col, inb) > 0
        out |= hard & any_vertex
        for i in np.nonzero(hard & ~any_vertex)[0]:
            out[i] = geo.intersects(col.geometry(int(i)), g)
    return out


@dataclass(frozen=True)
class Intersects(Filter):
    """INTERSECTS(prop, <geometry>)."""

    prop: str
    geom: geo.Geometry

    def evaluate(self, batch):
        col = _column(batch, self.prop)
        g = self.geom
        if isinstance(col, PointColumn):
            # vectorized bbox prefilter bounds the per-point work to
            # near-hit points (the Python loops below are exact but slow)
            x0, y0, x1, y1 = g.bounds()
            near = (col.x >= x0) & (col.x <= x1) & (col.y >= y0) & (col.y <= y1)
            if isinstance(g, (geo.Polygon, geo.MultiPolygon)):
                inside = np.zeros(len(col), dtype=bool)
                ni = np.nonzero(near)[0]
                inside[ni] = geo.points_in_polygon(col.x[ni], col.y[ni], g)
                # boundary counts for intersects — vectorized over the
                # near-but-not-inside candidates (a per-point loop here
                # cost seconds on dense bbox-near outside regions)
                nb = ni[~inside[ni]]
                if len(nb):
                    inside[nb] = geo.points_on_boundary(
                        col.x[nb], col.y[nb], g
                    )
                return inside
            out = np.zeros(len(col), dtype=bool)
            for i in np.nonzero(near)[0]:
                out[i] = geo.intersects(geo.Point(float(col.x[i]), float(col.y[i])), g)
            return out
        if isinstance(col, geo.PackedGeometryColumn):
            q = np.array(g.bounds())
            if geo.is_rectangle(g):
                return _packed_box_intersects(col, q, g)
            rough = geo.bbox_intersects(col.bboxes.astype(np.float64), q)
            out = np.zeros(len(col), dtype=bool)
            n_rough = int(rough.sum())
            if n_rough > 64 and isinstance(g, (geo.Polygon, geo.MultiPolygon)):
                # accept tier for a POLYGON query over arbitrary features:
                # any feature vertex inside the query polygon proves
                # intersection (one vectorized ray cast over the coords pool)
                c = col.coords
                inside = geo.points_in_polygon(c[:, 0], c[:, 1], g)
                n_in = _per_geom_vertex_counts(col, inside)
                out |= rough & (n_in > 0)
                rough &= ~out
            for i in np.nonzero(rough)[0]:
                out[i] = geo.intersects(col.geometry(int(i)), g)
            return out
        raise TypeError(f"not a geometry column: {type(col)}")


@dataclass(frozen=True)
class Within(Filter):
    """WITHIN(prop, <geometry>): the feature lies within the query geometry."""

    prop: str
    geom: geo.Geometry

    def evaluate(self, batch):
        col = _column(batch, self.prop)
        g = self.geom
        if not isinstance(g, (geo.Polygon, geo.MultiPolygon)):
            raise ValueError("WITHIN requires a polygonal query geometry")
        if isinstance(col, PointColumn):
            return geo.points_in_polygon(col.x, col.y, g)
        # necessary condition, vectorized: the feature's bbox lies inside
        # the query's bbox (within implies bbox containment). Stored
        # bboxes are f32-widened one ulp OUTWARD, so the query bounds
        # widen by an ulp too — no true-within row is ever excluded;
        # extra grazers fall to the exact check below.
        x0, y0, x1, y1 = _ulp_out(*g.bounds())
        b = col.bboxes.astype(np.float64)
        cand = (b[:, 0] >= x0) & (b[:, 1] >= y0) & (b[:, 2] <= x1) & (b[:, 3] <= y1)
        if geo.is_rectangle(g):
            # two-tier for a rect query: rows whose OUTWARD-widened stored
            # bbox fits inside the RAW query bounds are definitely within
            # (true bbox subset of stored; boundary contact allowed, as
            # JTS `within` permits boundary points). Only the sub-ulp
            # boundary band (cand minus sure) needs the exact check, so
            # a protruding vertex 1 ulp past the edge is never accepted.
            rx0, ry0, rx1, ry1 = g.bounds()
            sure = (
                (b[:, 0] >= rx0) & (b[:, 1] >= ry0)
                & (b[:, 2] <= rx1) & (b[:, 3] <= ry1)
            )
            out = _eval_spatial(
                col, None, lambda feat: geo.contains(g, feat),
                candidates=cand & ~sure,
            )
            return out | sure
        return _eval_spatial(
            col, None, lambda feat: geo.contains(g, feat), candidates=cand
        )


@dataclass(frozen=True)
class Contains(Filter):
    """CONTAINS(prop, <geometry>): the feature contains the query geometry."""

    prop: str
    geom: geo.Geometry

    def evaluate(self, batch):
        col = _column(batch, self.prop)
        if isinstance(col, PointColumn):
            if isinstance(self.geom, geo.Point):
                return (col.x == self.geom.x) & (col.y == self.geom.y)
            return np.zeros(len(col), dtype=bool)
        # necessary condition, vectorized: the feature's bbox covers the
        # query geometry's bbox (stored bboxes widen outward, so the
        # direct comparison is already conservative for covering)
        x0, y0, x1, y1 = self.geom.bounds()
        b = col.bboxes.astype(np.float64)
        cand = (b[:, 0] <= x0) & (b[:, 1] <= y0) & (b[:, 2] >= x1) & (b[:, 3] >= y1)
        return _eval_spatial(
            col, None, lambda feat: isinstance(feat, (geo.Polygon, geo.MultiPolygon))
            and geo.contains(feat, self.geom),
            candidates=cand,
        )


@dataclass(frozen=True)
class DWithin(Filter):
    """DWITHIN(prop, <geometry>, distance): within planar distance."""

    prop: str
    geom: geo.Geometry
    dist: float

    def evaluate(self, batch):
        col = _column(batch, self.prop)
        if isinstance(col, PointColumn):
            if isinstance(self.geom, geo.Point):
                return np.hypot(col.x - self.geom.x, col.y - self.geom.y) <= self.dist
            # bbox prefilter: only points inside the distance-expanded
            # envelope can be within range
            x0, y0, x1, y1 = self.bounds
            near = (col.x >= x0) & (col.x <= x1) & (col.y >= y0) & (col.y <= y1)
            out = np.zeros(len(col), dtype=bool)
            for i in np.nonzero(near)[0]:
                out[i] = (
                    geo._point_geom_distance(float(col.x[i]), float(col.y[i]), self.geom)
                    <= self.dist
                )
            return out
        x0, y0, x1, y1 = _ulp_out(*self.bounds)
        b = col.bboxes.astype(np.float64)
        cand = (b[:, 0] <= x1) & (b[:, 2] >= x0) & (b[:, 1] <= y1) & (b[:, 3] >= y0)
        return _eval_spatial(
            col, None, lambda feat: geo.distance(feat, self.geom) <= self.dist,
            candidates=cand,
        )

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        x0, y0, x1, y1 = self.geom.bounds()
        return (x0 - self.dist, y0 - self.dist, x1 + self.dist, y1 + self.dist)


# ---------------------------------------------------------------------------
# temporal (epoch-millis int64 columns)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class During(Filter):
    """prop DURING lo/hi — half-open [lo, hi) on epoch millis, matching the
    reference's During semantics (FilterHelper.extractIntervals treats During
    as exclusive bounds; we use inclusive-lo/exclusive-hi which matches how
    GeoMesa plans Z3 ranges in practice)."""

    prop: str
    lo_ms: int
    hi_ms: int

    def evaluate(self, batch):
        c = np.asarray(_column(batch, self.prop), dtype=np.int64)
        return (c >= self.lo_ms) & (c < self.hi_ms)


# ---------------------------------------------------------------------------
# attribute comparisons
# ---------------------------------------------------------------------------

_OPS = {"=", "<>", "<", "<=", ">", ">="}


def _is_str_col(c: np.ndarray) -> bool:
    return c.dtype.kind in ("U", "S", "O")


@dataclass(frozen=True)
class Cmp(Filter):
    """prop <op> literal, op in =, <>, <, <=, >, >=."""

    prop: str
    op: str
    value: object

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"bad op {self.op!r}")

    def evaluate(self, batch):
        c = _column(batch, self.prop)
        c = np.asarray(c)
        v = self.value
        if self.op == "=":
            return c == v
        if self.op == "<>":
            return c != v
        if self.op == "<":
            return c < v
        if self.op == "<=":
            return c <= v
        if self.op == ">":
            return c > v
        return c >= v


@dataclass(frozen=True)
class Between(Filter):
    """prop BETWEEN lo AND hi (inclusive both ends, per ECQL)."""

    prop: str
    lo: object
    hi: object

    def evaluate(self, batch):
        c = np.asarray(_column(batch, self.prop))
        return (c >= self.lo) & (c <= self.hi)


@dataclass(frozen=True)
class In(Filter):
    """prop IN (v1, v2, ...)."""

    prop: str
    values: tuple

    def evaluate(self, batch):
        c = np.asarray(_column(batch, self.prop))
        return np.isin(c, np.asarray(list(self.values)))


@dataclass(frozen=True)
class Like(Filter):
    """prop LIKE 'pattern' with % (any) and _ (one) wildcards."""

    prop: str
    pattern: str

    def _regex(self) -> re.Pattern:
        esc = re.escape(self.pattern).replace("%", ".*").replace("_", ".")
        return re.compile(f"^{esc}$")

    def evaluate(self, batch):
        c = np.asarray(_column(batch, self.prop))
        rx = self._regex()
        return np.array([bool(rx.match(str(v))) for v in c], dtype=bool)


@dataclass(frozen=True)
class IsNull(Filter):
    """prop IS NULL — NaN for floats, sentinel '' for strings, NaT dates."""

    prop: str

    def evaluate(self, batch):
        c = np.asarray(_column(batch, self.prop))
        if c.dtype.kind == "f":
            return np.isnan(c)
        if _is_str_col(c):
            return np.array([v == "" or v is None for v in c], dtype=bool)
        return np.zeros(len(c), dtype=bool)


@dataclass(frozen=True)
class IdFilter(Filter):
    """Feature-id lookup (ECQL `IN ('id1', 'id2')` without a property).

    Reference: IdFilterStrategy / IdIndexKeySpace.
    """

    ids: tuple

    def evaluate(self, batch):
        fids = batch.get("__id__")
        if fids is None:
            raise KeyError("batch has no __id__ column for id filter")
        fids = np.asarray(fids)
        want = np.asarray(list(self.ids))
        if fids.dtype.kind != want.dtype.kind:
            # ECQL id literals are strings; stored ids may be numeric —
            # compare canonically as strings
            fids = fids.astype(str)
            want = want.astype(str)
        return np.isin(fids, want)


# ---------------------------------------------------------------------------
# logical
# ---------------------------------------------------------------------------


def _flatten(cls, filters: Sequence[Filter]) -> tuple[Filter, ...]:
    out: list[Filter] = []
    for f in filters:
        if isinstance(f, cls):
            out.extend(f.filters)
        else:
            out.append(f)
    return tuple(out)


@dataclass(frozen=True)
class And(Filter):
    filters: tuple = ()

    def __init__(self, filters: Sequence[Filter]):
        object.__setattr__(self, "filters", _flatten(And, tuple(filters)))
        if len(self.filters) < 1:
            raise ValueError("And needs >= 1 children")

    def evaluate(self, batch):
        m = self.filters[0].evaluate(batch)
        for f in self.filters[1:]:
            m = m & f.evaluate(batch)
        return m


@dataclass(frozen=True)
class Or(Filter):
    filters: tuple = ()

    def __init__(self, filters: Sequence[Filter]):
        object.__setattr__(self, "filters", _flatten(Or, tuple(filters)))
        if len(self.filters) < 1:
            raise ValueError("Or needs >= 1 children")

    def evaluate(self, batch):
        m = self.filters[0].evaluate(batch)
        for f in self.filters[1:]:
            m = m | f.evaluate(batch)
        return m


@dataclass(frozen=True)
class Not(Filter):
    filter: Filter = None  # type: ignore[assignment]

    def evaluate(self, batch):
        return ~self.filter.evaluate(batch)


def canonical_key(f: Filter) -> str:
    """Deterministic canonical string of a filter tree (the port's copy of
    the JAX package's, letter for letter). Logically equal trees that
    differ only in And/Or child order give the same string (children sort
    by their own canonical keys), so cache fingerprints and the planner's
    scan-config memo treat ``a AND b`` and ``b AND a`` as one query.
    Geometries render as WKT; floats as repr (round-trip exact)."""
    if isinstance(f, (And, Or)):
        kids = sorted(canonical_key(c) for c in f.filters)
        return f"{type(f).__name__}({','.join(kids)})"
    if isinstance(f, Not):
        return f"Not({canonical_key(f.filter)})"
    from dataclasses import fields, is_dataclass

    if not is_dataclass(f):  # pragma: no cover - all predicates are dataclasses
        return repr(f)
    parts = [f"{fd.name}={_canonical_value(getattr(f, fd.name))}" for fd in fields(f)]
    return f"{type(f).__name__}({','.join(parts)})"


def _canonical_value(v) -> str:
    if isinstance(v, geo.Geometry):
        return v.wkt
    if isinstance(v, (bool, np.bool_)):
        return repr(bool(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (int, np.integer)):
        return repr(int(v))
    if isinstance(v, (tuple, list)):
        return "(" + ",".join(_canonical_value(x) for x in v) + ")"
    return repr(v)


def wrap_box(prop: str, x0: float, y0: float, x1: float, y1: float) -> Filter:
    """A lon/lat box as a filter, WRAPPING across the antimeridian
    (GeoTools BBOX semantics: a box past +/-180 crosses the seam and
    becomes two boxes). Latitude clamps to [-90, 90]."""
    import math

    y0, y1 = max(y0, -90.0), min(y1, 90.0)
    if not (math.isfinite(x0) and math.isfinite(x1)):
        # non-finite lons (e.g. an overflowed literal): keep the raw box —
        # the shift loops below would never terminate on inf
        return BBox(prop, x0, y0, x1, y1)
    if x1 - x0 >= 360.0:
        return BBox(prop, -180.0, y0, 180.0, y1)
    # a box lying ENTIRELY beyond the seam shifts into range first — the
    # splits below would otherwise emit an inverted (xmin > xmax) arm
    while x0 > 180.0:
        x0 -= 360.0
        x1 -= 360.0
    while x1 < -180.0:
        x0 += 360.0
        x1 += 360.0
    if x0 < -180.0:
        return Or((
            BBox(prop, -180.0, y0, x1, y1),
            BBox(prop, x0 + 360.0, y0, 180.0, y1),
        ))
    if x1 > 180.0:
        return Or((
            BBox(prop, x0, y0, 180.0, y1),
            BBox(prop, -180.0, y0, x1 - 360.0, y1),
        ))
    return BBox(prop, x0, y0, x1, y1)


def normalize_antimeridian(f: Filter) -> Filter:
    """Rewrite out-of-range BBOXes anywhere in a filter tree into their
    wrapped two-box form (reference FilterHelper splits seam-crossing
    boxes the same way; without this the planner's world-clamping would
    silently drop the wrapped part). Returns ``f`` itself when nothing
    in the tree needed rewriting (the common case on every plan())."""
    if isinstance(f, BBox) and (f.xmin < -180.0 or f.xmax > 180.0):
        return wrap_box(f.prop, f.xmin, f.ymin, f.xmax, f.ymax)
    if isinstance(f, (And, Or)):
        kids = tuple(normalize_antimeridian(c) for c in f.filters)
        if all(k is c for k, c in zip(kids, f.filters)):
            return f
        return And(kids) if isinstance(f, And) else Or(kids)
    if isinstance(f, Not):
        inner = normalize_antimeridian(f.filter)
        return f if inner is f.filter else Not(inner)
    return f
