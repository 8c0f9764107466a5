"""ST_* spatial function library.

Reference: the ~60 spark-jts UDFs (geomesa-spark/
geomesa-spark-jts/src/main/scala/org/locationtech/geomesa/spark/jts/udf/ —
GeometricConstructorFunctions, GeometricAccessorFunctions,
SpatialRelationFunctions, GeometricOutputFunctions,
GeometricProcessingFunctions). Functions take/return Geometry scalars or
lists of geometries (columnar batches map over them); every function is
registered in ``FUNCTIONS`` for name-based dispatch (``st_call``).

The port's copy of geomesa_tpu/sql/functions.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.process.knn import haversine_m

FUNCTIONS: dict[str, Callable] = {}


def _register(fn: Callable) -> Callable:
    FUNCTIONS[fn.__name__] = fn
    return fn


def st_call(name: str, *args):
    """Dispatch an ST_ function by (case-insensitive) name."""
    fn = FUNCTIONS.get(name.lower())
    if fn is None:
        raise KeyError(f"unknown function {name!r}")
    return fn(*args)


# -- constructors (GeometricConstructorFunctions) ------------------------

@_register
def st_point(x: float, y: float) -> geo.Point:
    return geo.Point(float(x), float(y))


@_register
def st_makepoint(x: float, y: float) -> geo.Point:
    return geo.Point(float(x), float(y))


@_register
def st_makebbox(xmin: float, ymin: float, xmax: float, ymax: float) -> geo.Polygon:
    return geo.box(xmin, ymin, xmax, ymax)


@_register
def st_makeline(points: Sequence) -> geo.LineString:
    coords = [(p.x, p.y) if isinstance(p, geo.Point) else tuple(p) for p in points]
    return geo.LineString(np.asarray(coords, dtype=np.float64))


@_register
def st_makepolygon(shell: "geo.LineString | Sequence") -> geo.Polygon:
    ring = shell.coords if isinstance(shell, geo.LineString) else np.asarray(shell)
    return geo.Polygon(ring)


@_register
def st_geomfromwkt(wkt: str) -> geo.Geometry:
    return geo.from_wkt(wkt)


@_register
def st_geomfromwkb(wkb: bytes) -> geo.Geometry:
    return geo.from_wkb(wkb)


# -- accessors (GeometricAccessorFunctions) ------------------------------

@_register
def st_x(g: geo.Geometry) -> float:
    if not isinstance(g, geo.Point):
        raise TypeError("st_x requires a Point")
    return g.x


@_register
def st_y(g: geo.Geometry) -> float:
    if not isinstance(g, geo.Point):
        raise TypeError("st_y requires a Point")
    return g.y


@_register
def st_envelope(g: geo.Geometry) -> geo.Polygon:
    return geo.box(*g.bounds())


@_register
def st_geometrytype(g: geo.Geometry) -> str:
    return g.geom_type


@_register
def st_numpoints(g: geo.Geometry) -> int:
    return g._coord_count()


@_register
def st_isvalid(g: geo.Geometry) -> bool:
    b = g.bounds()
    return all(math.isfinite(v) for v in b)


@_register
def st_area(g: geo.Geometry) -> float:
    if isinstance(g, geo.Polygon):
        return g.area
    if isinstance(g, geo.MultiPolygon):
        return sum(p.area for p in g.parts)
    return 0.0


@_register
def st_length(g: geo.Geometry) -> float:
    if isinstance(g, geo.LineString):
        return g.length
    if isinstance(g, geo.MultiLineString):
        return sum(p.length for p in g.parts)
    return 0.0


@_register
def st_centroid(g: geo.Geometry) -> geo.Point:
    if isinstance(g, geo.Point):
        return g
    if isinstance(g, geo.Polygon):
        return _polygon_centroid(g)
    if isinstance(g, geo.LineString):
        c = g.coords
        seg = np.linalg.norm(np.diff(c, axis=0), axis=1)
        if seg.sum() == 0:
            return geo.Point(float(c[0, 0]), float(c[0, 1]))
        mid = (c[:-1] + c[1:]) / 2
        w = seg / seg.sum()
        return geo.Point(float((mid[:, 0] * w).sum()), float((mid[:, 1] * w).sum()))
    # multis: area/length/count-weighted mean of part centroids
    if isinstance(g, (geo.MultiPoint, geo.MultiLineString, geo.MultiPolygon)):
        pts = [st_centroid(p) for p in g.parts]
        ws = [max(st_area(p) + st_length(p), 1e-30) for p in g.parts]
        tot = sum(ws)
        return geo.Point(
            sum(p.x * w for p, w in zip(pts, ws)) / tot,
            sum(p.y * w for p, w in zip(pts, ws)) / tot,
        )
    x0, y0, x1, y1 = g.bounds()
    return geo.Point((x0 + x1) / 2, (y0 + y1) / 2)


def _polygon_centroid(p: geo.Polygon) -> geo.Point:
    def ring_terms(ring):
        x, y = ring[:, 0], ring[:, 1]
        x1, y1 = np.roll(x, -1), np.roll(y, -1)
        cross = x * y1 - x1 * y
        a = cross.sum() / 2.0
        if a == 0:
            return 0.0, x.mean(), y.mean()
        cx = ((x + x1) * cross).sum() / (6 * a)
        cy = ((y + y1) * cross).sum() / (6 * a)
        return a, cx, cy

    a0, cx0, cy0 = ring_terms(p.shell)
    area, mx, my = abs(a0), abs(a0) * cx0, abs(a0) * cy0
    for h in p.holes:
        ah, cxh, cyh = ring_terms(h)
        area -= abs(ah)
        mx -= abs(ah) * cxh
        my -= abs(ah) * cyh
    if area <= 0:
        x0, y0, x1, y1 = p.bounds()
        return geo.Point((x0 + x1) / 2, (y0 + y1) / 2)
    return geo.Point(mx / area, my / area)


@_register
def st_exteriorring(g: geo.Polygon) -> geo.LineString:
    return geo.LineString(g.shell)


# -- relations (SpatialRelationFunctions) --------------------------------

@_register
def st_intersects(a: geo.Geometry, b: geo.Geometry) -> bool:
    return geo.intersects(a, b)


@_register
def st_disjoint(a: geo.Geometry, b: geo.Geometry) -> bool:
    return not geo.intersects(a, b)


@_register
def st_contains(a: geo.Geometry, b: geo.Geometry) -> bool:
    return geo.contains(a, b)


@_register
def st_within(a: geo.Geometry, b: geo.Geometry) -> bool:
    return geo.contains(b, a)


@_register
def st_covers(a: geo.Geometry, b: geo.Geometry) -> bool:
    return geo.contains(a, b)


@_register
def st_distance(a: geo.Geometry, b: geo.Geometry) -> float:
    return geo.distance(a, b)


@_register
def st_distancespheroid(a: geo.Geometry, b: geo.Geometry) -> float:
    """Meters between representative points (great-circle; the reference
    delegates to geodetic JTS calculators)."""
    ax, ay = _rep(a)
    bx, by = _rep(b)
    return float(haversine_m(ax, ay, bx, by))


@_register
def st_dwithin(a: geo.Geometry, b: geo.Geometry, d: float) -> bool:
    return geo.distance(a, b) <= d


@_register
def st_equals(a: geo.Geometry, b: geo.Geometry) -> bool:
    return a == b


@_register
def st_overlaps(a: geo.Geometry, b: geo.Geometry) -> bool:
    return (
        geo.intersects(a, b)
        and not geo.contains(a, b)
        and not geo.contains(b, a)
    )


def _rep(g: geo.Geometry):
    if isinstance(g, geo.Point):
        return g.x, g.y
    x0, y0, x1, y1 = g.bounds()
    return (x0 + x1) / 2, (y0 + y1) / 2


# -- outputs / processing ------------------------------------------------

@_register
def st_astext(g: geo.Geometry) -> str:
    return geo.to_wkt(g)


@_register
def st_asbinary(g: geo.Geometry) -> bytes:
    return geo.to_wkb(g)


@_register
def st_bufferpoint(g: geo.Point, meters: float, segments: int = 32) -> geo.Polygon:
    """Geodesic-ish circular buffer of a point (reference ST_BufferPoint):
    a ring of ``segments`` vertices at the meter radius."""
    lat_deg = meters / 111_320.0
    lon_deg = lat_deg / max(0.01, math.cos(math.radians(min(abs(g.y), 89.0))))
    t = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([g.x + lon_deg * np.cos(t), g.y + lat_deg * np.sin(t)], axis=1)
    return geo.Polygon(ring)


@_register
def st_translate(g: geo.Geometry, dx: float, dy: float) -> geo.Geometry:
    return geo.from_wkb(_translate_wkb(geo.to_wkb(g), dx, dy))


def _translate_wkb(wkb: bytes, dx: float, dy: float) -> bytes:
    g = geo.from_wkb(wkb)

    def shift(ring):
        out = np.asarray(ring, dtype=np.float64).copy()
        out[:, 0] += dx
        out[:, 1] += dy
        return out

    if isinstance(g, geo.Point):
        return geo.to_wkb(geo.Point(g.x + dx, g.y + dy))
    if isinstance(g, geo.LineString):
        return geo.to_wkb(geo.LineString(shift(g.coords)))
    if isinstance(g, geo.Polygon):
        return geo.to_wkb(geo.Polygon(shift(g.shell), [shift(h) for h in g.holes]))
    parts = [geo.from_wkb(_translate_wkb(geo.to_wkb(p), dx, dy)) for p in g.parts]
    return geo.to_wkb(type(g)(parts))


def _all_coords(g: geo.Geometry) -> np.ndarray:
    """Every vertex of a geometry as [n, 2]."""
    if isinstance(g, geo.Point):
        return np.array([[g.x, g.y]])
    if isinstance(g, geo.LineString):
        return np.asarray(g.coords, dtype=np.float64)
    if isinstance(g, geo.Polygon):
        parts = [np.asarray(g.shell, dtype=np.float64)]
        parts += [np.asarray(h, dtype=np.float64) for h in g.holes]
        return np.concatenate(parts)
    return np.concatenate([_all_coords(p) for p in g.parts])


@_register
def st_convexhull(g: geo.Geometry) -> geo.Geometry:
    """Convex hull (Andrew monotone chain). Degenerate inputs return the
    point / segment itself."""
    # np.unique(axis=0) already yields (x, y)-lexicographic order
    p = np.unique(_all_coords(g), axis=0)
    if len(p) == 1:
        return geo.Point(float(p[0, 0]), float(p[0, 1]))
    if len(p) == 2:
        return geo.LineString(p)

    def cross2(a, b) -> float:  # 2-d cross product (np.cross 2-d is deprecated)
        return float(a[0] * b[1] - a[1] * b[0])

    def chain(points):
        out: list = []
        for q in points:
            while len(out) >= 2 and cross2(out[-1] - out[-2], q - out[-1]) <= 0:
                out.pop()
            out.append(q)
        return out

    lower = chain(p)
    upper = chain(p[::-1])
    hull = np.array(lower[:-1] + upper[:-1])
    if len(hull) < 3:  # collinear input
        return geo.LineString(np.array([p[0], p[-1]]))
    ring = np.concatenate([hull, hull[:1]])
    return geo.Polygon(ring)


def _dp_simplify(coords: np.ndarray, tol: float) -> np.ndarray:
    """Douglas-Peucker on an open coordinate run."""
    keep = np.zeros(len(coords), dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, len(coords) - 1)]
    while stack:
        a, b = stack.pop()
        if b - a < 2:
            continue
        seg = coords[b] - coords[a]
        ln = np.hypot(*seg)
        mid = coords[a + 1 : b]
        if ln == 0:
            d = np.hypot(mid[:, 0] - coords[a, 0], mid[:, 1] - coords[a, 1])
        else:
            rel = mid - coords[a]
            d = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / ln
        i = int(np.argmax(d))
        if d[i] > tol:
            k = a + 1 + i
            keep[k] = True
            stack += [(a, k), (k, b)]
    return coords[keep]


@_register
def st_simplify(g: geo.Geometry, tolerance: float) -> geo.Geometry:
    """Douglas-Peucker simplification (planar degrees tolerance). Polygon
    rings that collapse below 4 points are dropped (holes) or kept at
    minimum shape (shells keep their bounding triangle behavior by
    falling back to the original ring)."""
    if isinstance(g, geo.Point):
        return g
    if isinstance(g, geo.LineString):
        return geo.LineString(_dp_simplify(np.asarray(g.coords, float), tolerance))
    if isinstance(g, geo.Polygon):
        def ring(r):
            rr = np.asarray(r, dtype=np.float64)
            # simplify the closed ring on its open form, re-close after
            s = _dp_simplify(rr[:-1], tolerance) if len(rr) > 4 else rr[:-1]
            return np.concatenate([s, s[:1]])

        shell = ring(g.shell)
        if len(shell) < 4:
            shell = np.asarray(g.shell, dtype=np.float64)
        holes = [h2 for h in g.holes if len(h2 := ring(h)) >= 4]
        return geo.Polygon(shell, holes)
    return type(g)([st_simplify(p, tolerance) for p in g.parts])


@_register
def st_boundary(g: geo.Geometry) -> geo.Geometry:
    """Boundary (OGC): polygon/multipolygon -> rings, linestring ->
    endpoints, multilinestring -> all endpoints, point -> empty multi."""
    if isinstance(g, geo.Point):
        return geo.MultiPoint([])  # a point's boundary is empty
    if isinstance(g, geo.LineString):
        if st_isclosed(g):
            return geo.MultiPoint([])  # a ring's boundary is empty (OGC)
        c = np.asarray(g.coords)
        return geo.MultiPoint([
            geo.Point(float(c[0, 0]), float(c[0, 1])),
            geo.Point(float(c[-1, 0]), float(c[-1, 1])),
        ])
    if isinstance(g, geo.Polygon):
        rings = [geo.LineString(g.shell)] + [geo.LineString(h) for h in g.holes]
        return rings[0] if len(rings) == 1 else geo.MultiLineString(rings)
    if isinstance(g, geo.MultiPoint):
        return geo.MultiPoint([])
    if isinstance(g, (geo.MultiLineString, geo.MultiPolygon)):
        pieces = [st_boundary(p) for p in g.parts]
        flat: list = []
        for b in pieces:
            flat.extend(b.parts if hasattr(b, "parts") else [b])
        if isinstance(g, geo.MultiLineString):
            # OGC mod-2 rule: a point is on the boundary iff it is an
            # endpoint of an odd number of parts
            counts: dict = {}
            for p in flat:
                counts[(p.x, p.y)] = counts.get((p.x, p.y), 0) + 1
            return geo.MultiPoint(
                [geo.Point(x, y) for (x, y), n in counts.items() if n % 2 == 1]
            )
        return geo.MultiLineString(flat)
    raise TypeError(f"st_boundary of {type(g).__name__} unsupported")


@_register
def st_numinteriorrings(g: geo.Polygon) -> int:
    return len(g.holes)


def _ogc_index(n: int, count: int, what: str) -> int:
    """1-based OGC index with explicit range errors (a bare [n-1] would
    silently return the LAST element for n=0)."""
    if not 1 <= n <= count:
        raise IndexError(f"{what} index {n} out of range [1, {count}]")
    return n - 1


@_register
def st_interiorringn(g: geo.Polygon, n: int) -> geo.LineString:
    return geo.LineString(g.holes[_ogc_index(n, len(g.holes), "interior ring")])


@_register
def st_pointn(g: geo.LineString, n: int) -> geo.Point:
    c = np.asarray(g.coords)
    i = _ogc_index(n, len(c), "point")
    return geo.Point(float(c[i, 0]), float(c[i, 1]))


@_register
def st_startpoint(g: geo.LineString) -> geo.Point:
    return st_pointn(g, 1)


@_register
def st_endpoint(g: geo.LineString) -> geo.Point:
    return st_pointn(g, len(np.asarray(g.coords)))


@_register
def st_numgeometries(g: geo.Geometry) -> int:
    return len(g.parts) if hasattr(g, "parts") else 1


@_register
def st_geometryn(g: geo.Geometry, n: int) -> geo.Geometry:
    if hasattr(g, "parts"):
        return g.parts[_ogc_index(n, len(g.parts), "geometry")]
    if n == 1:
        return g
    raise IndexError(n)


@_register
def st_geohash(g: geo.Point, precision: int = 12) -> str:
    from geomesa_tpu_torch.utils import geohash

    return str(geohash.encode(g.x, g.y, precision))


@_register
def st_geomfromgeohash(h: str) -> geo.Polygon:
    """The geohash CELL as a polygon (reference ST_GeomFromGeoHash)."""
    from geomesa_tpu_torch.utils import geohash

    x0, y0, x1, y1 = geohash.bbox(h)
    return geo.box(x0, y0, x1, y1)


@_register
def st_pointfromgeohash(h: str) -> geo.Point:
    from geomesa_tpu_torch.utils import geohash

    cx, cy = geohash.decode(h)
    return geo.Point(cx, cy)


@_register
def st_astwkb(g: geo.Geometry, precision: int = 7) -> bytes:
    from geomesa_tpu_torch.io.twkb import to_twkb

    return to_twkb(g, precision)


@_register
def st_geomfromtwkb(data: bytes) -> geo.Geometry:
    from geomesa_tpu_torch.io.twkb import from_twkb

    return from_twkb(data)


# -- typed WKT/WKB constructors (GeometricConstructorFunctions) ----------
#
# Reference: ST_PointFromText / ST_LineFromText / ST_PolygonFromText /
# ST_MPointFromText / ST_MLineFromText / ST_MPolyFromText / ST_PointFromWKB
# (geomesa-spark/geomesa-spark-jts/.../udf/
#  GeometricConstructorFunctions.scala) — parse + assert the result type.

def _typed_from_wkt(text: str, cls, name: str):
    g = geo.from_wkt(text)
    if not isinstance(g, cls):
        raise TypeError(f"{name} parsed a {g.geom_type}")
    return g


@_register
def st_pointfromtext(text: str) -> geo.Point:
    return _typed_from_wkt(text, geo.Point, "st_pointfromtext")


@_register
def st_linefromtext(text: str) -> geo.LineString:
    return _typed_from_wkt(text, geo.LineString, "st_linefromtext")


@_register
def st_polygonfromtext(text: str) -> geo.Polygon:
    return _typed_from_wkt(text, geo.Polygon, "st_polygonfromtext")


@_register
def st_mpointfromtext(text: str) -> geo.MultiPoint:
    return _typed_from_wkt(text, geo.MultiPoint, "st_mpointfromtext")


@_register
def st_mlinefromtext(text: str) -> geo.MultiLineString:
    return _typed_from_wkt(text, geo.MultiLineString, "st_mlinefromtext")


@_register
def st_mpolyfromtext(text: str) -> geo.MultiPolygon:
    return _typed_from_wkt(text, geo.MultiPolygon, "st_mpolyfromtext")


@_register
def st_pointfromwkb(wkb: bytes) -> geo.Point:
    g = geo.from_wkb(wkb)
    if not isinstance(g, geo.Point):
        raise TypeError(f"st_pointfromwkb parsed a {g.geom_type}")
    return g


@_register
def st_polygon(shell: "geo.LineString") -> geo.Polygon:
    """Polygon from a closed LineString (reference ST_Polygon)."""
    return st_makepolygon(shell)


@_register
def st_makebox(ll: geo.Point, ur: geo.Point) -> geo.Polygon:
    return geo.box(ll.x, ll.y, ur.x, ur.y)


@_register
def st_makepointm(x: float, y: float, m: float) -> geo.Point:
    """The measure coordinate is not stored (the columnar model is 2-D);
    reference parity is the (x, y) point."""
    return geo.Point(float(x), float(y))


# -- casts (CastFunctions) ----------------------------------------------

@_register
def st_casttogeometry(g: geo.Geometry) -> geo.Geometry:
    return g


def _cast(g: geo.Geometry, cls, name: str):
    if isinstance(g, cls):
        return g
    raise TypeError(f"{name}: {g.geom_type} is not a {cls.__name__}")


@_register
def st_casttopoint(g: geo.Geometry) -> geo.Point:
    return _cast(g, geo.Point, "st_casttopoint")


@_register
def st_casttolinestring(g: geo.Geometry) -> geo.LineString:
    return _cast(g, geo.LineString, "st_casttolinestring")


@_register
def st_casttopolygon(g: geo.Geometry) -> geo.Polygon:
    return _cast(g, geo.Polygon, "st_casttopolygon")


# -- accessors: dimension / emptiness / simplicity ----------------------

@_register
def st_coorddim(g: geo.Geometry) -> int:
    """Coordinate dimension — the store is strictly 2-D."""
    return 2


@_register
def st_dimension(g: geo.Geometry) -> int:
    """Topological dimension: 0 points, 1 lines, 2 polygons; collections
    take the max over parts (JTS Geometry.getDimension)."""
    if isinstance(g, geo.Point):
        return 0
    if isinstance(g, geo.LineString):
        return 1
    if isinstance(g, geo.Polygon):
        return 2
    if isinstance(g, geo.MultiPoint):
        return 0
    if isinstance(g, geo.MultiLineString):
        return 1
    if isinstance(g, geo.MultiPolygon):
        return 2
    return max((st_dimension(p) for p in g.parts), default=0)


@_register
def st_isempty(g: geo.Geometry) -> bool:
    return g._coord_count() == 0


@_register
def st_iscollection(g: geo.Geometry) -> bool:
    return hasattr(g, "parts")


@_register
def st_isclosed(g: geo.Geometry) -> bool:
    """LineString closed iff first == last vertex; multis iff every part
    is; points are closed by convention (PostGIS/JTS)."""
    if isinstance(g, geo.LineString):
        c = np.asarray(g.coords)
        return bool(len(c) > 0 and (c[0] == c[-1]).all())
    if isinstance(g, geo.MultiLineString):
        return all(st_isclosed(p) for p in g.parts)
    return True


@_register
def st_issimple(g: geo.Geometry) -> bool:
    """No anomalous self-intersection: LineStrings may not cross
    themselves (shared endpoints of adjacent segments and ring closure
    are allowed); MultiPoints may not repeat a point; polygons are
    treated as simple when their rings are."""
    if isinstance(g, geo.Point):
        return True
    if isinstance(g, geo.MultiPoint):
        pts = {(p.x, p.y) for p in g.parts}
        return len(pts) == len(g.parts)
    if isinstance(g, geo.LineString):
        return _line_is_simple(np.asarray(g.coords, dtype=np.float64))
    if isinstance(g, geo.Polygon):
        return all(
            _line_is_simple(np.asarray(r, dtype=np.float64))
            for r in [g.shell, *g.holes]
        )
    return all(st_issimple(p) for p in g.parts)


def _line_is_simple(c: np.ndarray) -> bool:
    n = len(c) - 1  # segment count
    if n < 2:
        return True
    closed = bool((c[0] == c[-1]).all())
    a, b = c[:-1], c[1:]
    lo = np.minimum(a, b)  # [n, 2] per-segment bounding boxes
    hi = np.maximum(a, b)
    # axis-sweep prune: in min order along one axis, position p can only
    # intersect later positions whose min <= p's max — a contiguous
    # sorted run, found with one searchsorted — so the exact test touches
    # bbox-overlapping pairs only (intersecting segments always have
    # overlapping bboxes). Sweep whichever axis yields fewer candidate
    # pairs: a long north-south track overlaps everything in x but
    # almost nothing in y. Inputs degenerate in BOTH axes fall back to
    # the full O(n^2) pair set, same as testing every pair directly.
    def sweep(ax):
        order = np.argsort(lo[:, ax], kind="stable")
        stop = np.searchsorted(lo[order, ax], hi[order, ax], side="right")
        lens = np.maximum(stop - np.arange(1, n + 1), 0)
        return order, lens, int(lens.sum())

    sx, sy = sweep(0), sweep(1)
    (order, lens_all, _), other = (sx, 1) if sx[2] <= sy[2] else (sy, 0)
    # block by PAIR count, not position count: a position in a heavily
    # overlapping stretch can have ~n candidates, so a fixed position
    # block would materialize O(block * n) pair indices at once —
    # capping pairs keeps peak memory flat
    csum = np.concatenate([[0], np.cumsum(lens_all)])
    cap = 1_000_000  # pairs per iteration (~8 MB per index array)
    p0 = 0
    while p0 < n:
        p1 = max(int(np.searchsorted(csum, csum[p0] + cap)), p0 + 1)
        pp = np.arange(p0, min(p1, n))
        p0 = min(p1, n)
        lens = lens_all[pp]
        total = int(lens.sum())
        if total == 0:
            continue
        pi = np.repeat(pp, lens)
        qi = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens) + pi + 1
        i, j = order[pi], order[qi]
        # non-adjacent pairs only (adjacent segments share a vertex by
        # design; ring closure shares the first/last vertex)
        keep = np.abs(i - j) >= 2
        if closed:
            keep &= (np.minimum(i, j) != 0) | (np.maximum(i, j) != n - 1)
        i, j = i[keep], j[keep]
        keep = (  # bbox overlap on the non-swept axis
            (lo[i, other] <= hi[j, other]) & (lo[j, other] <= hi[i, other])
        )
        i, j = i[keep], j[keep]
        if len(i) and bool(np.any(geo.segments_intersect(a[i], b[i], a[j], b[j]))):
            return False
    return True


@_register
def st_isring(g: geo.LineString) -> bool:
    return st_isclosed(g) and st_issimple(g)


# -- GeoJSON / text outputs (GeometricOutputFunctions) ------------------

@_register
def st_asgeojson(g: geo.Geometry) -> str:
    import json

    from geomesa_tpu_torch.io.exporters import _geojson_geom

    return json.dumps(_geojson_geom(g), separators=(",", ":"))


@_register
def st_geomfromgeojson(text: "str | dict") -> geo.Geometry:
    import json

    obj = json.loads(text) if isinstance(text, str) else text
    return _geom_from_geojson(obj)


def _geom_from_geojson(obj: dict) -> geo.Geometry:
    t = obj["type"]
    c = obj.get("coordinates")
    if t == "Point":
        return geo.Point(float(c[0]), float(c[1]))
    if t == "LineString":
        return geo.LineString(np.asarray(c, dtype=np.float64))
    if t == "Polygon":
        rings = [np.asarray(r, dtype=np.float64) for r in c]
        return geo.Polygon(rings[0], rings[1:])
    if t == "MultiPoint":
        return geo.MultiPoint([geo.Point(float(p[0]), float(p[1])) for p in c])
    if t == "MultiLineString":
        return geo.MultiLineString(
            [geo.LineString(np.asarray(l, dtype=np.float64)) for l in c]
        )
    if t == "MultiPolygon":
        return geo.MultiPolygon(
            [
                geo.Polygon(
                    np.asarray(p[0], dtype=np.float64),
                    [np.asarray(r, dtype=np.float64) for r in p[1:]],
                )
                for p in c
            ]
        )
    if t == "GeometryCollection":
        raise ValueError("GeometryCollection is not supported")
    raise ValueError(f"unknown GeoJSON type {t!r}")


def _dms(value: float, axis: str) -> str:
    hemi = ("N" if value >= 0 else "S") if axis == "lat" else (
        "E" if value >= 0 else "W"
    )
    # work in rounded milliarc-ish units so 59.9999" carries into the
    # next minute/degree instead of rendering an invalid 60.000"
    total_ms = round(abs(value) * 3600 * 1000)
    d, rem = divmod(total_ms, 3600 * 1000)
    m, s_ms = divmod(rem, 60 * 1000)
    return f"{d}°{m}'{s_ms / 1000:.3f}\"{hemi}"


@_register
def st_aslatlontext(g: geo.Point) -> str:
    """Degrees-minutes-seconds rendering of a point (reference
    ST_AsLatLonText)."""
    return f"{_dms(g.y, 'lat')} {_dms(g.x, 'lon')}"


@_register
def st_bytearray(s: str) -> bytes:
    return s.encode("utf-8")


# -- interior/boundary relations (SpatialRelationFunctions) -------------
#
# The reference delegates ST_Touches/ST_Crosses/ST_Relate to JTS's full
# DE-9IM machinery. Here they are built from the host predicate engine:
# exact T/F entries for non-degenerate point/line/polygon inputs, with
# intersection *dimensions* approximated by the generic-position value
# (e.g. a collinear-overlap L/L intersection reports dim 1).

def _strictly_inside_polygon(x, y, poly) -> bool:
    return bool(geo.points_in_polygon(x, y, poly)) and not geo._point_on_rings(
        poly, x, y
    )


def _line_interior_covers(line, x: float, y: float) -> bool:
    """Is (x, y) on `line` but not on its boundary? The boundary follows
    the OGC mod-2 rule (matching st_boundary), so a node shared by two
    chained MultiLineString parts is interior."""
    if not geo._point_on_rings(line, x, y):
        return False
    bd = st_boundary(line)
    pts = bd.parts if hasattr(bd, "parts") else [bd]
    return not any(p.x == x and p.y == y for p in pts)


def _proper_edge_crossing(a: geo.Geometry, b: geo.Geometry) -> bool:
    """Any edge pair crossing at a point interior to both edges
    (non-collinear, not endpoint touching). Broadcast [na,1]x[1,nb] like
    geometry._any_edge_intersection."""
    for ra in geo._rings_of(a):
        a1, a2 = geo._ring_edges(ra)
        for rb in geo._rings_of(b):
            b1, b2 = geo._ring_edges(rb)
            ax1, ay1 = a1[:, None, 0], a1[:, None, 1]
            ax2, ay2 = a2[:, None, 0], a2[:, None, 1]
            bx1, by1 = b1[None, :, 0], b1[None, :, 1]
            bx2, by2 = b2[None, :, 0], b2[None, :, 1]
            d1 = geo._orient(ax1, ay1, ax2, ay2, bx1, by1)
            d2 = geo._orient(ax1, ay1, ax2, ay2, bx2, by2)
            d3 = geo._orient(bx1, by1, bx2, by2, ax1, ay1)
            d4 = geo._orient(bx1, by1, bx2, by2, ax2, ay2)
            if bool(((d1 * d2 < 0) & (d3 * d4 < 0)).any()):
                return True
    return False


def _interiors_intersect(a: geo.Geometry, b: geo.Geometry) -> bool:
    da, db = st_dimension(a), st_dimension(b)
    if da > db:
        return _interiors_intersect(b, a)
    # da <= db
    if isinstance(a, (geo.Point, geo.MultiPoint)):
        pts = [a] if isinstance(a, geo.Point) else list(a.parts)
        for p in pts:
            if isinstance(b, (geo.Point, geo.MultiPoint)):
                if geo._geom_covers_point(b, p.x, p.y):
                    return True
            elif isinstance(b, (geo.LineString, geo.MultiLineString)):
                if _line_interior_covers(b, p.x, p.y):
                    return True
            elif _strictly_inside_polygon(p.x, p.y, b):
                return True
        return False
    if isinstance(a, (geo.LineString, geo.MultiLineString)):
        if isinstance(b, (geo.LineString, geo.MultiLineString)):
            if _proper_edge_crossing(a, b) or _collinear_overlap(a, b):
                return True
            # crossing THROUGH a vertex: an interior vertex of one line
            # lying on the interior of the other is not a "proper" edge
            # crossing (orient == 0 at the shared point) but interiors meet
            for g1, g2 in ((a, b), (b, a)):
                for x, y in _interior_vertices(g1):
                    if _line_interior_covers(g2, x, y):
                        return True
            return False
        # line vs polygon: a vertex strictly inside, or any cut sub-piece
        # whose midpoint is strictly inside (catches edges that enter the
        # interior through polygon vertices, where no crossing is "proper")
        va = _all_coords(a)
        if any(
            _strictly_inside_polygon(float(x), float(y), b) for x, y in va
        ):
            return True
        return _proper_edge_crossing(a, b) or _cut_midpoint_inside(a, b)
    # polygon vs polygon
    va = _all_coords(a)
    if any(_strictly_inside_polygon(float(x), float(y), b) for x, y in va):
        return True
    vb = _all_coords(b)
    if any(_strictly_inside_polygon(float(x), float(y), a) for x, y in vb):
        return True
    if _proper_edge_crossing(a, b):
        return True
    if _cut_midpoint_inside(a, b) or _cut_midpoint_inside(b, a):
        return True
    # boundary-identical overlaps (equal polygons, or one tracing part of
    # the other's boundary): no vertex is STRICTLY inside and no crossing
    # is proper, but a guaranteed-interior probe point settles it
    for g1, g2 in ((a, b), (b, a)):
        px, py = _interior_probe(g1)
        if _strictly_inside_polygon(px, py, g2):
            return True
    return False


def _interior_probe(g) -> tuple:
    """A point strictly inside a polygonal geometry: scanline at the
    bbox's mid-height (nudged off any vertex y), midpoint of the first
    inside interval of ring-crossing x's."""
    poly = g.parts[0] if isinstance(g, geo.MultiPolygon) else g
    x0, y0, x1, y1 = poly.bounds()
    ys = np.unique(_all_coords(poly)[:, 1])
    y = (y0 + y1) / 2.0
    if np.any(ys == y):  # nudge between the two nearest distinct vertex rows
        above = ys[ys > y]
        y = (y + above[0]) / 2.0 if len(above) else (y + y0) / 2.0
    xs = []
    for ring in geo._rings_of(poly):
        p1, p2 = geo._ring_edges(ring)
        cross = (p1[:, 1] > y) != (p2[:, 1] > y)
        if cross.any():
            t = (y - p1[cross, 1]) / (p2[cross, 1] - p1[cross, 1])
            xs.extend((p1[cross, 0] + t * (p2[cross, 0] - p1[cross, 0])).tolist())
    xs = sorted(xs)
    if len(xs) >= 2:
        return (xs[0] + xs[1]) / 2.0, y
    return (x0 + x1) / 2.0, (y0 + y1) / 2.0  # degenerate fallback


def _interior_vertices(line) -> list:
    """Vertices on a line geometry's interior (all but the endpoints of
    each open part; every vertex of a closed part)."""
    out = []
    for part in getattr(line, "parts", [line]):
        c = np.asarray(part.coords)
        lo, hi = (0, len(c)) if st_isclosed(part) else (1, len(c) - 1)
        out.extend((float(x), float(y)) for x, y in c[lo:hi])
    return out


def _cut_midpoint_inside(a: geo.Geometry, b) -> bool:
    """Cut each edge of `a` at its crossings with b's rings; does any
    sub-piece midpoint land strictly inside polygon `b`? Exact for edges
    that traverse the interior via vertices of b."""
    for ring in geo._rings_of(a):
        p1, p2 = geo._ring_edges(ring)
        for i in range(len(p1)):
            ts = _seg_cut_params(p1[i], p2[i], b)
            mids = p1[i] + ((ts[:-1] + ts[1:]) / 2)[:, None] * (p2[i] - p1[i])
            for mx, my in mids:
                if _strictly_inside_polygon(float(mx), float(my), b):
                    return True
    return False


def _collinear_overlap(a, b) -> bool:
    """Two line geometries sharing a positive-length collinear run
    (broadcast over both edge sets at once)."""
    for ra in geo._rings_of(a):
        a1, a2 = geo._ring_edges(ra)
        ax1, ay1 = a1[:, None, 0], a1[:, None, 1]
        ax2, ay2 = a2[:, None, 0], a2[:, None, 1]
        dx, dy = ax2 - ax1, ay2 - ay1
        len2 = dx * dx + dy * dy
        for rb in geo._rings_of(b):
            b1, b2 = geo._ring_edges(rb)
            bx1, by1 = b1[None, :, 0], b1[None, :, 1]
            bx2, by2 = b2[None, :, 0], b2[None, :, 1]
            both = (geo._orient(ax1, ay1, ax2, ay2, bx1, by1) == 0) & (
                geo._orient(ax1, ay1, ax2, ay2, bx2, by2) == 0
            )
            if not both.any():
                continue
            # project onto each a-edge's axis; positive 1-d interval overlap
            t1 = (bx1 - ax1) * dx + (by1 - ay1) * dy
            t2 = (bx2 - ax1) * dx + (by2 - ay1) * dy
            lo = np.minimum(t1, t2)
            hi = np.maximum(t1, t2)
            run = np.minimum(hi, len2) - np.maximum(lo, 0.0)
            if bool((both & (run > 0)).any()):
                return True
    return False


def _has_point_outside(a: geo.Geometry, b: geo.Geometry) -> bool:
    """Does a's interior extend outside b? (vertex-level test plus a
    bounds check — exact unless every vertex of a lies inside b while an
    edge dips out, which requires a non-convex b in special position)."""
    ab, bb = a.bounds(), b.bounds()
    if ab[0] < bb[0] or ab[1] < bb[1] or ab[2] > bb[2] or ab[3] > bb[3]:
        return True
    va = _all_coords(a)
    if isinstance(b, (geo.Polygon, geo.MultiPolygon)):
        return any(
            not bool(geo.points_in_polygon(float(x), float(y), b)) for x, y in va
        )
    if isinstance(b, (geo.LineString, geo.MultiLineString)):
        return any(not geo._point_on_rings(b, float(x), float(y)) for x, y in va)
    return any(not geo._geom_covers_point(b, float(x), float(y)) for x, y in va)


@_register
def st_touches(a: geo.Geometry, b: geo.Geometry) -> bool:
    """Geometries meet only on their boundaries."""
    return geo.intersects(a, b) and not _interiors_intersect(a, b)


@_register
def st_crosses(a: geo.Geometry, b: geo.Geometry) -> bool:
    """Interiors intersect and each geometry extends beyond the other
    (JTS crosses for P/L, P/A, L/A and L/L)."""
    da, db = st_dimension(a), st_dimension(b)
    if da == db and da != 1:
        return False  # crosses is not defined for P/P or A/A
    if not _interiors_intersect(a, b):
        return False
    if da == db == 1:
        # L/L crosses iff the intersection is points (interiors already
        # known to meet), not a shared collinear run
        return not _collinear_overlap(a, b)
    lo, hi = (a, b) if da < db else (b, a)
    return _has_point_outside(lo, hi)


def _boundary_or_none(g: geo.Geometry):
    b = st_boundary(g)
    return None if b._coord_count() == 0 else b


def _int_dim(sa: int, sb: int, ga, gb) -> int:
    """Dimension of the intersection of two point sets with dims
    ``sa``/``sb`` (carried by geometries ``ga``/``gb``): min(sa, sb) —
    except two 1-dimensional sets, which meet in isolated points (dim 0)
    unless they share a positive-length collinear run (JTS reports the
    true dimension here, not the generic min; e.g. two overlapping boxes'
    boundaries cross at two POINTS -> '0')."""
    if sa == 1 and sb == 1:
        return 1 if _collinear_overlap(ga, gb) else 0
    return min(sa, sb)


@_register
def st_relate(a: geo.Geometry, b: geo.Geometry) -> str:
    """DE-9IM matrix. Entries are computed from the predicate engine;
    1-dim x 1-dim entries resolve point-vs-collinear-run exactly
    (_int_dim); remaining dimensions are the generic-position values."""
    da, db = st_dimension(a), st_dimension(b)
    ba, bb_ = _boundary_or_none(a), _boundary_or_none(b)

    def dim_or_f(hit: bool, dim: int) -> str:
        return str(dim) if hit else "F"

    ii = dim_or_f(_interiors_intersect(a, b), _int_dim(da, db, a, b))
    ib = dim_or_f(
        bb_ is not None and _interiors_intersect(a, bb_),
        _int_dim(da, db - 1, a, bb_) if bb_ is not None else 0,
    )
    ie = dim_or_f(_has_point_outside(a, b), da)
    bi = dim_or_f(
        ba is not None and _interiors_intersect(ba, b),
        _int_dim(da - 1, db, ba, b) if ba is not None else 0,
    )
    bb2 = dim_or_f(
        ba is not None and bb_ is not None and geo.intersects(ba, bb_),
        _int_dim(da - 1, db - 1, ba, bb_)
        if ba is not None and bb_ is not None else 0,
    )
    be = dim_or_f(
        ba is not None and _has_point_outside(ba, b), da - 1 if ba is not None else 0
    )
    ei = dim_or_f(_has_point_outside(b, a), db)
    eb = dim_or_f(
        bb_ is not None and _has_point_outside(bb_, a), db - 1 if bb_ is not None else 0
    )
    return f"{ii}{ib}{ie}{bi}{bb2}{be}{ei}{eb}2"


@_register
def st_relatebool(a: geo.Geometry, b: geo.Geometry, pattern: str) -> bool:
    """Match a DE-9IM pattern (T = any intersection, F = none, * = any,
    0/1/2 = exact dimension)."""
    m = st_relate(a, b)
    if len(pattern) != 9:
        raise ValueError(f"DE-9IM pattern must have 9 chars: {pattern!r}")
    for got, want in zip(m, pattern):
        if want == "*":
            continue
        if want == "T" and got == "F":
            return False
        if want == "F" and got != "F":
            return False
        if want in "012" and got != want:
            return False
    return True


# -- sphere-metric functions --------------------------------------------

@_register
def st_distancesphere(a: geo.Geometry, b: geo.Geometry) -> float:
    """Great-circle meters between two geometries (reference
    ST_DistanceSphere): 0 when they intersect, else the haversine
    distance between the planar nearest-point pair — exact at vertices,
    a documented approximation when the true geodesic nearest points
    fall mid-edge (planar projection picks the edge points)."""
    if geo.intersects(a, b):
        return 0.0
    pa = st_closestpoint(a, b)
    # derive b's point FROM pa: independent closest points can come from
    # different tie-minimizing pairs (parallel overlapping lines) and
    # pairing them would overstate the distance
    pb = st_closestpoint(b, pa)
    return float(haversine_m(pa.x, pa.y, pb.x, pb.y))


@_register
def st_lengthsphere(g: geo.Geometry) -> float:
    """Great-circle length of a line geometry in meters."""
    if isinstance(g, geo.LineString):
        c = np.asarray(g.coords)
        if len(c) < 2:
            return 0.0
        return float(
            np.sum(haversine_m(c[:-1, 0], c[:-1, 1], c[1:, 0], c[1:, 1]))
        )
    if isinstance(g, geo.MultiLineString):
        return sum(st_lengthsphere(p) for p in g.parts)
    return 0.0


@_register
def st_aggregatedistancesphere(points: Sequence) -> float:
    """Total great-circle meters along a sequence of points (reference
    ST_AggregateDistanceSphere aggregate)."""
    pts = [(p.x, p.y) if isinstance(p, geo.Point) else tuple(p) for p in points]
    if len(pts) < 2:
        return 0.0
    c = np.asarray(pts, dtype=np.float64)
    return float(np.sum(haversine_m(c[:-1, 0], c[:-1, 1], c[1:, 0], c[1:, 1])))


# -- closest point / valid / antimeridian -------------------------------

@_register
def st_closestpoint(a: geo.Geometry, b: geo.Geometry) -> geo.Point:
    """The point ON `a` closest to `b` (PostGIS/JTS semantics). For
    non-intersecting geometries the nearest pair is always achieved at a
    vertex of one operand (projected onto the other), which this searches
    exactly."""
    if isinstance(a, geo.Point):
        return a
    if isinstance(a, geo.MultiPoint):
        return min(a.parts, key=lambda p: geo.distance(p, b))
    if geo.intersects(a, b):
        # any shared point will do; prefer a vertex of b covered by a
        for x, y in _all_coords(b):
            if geo._geom_covers_point(a, float(x), float(y)):
                return geo.Point(float(x), float(y))
        for x, y in _all_coords(a):
            if geo._geom_covers_point(b, float(x), float(y)):
                return geo.Point(float(x), float(y))
        if not isinstance(b, (geo.Point, geo.MultiPoint)):
            p = _first_edge_crossing(a, b)
            if p is not None:
                return p
    best_d, best_p = np.inf, None
    # vertices of b projected onto a's edges
    for ring in geo._rings_of(a):
        p1, p2 = geo._ring_edges(ring)
        for x, y in _all_coords(b):
            d = geo._point_segments_distance(float(x), float(y), p1, p2)
            i = int(np.argmin(d))
            if d[i] < best_d:
                seg = p2[i] - p1[i]
                len2 = float((seg**2).sum())
                t = 0.0 if len2 == 0 else float(
                    np.clip(((x - p1[i, 0]) * seg[0] + (y - p1[i, 1]) * seg[1]) / len2, 0, 1)
                )
                best_d = float(d[i])
                best_p = geo.Point(
                    float(p1[i, 0] + t * seg[0]), float(p1[i, 1] + t * seg[1])
                )
    # vertices of a against b (the nearest point is then the a-vertex)
    for x, y in _all_coords(a):
        d = geo._point_geom_distance(float(x), float(y), b)
        if d < best_d:
            best_d = d
            best_p = geo.Point(float(x), float(y))
    assert best_p is not None
    return best_p


def _first_edge_crossing(a: geo.Geometry, b: geo.Geometry) -> "geo.Point | None":
    """A concrete intersection point of two crossing edge sets (used when
    geometries intersect but share no vertex)."""
    for ra in geo._rings_of(a):
        a1, a2 = geo._ring_edges(ra)
        for rb in geo._rings_of(b):
            b1, b2 = geo._ring_edges(rb)
            for i in range(len(a1)):
                d = a2[i] - a1[i]
                e = b2 - b1
                denom = d[0] * e[:, 1] - d[1] * e[:, 0]
                ok = denom != 0
                if not ok.any():
                    continue
                w = b1 - a1[i]
                t = (w[:, 0] * e[:, 1] - w[:, 1] * e[:, 0]) / np.where(ok, denom, 1)
                u = (w[:, 0] * d[1] - w[:, 1] * d[0]) / np.where(ok, denom, 1)
                hit = ok & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
                if hit.any():
                    j = int(np.argmax(hit))
                    p = a1[i] + t[j] * d
                    return geo.Point(float(p[0]), float(p[1]))
    return None


@_register
def st_makevalid(g: geo.Geometry) -> geo.Geometry:
    """Light-weight validity repair: drop repeated consecutive vertices,
    re-close rings, drop collapsed rings (the reference delegates to JTS
    MakeValid; full self-intersection node-splitting is out of scope)."""
    def clean_run(c: np.ndarray) -> np.ndarray:
        c = np.asarray(c, dtype=np.float64)
        if len(c) == 0:
            return c
        keep = np.ones(len(c), dtype=bool)
        keep[1:] = (c[1:] != c[:-1]).any(axis=1)
        return c[keep]

    if isinstance(g, geo.Point):
        return g
    if isinstance(g, geo.LineString):
        return geo.LineString(clean_run(np.asarray(g.coords)))
    if isinstance(g, geo.Polygon):
        def ring(r):
            rr = clean_run(np.asarray(r))
            if len(rr) and (rr[0] != rr[-1]).any():
                rr = np.concatenate([rr, rr[:1]])
            return rr

        shell = ring(g.shell)
        if len(shell) < 4:  # the whole polygon collapsed
            return geo.MultiPolygon([])
        holes = [h2 for h in g.holes if len(h2 := ring(h)) >= 4]
        return geo.Polygon(shell, holes)
    parts = [st_makevalid(p) for p in g.parts]
    return type(g)([p for p in parts if p._coord_count() > 0])


@_register
def st_antimeridiansafegeom(g: geo.Geometry) -> geo.Geometry:
    """Split a geometry that crosses the antimeridian (longitude span
    > 180° interpreted as wrapping) into a MultiPolygon/-LineString with
    parts on each side, mirroring the planner's BBOX wrap semantics
    (filter/predicates.normalize_antimeridian)."""
    x0, _, x1, _ = g.bounds()
    if x1 - x0 <= 180.0:
        return g

    def shift(c: np.ndarray) -> np.ndarray:
        out = np.asarray(c, dtype=np.float64).copy()
        out[out[:, 0] < 0.0, 0] += 360.0
        return out

    if isinstance(g, geo.Polygon):
        shell = shift(g.shell)
        holes = [shift(h) for h in g.holes]
        east = _clip_halfplane([shell, *holes], lambda x: x <= 180.0)
        west = _clip_halfplane([shell, *holes], lambda x: x >= 180.0)
        parts = []
        if east is not None:
            parts.append(east)
        if west is not None:
            w = geo.Polygon(
                west.shell - [360.0, 0.0], [h - [360.0, 0.0] for h in west.holes]
            )
            parts.append(w)
        return parts[0] if len(parts) == 1 else geo.MultiPolygon(parts)
    if isinstance(g, geo.LineString):
        c = shift(np.asarray(g.coords))
        pieces = _split_line_at(c, 180.0)
        out = []
        for p in pieces:
            q = p.copy()
            # a west piece is entirely at x >= 180 (its cut vertex sits
            # exactly on 180): shift the WHOLE piece, cut vertex included,
            # so it lands on [-180, ...] instead of spanning the map
            if q[:, 0].max() > 180.0:
                q[:, 0] -= 360.0
            out.append(geo.LineString(q))
        return out[0] if len(out) == 1 else geo.MultiLineString(out)
    if hasattr(g, "parts"):
        flat = []
        for p in g.parts:
            s = st_antimeridiansafegeom(p)
            flat.extend(s.parts if hasattr(s, "parts") else [s])
        return type(g)(flat)
    return g


def _clip_halfplane(rings, inside) -> "geo.Polygon | None":
    """Sutherland-Hodgman clip of a polygon (shell + holes) against a
    vertical half-plane predicate on x."""
    def clip_ring(ring: np.ndarray) -> np.ndarray:
        out = []
        c = ring[:-1] if len(ring) and (ring[0] == ring[-1]).all() else ring
        n = len(c)
        for i in range(n):
            cur, nxt = c[i], c[(i + 1) % n]
            cin, nin = inside(cur[0]), inside(nxt[0])
            if cin:
                out.append(cur)
            if cin != nin and nxt[0] != cur[0]:
                t = (180.0 - cur[0]) / (nxt[0] - cur[0])
                out.append(cur + t * (nxt - cur))
        if len(out) < 3:
            return np.empty((0, 2))
        out.append(out[0])
        return np.asarray(out)

    shell = clip_ring(rings[0])
    if len(shell) < 4:
        return None
    holes = [h2 for h in rings[1:] if len(h2 := clip_ring(h)) >= 4]
    return geo.Polygon(shell, holes)


def _split_line_at(c: np.ndarray, x_cut: float) -> list:
    pieces, cur = [], [c[0]]
    for i in range(1, len(c)):
        a, b = c[i - 1], c[i]
        if (a[0] - x_cut) * (b[0] - x_cut) < 0:
            t = (x_cut - a[0]) / (b[0] - a[0])
            mid = a + t * (b - a)
            cur.append(mid)
            pieces.append(np.asarray(cur))
            cur = [mid]
        elif b[0] == x_cut and i < len(c) - 1:
            # a vertex exactly ON the cut also ends the piece (the strict
            # sign test above is 0 there and would never split)
            cur.append(b)
            pieces.append(np.asarray(cur))
            cur = [b]
            continue
        cur.append(b)
    pieces.append(np.asarray(cur))
    return [p for p in pieces if len(p) >= 2]


# -- overlay (ST_Intersection / ST_Difference) --------------------------
#
# The reference delegates overlay to JTS. Implemented exactly for the
# shapes the query path produces: point/multipoint vs anything, line vs
# polygon (parametric segment clipping against arbitrary rings), and
# polygon vs CONVEX polygon (Sutherland-Hodgman). General concave/concave
# polygon overlay raises rather than approximate.

def _is_convex_ring(ring: np.ndarray) -> bool:
    c = ring[:-1]
    if len(c) < 3:
        return False
    x1 = np.roll(c, -1, axis=0) - c
    x2 = np.roll(c, -2, axis=0) - np.roll(c, -1, axis=0)
    cross = x1[:, 0] * x2[:, 1] - x1[:, 1] * x2[:, 0]
    return bool((cross >= 0).all() or (cross <= 0).all())


def _seg_cut_params(a: np.ndarray, b: np.ndarray, g: geo.Geometry) -> np.ndarray:
    """Parameters t in (0, 1) where segment a->b crosses an edge of g."""
    ts = [0.0, 1.0]
    d = b - a
    for ring in geo._rings_of(g):
        p1, p2 = geo._ring_edges(ring)
        e = p2 - p1
        denom = d[0] * e[:, 1] - d[1] * e[:, 0]
        ok = denom != 0
        if not ok.any():
            continue
        w = p1 - a
        t = np.where(ok, (w[:, 0] * e[:, 1] - w[:, 1] * e[:, 0]) / np.where(ok, denom, 1), -1)
        u = np.where(ok, (w[:, 0] * d[1] - w[:, 1] * d[0]) / np.where(ok, denom, 1), -1)
        hit = ok & (t > 0) & (t < 1) & (u >= 0) & (u <= 1)
        ts.extend(t[hit].tolist())
    return np.unique(np.asarray(ts, dtype=np.float64))


def _line_polygon_pieces(line: geo.LineString, poly, keep_inside: bool) -> list:
    """Sub-runs of `line` inside (or outside) polygon `poly`."""
    c = np.asarray(line.coords, dtype=np.float64)
    runs, cur = [], []
    for i in range(len(c) - 1):
        a, b = c[i], c[i + 1]
        ts = _seg_cut_params(a, b, poly)
        for t0, t1 in zip(ts[:-1], ts[1:]):
            mid = a + (t0 + t1) / 2 * (b - a)
            inside = geo._geom_covers_point(poly, float(mid[0]), float(mid[1]))
            if inside == keep_inside:
                p0, p1 = a + t0 * (b - a), a + t1 * (b - a)
                if cur and np.allclose(cur[-1], p0):
                    cur.append(p1)
                else:
                    if len(cur) >= 2:
                        runs.append(np.asarray(cur))
                    cur = [p0, p1]
            else:
                if len(cur) >= 2:
                    runs.append(np.asarray(cur))
                cur = []
    if len(cur) >= 2:
        runs.append(np.asarray(cur))
    return runs


def _runs_to_geom(runs: list) -> geo.Geometry:
    if not runs:
        return geo.MultiLineString([])
    lines = [geo.LineString(r) for r in runs]
    return lines[0] if len(lines) == 1 else geo.MultiLineString(lines)


@_register
def st_intersection(a: geo.Geometry, b: geo.Geometry) -> geo.Geometry:
    if isinstance(b, (geo.Point, geo.MultiPoint)) and not isinstance(
        a, (geo.Point, geo.MultiPoint)
    ):
        return st_intersection(b, a)
    if isinstance(a, geo.Point):
        return a if geo.intersects(a, b) else geo.MultiPoint([])
    if isinstance(a, geo.MultiPoint):
        hits = [p for p in a.parts if geo.intersects(p, b)]
        return hits[0] if len(hits) == 1 else geo.MultiPoint(hits)
    la = isinstance(a, geo.LineString)
    lb = isinstance(b, geo.LineString)
    pa = isinstance(a, (geo.Polygon, geo.MultiPolygon))
    pb = isinstance(b, (geo.Polygon, geo.MultiPolygon))
    if la and pb:
        return _runs_to_geom(_line_polygon_pieces(a, b, keep_inside=True))
    if lb and pa:
        return _runs_to_geom(_line_polygon_pieces(b, a, keep_inside=True))
    if isinstance(a, geo.Polygon) and isinstance(b, geo.Polygon):
        clip, subj = (a, b) if _is_convex_ring(a.shell) and not a.holes else (b, a)
        if _is_convex_ring(clip.shell) and not clip.holes:
            out = _clip_convex(subj, clip)
            if out is None:
                return geo.MultiPolygon([])
            if _line_is_simple(np.asarray(out.shell, dtype=np.float64)):
                return out
            # a concave subject whose true intersection is DISCONNECTED
            # degenerates to a self-touching Sutherland-Hodgman ring:
            # refuse rather than return overlapping bridge edges
            raise ValueError(
                "st_intersection: disconnected concave intersection is "
                "not supported"
            )
    raise ValueError(
        "st_intersection supports point/line/convex-polygon operands; "
        f"got {a.geom_type} x {b.geom_type}"
    )


def _clip_convex(subject: geo.Polygon, clip: geo.Polygon) -> "geo.Polygon | None":
    """Sutherland-Hodgman clip of `subject` against convex `clip`."""
    ring = np.asarray(clip.shell, dtype=np.float64)
    c = ring[:-1]
    # orient CCW so "inside" is left of each edge
    if geo._ring_area(ring) < 0:
        c = c[::-1]

    def clip_against(poly: np.ndarray, e0, e1) -> np.ndarray:
        if len(poly) == 0:
            return poly
        p = poly[:-1] if (poly[0] == poly[-1]).all() else poly
        out = []
        n = len(p)
        for i in range(n):
            cur, nxt = p[i], p[(i + 1) % n]
            cin = geo._orient(e0[0], e0[1], e1[0], e1[1], cur[0], cur[1]) >= 0
            nin = geo._orient(e0[0], e0[1], e1[0], e1[1], nxt[0], nxt[1]) >= 0
            if cin:
                out.append(cur)
            if cin != nin:
                d = nxt - cur
                e = e1 - e0
                denom = d[0] * e[1] - d[1] * e[0]
                if denom != 0:
                    t = ((e0[0] - cur[0]) * e[1] - (e0[1] - cur[1]) * e[0]) / denom
                    out.append(cur + t * d)
        if len(out) < 3:
            return np.empty((0, 2))
        return np.asarray(out)

    poly = np.asarray(subject.shell, dtype=np.float64)
    for i in range(len(c)):
        poly = clip_against(poly, c[i], c[(i + 1) % len(c)])
        if len(poly) == 0:
            return None
    shell = np.concatenate([poly, poly[:1]])
    holes = []
    for h in subject.holes:
        hh = np.asarray(h, dtype=np.float64)
        for i in range(len(c)):
            hh = clip_against(hh, c[i], c[(i + 1) % len(c)])
            if len(hh) == 0:
                break
        if len(hh) >= 3:
            holes.append(np.concatenate([hh, hh[:1]]))
    return geo.Polygon(shell, holes)


@_register
def st_difference(a: geo.Geometry, b: geo.Geometry) -> geo.Geometry:
    if isinstance(a, geo.Point):
        return a if not geo.intersects(a, b) else geo.MultiPoint([])
    if isinstance(a, geo.MultiPoint):
        keep = [p for p in a.parts if not geo.intersects(p, b)]
        return keep[0] if len(keep) == 1 else geo.MultiPoint(keep)
    if isinstance(a, geo.LineString) and isinstance(b, (geo.Polygon, geo.MultiPolygon)):
        return _runs_to_geom(_line_polygon_pieces(a, b, keep_inside=False))
    if isinstance(a, (geo.Polygon, geo.MultiPolygon)) and not geo.intersects(a, b):
        return a
    raise ValueError(
        "st_difference supports point/line left operands (or disjoint "
        f"polygons); got {a.geom_type} - {b.geom_type}"
    )
