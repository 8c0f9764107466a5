"""Geometry model: host objects, WKT codec and vectorized predicate math.

The port's copy of the parts of geomesa_tpu/geometry.py that features,
ECQL parsing, filter extraction and host refinement of point schemas
read: the geometry objects, the WKT codec, the exact predicates
(even-odd ray casting, orientation tests) and the raster cell classifier
of polygon queries. The packed extent column and WKB stay in the JAX
package until the port takes extent schemas.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

# geometry type codes
POINT = 1
LINESTRING = 2
POLYGON = 3
MULTIPOINT = 4
MULTILINESTRING = 5
MULTIPOLYGON = 6

TYPE_NAMES = {
    POINT: "Point",
    LINESTRING: "LineString",
    POLYGON: "Polygon",
    MULTIPOINT: "MultiPoint",
    MULTILINESTRING: "MultiLineString",
    MULTIPOLYGON: "MultiPolygon",
}
TYPE_CODES = {v.upper(): k for k, v in TYPE_NAMES.items()}


# ---------------------------------------------------------------------------
# host geometry objects
# ---------------------------------------------------------------------------


class Geometry:
    """Base host geometry. Subclasses hold numpy coordinate arrays."""

    type_code: int

    @property
    def geom_type(self) -> str:
        return TYPE_NAMES[self.type_code]

    def bounds(self) -> tuple[float, float, float, float]:
        raise NotImplementedError

    @property
    def wkt(self) -> str:
        return to_wkt(self)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return self.wkt if self._coord_count() <= 12 else f"<{self.geom_type} ({self._coord_count()} pts)>"

    def _coord_count(self) -> int:
        raise NotImplementedError

    def __eq__(self, other) -> bool:
        return isinstance(other, Geometry) and self.wkt == other.wkt

    def __hash__(self) -> int:
        return hash(self.wkt)


def _coords(arr) -> np.ndarray:
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"coordinates must be [n, 2]: got shape {a.shape}")
    return a


class Point(Geometry):
    type_code = POINT

    def __init__(self, x: float, y: float):
        self.x = float(x)
        self.y = float(y)

    def bounds(self):
        return (self.x, self.y, self.x, self.y)

    def _coord_count(self):
        return 1


class LineString(Geometry):
    type_code = LINESTRING

    def __init__(self, coords):
        self.coords = _coords(coords)
        if len(self.coords) < 2:
            raise ValueError("LineString needs >= 2 points")

    def bounds(self):
        return (
            float(self.coords[:, 0].min()),
            float(self.coords[:, 1].min()),
            float(self.coords[:, 0].max()),
            float(self.coords[:, 1].max()),
        )

    def _coord_count(self):
        return len(self.coords)


class Polygon(Geometry):
    """Shell + holes, each a closed ring (first point == last point; the
    constructor closes unclosed rings)."""

    type_code = POLYGON

    def __init__(self, shell, holes: Sequence | None = None):
        self.shell = _close_ring(_coords(shell))
        self.holes = [_close_ring(_coords(h)) for h in (holes or [])]

    def bounds(self):
        return (
            float(self.shell[:, 0].min()),
            float(self.shell[:, 1].min()),
            float(self.shell[:, 0].max()),
            float(self.shell[:, 1].max()),
        )

    def _coord_count(self):
        return len(self.shell) + sum(len(h) for h in self.holes)


class _Multi(Geometry):
    part_type: type

    def __init__(self, parts: Iterable):
        self.parts = list(parts)
        for p in self.parts:
            if not isinstance(p, self.part_type):
                raise ValueError(f"{self.geom_type} parts must be {self.part_type.__name__}")

    def bounds(self):
        bs = np.array([p.bounds() for p in self.parts])
        return (
            float(bs[:, 0].min()),
            float(bs[:, 1].min()),
            float(bs[:, 2].max()),
            float(bs[:, 3].max()),
        )

    def _coord_count(self):
        return sum(p._coord_count() for p in self.parts)


class MultiPoint(_Multi):
    type_code = MULTIPOINT
    part_type = Point


class MultiLineString(_Multi):
    type_code = MULTILINESTRING
    part_type = LineString


class MultiPolygon(_Multi):
    type_code = MULTIPOLYGON
    part_type = Polygon


def _close_ring(ring: np.ndarray) -> np.ndarray:
    if len(ring) < 3:
        raise ValueError("ring needs >= 3 points")
    if not np.array_equal(ring[0], ring[-1]):
        ring = np.vstack([ring, ring[:1]])
    return ring


def box(xmin: float, ymin: float, xmax: float, ymax: float) -> Polygon:
    """Axis-aligned box polygon (the BBOX query literal)."""
    return Polygon(
        [(xmin, ymin), (xmax, ymin), (xmax, ymax), (xmin, ymax), (xmin, ymin)]
    )


# ---------------------------------------------------------------------------
# WKT codec
# ---------------------------------------------------------------------------


def _fmt_coord(c) -> str:
    def num(v: float) -> str:
        s = f"{v:.10f}".rstrip("0").rstrip(".")
        return s if s not in ("-0", "") else "0"

    return f"{num(c[0])} {num(c[1])}"


def _fmt_ring(ring: np.ndarray) -> str:
    return "(" + ", ".join(_fmt_coord(c) for c in ring) + ")"


def to_wkt(g: Geometry) -> str:
    """Serialize to WKT. Mirrors JTS WKTWriter output shape."""
    if isinstance(g, Point):
        return f"POINT ({_fmt_coord((g.x, g.y))})"
    if isinstance(g, LineString):
        return f"LINESTRING {_fmt_ring(g.coords)}"
    if isinstance(g, Polygon):
        rings = ", ".join(_fmt_ring(r) for r in [g.shell] + g.holes)
        return f"POLYGON ({rings})"
    if isinstance(g, MultiPoint):
        return "MULTIPOINT (" + ", ".join(f"({_fmt_coord((p.x, p.y))})" for p in g.parts) + ")"
    if isinstance(g, MultiLineString):
        return "MULTILINESTRING (" + ", ".join(_fmt_ring(p.coords) for p in g.parts) + ")"
    if isinstance(g, MultiPolygon):
        polys = ", ".join(
            "(" + ", ".join(_fmt_ring(r) for r in [p.shell] + p.holes) + ")" for p in g.parts
        )
        return f"MULTIPOLYGON ({polys})"
    raise ValueError(f"cannot serialize {type(g)}")


class _WktParser:
    """Recursive-descent WKT parser (POINT/LINESTRING/POLYGON/MULTI*)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def _expect(self, ch: str):
        self._skip_ws()
        if self.pos >= len(self.text) or self.text[self.pos] != ch:
            raise ValueError(f"expected {ch!r} at {self.pos} in {self.text!r}")
        self.pos += 1

    def _peek(self) -> str:
        self._skip_ws()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _word(self) -> str:
        self._skip_ws()
        start = self.pos
        while self.pos < len(self.text) and (self.text[self.pos].isalpha()):
            self.pos += 1
        return self.text[start : self.pos].upper()

    def _number(self) -> float:
        self._skip_ws()
        start = self.pos
        while self.pos < len(self.text) and self.text[self.pos] not in " ,()\t\n":
            self.pos += 1
        return float(self.text[start : self.pos])

    def _coord(self) -> tuple[float, float]:
        x = self._number()
        y = self._number()
        return (x, y)

    def _coord_list(self) -> np.ndarray:
        self._expect("(")
        out = [self._coord()]
        while self._peek() == ",":
            self._expect(",")
            out.append(self._coord())
        self._expect(")")
        return np.array(out, dtype=np.float64)

    def _ring_list(self) -> list[np.ndarray]:
        self._expect("(")
        rings = [self._coord_list()]
        while self._peek() == ",":
            self._expect(",")
            rings.append(self._coord_list())
        self._expect(")")
        return rings

    def parse(self) -> Geometry:
        word = self._word()
        if word not in TYPE_CODES:
            raise ValueError(f"unknown WKT type {word!r}")
        nxt = self._word()
        if nxt == "EMPTY":
            raise ValueError(f"EMPTY {word} not supported")
        if nxt:
            raise ValueError(f"unexpected token {nxt!r}")
        if word == "POINT":
            self._expect("(")
            x, y = self._coord()
            self._expect(")")
            return Point(x, y)
        if word == "LINESTRING":
            return LineString(self._coord_list())
        if word == "POLYGON":
            rings = self._ring_list()
            return Polygon(rings[0], rings[1:])
        if word == "MULTIPOINT":
            self._expect("(")
            pts = []
            while True:
                if self._peek() == "(":
                    self._expect("(")
                    pts.append(Point(*self._coord()))
                    self._expect(")")
                else:
                    pts.append(Point(*self._coord()))
                if self._peek() == ",":
                    self._expect(",")
                else:
                    break
            self._expect(")")
            return MultiPoint(pts)
        if word == "MULTILINESTRING":
            return MultiLineString([LineString(c) for c in self._ring_list()])
        # MULTIPOLYGON
        self._expect("(")
        polys = []
        while True:
            rings = self._ring_list()
            polys.append(Polygon(rings[0], rings[1:]))
            if self._peek() == ",":
                self._expect(",")
            else:
                break
        self._expect(")")
        return MultiPolygon(polys)


def from_wkt(text: str) -> Geometry:
    p = _WktParser(text.strip())
    g = p.parse()
    p._skip_ws()
    if p.pos != len(p.text):
        raise ValueError(f"trailing content in WKT: {p.text[p.pos:]!r}")
    return g



# ---------------------------------------------------------------------------
# predicate math (vectorized numpy)
# ---------------------------------------------------------------------------


def bbox_intersects(a, b) -> np.ndarray:
    """Axis-aligned box overlap; a, b = (xmin, ymin, xmax, ymax) arrays."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return (
        (a[..., 0] <= b[..., 2])
        & (a[..., 2] >= b[..., 0])
        & (a[..., 1] <= b[..., 3])
        & (a[..., 3] >= b[..., 1])
    )


def points_in_ring(px, py, ring: np.ndarray) -> np.ndarray:
    """Even-odd ray-cast crossing parity of points against one ring.

    Vectorized over points. Standard construction: for each edge (x1,y1) ->
    (x2,y2), a rightward horizontal ray from (px, py) crosses it iff the edge
    spans py half-open in y and the intersection x exceeds px.
    """
    px = np.asarray(px, dtype=np.float64)
    py = np.asarray(py, dtype=np.float64)
    x1, y1 = ring[:-1, 0], ring[:-1, 1]
    x2, y2 = ring[1:, 0], ring[1:, 1]
    # [n_points, n_edges]
    pyc = py[..., None]
    pxc = px[..., None]
    spans = (y1 <= pyc) != (y2 <= pyc)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (pyc - y1) / np.where(y2 == y1, np.inf, y2 - y1)
        xi = x1 + t * (x2 - x1)
    crossings = spans & (xi > pxc)
    return crossings.sum(axis=-1) % 2 == 1


_PIP_CHUNK = 65536


def points_in_polygon(px, py, poly: "Polygon | MultiPolygon") -> np.ndarray:
    """Point-in-polygon with holes via even-odd parity over all rings.

    Large 1-D batches go through in chunks of _PIP_CHUNK points, so the
    [n_points, n_edges] crossing matrix stays bounded (the JAX package's
    C++ ray cast, with the identical crossing construction, is not carried
    over)."""
    px = np.asarray(px, dtype=np.float64)
    py = np.asarray(py, dtype=np.float64)
    if px.ndim == 1 and px.shape == py.shape and len(px) > _PIP_CHUNK:
        return np.concatenate([
            points_in_polygon(px[s : s + _PIP_CHUNK], py[s : s + _PIP_CHUNK], poly)
            for s in range(0, len(px), _PIP_CHUNK)
        ])
    if isinstance(poly, MultiPolygon):
        out = np.zeros(np.broadcast(px, py).shape, dtype=bool)
        for p in poly.parts:
            out |= points_in_polygon(px, py, p)
        return out
    parity = points_in_ring(px, py, poly.shell)
    for h in poly.holes:
        parity ^= points_in_ring(px, py, h)
    return parity

def _orient(ax, ay, bx, by, cx, cy):
    """Sign of the cross product (b - a) x (c - a): +1 CCW, -1 CW, 0 collinear."""
    return np.sign((bx - ax) * (cy - ay) - (by - ay) * (cx - ax))


def segments_intersect(a1, a2, b1, b2) -> np.ndarray:
    """Proper-or-touching segment intersection test, vectorized.

    a1/a2/b1/b2: [..., 2] arrays. Standard orientation construction
    including the collinear-overlap cases.
    """
    a1 = np.asarray(a1, dtype=np.float64)
    a2 = np.asarray(a2, dtype=np.float64)
    b1 = np.asarray(b1, dtype=np.float64)
    b2 = np.asarray(b2, dtype=np.float64)
    d1 = _orient(b1[..., 0], b1[..., 1], b2[..., 0], b2[..., 1], a1[..., 0], a1[..., 1])
    d2 = _orient(b1[..., 0], b1[..., 1], b2[..., 0], b2[..., 1], a2[..., 0], a2[..., 1])
    d3 = _orient(a1[..., 0], a1[..., 1], a2[..., 0], a2[..., 1], b1[..., 0], b1[..., 1])
    d4 = _orient(a1[..., 0], a1[..., 1], a2[..., 0], a2[..., 1], b2[..., 0], b2[..., 1])
    proper = (d1 * d2 < 0) & (d3 * d4 < 0)

    def on_seg(px, py, qx, qy, rx, ry):
        """r collinear with p-q and within its bbox."""
        return (
            (np.minimum(px, qx) <= rx)
            & (rx <= np.maximum(px, qx))
            & (np.minimum(py, qy) <= ry)
            & (ry <= np.maximum(py, qy))
        )

    touch = (
        ((d1 == 0) & on_seg(b1[..., 0], b1[..., 1], b2[..., 0], b2[..., 1], a1[..., 0], a1[..., 1]))
        | ((d2 == 0) & on_seg(b1[..., 0], b1[..., 1], b2[..., 0], b2[..., 1], a2[..., 0], a2[..., 1]))
        | ((d3 == 0) & on_seg(a1[..., 0], a1[..., 1], a2[..., 0], a2[..., 1], b1[..., 0], b1[..., 1]))
        | ((d4 == 0) & on_seg(a1[..., 0], a1[..., 1], a2[..., 0], a2[..., 1], b2[..., 0], b2[..., 1]))
    )
    return proper | touch


def _ring_edges(ring: np.ndarray):
    return ring[:-1], ring[1:]


def _rings_of(geom: Geometry) -> list[np.ndarray]:
    if isinstance(geom, Polygon):
        return [geom.shell] + geom.holes
    if isinstance(geom, LineString):
        return [geom.coords]
    if isinstance(geom, (MultiPolygon, MultiLineString)):
        out = []
        for p in geom.parts:
            out += _rings_of(p)
        return out
    raise ValueError(f"no rings: {type(geom)}")


def _any_edge_intersection(ga: Geometry, gb: Geometry) -> bool:
    for ra in _rings_of(ga):
        a1, a2 = _ring_edges(ra)
        for rb in _rings_of(gb):
            b1, b2 = _ring_edges(rb)
            # [na, nb] cross test
            hit = segments_intersect(
                a1[:, None, :], a2[:, None, :], b1[None, :, :], b2[None, :, :]
            )
            if hit.any():
                return True
    return False


def _first_point(g: Geometry) -> tuple[float, float]:
    if isinstance(g, Point):
        return g.x, g.y
    if isinstance(g, LineString):
        return float(g.coords[0, 0]), float(g.coords[0, 1])
    if isinstance(g, Polygon):
        return float(g.shell[0, 0]), float(g.shell[0, 1])
    return _first_point(g.parts[0])


def intersects(a: Geometry, b: Geometry) -> bool:
    """Exact geometry intersection (the host twin of the device refine).

    Construction: bbox reject, then point-containment either way, then any
    edge-pair intersection. Matches JTS `intersects` semantics (boundaries
    touching counts) for the supported types.
    """
    if not bool(bbox_intersects(np.array(a.bounds()), np.array(b.bounds()))):
        return False
    for g1, g2 in ((a, b), (b, a)):
        if isinstance(g1, Point):
            return _geom_covers_point(g2, g1.x, g1.y)
        if isinstance(g1, MultiPoint):
            return any(_geom_covers_point(g2, p.x, p.y) for p in g1.parts)
    # both have extent: containment either way, else edge intersection
    ax, ay = _first_point(a)
    bx, by = _first_point(b)
    if isinstance(b, (Polygon, MultiPolygon)) and bool(points_in_polygon(ax, ay, b)):
        return True
    if isinstance(a, (Polygon, MultiPolygon)) and bool(points_in_polygon(bx, by, a)):
        return True
    return _any_edge_intersection(a, b)


def _geom_covers_point(g: Geometry, x: float, y: float) -> bool:
    if isinstance(g, Point):
        return g.x == x and g.y == y
    if isinstance(g, MultiPoint):
        return any(p.x == x and p.y == y for p in g.parts)
    if isinstance(g, (Polygon, MultiPolygon)):
        if bool(points_in_polygon(x, y, g)):
            return True
        # boundary counts as intersecting
        return _point_on_rings(g, x, y)
    if isinstance(g, (LineString, MultiLineString)):
        return _point_on_rings(g, x, y)
    raise ValueError(type(g))


def points_on_boundary(px, py, g: Geometry) -> np.ndarray:
    """Vectorized-over-points sibling of ``_point_on_rings``: which (px,
    py) lie exactly on a ring edge of ``g`` (same _orient collinearity +
    edge-bbox test, looped over the few edges instead of the many
    points)."""
    px = np.asarray(px, dtype=np.float64)
    py = np.asarray(py, dtype=np.float64)
    out = np.zeros(len(px), dtype=bool)
    for ring in _rings_of(g):
        p1, p2 = _ring_edges(ring)
        for (x1, y1), (x2, y2) in zip(p1.tolist(), p2.tolist()):
            d = _orient(x1, y1, x2, y2, px, py)
            out |= (
                (d == 0)
                & (min(x1, x2) <= px) & (px <= max(x1, x2))
                & (min(y1, y2) <= py) & (py <= max(y1, y2))
            )
    return out


def _point_on_rings(g: Geometry, x: float, y: float) -> bool:
    for ring in _rings_of(g):
        p1, p2 = _ring_edges(ring)
        d = _orient(p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1], x, y)
        on = (
            (d == 0)
            & (np.minimum(p1[:, 0], p2[:, 0]) <= x)
            & (x <= np.maximum(p1[:, 0], p2[:, 0]))
            & (np.minimum(p1[:, 1], p2[:, 1]) <= y)
            & (y <= np.maximum(p1[:, 1], p2[:, 1]))
        )
        if on.any():
            return True
    return False


def _point_segments_distance(x, y, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Distance from (x, y) to each segment p1[i] -> p2[i]."""
    d = p2 - p1
    len2 = (d**2).sum(axis=1)
    ap = np.stack([x - p1[:, 0], y - p1[:, 1]], axis=1)
    t = np.clip((ap * d).sum(axis=1) / np.where(len2 == 0, 1, len2), 0.0, 1.0)
    proj = p1 + t[:, None] * d
    return np.hypot(x - proj[:, 0], y - proj[:, 1])


def _point_geom_distance(x: float, y: float, g: Geometry) -> float:
    if isinstance(g, Point):
        return float(np.hypot(x - g.x, y - g.y))
    if isinstance(g, MultiPoint):
        return min(float(np.hypot(x - p.x, y - p.y)) for p in g.parts)
    if isinstance(g, (Polygon, MultiPolygon)) and bool(points_in_polygon(x, y, g)):
        return 0.0
    best = np.inf
    for ring in _rings_of(g):
        p1, p2 = _ring_edges(ring)
        best = min(best, float(_point_segments_distance(x, y, p1, p2).min()))
    return best


# ---------------------------------------------------------------------------
# raster cell classification (the Raster Intervals core, arXiv 2307.01716)
# ---------------------------------------------------------------------------

RASTER_OUT = 0
RASTER_PARTIAL = 1
RASTER_FULL = 2


def classify_raster_cells(
    geom: "Polygon | MultiPolygon",
    x_edges: np.ndarray,
    y_edges: np.ndarray,
    margin: float = 0.0,
) -> np.ndarray:
    """int8 [ny, nx] cell classes of ``geom`` over an axis-aligned grid:
    cell (j, i) spans [x_edges[i], x_edges[i+1]] x [y_edges[j], y_edges[j+1]].

    Conservative: a cell is RASTER_FULL only when the cell rectangle
    expanded by ``margin`` lies entirely inside the polygon, RASTER_OUT
    only when the expanded rectangle misses it, RASTER_PARTIAL otherwise.
    Every ring edge is rasterized with a margin-expanded column sweep (the
    cells its clipped y-span touches become PARTIAL, a superset of the
    boundary cells); every other cell avoids the boundary, so its center's
    even-odd parity classifies the whole cell.
    """
    nx, ny = len(x_edges) - 1, len(y_edges) - 1
    part = np.zeros((ny, nx), dtype=bool)
    for ring in _rings_of(geom):
        p1, p2 = _ring_edges(ring)
        for (x1, y1), (x2, y2) in zip(p1.tolist(), p2.tolist()):
            lo_x, hi_x = min(x1, x2) - margin, max(x1, x2) + margin
            if hi_x < x_edges[0] or lo_x > x_edges[-1]:
                continue
            c0 = max(int(np.searchsorted(x_edges, lo_x, side="right")) - 1, 0)
            c1 = min(int(np.searchsorted(x_edges, hi_x, side="right")) - 1, nx - 1)
            cols = np.arange(c0, c1 + 1)
            sl_lo = x_edges[cols] - margin
            sl_hi = x_edges[cols + 1] + margin
            dx, dy = x2 - x1, y2 - y1
            if dx == 0.0:
                y_a = np.full(len(cols), min(y1, y2))
                y_b = np.full(len(cols), max(y1, y2))
            else:
                ta = np.clip((sl_lo - x1) / dx, 0.0, 1.0)
                tb = np.clip((sl_hi - x1) / dx, 0.0, 1.0)
                y_a = y1 + np.minimum(ta, tb) * dy
                y_b = y1 + np.maximum(ta, tb) * dy
                if dy < 0:
                    y_a, y_b = y_b, y_a
            r0 = np.clip(
                np.searchsorted(y_edges, y_a - margin, side="right") - 1, 0, ny - 1
            )
            r1 = np.clip(
                np.searchsorted(y_edges, y_b + margin, side="right") - 1, 0, ny - 1
            )
            for i, a, b in zip(cols.tolist(), r0.tolist(), r1.tolist()):
                part[a : b + 1, i] = True
    cls = np.zeros((ny, nx), dtype=np.int8)
    cls[part] = RASTER_PARTIAL
    jj, ii = np.nonzero(~part)
    if len(jj):
        cxs = 0.5 * (x_edges[ii] + x_edges[ii + 1])
        cys = 0.5 * (y_edges[jj] + y_edges[jj + 1])
        inside = points_in_polygon(cxs, cys, geom)
        cls[jj[inside], ii[inside]] = RASTER_FULL
    return cls
