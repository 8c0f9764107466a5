"""Geometry model: host objects, WKT codec, packed columnar storage and
vectorized predicate math.

The port's copy of the parts of geomesa_tpu/geometry.py that features,
ECQL parsing, filter extraction and host refinement read: the geometry
objects with their planar length and area, the WKT and WKB codecs, the
packed extent column of non-point schemas (flat coordinates + nested
offsets, per-geometry f32 bboxes that become the XZ indexes' device
columns), the exact predicates (even-odd ray casting, orientation tests,
intersects / contains / distance) and the raster cell classifier of
polygon queries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from geomesa_tpu_torch import native

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

    @property
    def length(self) -> float:
        d = np.diff(self.coords, axis=0)
        return float(np.sqrt((d**2).sum(axis=1)).sum())


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

    @property
    def area(self) -> float:
        a = _ring_area(self.shell)
        return abs(a) - sum(abs(_ring_area(h)) for h in self.holes)


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


def _ring_area(ring: np.ndarray) -> float:
    x, y = ring[:, 0], ring[:, 1]
    return float(0.5 * np.sum(x[:-1] * y[1:] - x[1:] * y[:-1]))


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
# WKB codec (little-endian, 2-D): the write-ahead log's geometry encoding
# (geomesa_tpu/geometry.py:371-447, reference WkbSerialization)
# ---------------------------------------------------------------------------


def to_wkb(g: Geometry) -> bytes:
    import struct

    def header(code: int) -> bytes:
        return struct.pack("<BI", 1, code)

    def pts(a: np.ndarray) -> bytes:
        return struct.pack("<I", len(a)) + a.astype("<f8").tobytes()

    if isinstance(g, Point):
        return header(POINT) + struct.pack("<dd", g.x, g.y)
    if isinstance(g, LineString):
        return header(LINESTRING) + pts(g.coords)
    if isinstance(g, Polygon):
        rings = [g.shell] + g.holes
        return header(POLYGON) + struct.pack("<I", len(rings)) + b"".join(pts(r) for r in rings)
    if isinstance(g, (MultiPoint, MultiLineString, MultiPolygon)):
        return (
            header(g.type_code)
            + np.uint32(len(g.parts)).tobytes()
            + b"".join(to_wkb(p) for p in g.parts)
        )
    raise ValueError(f"cannot serialize {type(g)}")


def from_wkb(data: bytes) -> Geometry:
    g, _ = _read_wkb(memoryview(data), 0)
    return g


def _read_wkb(buf: memoryview, pos: int) -> tuple[Geometry, int]:
    import struct

    byte_order = buf[pos]
    endian = "<" if byte_order == 1 else ">"
    (code,) = struct.unpack_from(endian + "I", buf, pos + 1)
    pos += 5
    if code & 0x20000000:  # EWKB SRID flag: skip the 4-byte SRID payload
        pos += 4
    if code & 0xC0000000:  # EWKB Z/M flags: 3-/4-D coords unsupported
        raise ValueError(f"unsupported WKB dimension flags in type 0x{code:x}")
    code &= 0x1FFFFFFF
    if code > MULTIPOLYGON:  # ISO WKB Z/M variants (1001, 2001, ...) too
        raise ValueError(f"unsupported WKB geometry type {code}")

    def read_pts(pos: int) -> tuple[np.ndarray, int]:
        (n,) = struct.unpack_from(endian + "I", buf, pos)
        pos += 4
        a = np.frombuffer(buf, dtype=endian + "f8", count=2 * n, offset=pos).reshape(n, 2)
        return a.copy(), pos + 16 * n

    if code == POINT:
        x, y = struct.unpack_from(endian + "dd", buf, pos)
        return Point(x, y), pos + 16
    if code == LINESTRING:
        a, pos = read_pts(pos)
        return LineString(a), pos
    if code == POLYGON:
        (nrings,) = struct.unpack_from(endian + "I", buf, pos)
        pos += 4
        rings = []
        for _ in range(nrings):
            r, pos = read_pts(pos)
            rings.append(r)
        return Polygon(rings[0], rings[1:]), pos
    if code in (MULTIPOINT, MULTILINESTRING, MULTIPOLYGON):
        (nparts,) = struct.unpack_from(endian + "I", buf, pos)
        pos += 4
        parts = []
        for _ in range(nparts):
            p, pos = _read_wkb(buf, pos)
            parts.append(p)
        cls = {MULTIPOINT: MultiPoint, MULTILINESTRING: MultiLineString, MULTIPOLYGON: MultiPolygon}
        return cls[code](parts), pos
    raise ValueError(f"unsupported WKB type {code}")

def is_rectangle(g: "Geometry") -> bool:
    """True when ``g`` is a plain axis-aligned rectangle polygon (its
    geometry IS its bbox): bbox algebra then answers spatial predicates
    against it exactly. Every edge must be axis-aligned (a closed 5-point
    "bowtie" has 2 distinct xs/ys but diagonal edges — not a rectangle)."""
    if not isinstance(g, Polygon) or g.holes:
        return False
    ring = g.shell
    if len(ring) != 5 or not np.array_equal(ring[0], ring[4]):
        return False
    xs = set(ring[:, 0].tolist())
    ys = set(ring[:, 1].tolist())
    if len(xs) != 2 or len(ys) != 2:
        return False
    dx = ring[1:, 0] != ring[:-1, 0]
    dy = ring[1:, 1] != ring[:-1, 1]
    return bool(np.all(dx ^ dy))  # each edge moves in exactly one axis


# ---------------------------------------------------------------------------
# packed columnar geometry pool (the device-facing storage layout)
# ---------------------------------------------------------------------------


def _gather_rows(src: np.ndarray, flat: np.ndarray) -> np.ndarray:
    """out[i] = src[flat[i]] through the threaded native row gather
    (``native.take_rows``) when the pull is big enough to matter and the
    indices fit u32; numpy indexing otherwise."""
    if len(flat) > (1 << 16) and int(flat.min()) >= 0 and int(flat.max()) < (1 << 32):
        out = native.take_rows(src, flat)
        if out is not None:
            return out
    return src[flat]


@dataclass
class PackedGeometryColumn:
    """Arrow-style nested-list layout for a column of geometries.

    - ``coords``            f64 [total_points, 2] — every vertex
    - ``ring_offsets``      i32 [nrings + 1]  — ring r = coords[ro[r]:ro[r+1]]
    - ``part_ring_offsets`` i32 [nparts + 1]  — part p owns rings pro[p]..pro[p+1]
      (a polygon part's first ring is its shell, the rest are holes)
    - ``geom_part_offsets`` i32 [n + 1]       — geometry i owns parts gpo[i]..gpo[i+1]
    - ``types``             i8  [n]           — geometry type codes
    - ``bboxes``            f32 [n, 4]        — (xmin, ymin, xmax, ymax), widened one
      f32 ulp outward so the device prefilter never excludes a true hit

    ``bboxes`` ships to the device as the four extent columns of the XZ
    indexes' bbox-intersects leg; exact refinement decodes through the
    offsets on the host.
    """

    coords: np.ndarray
    ring_offsets: np.ndarray
    part_ring_offsets: np.ndarray
    geom_part_offsets: np.ndarray
    types: np.ndarray
    bboxes: np.ndarray

    def __len__(self) -> int:
        return len(self.types)

    @staticmethod
    def from_geometries(geoms: Sequence[Geometry]) -> "PackedGeometryColumn":
        coords: list[np.ndarray] = []
        ring_offsets = [0]
        part_ring_offsets = [0]
        geom_part_offsets = [0]
        types = []
        bboxes = []
        total = 0

        def add_ring(ring: np.ndarray):
            nonlocal total
            coords.append(ring)
            total += len(ring)
            ring_offsets.append(total)

        def add_part(rings: list[np.ndarray]):
            for r in rings:
                add_ring(r)
            part_ring_offsets.append(part_ring_offsets[-1] + len(rings))

        for g in geoms:
            types.append(g.type_code)
            bboxes.append(g.bounds())
            if isinstance(g, Point):
                add_part([np.array([[g.x, g.y]])])
            elif isinstance(g, LineString):
                add_part([g.coords])
            elif isinstance(g, Polygon):
                add_part([g.shell] + g.holes)
            elif isinstance(g, (MultiPoint, MultiLineString, MultiPolygon)):
                for p in g.parts:
                    if isinstance(p, Point):
                        add_part([np.array([[p.x, p.y]])])
                    elif isinstance(p, LineString):
                        add_part([p.coords])
                    else:
                        add_part([p.shell] + p.holes)
            else:
                raise ValueError(f"cannot pack {type(g)}")
            geom_part_offsets.append(len(part_ring_offsets) - 1)

        b = np.array(bboxes, dtype=np.float64).reshape(len(types), 4)
        lo = np.nextafter(b[:, :2].astype(np.float32), -np.inf)
        hi = np.nextafter(b[:, 2:].astype(np.float32), np.inf)
        return PackedGeometryColumn(
            coords=np.concatenate(coords, axis=0) if coords else np.zeros((0, 2)),
            ring_offsets=np.array(ring_offsets, dtype=np.int32),
            part_ring_offsets=np.array(part_ring_offsets, dtype=np.int32),
            geom_part_offsets=np.array(geom_part_offsets, dtype=np.int32),
            types=np.array(types, dtype=np.int8),
            bboxes=np.concatenate([lo, hi], axis=1).astype(np.float32),
        )

    @staticmethod
    def from_boxes(xmin, ymin, xmax, ymax) -> "PackedGeometryColumn":
        """Vectorized bulk constructor for n axis-aligned rectangle
        polygons (building-footprint-style ingest): 5 CCW vertices each,
        built with numpy broadcasting — no per-row Geometry objects."""
        xmin = np.asarray(xmin, dtype=np.float64)
        ymin = np.asarray(ymin, dtype=np.float64)
        xmax = np.asarray(xmax, dtype=np.float64)
        ymax = np.asarray(ymax, dtype=np.float64)
        n = len(xmin)
        coords = np.empty((n, 5, 2), dtype=np.float64)
        coords[:, 0, 0] = xmin; coords[:, 0, 1] = ymin
        coords[:, 1, 0] = xmax; coords[:, 1, 1] = ymin
        coords[:, 2, 0] = xmax; coords[:, 2, 1] = ymax
        coords[:, 3, 0] = xmin; coords[:, 3, 1] = ymax
        coords[:, 4, 0] = xmin; coords[:, 4, 1] = ymin
        b = np.stack([xmin, ymin, xmax, ymax], axis=1)
        lo = np.nextafter(b[:, :2].astype(np.float32), -np.inf)
        hi = np.nextafter(b[:, 2:].astype(np.float32), np.inf)
        idx = np.arange(n + 1, dtype=np.int32)
        col = PackedGeometryColumn(
            coords=coords.reshape(-1, 2),
            ring_offsets=idx * 5,
            part_ring_offsets=idx,
            geom_part_offsets=idx,
            types=np.full(n, POLYGON, dtype=np.int8),
            bboxes=np.concatenate([lo, hi], axis=1).astype(np.float32),
        )
        # every row is a rectangle by construction: seed the box_info
        # cache (exact f64 bounds) so queries never pay the O(n) lazy
        # rectangle detection on this column or its take() descendants,
        # and mark the uniform 5-vertex layout so take() can use one
        # width-10 row gather instead of nested offset expansion
        col._box_info = (np.ones(n, dtype=bool), b.copy())
        col._uniform_rect = True
        return col

    def box_info(self) -> tuple[np.ndarray, np.ndarray]:
        """(mask [n] bool, bounds [n, 4] f64): which geometries are plain
        axis-aligned rectangles (their geometry IS their bbox) and their
        exact f64 bounds. For those rows, bbox algebra answers spatial
        predicates exactly — the vectorized fast tier that keeps per-row
        Python refinement off box-shaped features (footprints, tiles,
        gridded extents). Computed once per column and cached."""
        cached = getattr(self, "_box_info", None)
        if cached is not None:
            return cached
        n = len(self)
        bounds = np.full((n, 4), np.nan)
        mask = self.types == POLYGON
        # every geometry owns >= 1 part and every part >= 1 ring, so the
        # first-part / first-ring lookups below are always in range
        mask &= np.diff(self.geom_part_offsets) == 1
        first_part = self.geom_part_offsets[:-1].astype(np.int64)
        mask &= np.diff(self.part_ring_offsets)[first_part] == 1
        first_ring = self.part_ring_offsets[first_part].astype(np.int64)
        mask &= np.diff(self.ring_offsets)[first_ring] == 5
        idx = np.flatnonzero(mask)
        if len(idx):
            starts = self.ring_offsets[first_ring[idx]].astype(np.int64)
            pts = self.coords[starts[:, None] + np.arange(5)]  # [k, 5, 2]
            x0 = pts[..., 0].min(axis=1)
            x1 = pts[..., 0].max(axis=1)
            y0 = pts[..., 1].min(axis=1)
            y1 = pts[..., 1].max(axis=1)
            ok = (pts[:, 0] == pts[:, 4]).all(axis=1)  # closed ring
            # every vertex on a corner, and all four corners present
            on_x = (pts[..., 0] == x0[:, None]) | (pts[..., 0] == x1[:, None])
            on_y = (pts[..., 1] == y0[:, None]) | (pts[..., 1] == y1[:, None])
            ok &= (on_x & on_y).all(axis=1)
            # every edge axis-aligned (excludes corner-ordered "bowties",
            # whose diagonal edges make the interior smaller than the bbox)
            dx = pts[:, 1:, 0] != pts[:, :-1, 0]
            dy = pts[:, 1:, 1] != pts[:, :-1, 1]
            ok &= (dx ^ dy).all(axis=1)
            for cx, cy in ((x0, y0), (x1, y0), (x1, y1), (x0, y1)):
                ok &= (
                    (pts[..., 0] == cx[:, None]) & (pts[..., 1] == cy[:, None])
                ).any(axis=1)
            mask[idx[~ok]] = False
            keep = idx[ok]
            bounds[keep, 0] = x0[ok]
            bounds[keep, 1] = y0[ok]
            bounds[keep, 2] = x1[ok]
            bounds[keep, 3] = y1[ok]
        self._box_info = (mask, bounds)
        return self._box_info

    # -- unpacking -------------------------------------------------------
    def _ring(self, r: int) -> np.ndarray:
        return self.coords[self.ring_offsets[r] : self.ring_offsets[r + 1]]

    def _part_rings(self, p: int) -> list[np.ndarray]:
        r0, r1 = int(self.part_ring_offsets[p]), int(self.part_ring_offsets[p + 1])
        return [self._ring(r) for r in range(r0, r1)]

    def geometry(self, i: int) -> Geometry:
        code = int(self.types[i])
        p0, p1 = int(self.geom_part_offsets[i]), int(self.geom_part_offsets[i + 1])
        if code == POINT:
            c = self._part_rings(p0)[0]
            return Point(c[0, 0], c[0, 1])
        if code == LINESTRING:
            return LineString(self._part_rings(p0)[0])
        if code == POLYGON:
            rings = self._part_rings(p0)
            return Polygon(rings[0], rings[1:])
        if code == MULTIPOINT:
            return MultiPoint(
                [Point(*self._part_rings(p)[0][0]) for p in range(p0, p1)]
            )
        if code == MULTILINESTRING:
            return MultiLineString(
                [LineString(self._part_rings(p)[0]) for p in range(p0, p1)]
            )
        if code == MULTIPOLYGON:
            polys = []
            for p in range(p0, p1):
                rings = self._part_rings(p)
                polys.append(Polygon(rings[0], rings[1:]))
            return MultiPolygon(polys)
        raise ValueError(f"bad type code {code}")

    def geometries(self) -> list[Geometry]:
        return [self.geometry(i) for i in range(len(self))]

    def take(self, idx: np.ndarray) -> "PackedGeometryColumn":
        """Subset by geometry indices (used when gathering query results).

        Pure array surgery — slices the nested offsets without
        materializing host geometry objects (this runs on every extent
        query's result gather).
        """
        idx = np.asarray(idx, dtype=np.int64)

        if getattr(self, "_uniform_rect", False):
            return self._take_uniform_rect(idx)

        def expand(starts, ends):
            """Concatenate aranges [starts[i], ends[i]) -> flat index list."""
            lens = ends - starts
            if len(lens) == 0 or lens.sum() == 0:
                return np.zeros(0, dtype=np.int64), np.zeros(1, dtype=np.int32)
            flat = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens) + np.arange(lens.sum())
            offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
            return flat, offsets

        p_flat, gpo = expand(
            self.geom_part_offsets[idx].astype(np.int64),
            self.geom_part_offsets[idx + 1].astype(np.int64),
        )
        r_flat, pro = expand(
            self.part_ring_offsets[p_flat].astype(np.int64),
            self.part_ring_offsets[p_flat + 1].astype(np.int64),
        )
        c_flat, ro = expand(
            self.ring_offsets[r_flat].astype(np.int64),
            self.ring_offsets[r_flat + 1].astype(np.int64),
        )

        rows = _gather_rows
        col = PackedGeometryColumn(
            coords=rows(self.coords, c_flat),
            ring_offsets=ro,
            part_ring_offsets=pro,
            geom_part_offsets=gpo,
            types=self.types[idx],
            bboxes=rows(self.bboxes, idx),
        )
        cached = getattr(self, "_box_info", None)
        if cached is not None:  # rectangle classification survives a subset
            col._box_info = (cached[0][idx], rows(cached[1], idx))
        return col

    def _take_uniform_rect(self, idx: np.ndarray) -> "PackedGeometryColumn":
        """take() fast path for from_boxes columns: every geometry is one
        5-vertex ring, so the subset is a single [n, 10] row gather plus
        arange offsets — ~5x fewer latency-bound lookups than the generic
        nested expansion."""
        rows = _gather_rows
        n = len(idx)
        coords10 = rows(np.ascontiguousarray(self.coords).reshape(len(self), 10), idx)
        off = np.arange(n + 1, dtype=np.int32)
        col = PackedGeometryColumn(
            coords=coords10.reshape(-1, 2),
            ring_offsets=off * 5,
            part_ring_offsets=off,
            geom_part_offsets=off,
            types=self.types[idx],
            bboxes=rows(self.bboxes, idx),
        )
        cached = getattr(self, "_box_info", None)
        if cached is not None:
            col._box_info = (cached[0][idx], rows(cached[1], idx))
        col._uniform_rect = True
        return col

    @staticmethod
    def concat(cols: Sequence["PackedGeometryColumn"]) -> "PackedGeometryColumn":
        """Concatenate columns by shifting the nested offset arrays."""
        cols = list(cols)
        if len(cols) == 1:
            return cols[0]

        def stack_offsets(arrays, shifts):
            out = [arrays[0]]
            for a, s in zip(arrays[1:], shifts[1:]):
                out.append(a[1:].astype(np.int64) + s)
            return np.concatenate(out).astype(np.int32)

        coord_shift = np.concatenate([[0], np.cumsum([len(c.coords) for c in cols])])
        ring_shift = np.concatenate(
            [[0], np.cumsum([len(c.ring_offsets) - 1 for c in cols])]
        )
        part_shift = np.concatenate(
            [[0], np.cumsum([len(c.part_ring_offsets) - 1 for c in cols])]
        )
        out = PackedGeometryColumn(
            coords=np.concatenate([c.coords for c in cols], axis=0),
            ring_offsets=stack_offsets([c.ring_offsets for c in cols], coord_shift),
            part_ring_offsets=stack_offsets(
                [c.part_ring_offsets for c in cols], ring_shift
            ),
            geom_part_offsets=stack_offsets(
                [c.geom_part_offsets for c in cols], part_shift
            ),
            types=np.concatenate([c.types for c in cols]),
            bboxes=np.concatenate([c.bboxes for c in cols], axis=0),
        )
        caches = [getattr(c, "_box_info", None) for c in cols]
        if all(c is not None for c in caches):
            out._box_info = (
                np.concatenate([c[0] for c in caches]),
                np.concatenate([c[1] for c in caches], axis=0),
            )
        if all(getattr(c, "_uniform_rect", False) for c in cols):
            out._uniform_rect = True
        return out


def pad_polygon(poly: "Polygon | MultiPolygon", max_verts: int):
    """Pad a (multi)polygon into fixed-shape arrays for device kernels.

    Returns (verts f32 [max_verts, 2], n int32, ring_id int32 [max_verts]):
    all rings (shells and holes, every part) are concatenated; ``ring_id``
    marks which ring each *edge start* vertex belongs to so the device
    ray-cast never counts the closing segment between different rings.
    Even-odd crossing counting makes holes subtract automatically.
    """
    rings: list[np.ndarray] = []
    if isinstance(poly, Polygon):
        rings = [poly.shell] + poly.holes
    else:
        for p in poly.parts:
            rings += [p.shell] + p.holes
    verts = np.concatenate(rings, axis=0)
    if len(verts) > max_verts:
        raise ValueError(f"polygon has {len(verts)} verts > cap {max_verts}")
    ring_id = np.concatenate([np.full(len(r), i) for i, r in enumerate(rings)])
    out_v = np.zeros((max_verts, 2), dtype=np.float32)
    out_r = np.full(max_verts, -1, dtype=np.int32)
    out_v[: len(verts)] = verts.astype(np.float32)
    out_r[: len(verts)] = ring_id
    return out_v, np.int32(len(verts)), out_r


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

    1-D batches of more than 4096 points go through the native threaded
    ray cast (``native.points_in_polygon``, the identical crossing
    construction); under ``native.disabled()`` large batches go through
    numpy in chunks of _PIP_CHUNK points, so the [n_points, n_edges]
    crossing matrix stays bounded."""
    px = np.asarray(px, dtype=np.float64)
    py = np.asarray(py, dtype=np.float64)
    if px.ndim == 1 and px.shape == py.shape and len(px) > 4096:
        parts = poly.parts if isinstance(poly, MultiPolygon) else [poly]
        rings, ring_part = [], []
        for pi, p in enumerate(parts):
            for r in [p.shell, *p.holes]:
                rings.append(np.asarray(r, dtype=np.float64))
                ring_part.append(pi)
        out = native.points_in_polygon(px, py, rings, ring_part)
        if out is not None:
            return out
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


def contains(a: Geometry, b: Geometry) -> bool:
    """Does polygonal `a` contain `b`? (all of b's vertices inside a, no
    boundary crossing, and no hole of `a` lying inside b — the JTS
    `contains` for the cases the query path needs: polygon contains
    point/line/polygon)."""
    if not isinstance(a, (Polygon, MultiPolygon)):
        raise ValueError("contains() requires a polygonal left operand")
    if isinstance(b, Point):
        return bool(points_in_polygon(b.x, b.y, a))
    if isinstance(b, MultiPoint):
        return all(bool(points_in_polygon(p.x, p.y, a)) for p in b.parts)
    verts = np.concatenate(_rings_of(b), axis=0)
    if not bool(points_in_polygon(verts[:, 0], verts[:, 1], a).all()):
        return False
    if _any_edge_intersection(a, b):
        return False
    # a hole of `a` strictly inside b excludes part of b's interior even
    # though no vertex of b touches it and no edges cross
    if isinstance(b, (Polygon, MultiPolygon)):
        holes = (
            a.holes
            if isinstance(a, Polygon)
            else [h for p in a.parts for h in p.holes]
        )
        for h in holes:
            if bool(points_in_polygon(h[:-1, 0], h[:-1, 1], b).any()):
                return False
    return True


def distance(a: Geometry, b: Geometry) -> float:
    """Euclidean (planar degrees) distance between two geometries."""
    if isinstance(a, Point) and isinstance(b, Point):
        return float(np.hypot(a.x - b.x, a.y - b.y))
    if isinstance(a, Point):
        return _point_geom_distance(a.x, a.y, b)
    if isinstance(b, Point):
        return _point_geom_distance(b.x, b.y, a)
    if intersects(a, b):
        return 0.0
    va = np.concatenate(_rings_of(a), axis=0)
    best = np.inf
    for ring in _rings_of(b):
        p1, p2 = _ring_edges(ring)
        for v in va:
            best = min(best, float(_point_segments_distance(v[0], v[1], p1, p2).min()))
    vb = np.concatenate(_rings_of(b), axis=0)
    for ring in _rings_of(a):
        p1, p2 = _ring_edges(ring)
        for v in vb:
            best = min(best, float(_point_segments_distance(v[0], v[1], p1, p2).min()))
    return best


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
