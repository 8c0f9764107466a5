"""S2: Hilbert curve on the quadratically-projected unit cube.

The port's copy of geomesa_tpu/curve/s2.py (reference S2SFC.scala:23-60,
which wraps com.google.common.geometry): 64-bit cell ids laid out as
[3 face bits][2*level Hilbert position bits][1][trailing zeros], leaf
level 30. Host-side numpy in f64 and uint64, like the z-curves: cells on
faces 4 and 5 set bit 63, so keys stay unsigned on every path that moves
them (the native ``sort_bins_z``, numpy searchsorted, persist).

The covering (``ranges``) is a per-face quadtree BFS classified in UV
space: the query lat/lng box maps to one conservative superset UV
rectangle per face, so the cover never misses a true hit; over-coverage
is removed by the host refinement tier like every other curve here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch.curve.zranges import IndexRange

MAX_LEVEL = 30
_FACE_SHIFT = 2 * MAX_LEVEL + 1  # 61

# Hilbert orientation tables (standard S2 layout):
# position-in-parent -> (i, j) sub-cell, per orientation (swap|invert bits)
POS_TO_IJ = np.array(
    [[0, 1, 3, 2], [0, 2, 3, 1], [3, 2, 0, 1], [3, 1, 0, 2]], dtype=np.uint64
)
IJ_TO_POS = np.array(
    [[0, 1, 3, 2], [0, 3, 1, 2], [2, 3, 1, 0], [2, 1, 3, 0]], dtype=np.uint64
)
POS_TO_ORIENTATION = np.array([1, 0, 0, 3], dtype=np.uint64)

_U = np.uint64


# -- projection ----------------------------------------------------------

def _xyz_from_lonlat(lon, lat):
    lam = np.radians(np.asarray(lon, dtype=np.float64))
    phi = np.radians(np.asarray(lat, dtype=np.float64))
    cp = np.cos(phi)
    return cp * np.cos(lam), cp * np.sin(lam), np.sin(phi)


def _face_from_xyz(x, y, z):
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    face = np.where(ax >= ay, np.where(ax >= az, 0, 2), np.where(ay >= az, 1, 2))
    face = face + np.where(
        np.choose(face, [x, y, z]) < 0, 3, 0
    )
    return face.astype(np.int64)


def _uv_from_xyz(face, x, y, z):
    u = np.empty_like(x)
    v = np.empty_like(x)
    # canonical face->(u, v) with the TRUE (possibly negative) denominator
    for f, (ue, ve, de) in enumerate(
        [
            (lambda: y, lambda: z, lambda: x),  # 0: +x  u=y/x   v=z/x
            (lambda: -x, lambda: z, lambda: y),  # 1: +y  u=-x/y  v=z/y
            (lambda: -x, lambda: -y, lambda: z),  # 2: +z  u=-x/z  v=-y/z
            (lambda: z, lambda: y, lambda: x),  # 3: -x  u=z/x   v=y/x
            (lambda: z, lambda: -x, lambda: y),  # 4: -y  u=z/y   v=-x/y
            (lambda: -y, lambda: -x, lambda: z),  # 5: -z  u=-y/z  v=-x/z
        ]
    ):
        m = face == f
        if m.any():
            d = de()[m]
            u[m] = ue()[m] / d
            v[m] = ve()[m] / d
    return u, v


def _st_from_uv(u):
    """Quadratic projection (S2's default ST transform)."""
    s = 0.5 * np.sqrt(1.0 + 3.0 * np.abs(u))
    return np.where(u >= 0, s, 1.0 - s)


def _uv_from_st(s):
    s = np.asarray(s, dtype=np.float64)
    return np.where(
        s >= 0.5, (1.0 / 3.0) * (4.0 * s * s - 1.0), (1.0 / 3.0) * (1.0 - 4.0 * (1.0 - s) ** 2)
    )


def _ij_from_st(s):
    return np.clip((s * (1 << MAX_LEVEL)).astype(np.int64), 0, (1 << MAX_LEVEL) - 1)


# -- cell ids ------------------------------------------------------------

def cell_id_from_lonlat(lon, lat, level: int = MAX_LEVEL) -> np.ndarray:
    """Leaf (or coarser) cell ids for lon/lat arrays (vectorized)."""
    x, y, z = _xyz_from_lonlat(lon, lat)
    face = _face_from_xyz(x, y, z)
    u, v = _uv_from_xyz(face, x, y, z)
    i = _ij_from_st(_st_from_uv(u)).astype(np.uint64)
    j = _ij_from_st(_st_from_uv(v)).astype(np.uint64)
    return cell_id_from_face_ij(face.astype(np.uint64), i, j, level)


def _lookup_pos() -> np.ndarray:
    """Four steps of the orientation walk in one table lookup (S2's
    LOOKUP_POS): entry ``(i4 << 6) | (j4 << 2) | o`` holds ``(pos8 << 2) |
    o'``, the 8 position bits and the orientation after walking the four
    (i, j) bit pairs of ``i4`` / ``j4`` from orientation ``o``, built by
    running the one-step walk itself."""
    lut = np.zeros(1024, dtype=np.uint64)
    for o0 in range(4):
        for i4 in range(16):
            for j4 in range(16):
                o, pos = o0, 0
                for k in (3, 2, 1, 0):
                    p = int(IJ_TO_POS[o, (((i4 >> k) & 1) << 1) | ((j4 >> k) & 1)])
                    pos = (pos << 2) | p
                    o ^= int(POS_TO_ORIENTATION[p])
                lut[(i4 << 6) | (j4 << 2) | o0] = (pos << 2) | o
    return lut


_LOOKUP_POS = _lookup_pos()


def cell_id_from_face_ij(face, i, j, level: int = MAX_LEVEL) -> np.ndarray:
    """Hilbert position encoding: the orientation walk over the top
    ``level`` bits of i and j (vectorized). Four levels take one lookup
    in ``_LOOKUP_POS``; the levels past the last whole group of four take
    the one-step walk. Bit for bit the JAX package's 30-step walk."""
    face = np.asarray(face, dtype=np.uint64)
    i = np.asarray(i, dtype=np.uint64)
    j = np.asarray(j, dtype=np.uint64)
    o = face & _U(1)  # initial orientation: swap bit from the face
    pos = np.zeros_like(face)
    k = 0
    while k + 4 <= level:
        shift = _U(MAX_LEVEL - 4 - k)
        idx = (((i >> shift) & _U(15)) << _U(6)) | (((j >> shift) & _U(15)) << _U(2)) | o
        v = _LOOKUP_POS.take(idx.astype(np.intp))
        pos = (pos << _U(8)) | (v >> _U(2))
        o = v & _U(3)
        k += 4
    for k in range(k, level):
        shift = _U(MAX_LEVEL - 1 - k)
        ib = (i >> shift) & _U(1)
        jb = (j >> shift) & _U(1)
        ij = (ib << _U(1)) | jb
        p = IJ_TO_POS[o, ij]
        pos = (pos << _U(2)) | p
        o = o ^ POS_TO_ORIENTATION[p]
    lsb = _U(1) << _U(2 * (MAX_LEVEL - level))
    return (face << _U(_FACE_SHIFT)) | ((pos << _U(1)) * lsb) | lsb


def cell_range(cell: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[range_min, range_max] of leaf ids under a cell (S2CellId.rangeMin/Max)."""
    cell = np.asarray(cell, dtype=np.uint64)
    lsb = cell & (~cell + _U(1))
    return cell - (lsb - _U(1)), cell + (lsb - _U(1))


def cell_center_lonlat(cell) -> tuple[np.ndarray, np.ndarray]:
    """Cell center (lon, lat) — the curve inversion (reference invert)."""
    cell = np.asarray(np.atleast_1d(cell), dtype=np.uint64)
    face = (cell >> _U(_FACE_SHIFT)).astype(np.int64)
    lsb = cell & (~cell + _U(1))
    level = MAX_LEVEL - ((np.log2(lsb.astype(np.float64))).astype(np.int64)) // 2
    i = np.zeros(len(cell), dtype=np.uint64)
    j = np.zeros(len(cell), dtype=np.uint64)
    o = (cell >> _U(_FACE_SHIFT)) & _U(1)
    for k in range(MAX_LEVEL):
        active = k < level
        shift = _U(2 * (MAX_LEVEL - 1 - k) + 1)
        p = (cell >> shift) & _U(3)
        ij = POS_TO_IJ[o, p]
        bit = _U(MAX_LEVEL - 1 - k)
        i = np.where(active, i | ((ij >> _U(1)) << bit), i)
        j = np.where(active, j | ((ij & _U(1)) << bit), j)
        o = np.where(active, o ^ POS_TO_ORIENTATION[p], o)
    # center of the cell in ST space
    size = (_U(1) << (_U(MAX_LEVEL) - level.astype(np.uint64))).astype(np.float64)
    s = (i.astype(np.float64) + size / 2.0) / (1 << MAX_LEVEL)
    t = (j.astype(np.float64) + size / 2.0) / (1 << MAX_LEVEL)
    u = _uv_from_st(s)
    v = _uv_from_st(t)
    x, y, z = _xyz_from_face_uv(face, u, v)
    lon = np.degrees(np.arctan2(y, x))
    lat = np.degrees(np.arctan2(z, np.hypot(x, y)))
    return lon, lat


def _xyz_from_face_uv(face, u, v):
    x = np.empty_like(u)
    y = np.empty_like(u)
    z = np.empty_like(u)
    specs = [
        lambda u, v: (np.ones_like(u), u, v),  # 0: +x
        lambda u, v: (-u, np.ones_like(u), v),  # 1: +y
        lambda u, v: (-u, -v, np.ones_like(u)),  # 2: +z
        lambda u, v: (-np.ones_like(u), -v, -u),  # 3: -x  (inverse of uv 3)
        lambda u, v: (v, -np.ones_like(u), -u),  # 4: -y
        lambda u, v: (v, u, -np.ones_like(u)),  # 5: -z
    ]
    for f, fn in enumerate(specs):
        m = face == f
        if m.any():
            xf, yf, zf = fn(u[m], v[m])
            x[m], y[m], z[m] = xf, yf, zf
    n = np.sqrt(x * x + y * y + z * z)
    return x / n, y / n, z / n


# -- covering ------------------------------------------------------------

@dataclass
class _FaceRegion:
    """Conservative UV-rectangle superset of the query box on one face."""

    face: int
    u0: float
    v0: float
    u1: float
    v1: float


def _face_regions(xmin, ymin, xmax, ymax) -> list[_FaceRegion]:
    """Map a lat/lng box to conservative UV rectangles per face.

    Equatorial faces (0, 1, 3, 4 — centers at lng 0/90/180/-90): u is
    monotone in lng (u = tan(lng - center)); |v| <= tan(lat_max_abs) *
    sqrt(1 + u_max^2) bounds v exactly. Polar faces (2: north, 5: south):
    the box's polar cap portion lies within the disk r <= 1/tan(|lat|),
    bounded by its enclosing square.
    """
    out: list[_FaceRegion] = []
    if ymin <= 45.0 and ymax >= -45.0:  # equatorial faces reach |lat| <= 45
        # face axis orientation: on faces 0/1, u = tan(lng_rel) and
        # v = tan(lat) * sqrt(1 + u^2); on faces 3/4 the roles swap with a
        # sign flip: v = tan(lng_rel), u = -tan(lat) * sqrt(1 + v^2)
        centers = {0: 0.0, 1: 90.0, 3: 180.0, 4: -90.0}
        for face, center in centers.items():
            # signed lng offset of the box from the face center; a wide box
            # may wrap past +180 and re-enter at -180 — split the interval
            d0 = ((xmin - center + 180.0) % 360.0) - 180.0
            d1 = d0 + (xmax - xmin)
            pieces = [(d0, d1)] if d1 <= 180.0 else [(d0, 180.0), (-180.0, d1 - 360.0)]
            for p0, p1 in pieces:
                lo, hi = max(p0, -45.0), min(p1, 45.0)
                if hi < lo:
                    continue  # box misses this face's lng wedge
                a0, a1 = np.tan(np.radians(lo)), np.tan(np.radians(hi))
                amax = max(abs(a0), abs(a1))
                # conservative lat coordinate: scale >= 1 only widens the
                # bound in the direction away from zero
                scale = np.sqrt(1.0 + amax * amax)
                t_hi = np.tan(np.radians(min(ymax, 89.9999)))
                t_lo = np.tan(np.radians(max(ymin, -89.9999)))
                b1 = t_hi * (scale if t_hi >= 0 else 1.0)
                b0 = t_lo * (scale if t_lo <= 0 else 1.0)
                b0, b1 = float(np.clip(b0, -1, 1)), float(np.clip(b1, -1, 1))
                if face in (0, 1):
                    out.append(_FaceRegion(face, float(a0), b0, float(a1), b1))
                else:  # lng on v, negated lat on u
                    out.append(_FaceRegion(face, -b1, float(a0), -b0, float(a1)))
    # polar faces: a face point has |lat| >= atan(1/sqrt(2)) ~ 35.26 deg;
    # its radius r = hypot(u, v) = 1/tan(|lat|)
    if ymax >= 35.0:
        r = min(1.0 / np.tan(np.radians(max(ymin, 35.0))), 1.0) if ymin > 0 else 1.0
        out.append(_FaceRegion(2, -r, -r, r, r))
    if ymin <= -35.0:
        r = min(1.0 / np.tan(np.radians(-min(ymax, -35.0))), 1.0) if ymax < 0 else 1.0
        out.append(_FaceRegion(5, -r, -r, r, r))
    return out


class S2SFC:
    """S2 curve with region covering (reference S2SFC + S2RegionCoverer)."""

    def __init__(
        self,
        min_level: int = 0,
        max_level: int = MAX_LEVEL,
        level_mod: int = 1,
        max_cells: int = 2000,
    ):
        if not (0 <= min_level <= max_level <= MAX_LEVEL):
            raise ValueError(f"bad level range [{min_level}, {max_level}]")
        self.min_level = min_level
        self.max_level = max_level
        self.level_mod = max(1, level_mod)
        self.max_cells = max_cells

    def index(self, lon, lat) -> np.ndarray:
        """Leaf cell ids (reference S2SFC.index with lenient=true: clamp
        out-of-range coordinates, matching the z-curves' NormalizedDimension
        clamping so a mixed-index write can't fail halfway through)."""
        lon = np.clip(np.asarray(lon, dtype=np.float64), -180.0, 180.0)
        lat = np.clip(np.asarray(lat, dtype=np.float64), -90.0, 90.0)
        return cell_id_from_lonlat(lon, lat)

    def invert(self, cell) -> tuple[np.ndarray, np.ndarray]:
        return cell_center_lonlat(cell)

    def ranges(self, bounds) -> list[IndexRange]:
        """Covering leaf-id ranges for lat/lng boxes (reference ranges)."""
        spans: list[tuple[int, int]] = []
        regions: list[_FaceRegion] = []
        for (xmin, ymin, xmax, ymax) in bounds:
            if xmin > xmax or ymin > ymax:
                raise ValueError(f"inverted bbox: {(xmin, ymin, xmax, ymax)}")
            regions.extend(_face_regions(xmin, ymin, xmax, ymax))
        budget = max(4, self.max_cells // max(1, len(regions)))
        for region in regions:
            self._cover_face(region, spans, budget)
        if not spans:
            return []
        spans.sort()
        merged: list[list[int]] = []
        for lo, hi in spans:
            if merged and lo <= merged[-1][1] + 1:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [IndexRange(lo, hi, contained=False) for lo, hi in merged]

    def _cover_face(self, region: _FaceRegion, out: list, budget: int) -> None:
        """BFS quadtree cover of one face's UV rectangle, bounded by
        ``budget`` emitted cells (the S2RegionCoverer maxCells analogue:
        when refining would blow the budget, the frontier emits coarse).

        ``level_mod`` shapes only which levels may *stop early* when a cell
        is contained; the emitted output is id ranges, so unions at
        non-conforming levels are not needed.

        Every node of a BFS level is classified at once (numpy arrays over
        the frontier, the same f64 arithmetic as one node at a time), so
        the emitted cells, and the budget's cut, are the JAX package's.
        """
        face = region.face
        scale = float(1 << MAX_LEVEL)
        level = 0
        pos = np.zeros(1, np.uint64)
        o = np.array([face & 1], np.int64)
        i0 = np.zeros(1, np.int64)
        j0 = np.zeros(1, np.int64)
        emitted = 0
        while len(pos):
            size = 1 << (MAX_LEVEL - level)
            u0 = _uv_from_st(i0 / scale)
            u1 = _uv_from_st((i0 + size) / scale)
            v0 = _uv_from_st(j0 / scale)
            v1 = _uv_from_st((j0 + size) / scale)
            live = ~((u1 < region.u0) | (u0 > region.u1) | (v1 < region.v0) | (v0 > region.v1))
            contained = (
                (u0 >= region.u0) & (u1 <= region.u1) & (v0 >= region.v0) & (v1 <= region.v1)
            )
            if level >= self.max_level:
                stop = live
            elif level >= self.min_level and (level - self.min_level) % self.level_mod == 0:
                stop = live & contained
            else:
                stop = np.zeros_like(live)
            keep = live & ~stop
            if stop.any():
                self._emit_many(face, level, pos[stop], out)
                emitted += int(stop.sum())
            n_keep = int(keep.sum())
            if not n_keep:
                return
            if emitted + 4 * n_keep > budget:
                self._emit_many(face, level, pos[keep], out)
                return
            pos, o, i0, j0 = pos[keep], o[keep], i0[keep], j0[keep]
            half = size >> 1
            ij = POS_TO_IJ.astype(np.int64)[o]  # [n, 4] child (i, j) bits, p = 0..3
            po = POS_TO_ORIENTATION.astype(np.int64)
            pos = ((pos[:, None] << _U(2)) | np.arange(4, dtype=np.uint64)).ravel()
            o = (o[:, None] ^ po[None, :]).ravel()
            i0 = (i0[:, None] + (ij >> 1) * half).ravel()
            j0 = (j0[:, None] + (ij & 1) * half).ravel()
            level += 1

    @staticmethod
    def _emit_many(face: int, level: int, pos: np.ndarray, out: list) -> None:
        lsb = _U(1) << _U(2 * (MAX_LEVEL - level))
        cell = (_U(face) << _U(_FACE_SHIFT)) | ((pos << _U(1)) * lsb) | lsb
        out.extend(zip((cell - (lsb - _U(1))).tolist(), (cell + (lsb - _U(1))).tolist()))
