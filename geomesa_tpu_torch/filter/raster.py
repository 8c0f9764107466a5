"""Raster-interval polygon approximations (arXiv 2307.01716).

The port's copy of geomesa_tpu/filter/raster.py. A query/join polygon rasterizes ONCE onto a Z2-aligned grid — the cells
are genuine Z2 SFC cells at one level ``g`` (the finest whose bbox window
fits the ``geomesa.raster.max.cells`` budget), so every cell is both an
axis-aligned rectangle in (lon, lat) AND a contiguous z-code range. Each
cell classifies conservatively (geometry.classify_raster_cells) as

- FULL    — entirely inside the polygon, with margin: any point within
            the cell is a guaranteed f64 hit;
- OUT     — entirely outside, with margin: a guaranteed miss;
- PARTIAL — the boundary residue, where the exact even-odd PIP still runs.

Two products feed the scan engine:

1. :meth:`RasterApprox.zranges` — the polygon's covering z-ranges derived
   from the raster itself: FULL cells emit *contained* ranges (their rows
   are certain hits — no kernel work, no refinement; the round-3
   contained-span machinery applies unchanged, now valid for polygons
   because full-cell containment implies membership), PARTIAL cells emit
   overlap ranges, OUT cells inside the bbox emit nothing (pruned before
   any device work — the win the plain bbox decomposition cannot see).
2. :meth:`RasterApprox.pack_block` — the packed [1 + R, 128] f32 interval
   stack the scan kernel classifies candidate rows against (sorted
   integer intervals over row-major bbox-local cell ids; see the raster
   leg of block_kernels.masks_plain and csrc/masks.cuh): full ->
   wide+inner, out -> neither, partial -> the exact PIP leg (device
   residue) or host refinement.

The host-side :meth:`classify_points` classifies points on the host
(the JAX package's spatial join reads it; the port has no join yet).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.curve.zorder import Z2

# conservative classification margin, degrees: must exceed the stored-f32
# coordinate rounding (ulp(360) ~ 3e-5) plus the kernel's f32 cell
# arithmetic error (~6e-5 worst case), so a point the KERNEL lands in a
# full/out cell is truly within margin of that cell at f64. 3e-4 keeps
# ~5x headroom; cells must be >= ~8 margins wide to classify usefully, so
# polygons smaller than ~2.4e-3 deg skip rasterization (build() -> None).
RASTER_MARGIN = 3e-4

Z2_BITS = 31  # ordinal bits per dimension (curve.z2sfc.Z2SFC precision)


@dataclass
class RasterApprox:
    """One polygon's Z2-aligned raster: cell classes + interval forms."""

    level: int          # z2 grid level g (2^g cells per dimension)
    i0: int             # window origin, level-g cell ordinals
    j0: int
    classes: np.ndarray  # int8 [ny, nx] (geometry.RASTER_* codes)
    x0: float           # window origin in degrees (exact cell edges)
    y0: float
    cell_w: float       # cell size, degrees (exact binary rationals)
    cell_h: float
    # row-major interval runs over c = j * nx + i (non-OUT cells only),
    # inclusive [lo, hi] with a full/partial flag per run
    ilo: np.ndarray = None
    ihi: np.ndarray = None
    ifull: np.ndarray = None

    def __post_init__(self):
        flat = self.classes.ravel()
        runs = np.flatnonzero(np.diff(flat)) + 1
        starts = np.concatenate([[0], runs])
        ends = np.concatenate([runs, [len(flat)]])
        keep = flat[starts] != geo.RASTER_OUT
        self.ilo = starts[keep].astype(np.int64)
        self.ihi = (ends[keep] - 1).astype(np.int64)
        self.ifull = flat[starts[keep]] == geo.RASTER_FULL

    # -- shape accessors --------------------------------------------------
    @property
    def ny(self) -> int:
        return self.classes.shape[0]

    @property
    def nx(self) -> int:
        return self.classes.shape[1]

    @property
    def n_cells(self) -> int:
        return self.classes.size

    @property
    def cell_counts(self) -> tuple[int, int, int]:
        """(full, partial, out) cell counts — the selectivity signal the
        adaptive join planner reads."""
        full = int((self.classes == geo.RASTER_FULL).sum())
        part = int((self.classes == geo.RASTER_PARTIAL).sum())
        return full, part, self.n_cells - full - part

    @property
    def boundary_fraction(self) -> float:
        """Partial cells / non-out cells: the fraction of covered area
        that still pays the exact predicate."""
        full, part, _ = self.cell_counts
        return part / max(full + part, 1)

    @property
    def decided_fraction(self) -> float:
        """(full + out) / all cells: how much of the bbox the raster
        resolves without the exact predicate. The worthwhile-ness gate."""
        full, part, out = self.cell_counts
        return (full + out) / max(self.n_cells, 1)

    # -- host classification ----------------------------------------------
    def classify_points(self, x, y) -> np.ndarray:
        """int8 [n] cell class per point (RASTER_OUT for points outside
        the grid window — the window covers the polygon bbox, so such
        points are guaranteed misses)."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        i = np.floor((x - self.x0) / self.cell_w).astype(np.int64)
        j = np.floor((y - self.y0) / self.cell_h).astype(np.int64)
        ok = (i >= 0) & (i < self.nx) & (j >= 0) & (j < self.ny)
        out = np.zeros(len(x), dtype=np.int8)
        out[ok] = self.classes[j[ok], i[ok]]
        return out

    # -- z-range emission -------------------------------------------------
    def zranges(self, max_ranges: int | None = None):
        """(lo [u64], hi [u64], contained [bool]) covering z-ranges of the
        non-OUT cells at this raster's level: consecutive-morton runs of
        one class merge; past ``max_ranges`` the closest-gap neighbours
        coalesce as *overlap* ranges (absorbed OUT/FULL cells downgrade to
        kernel-classified rows — a superset, never wrong)."""
        jj, ii = np.nonzero(self.classes != geo.RASTER_OUT)
        if len(jj) == 0:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, bool)
        gi = (ii + self.i0).astype(np.uint64)
        gj = (jj + self.j0).astype(np.uint64)
        m = np.asarray(Z2.index(gi, gj))
        full = self.classes[jj, ii] == geo.RASTER_FULL
        order = np.argsort(m)
        m, full = m[order], full[order]
        brk = np.flatnonzero((np.diff(m) != 1) | (full[1:] != full[:-1]))
        starts = np.concatenate([[0], brk + 1])
        ends = np.concatenate([brk, [len(m) - 1]])
        shift = np.uint64(2 * (Z2_BITS - self.level))
        lo = m[starts] << shift
        hi = ((m[ends] + np.uint64(1)) << shift) - np.uint64(1)
        contained = full[starts]
        if max_ranges is not None and len(lo) > max_ranges:
            lo, hi, contained = _coalesce_ranges(lo, hi, contained, max_ranges)
        return lo, hi, contained

    # -- kernel interval stack --------------------------------------------
    def pack_block(self, bucket: int) -> np.ndarray:
        """[1 + bucket, 128] f32 kernel block (block_kernels raster leg).

        Row 0 header lanes: (x0, y0, 1/cell_w, 1/cell_h, nx, ny). Rows
        1..bucket: one interval each, lanes (lo, hi, cls) with cls +1 =
        full / -1 = partial; pad rows carry lo=1 > hi=0 (never match).
        Cell ids fit f32 exactly (max.cells <= 2^24). More runs than the
        bucket coalesce via consecutive-run grouping: a merged group is
        full only if it was one contiguous all-full stretch, else partial
        (absorbed out-gap rows become boundary residue — safe)."""
        lo, hi, full = self.ilo, self.ihi, self.ifull
        if len(lo) > bucket:
            groups = np.array_split(np.arange(len(lo)), bucket)
            lo = np.array([lo[g[0]] for g in groups])
            nhi = np.array([self.ihi[g[-1]] for g in groups])
            nfull = np.array([
                bool(self.ifull[g].all())
                and bool((self.ilo[g][1:] == self.ihi[g][:-1] + 1).all())
                for g in groups
            ])
            hi, full = nhi, nfull
        from geomesa_tpu_torch.scan.block_kernels import LANES

        out = np.zeros((1 + bucket, LANES), np.float32)
        out[0, 0] = self.x0
        out[0, 1] = self.y0
        out[0, 2] = 1.0 / self.cell_w
        out[0, 3] = 1.0 / self.cell_h
        out[0, 4] = self.nx
        out[0, 5] = self.ny
        out[1:, 0] = 1.0
        out[1:, 1] = 0.0
        n = len(lo)
        out[1 : 1 + n, 0] = lo
        out[1 : 1 + n, 1] = hi
        out[1 : 1 + n, 2] = np.where(full, 1.0, -1.0)
        return out


def _coalesce_ranges(lo, hi, contained, max_ranges):
    """Merge closest-gap neighbours until <= max_ranges. A merge spanning
    a gap (or mixing classes) is an overlap range: the raster kernel leg /
    host refinement re-excludes the absorbed rows exactly."""
    lo = lo.astype(np.uint64)
    hi = hi.astype(np.uint64)
    contained = contained.copy()
    while len(lo) > max_ranges:
        gaps = (lo[1:] - hi[:-1]).astype(np.int64)
        k = len(lo) - max_ranges
        merge = np.argsort(gaps, kind="stable")[:k]
        drop = np.zeros(len(lo), bool)
        new_cont = contained.copy()
        for i in sorted(merge.tolist(), reverse=True):
            if drop[i + 1]:
                continue  # chained merges resolve next pass
            hi[i] = max(hi[i], hi[i + 1])
            new_cont[i] = bool(
                contained[i] and contained[i + 1] and gaps[i] == 1
            )
            drop[i + 1] = True
        keep = ~drop
        lo, hi, contained = lo[keep], hi[keep], new_cont[keep]
    return lo, hi, contained


def build_raster(
    geom: "geo.Polygon | geo.MultiPolygon",
    max_cells: int | None = None,
    margin: float = RASTER_MARGIN,
    min_decided: float = 0.25,
) -> "RasterApprox | None":
    """Rasterize one polygon onto the finest Z2-aligned grid whose bbox
    window fits ``max_cells``, or None when rasterization cannot help:
    non-polygon input, a polygon too small for margin-safe cells, or a
    raster that decides less than ``min_decided`` of its bbox (slivers —
    everything would be boundary residue anyway)."""
    if not isinstance(geom, (geo.Polygon, geo.MultiPolygon)):
        return None
    from geomesa_tpu_torch.conf import RASTER_MAX_CELLS

    if max_cells is None:
        max_cells = RASTER_MAX_CELLS.get()
    bx0, by0, bx1, by1 = geom.bounds()
    bx0, by0 = max(bx0, -180.0), max(by0, -90.0)
    bx1, by1 = min(bx1, 180.0), min(by1, 90.0)
    if bx1 < bx0 or by1 < by0:
        return None
    for level in range(Z2_BITS, 0, -1):
        cw = 360.0 / (1 << level)
        ch = 180.0 / (1 << level)
        if cw < 8 * margin or ch < 8 * margin:
            continue  # cells too small to classify past the margin
        i0 = min(int((bx0 + 180.0) / cw), (1 << level) - 1)
        i1 = min(int((bx1 + 180.0) / cw), (1 << level) - 1)
        j0 = min(int((by0 + 90.0) / ch), (1 << level) - 1)
        j1 = min(int((by1 + 90.0) / ch), (1 << level) - 1)
        nx, ny = i1 - i0 + 1, j1 - j0 + 1
        if nx * ny <= max_cells:
            break
    else:
        return None
    x_edges = -180.0 + (i0 + np.arange(nx + 1)) * cw
    y_edges = -90.0 + (j0 + np.arange(ny + 1)) * ch
    classes = geo.classify_raster_cells(geom, x_edges, y_edges, margin)
    approx = RasterApprox(
        level=level, i0=i0, j0=j0, classes=classes,
        x0=float(x_edges[0]), y0=float(y_edges[0]), cell_w=cw, cell_h=ch,
    )
    if approx.decided_fraction < min_decided:
        return None
    return approx


# -- memoized build (joins re-probe the same polygons; the planner's
# scan-config memo covers the query path, this covers direct callers) -----

_CACHE: "OrderedDict[tuple, RasterApprox | None]" = OrderedDict()
_CACHE_LOCK = threading.Lock()
_CACHE_MAX = 256


def clear_cache() -> None:
    """Drop memoized rasters (tests toggling the geomesa.raster.* knobs
    mid-process must not serve a stale build)."""
    with _CACHE_LOCK:
        _CACHE.clear()


def raster_for(
    geom, max_cells: int | None = None, min_edges: int | None = None
) -> "RasterApprox | None":
    """LRU-memoized :func:`build_raster`, gated by the config knobs:
    returns None when rasterization is disabled, the polygon is below
    ``geomesa.raster.min.edges``, or build_raster declines."""
    from geomesa_tpu_torch.conf import RASTER_ENABLED, RASTER_MIN_EDGES

    if not RASTER_ENABLED.get():
        return None
    if not isinstance(geom, (geo.Polygon, geo.MultiPolygon)):
        return None
    if min_edges is None:
        min_edges = RASTER_MIN_EDGES.get()
    n_edges = sum(len(r) - 1 for r in geo._rings_of(geom))
    if n_edges < min_edges:
        return None
    key = (geom.wkt, max_cells)
    with _CACHE_LOCK:
        if key in _CACHE:
            _CACHE.move_to_end(key)
            return _CACHE[key]
    approx = build_raster(geom, max_cells=max_cells)
    with _CACHE_LOCK:
        _CACHE[key] = approx
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)
    return approx
