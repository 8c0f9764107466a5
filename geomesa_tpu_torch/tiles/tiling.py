"""The slippy-tile lattice: exact global leaf-pixel binning.

The pyramid's exactness story (docs/tiles.md) lives here. A map tile at
zoom ``z`` is one cell of a plain-EPSG:4326 WorldCRS84Quad-style grid —
``2^(z+1) x 2^z`` tiles, each rendered as a ``px x px`` raster. The
pyramid's FINEST zoom is ``leaf_zoom``; every zoom above it derives from
leaf partials, never from its own scan.

**The global leaf lattice.** All binning happens ONCE, at leaf raster
resolution: the world splits into ``2^(leaf_zoom+1)*px`` columns by
``2^leaf_zoom*px`` rows of leaf pixels, with exact binary-rational edge
arrays (``k * 360/2^n`` sums exactly in f64 — the TileAggregateCache
edge discipline, cache/tiles.py). A point's leaf pixel depends only on
the point, not on which tile asked: half-open ``[edge_k, edge_{k+1})``
membership via searchsorted, so adjacent tiles can never double-count a
boundary row and any zoom-``z`` pixel is an EXACT f64 integer sum of the
leaf pixels it covers — which is what makes a recomposed parent
bit-identical to a from-scratch aggregation of the same rows.

Row index convention: tile ``y`` and raster rows count from the NORTH
edge (the slippy convention PNG scanlines want); the ascending latitude
edge array is south-up, so :meth:`TileLattice.bin_leaf` flips once.

The port's copy of geomesa_tpu/tiles/tiling.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import numpy as np


class TileLattice:
    """The fixed tiling geometry for one pyramid: leaf zoom + tile px."""

    def __init__(self, leaf_zoom: int = 3, px: int = 256):
        if leaf_zoom < 0:
            raise ValueError(f"leaf_zoom must be >= 0, got {leaf_zoom}")
        if px < 1:
            raise ValueError(f"px must be >= 1, got {px}")
        self.leaf_zoom = int(leaf_zoom)
        self.px = int(px)
        #: global leaf-pixel grid dimensions
        self.nx = (1 << (self.leaf_zoom + 1)) * self.px
        self.ny = (1 << self.leaf_zoom) * self.px
        # exact binary-rational pixel edges (see module docstring): the
        # ONE pair of arrays every binning and bbox derivation reads
        self.xe = -180.0 + np.arange(self.nx + 1) * (360.0 / self.nx)
        self.ye = -90.0 + np.arange(self.ny + 1) * (180.0 / self.ny)

    def n_tiles(self, z: int) -> tuple[int, int]:
        """(columns, rows) of the zoom-``z`` tile grid."""
        return 1 << (z + 1), 1 << z

    def valid(self, z: int, x: int, y: int) -> bool:
        if not 0 <= z <= self.leaf_zoom:
            return False
        cx, cy = self.n_tiles(z)
        return 0 <= x < cx and 0 <= y < cy

    def leaf_span(self, z: int, x: int, y: int) -> tuple[int, int, int, int]:
        """Half-open leaf-pixel span ``(col0, col1, row0, row1)`` of one
        tile; rows count from the north edge."""
        s = self.px << (self.leaf_zoom - z)
        return x * s, (x + 1) * s, y * s, (y + 1) * s

    def tile_bbox(self, z: int, x: int, y: int) -> tuple[float, float, float, float]:
        """(xmin, ymin, xmax, ymax) of one tile — read off the exact
        edge arrays, so a closed bbox scan of it covers exactly the
        rows that can bin inside (boundary rows bin to ONE neighbor)."""
        c0, c1, r0, r1 = self.leaf_span(z, x, y)
        return (
            float(self.xe[c0]), float(self.ye[self.ny - r1]),
            float(self.xe[c1]), float(self.ye[self.ny - r0]),
        )

    def bin_leaf(self, x, y) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Global leaf pixel ``(col, north_row)`` per point plus the
        in-world mask. Half-open membership; the world's own closed
        upper edges (lon=180, lat=90) join the last pixel, so every
        in-world point bins exactly once."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        ok = (x >= -180.0) & (x <= 180.0) & (y >= -90.0) & (y <= 90.0)
        col = np.searchsorted(self.xe, x, side="right") - 1
        row_s = np.searchsorted(self.ye, y, side="right") - 1
        col = np.clip(col, 0, self.nx - 1)
        row_s = np.clip(row_s, 0, self.ny - 1)
        return col, (self.ny - 1) - row_s, ok

    def leaf_tiles_overlapping(self, bounds=None) -> int:
        """How many LEAF tiles a mutation over ``bounds`` (xmin, ymin,
        xmax, ymax; None = everywhere) can dirty — the delta-to-tile-
        range accounting behind the ``geomesa.tiles.dirty`` metric."""
        cx, cy = self.n_tiles(self.leaf_zoom)
        if bounds is None:
            return cx * cy
        x0, y0, x1, y1 = (float(v) for v in bounds)
        x0, x1 = max(x0, -180.0), min(x1, 180.0)
        y0, y1 = max(y0, -90.0), min(y1, 90.0)
        if x1 < x0 or y1 < y0:
            return 0
        col, row, _ = self.bin_leaf(
            np.array([x0, x1]), np.array([y0, y1])
        )
        i0, i1 = int(col[0]) // self.px, int(col[1]) // self.px
        # y1 is the NORTH edge of the delta -> the smaller north row
        j0, j1 = int(row[1]) // self.px, int(row[0]) // self.px
        return (i1 - i0 + 1) * (j1 - j0 + 1)

    def children_of(self, z: int, x: int, y: int):
        """The 4 children of one tile at zoom ``z+1``, north-west first
        in raster order: (dx, dy) over {0,1} x {0,1}."""
        return [
            (z + 1, 2 * x + dx, 2 * y + dy)
            for dy in (0, 1) for dx in (0, 1)
        ]
