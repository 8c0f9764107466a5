"""The precomposed density pyramid: leaf scans once, parents fold.

The GeoBlocks endgame (docs/tiles.md; arXiv:1908.07753): map clients
fetch ``(z, x, y)`` tiles at thousands of requests per second while the
hot tier keeps ingesting. Rescanning rows per request loses by orders
of magnitude, so the pyramid precomposes:

- **leaf tiles** (zoom ``leaf_zoom``) aggregate rows ONCE — a single
  bbox scan binned onto the global leaf lattice
  (:class:`~geomesa_tpu_torch.tiles.tiling.TileLattice`);
- **parents** fold their 4 children's cached grids with an exact f64
  2x2 block sum (scan/aggregations.block_sum) — never rescanning rows a
  clean child already aggregated;
- every composed grid lives in the pyramid's own
  :class:`~geomesa_tpu_torch.cache.result.ResultCache` keyed by tile, with
  the tile's bbox as its generation key range — so a flush/fold bumping
  its mutation's key ranges (GenerationTracker's scoped invalidation)
  dirties ONLY the tiles it touched, and dirty tiles recompose lazily
  on the next fetch while far tiles keep serving warm. Single-flight
  absorbs thundering-herd fetches of the same hot tile, and the TTL
  jitter knob (``geomesa.cache.ttl.jitter``) keeps a burst of same-TTL
  tiles from re-expiring in lockstep.

Counts are integers held in f64 (exact to 2^53), and leaf binning
depends only on the point — so a pyramid tile is **bit-identical** to
:meth:`TilePyramid.fresh`, the from-scratch oracle that rescans the
tile's rows per request (also the ``mode=fresh`` server path).

Locking: ``TilePyramid._lock`` (LOCKS rank 54) guards only the delta
accounting and the leaf-scan cost EWMA — never held across a store
scan or another cache tier's lock. Cache entries ride the shared
``ResultCache._lock`` / ``GenerationTracker._lock`` discipline.

Metrics: ``geomesa.tiles.compose`` / ``.leaf.scan`` / ``.dirty``
counters here; the serving tier adds ``geomesa.tiles.fetch`` (latency
histogram), ``.served``, ``.not_modified`` and ``.fresh``.

The port's copy of geomesa_tpu/tiles/pyramid.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from geomesa_tpu_torch import fault
from geomesa_tpu_torch.cache.generations import GenerationTracker, KeyRange
from geomesa_tpu_torch.cache.result import ResultCache, ResultCacheConf
from geomesa_tpu_torch.tiles.tiling import TileLattice

_EWMA_ALPHA = 0.25  # same smoothing as the tile-aggregate cost gate


@dataclass
class TilesConfig:
    """Pyramid knobs; defaults resolve from the conf.py property tier."""

    leaf_zoom: int = 3
    px: int = 256
    cache_max_bytes: int = 128 << 20
    ttl_s: Optional[float] = None
    ttl_jitter: float = 0.0
    max_age_s: float = 0.0

    @staticmethod
    def from_properties() -> "TilesConfig":
        from geomesa_tpu_torch import conf

        return TilesConfig(
            leaf_zoom=conf.TILES_LEAF_ZOOM.get(),
            px=conf.TILES_PX.get(),
            cache_max_bytes=conf.TILES_CACHE_MAX_BYTES.get(),
            ttl_s=conf.TILES_TTL.get(),
            ttl_jitter=conf.CACHE_TTL_JITTER.get(),
            max_age_s=conf.TILES_MAX_AGE_S.get(),
        )


@dataclass(frozen=True)
class TileGrid:
    """One composed tile: the per-pixel count grid (row 0 = north) plus
    the generation tick captured at compose start — the ETag source."""

    grid: np.ndarray
    tick: int
    count: float

    @property
    def nbytes(self) -> int:
        # the ResultCache admission sizing hook (collection_nbytes)
        return int(self.grid.nbytes) + 96


class TilePyramid:
    """The tile tier over one (cold) store.

    With a :class:`~geomesa_tpu_torch.cache.QueryCache` attached to the store,
    composed grids cache against its GenerationTracker and the pyramid
    registers for mutation-delta accounting (``cache.attach_pyramid``).
    A cacheless store still serves correct tiles — every fetch simply
    recomposes from scratch (no tracker means no safe invalidation)."""

    def __init__(self, store, config: "TilesConfig | None" = None,
                 metrics=None):
        from geomesa_tpu_torch.lockwitness import witness
        from geomesa_tpu_torch.metrics import resolve

        self.store = store
        self.conf = config or TilesConfig.from_properties()
        self.lattice = TileLattice(self.conf.leaf_zoom, self.conf.px)
        self.metrics = resolve(
            metrics if metrics is not None
            else getattr(store, "metrics", None)
        )
        self._lock = witness(threading.Lock(), "TilePyramid._lock")
        self._deltas = 0        # guarded-by: _lock
        self._dirty_leaves = 0  # guarded-by: _lock
        self._leaf_scan_s: dict[str, float] = {}  # guarded-by: _lock
        cache_tier = getattr(store, "cache", None)
        if cache_tier is not None:
            self.generations: GenerationTracker = cache_tier.generations
            self._result: "ResultCache | None" = ResultCache(
                ResultCacheConf(
                    max_bytes=self.conf.cache_max_bytes,
                    ttl_s=self.conf.ttl_s,
                    min_cost_s=0.0,
                    ttl_jitter=self.conf.ttl_jitter,
                ),
                self.generations,
                metrics=self.metrics,
            )
            cache_tier.attach_pyramid(self)
        else:
            self.generations = GenerationTracker()
            self._result = None

    # -- fetch paths -----------------------------------------------------
    def fetch(self, type_name: str, z: int, x: int, y: int) -> TileGrid:
        """The precomposed path: the cached grid when its generations
        are clean, else a lazy recompose (single-flight coalesced)."""
        self._check(type_name, z, x, y)
        return self._get(type_name, z, x, y)

    def fresh(self, type_name: str, z: int, x: int, y: int) -> TileGrid:
        """The from-scratch oracle (and the server's ``mode=fresh``
        baseline): one bbox scan of the tile's rows, binned on the SAME
        global leaf lattice, leaf indices shifted down to zoom ``z`` —
        bit-identical to :meth:`fetch` by construction."""
        from geomesa_tpu_torch.scan.aggregations import tile_partial

        self._check(type_name, z, x, y)
        tick = self.generations.tick()
        col, row, c0, r0 = self._tile_rows(type_name, z, x, y)
        shift = self.lattice.leaf_zoom - z
        grid = tile_partial(
            (col - c0) >> shift, (row - r0) >> shift,
            self.conf.px, self.conf.px,
        )
        self.metrics.counter("geomesa.tiles.fresh")
        return TileGrid(grid=grid, tick=tick, count=float(grid.sum()))

    def peek(self, type_name: str, z: int, x: int, y: int) -> Optional[TileGrid]:
        """The still-valid cached grid, or None — the conditional-GET
        check (a matching ETag answers 304 with no compose or render
        work). Read-only: no counters, no entry drops."""
        if self._result is None or not self.lattice.valid(z, x, y):
            return None
        return self._result.peek(self._key(type_name, z, x, y))

    # -- mutation hooks --------------------------------------------------
    def note_delta(self, type_name: str, bounds=None) -> int:
        """One mutated batch landed over ``bounds`` (the QueryCache
        forwards every on_mutation): account how many leaf tiles its
        key range can dirty. Invalidation itself rides the shared
        GenerationTracker — entries re-validate lazily on fetch."""
        n = self.lattice.leaf_tiles_overlapping(bounds)
        with self._lock:
            self._deltas += 1
            self._dirty_leaves += n
        self.metrics.counter("geomesa.tiles.dirty", n)
        return n

    def invalidate_type(self, type_name: str) -> int:
        """Drop every cached grid for one type (schema dropped)."""
        if self._result is None:
            return 0
        return self._result.invalidate_type(type_name)

    def sweep(self, type_name: "str | None" = None) -> int:
        """Eagerly drop stale/expired grids (quarantine hook)."""
        if self._result is None:
            return 0
        return self._result.sweep(type_name)

    def stats(self) -> dict:
        with self._lock:
            deltas, dirty = self._deltas, self._dirty_leaves
        return {
            "tile_grid_entries": len(self._result) if self._result else 0,
            "tile_grid_bytes": (
                self._result.bytes_resident if self._result else 0
            ),
            "tile_deltas": deltas,
            "tile_dirty_leaves": dirty,
            "leaf_zoom": self.lattice.leaf_zoom,
            "px": self.conf.px,
        }

    # -- composition -----------------------------------------------------
    def _check(self, type_name: str, z: int, x: int, y: int) -> None:
        self.store.get_schema(type_name)  # KeyError -> the caller's 404
        if not self.lattice.valid(z, x, y):
            cx, cy = self.lattice.n_tiles(max(min(z, self.lattice.leaf_zoom), 0))
            raise ValueError(
                f"tile ({z}/{x}/{y}) outside the pyramid: zoom in "
                f"[0, {self.lattice.leaf_zoom}], {cx}x{cy} tiles at that zoom"
            )

    def _key(self, type_name: str, z: int, x: int, y: int) -> str:
        return f"tiles/{type_name}/{z}/{x}/{y}"

    def _get(self, type_name: str, z: int, x: int, y: int) -> TileGrid:
        if self._result is None:
            return self._compose(type_name, z, x, y)[0]
        key_range = KeyRange(
            boxes=(self.lattice.tile_bbox(z, x, y),), interval=None
        )
        value, _status, _probe = self._result.get_or_compute(
            self._key(type_name, z, x, y), type_name, key_range,
            lambda: self._compose(type_name, z, x, y),
        )
        return value

    def _compose(self, type_name: str, z: int, x: int, y: int):
        """Build one grid: a leaf scan at ``leaf_zoom``, else an exact
        2x2 block-sum fold of the 4 children (each fetched through the
        cache, so clean subtrees are never rescanned). Returns
        ``(TileGrid, cost_seconds)`` — the ResultCache compute shape."""
        from geomesa_tpu_torch.scan.aggregations import block_sum

        t0 = time.perf_counter()
        fault.fault_point("tiles.compose")
        tick = self.generations.tick()
        px = self.lattice.px
        if z >= self.lattice.leaf_zoom:
            grid = self._leaf_grid(type_name, z, x, y)
        else:
            combined = np.zeros((2 * px, 2 * px), np.float64)
            for cz, cx, cy in self.lattice.children_of(z, x, y):
                dx, dy = cx - 2 * x, cy - 2 * y
                child = self._get(type_name, cz, cx, cy)
                combined[
                    dy * px:(dy + 1) * px, dx * px:(dx + 1) * px
                ] = child.grid
            grid = block_sum(combined, 2)
        self.metrics.counter("geomesa.tiles.compose")
        g = TileGrid(grid=grid, tick=tick, count=float(grid.sum()))
        return g, time.perf_counter() - t0

    def _leaf_grid(self, type_name: str, z: int, x: int, y: int) -> np.ndarray:
        from geomesa_tpu_torch.scan.aggregations import tile_partial

        fault.fault_point("tiles.leaf.scan")
        t0 = time.perf_counter()
        col, row, c0, r0 = self._tile_rows(type_name, z, x, y)
        grid = tile_partial(col - c0, row - r0, self.conf.px, self.conf.px)
        scan_s = time.perf_counter() - t0
        with self._lock:
            prev = self._leaf_scan_s.get(type_name)
            self._leaf_scan_s[type_name] = (
                scan_s if prev is None
                else prev + _EWMA_ALPHA * (scan_s - prev)
            )
        self.metrics.counter("geomesa.tiles.leaf.scan")
        return grid

    def _tile_rows(self, type_name: str, z: int, x: int, y: int):
        """One closed-bbox scan of a tile's rows, binned on the global
        leaf lattice and masked to the tile's half-open leaf-pixel span
        (a boundary row the closed scan returned for BOTH neighbors
        bins into exactly one). Returns (col, row, col0, row0) with the
        mask applied."""
        from geomesa_tpu_torch.filter.predicates import BBox
        from geomesa_tpu_torch.planning.hints import QueryHints

        sft = self.store.get_schema(type_name)
        bbox = self.lattice.tile_bbox(z, x, y)
        rows = self.store.query(
            type_name, BBox(sft.geom_field, *bbox),
            hints=QueryHints(cache="bypass"),
        )
        if len(rows):
            px_, py_ = rows.representative_xy()
            col, row, ok = self.lattice.bin_leaf(px_, py_)
        else:
            col = row = np.zeros(0, np.int64)
            ok = np.zeros(0, bool)
        c0, c1, r0, r1 = self.lattice.leaf_span(z, x, y)
        keep = ok & (col >= c0) & (col < c1) & (row >= r0) & (row < r1)
        return col[keep], row[keep], c0, r0
