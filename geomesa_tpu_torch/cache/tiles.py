"""Tile-aggregate cache: memoized per-SFC-tile partial aggregates.

The port's copy of geomesa_tpu/cache/tiles.py (the GeoBlocks idea,
arXiv:1908.07753): aggregate at the granularity of space-filling-curve
tiles, so an arbitrary bbox aggregation composes cached interior tiles
with fresh edge scans, and repeated and shifted dashboard boxes stop
scanning the interior they already aggregated.

Tiles are the Z2 cell grid at a configurable resolution (``tile_bits``:
the world splits into 2^bits x 2^bits lon/lat cells, each one tile). A
tile's aggregate is the same stat layout the device bounds kernel emits:
count, xmin, xmax, ymin, ymax, enough for count(), bounds() and Count()
stats.

Exactness: tile membership is half-open ([x0, x1) x [y0, y1)), computed
on the host from exact (refined) query rows via searchsorted against
exact tile-edge arrays, so adjacent tiles never count a boundary row
twice and the composed aggregate equals the uncached scan. The edge of
the query bbox decomposes into <= 4 closed strips scanned as one union
query, masked to the closed query box minus the half-open interior (see
_strips / _scan_and_fill). That scan goes through the store's normal row
path (the index scan kernel), with ``QueryHints(cache="bypass")``.

Invalidation: each tile records the generation tick at fill; a lookup
validates it against the tracker (cache.generations), so any overlapping
mutation forces a refill.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np

from geomesa_tpu_torch.cache.generations import GenerationTracker, KeyRange


@dataclass
class TileAggregate:
    """Partial aggregate of one tile's rows (count/min/max lanes)."""

    count: int
    xmin: float
    ymin: float
    xmax: float
    ymax: float
    tick: int


@dataclass
class TileComposition:
    """One composed bbox aggregation: the answer + reuse accounting."""

    count: int
    bounds: Optional[tuple]  # (xmin, ymin, xmax, ymax) | None when empty
    tiles_total: int
    tiles_reused: int
    tiles_filled: int
    probe_s: float


@dataclass
class TileCacheConf:
    tile_bits: int = 6
    max_entries: int = 65_536
    max_tiles_per_query: int = 1024


# adaptive cost gate (the work-reuse idea of arXiv:1802.09488): a
# composition is only worth it when it beats the plain scan it replaces,
# which depends on data size, box/tile geometry, and the backend's cost
# for fragmented edge-strip scans. The cache measures BOTH costs per type
# (EWMAs) and gates composition off when it is losing, re-probing
# periodically in case the balance shifts (store grew, tiles warmed).
# The blend and explore/re-probe moves are the port's copy of the JAX
# package's tuning primitives (ewma_step, ProbeGate).
_EXPLORE_MIN = 6     # composes observed before the gate may trip
_REPROBE_EVERY = 8   # gated attempts between re-explorations
_EWMA_ALPHA = 0.25


def ewma_step(prev: Optional[float], sample: float, alpha: float) -> float:
    """One EWMA blend: the first sample seeds the average, later ones
    fold in at weight ``alpha``."""
    if prev is None:
        return sample
    return (1.0 - alpha) * prev + alpha * sample


class ProbeGate:
    """Explore-then-reprobe admission for a measured alternative: the
    first ``explore_min`` trials pass unconditionally (the EWMAs need
    samples first); once the measurement says "losing", every
    ``reprobe_every``-th blocked attempt still passes, so a shift in the
    workload can win the gate back."""

    __slots__ = ("explore_min", "reprobe_every", "trials", "blocked")

    def __init__(self, explore_min: int, reprobe_every: int):
        self.explore_min = explore_min
        self.reprobe_every = reprobe_every
        self.trials = 0   # measured attempts let through so far
        self.blocked = 0  # consecutive losses since the last re-probe

    @property
    def exploring(self) -> bool:
        return self.trials < self.explore_min

    def note_trial(self) -> None:
        self.trials += 1

    def block(self) -> bool:
        """Record one losing decision. True = let this attempt through
        anyway (the periodic re-probe, resetting the streak)."""
        self.blocked += 1
        if self.blocked >= self.reprobe_every:
            self.blocked = 0
            return True
        return False


def _accumulate(x, y):
    """(count, xmin, ymin, xmax, ymax) of a row subset."""
    if len(x) == 0:
        return 0, np.inf, np.inf, -np.inf, -np.inf
    return (
        len(x),
        float(x.min()), float(y.min()), float(x.max()), float(y.max()),
    )


class TileAggregateCache:
    """LRU map (type, i, j) -> TileAggregate at one fixed resolution."""

    def __init__(
        self,
        conf: TileCacheConf,
        generations: GenerationTracker,
        metrics=None,
    ):
        from geomesa_tpu_torch.metrics import resolve

        from geomesa_tpu_torch.lockwitness import witness

        self.conf = conf
        self.generations = generations
        self.metrics = resolve(metrics)
        self._lock = witness(threading.RLock(), "TileAggregateCache._lock")
        self._tiles: "OrderedDict[tuple, TileAggregate]" = OrderedDict()  # guarded-by: _lock
        # adaptive cost gate state: per-type EWMAs of plain-scan vs
        # composition cost, plus the gated-attempt counter for re-probes
        self._scan_s: dict[str, float] = {}      # guarded-by: _lock
        self._compose_s: dict[str, float] = {}   # guarded-by: _lock
        self._probe: "dict[str, ProbeGate]" = {}  # guarded-by: _lock
        self._scanning = threading.local()
        n = 1 << conf.tile_bits
        # exact binary-rational tile edges (i * 360/2^bits sums exactly in
        # f64 at any practical resolution), shared by binning and strips
        self._xe = -180.0 + np.arange(n + 1) * (360.0 / n)
        self._ye = -90.0 + np.arange(n + 1) * (180.0 / n)

    @property
    def enabled(self) -> bool:
        return self.conf.max_entries > 0

    def __len__(self) -> int:
        return len(self._tiles)

    def _tile_range(self, key: tuple) -> KeyRange:
        _, i, j = key
        return KeyRange(
            boxes=((
                float(self._xe[i]), float(self._ye[j]),
                float(self._xe[i + 1]), float(self._ye[j + 1]),
            ),),
            interval=None,
        )

    def _probe_locked(self, key: tuple) -> Optional[TileAggregate]:
        agg = self._tiles.get(key)
        if agg is None:
            return None
        if self.generations.stale(key[0], self._tile_range(key), agg.tick):
            del self._tiles[key]
            self.metrics.counter("geomesa.cache.tile.invalidation")
            return None
        self._tiles.move_to_end(key)
        return agg

    def _store_locked(self, key: tuple, agg: TileAggregate) -> None:
        self._tiles.pop(key, None)
        self._tiles[key] = agg
        while len(self._tiles) > self.conf.max_entries:
            self._tiles.popitem(last=False)
            self.metrics.counter("geomesa.cache.tile.eviction")
        self.metrics.gauge("geomesa.cache.tile.entries", len(self._tiles))

    # -- adaptive cost gate ----------------------------------------------
    def note_scan(self, type_name: str, seconds: float) -> None:
        """Observed cost of one uncached row scan (the store's
        record_query feeds this): the baseline a composition must beat.
        Samples taken during a composition's own union scan are ignored —
        they measure edge strips, not the plain scan being replaced."""
        if getattr(self._scanning, "active", False):
            return
        with self._lock:
            self._scan_s[type_name] = ewma_step(
                self._scan_s.get(type_name), seconds, _EWMA_ALPHA
            )

    def _note_compose(self, type_name: str, seconds: float) -> None:
        with self._lock:
            self._compose_s[type_name] = ewma_step(
                self._compose_s.get(type_name), seconds, _EWMA_ALPHA
            )
            self._gate_locked(type_name).note_trial()

    def _gate_locked(self, type_name: str) -> ProbeGate:
        gate = self._probe.get(type_name)
        if gate is None:
            gate = self._probe[type_name] = ProbeGate(
                _EXPLORE_MIN, _REPROBE_EVERY
            )
        return gate

    def worth_composing(self, type_name: str) -> bool:
        """The gate: True until _EXPLORE_MIN compositions are measured,
        then only while composing beats the measured plain scan — with a
        re-exploration every _REPROBE_EVERY gated attempts. Gating is a
        pure perf decision; composed answers stay exact either way."""
        with self._lock:
            gate = self._gate_locked(type_name)
            if gate.exploring:
                return True
            scan = self._scan_s.get(type_name)
            comp = self._compose_s.get(type_name)
            if scan is None or comp is None or comp <= scan:
                return True
            if gate.block():
                return True
            self.metrics.counter("geomesa.cache.tile.gated")
            return False

    def invalidate_type(self, type_name: str) -> int:
        with self._lock:
            doomed = [k for k in self._tiles if k[0] == type_name]
            for k in doomed:
                del self._tiles[k]
            if doomed:
                self.metrics.counter(
                    "geomesa.cache.tile.invalidation", len(doomed)
                )
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._tiles.clear()

    # -- composition -----------------------------------------------------
    def compose(self, store, type_name: str, box) -> Optional[TileComposition]:
        """Answer ``bbox(geom) = box`` aggregation by composing cached
        interior tiles with fresh edge scans, or None when the bbox has no
        interior tiles at this resolution (too small) or too many (the
        caller's plain scan wins). ``box`` is a filter.predicates.BBox the
        CALLER already vetted (point schema, no visibility/interceptors).
        """
        t0 = time.perf_counter()
        tick0 = self.generations.tick()
        qx0, qy0 = float(box.xmin), float(box.ymin)
        qx1, qy1 = float(box.xmax), float(box.ymax)
        xe, ye = self._xe, self._ye
        # interior tile index span: tiles [i0, i1) x [j0, j1) lie fully
        # inside the query box (their edges within [q0, q1])
        i0 = int(np.searchsorted(xe, qx0, side="left"))
        i1 = int(np.searchsorted(xe, qx1, side="right")) - 1
        j0 = int(np.searchsorted(ye, qy0, side="left"))
        j1 = int(np.searchsorted(ye, qy1, side="right")) - 1
        if i1 <= i0 or j1 <= j0:
            return None
        n_tiles = (i1 - i0) * (j1 - j0)
        if n_tiles > self.conf.max_tiles_per_query:
            return None

        with self._lock:
            missing = []
            parts = []  # (count, xmin, ymin, xmax, ymax)
            for i in range(i0, i1):
                for j in range(j0, j1):
                    agg = self._probe_locked((type_name, i, j))
                    if agg is None:
                        missing.append((i, j))
                    elif agg.count:
                        parts.append(
                            (agg.count, agg.xmin, agg.ymin, agg.xmax, agg.ymax)
                        )
        reused = n_tiles - len(missing)
        probe_s = time.perf_counter() - t0

        # ONE fresh scan covers both the edge strips AND the missing-tile
        # cover (separate queries would each pay the fixed plan+dispatch
        # cost and lose to the single plain scan they replace)
        parts.extend(self._scan_and_fill(
            store, type_name, box.prop, missing, qx0, qy0, qx1, qy1,
            float(xe[i0]), float(ye[j0]), float(xe[i1]), float(ye[j1]),
        ))

        if self.generations.stale(
            type_name,
            KeyRange(boxes=((qx0, qy0, qx1, qy1),), interval=None),
            tick0,
        ):
            # a write landed mid-composition: the interior came from
            # pre-write tiles, the edge scan already saw the write — the
            # total would match NO store state. Discard; the caller's
            # plain scan answers (mirrors ResultCache._admit's re-check)
            self.metrics.counter("geomesa.cache.tile.reject")
            return None

        count = sum(p[0] for p in parts)
        bounds = None
        if count:
            bounds = (
                min(p[1] for p in parts), min(p[2] for p in parts),
                max(p[3] for p in parts), max(p[4] for p in parts),
            )
        self.metrics.counter("geomesa.cache.tile.reused", reused)
        self.metrics.counter("geomesa.cache.tile.filled", len(missing))
        self._note_compose(type_name, time.perf_counter() - t0)
        return TileComposition(
            count=count, bounds=bounds, tiles_total=n_tiles,
            tiles_reused=reused, tiles_filled=len(missing), probe_s=probe_s,
        )

    def _scan_and_fill(
        self, store, type_name, geom_field, missing,
        qx0, qy0, qx1, qy1, ix0, iy0, ix1, iy1,
    ) -> list:
        """The single fresh scan of one composition: a union row query
        over the <= 4 closed edge strips plus (when tiles are missing) the
        missing tiles' covering rectangle. Returned rows partition by
        half-open interior membership — interior rows bin into per-tile
        aggregates (cached; the missing ones contribute parts), the rest
        are the edge aggregate. Returns the non-empty parts."""
        from geomesa_tpu_torch.filter.predicates import BBox, Or
        from geomesa_tpu_torch.planning.hints import QueryHints

        xe, ye = self._xe, self._ye
        rects = [
            r for r in _strips(qx0, qy0, qx1, qy1, ix0, iy0, ix1, iy1)
            if r[2] >= r[0] and r[3] >= r[1]
        ]
        cover = None
        tick = 0
        if missing:
            tick = self.generations.tick()
            mi0 = min(i for i, _ in missing)
            mi1 = max(i for i, _ in missing) + 1
            mj0 = min(j for _, j in missing)
            mj1 = max(j for _, j in missing) + 1
            cover = (
                float(xe[mi0]), float(ye[mj0]), float(xe[mi1]), float(ye[mj1])
            )
            rects.append(cover)
        if not rects:
            return []
        boxes = [BBox(geom_field, x0, y0, x1, y1) for x0, y0, x1, y1 in rects]
        self._scanning.active = True
        try:
            rows = store.query(
                type_name,
                boxes[0] if len(boxes) == 1 else Or(boxes),
                hints=QueryHints(cache="bypass"),
            )
        finally:
            self._scanning.active = False
        if len(rows):
            x, y = rows.representative_xy()
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        else:
            x = y = np.zeros(0, np.float64)

        parts = []
        interior = (x >= ix0) & (x < ix1) & (y >= iy0) & (y < iy1)
        c = _accumulate(x[~interior], y[~interior])
        if c[0]:
            parts.append(c)
        if missing:
            # half-open membership: rows exactly on the cover's hi edges
            # belong to the NEXT tile out (cached, already counted)
            keep = (
                interior
                & (x >= cover[0]) & (x < cover[2])
                & (y >= cover[1]) & (y < cover[3])
            )
            fx, fy = x[keep], y[keep]
            bi = np.searchsorted(xe, fx, side="right") - 1
            bj = np.searchsorted(ye, fy, side="right") - 1
            missing_set = set(missing)
            with self._lock:
                for i in range(mi0, mi1):
                    for j in range(mj0, mj1):
                        m = (bi == i) & (bj == j)
                        cc = _accumulate(fx[m], fy[m])
                        self._store_locked(
                            (type_name, i, j), TileAggregate(*cc, tick)
                        )
                        if cc[0] and (i, j) in missing_set:
                            parts.append(cc)
        return parts


def _strips(qx0, qy0, qx1, qy1, ix0, iy0, ix1, iy1):
    """The <= 4 CLOSED edge strips whose union covers (closed query box)
    minus (half-open interior [ix0, ix1) x [iy0, iy1)). Closed strips may
    overlap at seams and catch interior-boundary rows; the single union
    scan counts each row once and _scan_and_fill masks interior members
    out, so the edge set is exactly the closed box minus the interior."""
    out = []
    if qx0 < ix0:
        out.append((qx0, qy0, ix0, qy1))     # left
    if ix1 <= qx1:
        out.append((ix1, qy0, qx1, qy1))     # right (closed at ix1)
    if qy0 < iy0:
        out.append((ix0, qy0, ix1, iy0))     # bottom
    if iy1 <= qy1:
        out.append((ix0, iy1, ix1, qy1))     # top (closed at iy1)
    return out
