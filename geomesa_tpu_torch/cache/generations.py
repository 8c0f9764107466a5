"""Generation-based cache invalidation: per-(schema, key-range) counters.

The port's copy of geomesa_tpu/cache/generations.py, the correctness
backbone of the cache tier: every mutation path (DataStore write,
upsert, delete, modify, age-off and the fold, the adapter's table
rebuilds, and persist.load's reload and quarantines) bumps a generation
over the key range it touched. A cached entry records the tracker's tick
at fill time plus the key range its filter covers; a lookup serves the
entry only when no overlapping bump happened since, so stale results
cannot be served (GeoBlocks invalidates curve-tile aggregates the same
way; arXiv:1908.07753 §4.2).

Ranges are tracked per axis on coarse grids: a fixed world grid of
spatial cells and 28-day time buckets (the persistence tier's partition
width, so a quarantined partition maps to exactly one bucket). Per-axis
tracking is conservative: an entry is invalidated when bumps overlap it
on both axes even if no single bump overlapped jointly; over-invalidation
costs a scan, never a wrong answer. A bump with an unknown range
(``bounds=None`` / ``time_range=None``) covers the whole axis.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

# spatial grid: 64 x 32 world cells (5.625 x 5.625 degrees)
GRID_X = 64
GRID_Y = 32
# time buckets align with the persistence partition scheme so quarantine
# invalidation maps 1:1 onto damaged partition files
BUCKET_MS = 28 * 86_400_000
# a bump spanning more buckets than this collapses to a whole-axis bump
# (bounds the bucket dict for pathological time ranges)
_MAX_BUCKET_SPAN = 4096


@dataclass(frozen=True)
class KeyRange:
    """The (space, time) region a cached entry's filter constrains.

    - ``boxes``: (xmin, ymin, xmax, ymax) tuples the filter's spatial
      predicates cover, or None when the filter does not bound space
      (covers everything on that axis)
    - ``interval``: (lo_ms, hi_ms) the temporal predicates cover, or None
    """

    boxes: Optional[tuple] = None
    interval: Optional[tuple] = None

    @staticmethod
    def everything() -> "KeyRange":
        return KeyRange(None, None)


def _cell_span(box) -> tuple[int, int, int, int]:
    """Inclusive (i0, i1, j0, j1) grid-cell span of a lon/lat box,
    clipped to the world."""
    x0, y0, x1, y1 = (float(v) for v in box)
    i0 = int(np.clip((x0 + 180.0) / (360.0 / GRID_X), 0, GRID_X - 1))
    i1 = int(np.clip((x1 + 180.0) / (360.0 / GRID_X), 0, GRID_X - 1))
    j0 = int(np.clip((y0 + 90.0) / (180.0 / GRID_Y), 0, GRID_Y - 1))
    j1 = int(np.clip((y1 + 90.0) / (180.0 / GRID_Y), 0, GRID_Y - 1))
    return min(i0, i1), max(i0, i1), min(j0, j1), max(j0, j1)


class _TypeGens:
    """Per-feature-type generation state."""

    __slots__ = ("cells", "t_all", "t_buckets", "schema_gen")

    def __init__(self):
        self.cells = np.zeros((GRID_Y, GRID_X), dtype=np.int64)
        self.t_all = 0
        self.t_buckets: dict[int, int] = {}
        self.schema_gen = 0


class GenerationTracker:
    """Monotonic tick + per-type per-axis generation grids. Thread-safe:
    bumps and staleness checks serialize on one lock (both are O(cells)
    numpy ops — nanoseconds next to any scan)."""

    def __init__(self):
        from geomesa_tpu_torch.lockwitness import witness

        self._lock = witness(threading.Lock(), "GenerationTracker._lock")
        self._tick = 0                            # guarded-by: _lock
        self._types: dict[str, _TypeGens] = {}    # guarded-by: _lock

    def tick(self) -> int:
        """The current global tick — snapshot BEFORE computing a result
        that will be cached, so a racing write invalidates the fill.
        Lock-free read: a stale tick only makes the admission check
        conservative (the fill is rejected, never wrongly kept)."""
        return self._tick

    def _gens_locked(self, type_name: str) -> _TypeGens:
        g = self._types.get(type_name)
        if g is None:
            g = self._types[type_name] = _TypeGens()
        return g

    # -- write side ------------------------------------------------------
    def bump(
        self,
        type_name: str,
        bounds: Optional[tuple] = None,
        time_range: Optional[tuple] = None,
    ) -> int:
        """Record a mutation over ``bounds`` (xmin, ymin, xmax, ymax) and
        ``time_range`` (lo_ms, hi_ms); None = the whole axis. Returns the
        new tick."""
        with self._lock:
            self._tick += 1
            g = self._gens_locked(type_name)
            if bounds is None:
                g.cells[:] = self._tick
            else:
                i0, i1, j0, j1 = _cell_span(bounds)
                g.cells[j0 : j1 + 1, i0 : i1 + 1] = self._tick
            if time_range is None:
                g.t_all = self._tick
            else:
                b0, b1 = int(time_range[0]) // BUCKET_MS, int(time_range[1] - 1) // BUCKET_MS
                if b1 - b0 > _MAX_BUCKET_SPAN:
                    g.t_all = self._tick
                else:
                    for b in range(b0, b1 + 1):
                        g.t_buckets[b] = self._tick
            return self._tick

    def bump_schema(self, type_name: str) -> None:
        """Schema dropped/replaced: every entry for the type is stale
        regardless of range, and the schema generation (part of every
        fingerprint) changes so even identical future specs re-key."""
        with self._lock:
            self._tick += 1
            g = self._gens_locked(type_name)
            g.schema_gen = self._tick
            g.cells[:] = self._tick
            g.t_all = self._tick

    def schema_gen(self, type_name: str) -> int:
        g = self._types.get(type_name)
        return g.schema_gen if g is not None else 0

    # -- read side -------------------------------------------------------
    def stale(self, type_name: str, key_range: KeyRange, tick: int) -> bool:
        """True when a bump newer than ``tick`` overlaps ``key_range`` on
        BOTH axes (see module docstring for why per-axis is safe)."""
        with self._lock:
            g = self._types.get(type_name)
            if g is None:
                return False
            # spatial axis
            if key_range.boxes is None:
                s_gen = int(g.cells.max())
            else:
                s_gen = 0
                for box in key_range.boxes:
                    i0, i1, j0, j1 = _cell_span(box)
                    sub = g.cells[j0 : j1 + 1, i0 : i1 + 1]
                    if sub.size:
                        s_gen = max(s_gen, int(sub.max()))
            if s_gen <= tick:
                return False
            # temporal axis
            t_gen = g.t_all
            if key_range.interval is None:
                if g.t_buckets:
                    t_gen = max(t_gen, max(g.t_buckets.values()))
            else:
                lo, hi = key_range.interval
                b0, b1 = int(lo) // BUCKET_MS, int(hi - 1) // BUCKET_MS
                for b, v in g.t_buckets.items():
                    if b0 <= b <= b1:
                        t_gen = max(t_gen, v)
            return t_gen > tick


def key_range_of(f, sft) -> KeyRange:
    """The KeyRange a filter constrains, extracted from its spatial and
    temporal predicates (geomesa_tpu_torch.filter.extract). Extraction is
    conservative: anything unextractable widens to the whole axis."""
    from geomesa_tpu_torch.filter.extract import (
        extract_geometries, extract_intervals, geometry_bounds,
    )

    boxes = None
    if sft.geom_field is not None:
        try:
            gv = extract_geometries(f, sft.geom_field)
            if gv.values and not gv.disjoint:
                boxes = tuple(tuple(b) for b in geometry_bounds(gv)) or None
        except Exception:
            boxes = None
    interval = None
    if sft.dtg_field is not None:
        try:
            iv = extract_intervals(f, sft.dtg_field)
            if iv.values and not iv.disjoint:
                interval = (
                    min(i.lo for i in iv.values),
                    max(i.hi for i in iv.values),
                )
        except Exception:
            interval = None
    return KeyRange(boxes=boxes, interval=interval)


def mutation_range(fc) -> tuple[Optional[tuple], Optional[tuple]]:
    """(bounds, time_range) covering a mutated batch's rows — what a
    write/delete bumps. Extent geometries use their FULL bboxes (a
    centroid would under-cover and miss invalidations)."""
    if len(fc) == 0:
        return None, None
    from geomesa_tpu_torch.filter.predicates import PointColumn

    bounds = None
    col = fc.geom_column
    if isinstance(col, PointColumn):
        bounds = (
            float(col.x.min()), float(col.y.min()),
            float(col.x.max()), float(col.y.max()),
        )
    elif col is not None and hasattr(col, "bboxes"):
        b = np.asarray(col.bboxes, dtype=np.float64)
        bounds = (
            float(b[:, 0].min()), float(b[:, 1].min()),
            float(b[:, 2].max()), float(b[:, 3].max()),
        )
    time_range = None
    dtg = fc.sft.dtg_field
    if dtg is not None:
        t = np.asarray(fc.columns[dtg], dtype=np.int64)
        time_range = (int(t.min()), int(t.max()) + 1)
    return bounds, time_range
