"""Z3: 3-D space-filling curve over (lon, lat, time-offset) points.

The port's copy of geomesa_tpu/curve/z3sfc.py (reference geomesa-z3
Z3SFC.scala:37-84): 21 bits per dimension; the time dimension spans the
offset range of one time bin.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from geomesa_tpu_torch.curve.binnedtime import MAX_OFFSET, TimePeriod
from geomesa_tpu_torch.curve.normalize import NormalizedLat, NormalizedLon, NormalizedTime
from geomesa_tpu_torch.curve.zorder import Z3
from geomesa_tpu_torch.curve.zranges import IndexRange, ZBox, zranges

_INSTANCES: dict[TimePeriod, "Z3SFC"] = {}


class Z3SFC:
    def __init__(self, period: "TimePeriod | str" = TimePeriod.WEEK, precision: int = 21):
        self.period = TimePeriod.parse(period)
        self.precision = precision
        self.lon = NormalizedLon(precision)
        self.lat = NormalizedLat(precision)
        self.time = NormalizedTime(precision, float(MAX_OFFSET[self.period]))

    @staticmethod
    def for_period(period: "TimePeriod | str") -> "Z3SFC":
        p = TimePeriod.parse(period)
        if p not in _INSTANCES:
            _INSTANCES[p] = Z3SFC(p)
        return _INSTANCES[p]

    def index(self, x, y, t) -> np.ndarray:
        """(lon, lat, offset) -> z (vectorized). Reference Z3SFC.index:37."""
        return Z3.index(
            self.lon.normalize(x).astype(np.uint64),
            self.lat.normalize(y).astype(np.uint64),
            self.time.normalize(t).astype(np.uint64),
        )

    def normalize(self, x, y, t):
        """(lon, lat, offset) -> int ordinals for the device columns."""
        return (
            self.lon.normalize(x).astype(np.int64),
            self.lat.normalize(y).astype(np.int64),
            self.time.normalize(t).astype(np.int64),
        )

    def invert(self, z):
        """z -> (lon, lat, offset) of the cell centres."""
        xi, yi, ti = Z3.decode(z)
        return (
            self.lon.denormalize(xi.astype(np.int64)),
            self.lat.denormalize(yi.astype(np.int64)),
            self.time.denormalize(ti.astype(np.int64)),
        )

    def ranges(
        self,
        bounds: Sequence[tuple[float, float, float, float]],
        times: Sequence[tuple[float, float]],
        max_ranges: int | None = None,
        max_recurse: int | None = None,
        inner: bool = False,
    ) -> list[IndexRange]:
        """Covering z-ranges for spatial boxes x time-offset windows.

        Reference Z3SFC.ranges:59-67 — the cartesian product of spatial
        bounds and (in-bin) time windows becomes one ZBox each.

        ``inner=True`` additionally classifies containment against ordinals
        shrunk 2 cells inward per dimension, making contained-range rows
        certain f64 hits (ScanConfig.contained_exact). The 2-cell margin
        absorbs normalize() floor rounding on both the query bounds and the
        stored values.
        """
        boxes = []
        inner_boxes: list[ZBox] | None = [] if inner else None
        for (xmin, ymin, xmax, ymax) in bounds:
            if xmin > xmax or ymin > ymax:
                raise ValueError(f"inverted bbox: {(xmin, ymin, xmax, ymax)}")
            for (tmin, tmax) in times:
                if tmin > tmax:
                    raise ValueError(f"inverted time window: {(tmin, tmax)}")
                lo = (
                    int(self.lon.normalize(xmin)),
                    int(self.lat.normalize(ymin)),
                    int(self.time.normalize(tmin)),
                )
                hi = (
                    int(self.lon.normalize(xmax)),
                    int(self.lat.normalize(ymax)),
                    int(self.time.normalize(tmax)),
                )
                boxes.append(ZBox(lo, hi))
                if inner:
                    inner_boxes.append(
                        ZBox(tuple(v + 2 for v in lo), tuple(max(v - 2, 0) for v in hi))
                    )
        return zranges(
            Z3, boxes, max_ranges=max_ranges, max_recurse=max_recurse,
            inner_boxes=inner_boxes,
        )
