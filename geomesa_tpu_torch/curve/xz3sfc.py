"""XZ3: 3-D XZ-ordering over (lon, lat, time-offset) boxes.

The port's copy of geomesa_tpu/curve/xz3sfc.py (numpy paths); parity with
the reference's XZ3SFC
(geomesa-z3/src/main/scala/org/locationtech/geomesa/curve/XZ3SFC.scala):
geometries with extent plus a time dimension, per time bin (the bin is a
separate key prefix, as in Z3). Default precision g=12.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from geomesa_tpu_torch.curve.binnedtime import MAX_OFFSET, TimePeriod
from geomesa_tpu_torch.curve.xzsfc import XElement, XZSFC
from geomesa_tpu_torch.curve.zranges import IndexRange

_INSTANCES: dict[tuple[int, TimePeriod], "XZ3SFC"] = {}


class XZ3SFC:
    def __init__(self, period: "TimePeriod | str" = TimePeriod.WEEK, g: int = 12):
        self.period = TimePeriod.parse(period)
        self.g = g
        self.core = XZSFC(g, dims=3)
        self.xmin, self.xmax = -180.0, 180.0
        self.ymin, self.ymax = -90.0, 90.0
        self.tmin, self.tmax = 0.0, float(MAX_OFFSET[self.period])

    @staticmethod
    def for_period(period: "TimePeriod | str", g: int = 12) -> "XZ3SFC":
        p = TimePeriod.parse(period)
        key = (g, p)
        if key not in _INSTANCES:
            _INSTANCES[key] = XZ3SFC(p, g)
        return _INSTANCES[key]

    def _norm(self, x, lo, hi):
        return np.clip((np.asarray(x, dtype=np.float64) - lo) / (hi - lo), 0.0, 1.0)

    def index(self, xmin, ymin, tmin, xmax, ymax, tmax) -> np.ndarray:
        lo = np.stack(
            [
                self._norm(xmin, self.xmin, self.xmax),
                self._norm(ymin, self.ymin, self.ymax),
                self._norm(tmin, self.tmin, self.tmax),
            ],
            axis=-1,
        )
        hi = np.stack(
            [
                self._norm(xmax, self.xmin, self.xmax),
                self._norm(ymax, self.ymin, self.ymax),
                self._norm(tmax, self.tmin, self.tmax),
            ],
            axis=-1,
        )
        return self.core.index(np.atleast_2d(lo), np.atleast_2d(hi))

    def ranges(
        self,
        bounds: Sequence[tuple[float, float, float, float, float, float]],
        max_ranges: int | None = None,
    ) -> list[IndexRange]:
        """bounds: (xmin, ymin, tmin, xmax, ymax, tmax) tuples."""
        queries = [
            XElement(
                (
                    float(self._norm(b[0], self.xmin, self.xmax)),
                    float(self._norm(b[1], self.ymin, self.ymax)),
                    float(self._norm(b[2], self.tmin, self.tmax)),
                ),
                (
                    float(self._norm(b[3], self.xmin, self.xmax)),
                    float(self._norm(b[4], self.ymin, self.ymax)),
                    float(self._norm(b[5], self.tmin, self.tmax)),
                ),
            )
            for b in bounds
        ]
        return self.core.ranges(queries, max_ranges=max_ranges)
