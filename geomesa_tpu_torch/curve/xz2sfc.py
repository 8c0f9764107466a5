"""XZ2: 2-D XZ-ordering over (lon, lat) boxes — polygons/lines with extent.

The port's copy of geomesa_tpu/curve/xz2sfc.py (numpy paths); parity with
the reference's XZ2SFC
(geomesa-z3/src/main/scala/org/locationtech/geomesa/curve/XZ2SFC.scala).
Default precision g=12 matches the reference's default XZ precision.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from geomesa_tpu_torch.curve.xzsfc import XElement, XZSFC
from geomesa_tpu_torch.curve.zranges import IndexRange

_INSTANCES: dict[int, "XZ2SFC"] = {}


class XZ2SFC:
    def __init__(self, g: int = 12):
        self.g = g
        self.core = XZSFC(g, dims=2)
        self.xmin, self.xmax = -180.0, 180.0
        self.ymin, self.ymax = -90.0, 90.0

    @staticmethod
    def for_precision(g: int = 12) -> "XZ2SFC":
        if g not in _INSTANCES:
            _INSTANCES[g] = XZ2SFC(g)
        return _INSTANCES[g]

    def _norm(self, x, lo, hi):
        return np.clip((np.asarray(x, dtype=np.float64) - lo) / (hi - lo), 0.0, 1.0)

    def index(self, xmin, ymin, xmax, ymax) -> np.ndarray:
        """Bounding boxes (vectorized) -> XZ2 codes. Reference XZ2SFC.index:54."""
        lo = np.stack(
            [self._norm(xmin, self.xmin, self.xmax), self._norm(ymin, self.ymin, self.ymax)],
            axis=-1,
        )
        hi = np.stack(
            [self._norm(xmax, self.xmin, self.xmax), self._norm(ymax, self.ymin, self.ymax)],
            axis=-1,
        )
        return self.core.index(np.atleast_2d(lo), np.atleast_2d(hi))

    def ranges(
        self,
        bounds: Sequence[tuple[float, float, float, float]],
        max_ranges: int | None = None,
    ) -> list[IndexRange]:
        queries = [
            XElement(
                (float(self._norm(b[0], self.xmin, self.xmax)), float(self._norm(b[1], self.ymin, self.ymax))),
                (float(self._norm(b[2], self.xmin, self.xmax)), float(self._norm(b[3], self.ymin, self.ymax))),
            )
            for b in bounds
        ]
        return self.core.ranges(queries, max_ranges=max_ranges)
