"""Z2: 2-D space-filling curve over (lon, lat) points.

The port's copy of geomesa_tpu/curve/z2sfc.py (reference geomesa-z3
Z2SFC.scala): 31 bits per dimension over lon [-180,180] / lat [-90,90].
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from geomesa_tpu_torch.curve.normalize import NormalizedLat, NormalizedLon
from geomesa_tpu_torch.curve.zorder import Z2
from geomesa_tpu_torch.curve.zranges import IndexRange, ZBox, zranges


class Z2SFC:
    def __init__(self, precision: int = 31):
        self.precision = precision
        self.lon = NormalizedLon(precision)
        self.lat = NormalizedLat(precision)

    def index(self, x, y) -> np.ndarray:
        """(lon, lat) -> z (vectorized). Reference Z2SFC.index."""
        return Z2.index(self.lon.normalize(x).astype(np.uint64), self.lat.normalize(y).astype(np.uint64))

    def normalize(self, x, y):
        """(lon, lat) -> (x_ord, y_ord) dimension ordinals, the decoded
        columns the device table stores."""
        return (
            self.lon.normalize(x).astype(np.int64),
            self.lat.normalize(y).astype(np.int64),
        )

    def invert(self, z):
        """z -> (lon, lat) of the cell centres."""
        xi, yi = Z2.decode(z)
        return self.lon.denormalize(xi.astype(np.int64)), self.lat.denormalize(yi.astype(np.int64))

    def ranges(
        self,
        bounds: Sequence[tuple[float, float, float, float]],
        max_ranges: int | None = None,
        max_recurse: int | None = None,
        inner: bool = False,
    ) -> list[IndexRange]:
        """Covering z-ranges for (xmin, ymin, xmax, ymax) boxes.

        Boxes must be axis-ordered (min <= max per dimension); callers split
        antimeridian-crossing boxes into two, as the reference's do.
        ``inner=True``: classify containment 2 cells inward so contained
        rows are certain f64 hits (see Z3SFC.ranges).
        """
        boxes = []
        inner_boxes: list[ZBox] | None = [] if inner else None
        for (xmin, ymin, xmax, ymax) in bounds:
            if xmin > xmax or ymin > ymax:
                raise ValueError(f"inverted bbox: {(xmin, ymin, xmax, ymax)}")
            lo = (int(self.lon.normalize(xmin)), int(self.lat.normalize(ymin)))
            hi = (int(self.lon.normalize(xmax)), int(self.lat.normalize(ymax)))
            boxes.append(ZBox(lo, hi))
            if inner:
                inner_boxes.append(
                    ZBox(tuple(v + 2 for v in lo), tuple(max(v - 2, 0) for v in hi))
                )
        return zranges(
            Z2, boxes, max_ranges=max_ranges, max_recurse=max_recurse,
            inner_boxes=inner_boxes,
        )
