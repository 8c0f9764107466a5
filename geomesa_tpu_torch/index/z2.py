"""Z2 index: z-order keys for point features, no time dimension.

The port's copy of geomesa_tpu/index/z2.py (reference Z2IndexKeySpace.scala
and Z2Filter.scala). Bin is constant 0 so the sorted table is ordered
purely by z2. A single polygon filter rides the scan kernel's
point-in-polygon and raster legs; where a raster exists, the z-ranges come
from it (full cells contained, out cells inside the bbox pruned).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from geomesa_tpu_torch import native
from geomesa_tpu_torch.curve.z2sfc import Z2SFC
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.extract import extract_geometries, geometry_bounds
from geomesa_tpu_torch.filter.predicates import Filter, PointColumn
from geomesa_tpu_torch.index.api import (
    ScanConfig, WriteKeys, shrink_boxes, widen_boxes,
)
from geomesa_tpu_torch.index.z3 import _bounds_only, _polygon_legs
from geomesa_tpu_torch.sft import FeatureType


class Z2Index:
    """Spatial-only point index."""

    def __init__(self, sft: FeatureType):
        self.sft = sft
        self.name = "z2"
        self.geom = sft.geom_field
        self.sfc = Z2SFC()

    def supports(self, sft: FeatureType) -> bool:
        return sft.is_points

    def write_keys(self, fc: FeatureCollection) -> WriteKeys:
        col = fc.columns[self.geom]
        if not isinstance(col, PointColumn):
            raise TypeError("z2 index requires a point geometry column")
        fused = native.z2_write_keys(col.x, col.y)
        if fused is not None:
            z, device_cols = fused
            return WriteKeys(bins=np.zeros(len(col), dtype=np.int32), zs=z, device_cols=device_cols)
        z = self.sfc.index(col.x, col.y)
        return WriteKeys(
            bins=np.zeros(len(col), dtype=np.int32),
            zs=z.astype(np.uint64),
            device_cols={
                "x": col.x.astype(np.float32),
                "y": col.y.astype(np.float32),
            },
        )

    def scan_config(self, f: Filter) -> Optional[ScanConfig]:
        geoms = extract_geometries(f, self.geom)
        if geoms.disjoint:
            return ScanConfig.empty(self.name)
        if not geoms.values:
            return None  # no spatial constraint: a z2 scan would be full-table
        bounds = geometry_bounds(geoms)
        bounds_exact = geoms.precise and _bounds_only(geoms.values)
        poly, rast, approx = (None, None, None) if bounds_exact else _polygon_legs(geoms)
        if approx is not None:
            # raster-derived z-ranges: full cells emit contained ranges
            # (full-cell containment implies membership, margin-safe at
            # f64), partial cells overlap ranges, out cells inside the
            # bbox nothing. The Z2-aligned grid makes every cell one
            # contiguous z-range.
            from geomesa_tpu_torch.conf import SCAN_RANGES_TARGET

            rlo, rhi, rcont = approx.zranges(max_ranges=SCAN_RANGES_TARGET.get())
            if len(rlo) == 0:
                return ScanConfig.empty(self.name)
            return ScanConfig(
                index=self.name,
                range_bins=np.zeros(len(rlo), dtype=np.int32),
                range_lo=rlo,
                range_hi=rhi,
                boxes=widen_boxes(bounds),
                windows=None,
                geom_precise=True,
                range_contained=rcont,
                contained_exact=True,
                boxes_inner=shrink_boxes(bounds),
                poly=poly,
                rast=rast,
            )
        ranges = self.sfc.ranges(bounds, inner=True)
        if not ranges:
            return ScanConfig.empty(self.name)
        return ScanConfig(
            index=self.name,
            range_bins=np.zeros(len(ranges), dtype=np.int32),
            range_lo=np.array([r.lower for r in ranges], dtype=np.uint64),
            range_hi=np.array([r.upper for r in ranges], dtype=np.uint64),
            boxes=widen_boxes(bounds),
            windows=None,
            # the point-in-polygon leg answers polygon queries exactly (the
            # host refines only the uncertainty band); contained-range
            # certainty stays bbox-only
            geom_precise=bool(bounds_exact or poly is not None),
            range_contained=np.array([r.contained for r in ranges], dtype=bool),
            contained_exact=bool(bounds_exact),
            boxes_inner=shrink_boxes(bounds),
            poly=poly,
        )
