"""XZ2 index: extent geometries (lines/polygons), spatial only.

The port's copy of geomesa_tpu/index/xz2.py (reference XZ2IndexKeySpace,
geomesa-index-api). Keys are XZ sequence codes of each geometry's bbox;
the device predicate is a bbox-*intersects* test over the per-geometry
f32 bbox columns (the packed geometry column stores them widened one ulp
outward), with exact geometry refinement of every candidate on the host,
the loose-vs-exact split of the reference (Z3IndexKeySpace.scala:240-254).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.curve.xz2sfc import XZ2SFC
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.extract import extract_geometries, geometry_bounds
from geomesa_tpu_torch.filter.predicates import Filter
from geomesa_tpu_torch.index.api import ScanConfig, WriteKeys, widen_boxes
from geomesa_tpu_torch.sft import FeatureType


class XZ2Index:
    """Spatial-only extent index."""

    def __init__(self, sft: FeatureType):
        self.sft = sft
        self.name = "xz2"
        self.geom = sft.geom_field
        self.sfc = XZ2SFC.for_precision(sft.xz_precision)

    def supports(self, sft: FeatureType) -> bool:
        return not sft.is_points and sft.geom_field is not None

    def write_keys(self, fc: FeatureCollection) -> WriteKeys:
        col = fc.columns[self.geom]
        if not isinstance(col, geo.PackedGeometryColumn):
            raise TypeError("xz2 index requires a packed geometry column")
        b = col.bboxes.astype(np.float64)
        z = self.sfc.index(b[:, 0], b[:, 1], b[:, 2], b[:, 3])
        n = len(col)
        return WriteKeys(
            bins=np.zeros(n, dtype=np.int32),
            zs=z.astype(np.uint64),
            device_cols={
                "gxmin": col.bboxes[:, 0],
                "gymin": col.bboxes[:, 1],
                "gxmax": col.bboxes[:, 2],
                "gymax": col.bboxes[:, 3],
            },
        )

    def scan_config(self, f: Filter) -> Optional[ScanConfig]:
        geoms = extract_geometries(f, self.geom)
        if geoms.disjoint:
            return ScanConfig.empty(self.name)
        if not geoms.values:
            return None
        bounds = geometry_bounds(geoms)
        ranges = self.sfc.ranges(bounds)
        if not ranges:
            return ScanConfig.empty(self.name)
        return ScanConfig(
            index=self.name,
            range_bins=np.zeros(len(ranges), dtype=np.int32),
            range_lo=np.array([r.lower for r in ranges], dtype=np.uint64),
            range_hi=np.array([r.upper for r in ranges], dtype=np.uint64),
            boxes=widen_boxes(bounds),
            windows=None,
            extent_mode=True,
            geom_precise=False,  # bbox-intersects is never exact for extents
        )
