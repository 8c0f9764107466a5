"""S2 index (points) and S3 index (points + time bin).

The port's copy of geomesa_tpu/index/s2.py (reference S2IndexKeySpace /
S3IndexKeySpace): the row models of z2 / z3 with the z value replaced
by an S2 cell id (S3 = [2B bin][8B s2]). Enabled per schema through
``geomesa.indices.enabled`` naming "s2" / "s3"; the z-curves stay the
default. Scans take the same kernels as Z2 / Z3 (box and window legs).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from geomesa_tpu_torch.curve.binnedtime import BinnedTime, TimePeriod
from geomesa_tpu_torch.curve.s2 import S2SFC
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.extract import extract_geometries, extract_intervals, geometry_bounds
from geomesa_tpu_torch.filter.predicates import Filter, PointColumn
from geomesa_tpu_torch.index.api import ScanConfig, WriteKeys, widen_boxes
from geomesa_tpu_torch.index.z3 import WHOLE_WORLD, _bounds_only, clamp_bins


class S2Index:
    """Spatial-only point index on the S2 curve."""

    def __init__(self, sft, min_level: int = 0, max_level: int = 30,
                 level_mod: int = 1, max_cells: int = 2000):
        self.sft = sft
        self.name = "s2"
        self.geom = sft.geom_field
        self.sfc = S2SFC(min_level, max_level, level_mod, max_cells)

    def supports(self, sft) -> bool:
        return sft.is_points

    def write_keys(self, fc: FeatureCollection) -> WriteKeys:
        col = fc.columns[self.geom]
        if not isinstance(col, PointColumn):
            raise TypeError("s2 index requires a point geometry column")
        z = self.sfc.index(col.x, col.y)
        n = len(col)
        return WriteKeys(
            bins=np.zeros(n, dtype=np.int32),
            zs=z,
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
            geom_precise=geoms.precise and _bounds_only(geoms.values),
        )


class S3Index:
    """Spatio-temporal point index: (time bin, s2 cell)."""

    def __init__(self, sft, **s2_kwargs):
        self.sft = sft
        self.name = "s3"
        self.geom = sft.geom_field
        self.dtg = sft.dtg_field
        self.period = TimePeriod.parse(sft.z3_interval)
        self.sfc = S2SFC(**s2_kwargs)
        self.binner = BinnedTime(self.period)
        self.bin_range = None  # (min, max) time bins present; see clamp_bins

    def supports(self, sft) -> bool:
        return sft.is_points and sft.dtg_field is not None

    def write_keys(self, fc: FeatureCollection) -> WriteKeys:
        col = fc.columns[self.geom]
        if not isinstance(col, PointColumn):
            raise TypeError("s3 index requires a point geometry column")
        millis = np.asarray(fc.columns[self.dtg], dtype=np.int64)
        binned = self.binner.to_binned(millis)
        z = self.sfc.index(col.x, col.y)
        return WriteKeys(
            bins=binned.bin.astype(np.int32),
            zs=z,
            device_cols={
                "x": col.x.astype(np.float32),
                "y": col.y.astype(np.float32),
                "tbin": binned.bin.astype(np.int32),
                "toff": binned.offset.astype(np.int32),
            },
        )

    def scan_config(self, f: Filter) -> Optional[ScanConfig]:
        if self.dtg is None:
            return None
        geoms = extract_geometries(f, self.geom)
        intervals = extract_intervals(f, self.dtg)
        if geoms.disjoint or intervals.disjoint:
            return ScanConfig.empty(self.name)
        if not intervals.values:
            return None
        # no spatial constraint -> boxes=None: the scan projects x/y away
        no_geom = not geoms.values
        bounds = geometry_bounds(geoms) if geoms.values else [WHOLE_WORLD]
        ranges = self.sfc.ranges(bounds)
        if not ranges:
            return ScanConfig.empty(self.name)
        rlo = np.array([r.lower for r in ranges], dtype=np.uint64)
        rhi = np.array([r.upper for r in ranges], dtype=np.uint64)

        bins_list, lo_list, hi_list = [], [], []
        for iv in intervals.values:
            b, lo, hi = self.binner.bins_for_interval(iv.lo, iv.hi - 1)
            b, (lo, hi) = clamp_bins(self.bin_range, b, lo, hi)
            if len(b) == 0:
                continue
            bins_list.append(b)
            lo_list.append(lo)
            hi_list.append(hi)
        if not bins_list:
            return ScanConfig.empty(self.name)
        bins = np.concatenate(bins_list)
        windows = np.stack(
            [bins, np.concatenate(lo_list), np.concatenate(hi_list)], axis=1
        ).astype(np.int32)

        # the s2 ranges are bin-independent: replicate per bin
        range_bins = np.repeat(bins, len(rlo)).astype(np.int32)
        range_lo = np.tile(rlo, len(bins))
        range_hi = np.tile(rhi, len(bins))
        return ScanConfig(
            index=self.name,
            range_bins=range_bins,
            range_lo=range_lo,
            range_hi=range_hi,
            boxes=None if no_geom else widen_boxes(bounds),
            windows=windows,
            geom_precise=geoms.precise and _bounds_only(geoms.values),
            time_precise=intervals.precise,
        )
