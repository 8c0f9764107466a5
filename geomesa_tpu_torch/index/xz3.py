"""XZ3 index: extent geometries with time.

The port's copy of geomesa_tpu/index/xz3.py (reference XZ3IndexKeySpace,
geomesa-index-api): keys are (time bin, xz3 code of (bbox, time-offset)).
Like XZ2 the device test is bbox-intersects plus the (bin, offset) time
windows; exact geometry refinement happens host-side on candidates.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.curve.binnedtime import BinnedTime, TimePeriod
from geomesa_tpu_torch.curve.xz3sfc import XZ3SFC
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.extract import extract_geometries, extract_intervals, geometry_bounds
from geomesa_tpu_torch.filter.predicates import Filter
from geomesa_tpu_torch.index.api import ScanConfig, WriteKeys, widen_boxes
from geomesa_tpu_torch.index.z3 import WHOLE_WORLD, clamp_bins
from geomesa_tpu_torch.sft import FeatureType


class XZ3Index:
    """Spatio-temporal extent index."""

    def __init__(self, sft: FeatureType):
        self.sft = sft
        self.name = "xz3"
        self.geom = sft.geom_field
        self.dtg = sft.dtg_field
        self.period = TimePeriod.parse(sft.z3_interval)
        self.sfc = XZ3SFC.for_period(self.period, sft.xz_precision)
        self.binner = BinnedTime(self.period)
        self.bin_range = None  # (min, max) time bins present; see clamp_bins

    def supports(self, sft: FeatureType) -> bool:
        return (
            not sft.is_points
            and sft.geom_field is not None
            and sft.dtg_field is not None
        )

    def write_keys(self, fc: FeatureCollection) -> WriteKeys:
        col = fc.columns[self.geom]
        if not isinstance(col, geo.PackedGeometryColumn):
            raise TypeError("xz3 index requires a packed geometry column")
        millis = np.asarray(fc.columns[self.dtg], dtype=np.int64)
        binned = self.binner.to_binned(millis)
        b = col.bboxes.astype(np.float64)
        t = binned.offset.astype(np.float64)
        z = self.sfc.index(b[:, 0], b[:, 1], t, b[:, 2], b[:, 3], t)
        return WriteKeys(
            bins=binned.bin.astype(np.int32),
            zs=z.astype(np.uint64),
            device_cols={
                "gxmin": col.bboxes[:, 0],
                "gymin": col.bboxes[:, 1],
                "gxmax": col.bboxes[:, 2],
                "gymax": col.bboxes[:, 3],
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
        los = np.concatenate(lo_list)
        his = np.concatenate(hi_list)
        windows = np.stack([bins, los, his], axis=1).astype(np.int64)

        range_bins, range_lo, range_hi = [], [], []
        for lo_off, hi_off in set(zip(los.tolist(), his.tolist())):
            xz_bounds = [
                (x0, y0, float(lo_off), x1, y1, float(hi_off))
                for (x0, y0, x1, y1) in bounds
            ]
            ranges = self.sfc.ranges(xz_bounds)
            if not ranges:
                continue
            rlo = np.array([r.lower for r in ranges], dtype=np.uint64)
            rhi = np.array([r.upper for r in ranges], dtype=np.uint64)
            for b in bins[(los == lo_off) & (his == hi_off)]:
                range_bins.append(np.full(len(rlo), b, dtype=np.int32))
                range_lo.append(rlo)
                range_hi.append(rhi)
        if not range_bins:
            return ScanConfig.empty(self.name)
        return ScanConfig(
            index=self.name,
            range_bins=np.concatenate(range_bins),
            range_lo=np.concatenate(range_lo),
            range_hi=np.concatenate(range_hi),
            boxes=None if no_geom else widen_boxes(bounds),
            windows=windows.astype(np.int32),
            extent_mode=True,
            geom_precise=False,
            time_precise=intervals.precise,
        )
