"""Attribute index: lexicoded attribute value keys + spatio-temporal
secondary device columns.

The port's copy of geomesa_tpu/index/attribute.py (reference
AttributeIndexKey.scala:21-70, AttributeIndexKeySpace.scala). The sort key
is an order-preserving u64 lexicode of the value (utils.lexicode):
searchsorted over the sorted code column prunes to the value range's row
spans, and the reference's secondary tier becomes the device predicate
columns: candidate blocks still carry (x, y) / bbox and (tbin, toff), so
the spatial and temporal parts of the filter mask on the device before
the host gather. Attribute semantics are refined exactly on the host
(string lexicodes collide past 8 bytes; the secondary sort words narrow
the boundary runs).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.index.z3 import _bounds_only, clamp_bins
from geomesa_tpu_torch.curve.binnedtime import BinnedTime, TimePeriod
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.extract import (
    extract_attribute_bounds,
    extract_geometries,
    extract_intervals,
    geometry_bounds,
)
from geomesa_tpu_torch.filter.predicates import Filter, PointColumn
from geomesa_tpu_torch.index.api import ScanConfig, WriteKeys, widen_boxes
from geomesa_tpu_torch.sft import FeatureType
from geomesa_tpu_torch.utils import lexicode


class AttributeIndex:
    """Secondary index over one ``index=true`` attribute."""

    def __init__(self, sft: FeatureType, attr: str):
        self.sft = sft
        self.attr = attr
        self.name = f"attr_{attr}"
        self.attr_type = sft.attr(attr).type
        self._is_string = self.attr_type not in (
            "Integer", "Int", "Long", "Date", "Float", "Double", "Boolean",
        )
        self.geom = sft.geom_field
        self.dtg = sft.dtg_field
        self.binner = (
            BinnedTime(TimePeriod.parse(sft.z3_interval)) if self.dtg else None
        )
        self.bin_range = None  # (min, max) time bins present; see clamp_bins

    def supports(self, sft: FeatureType) -> bool:
        return sft.has(self.attr) and not sft.attr(self.attr).is_geometry

    # -- write side ------------------------------------------------------
    def write_keys(self, fc: FeatureCollection) -> WriteKeys:
        codes = lexicode.lex_column(fc.columns[self.attr], self.attr_type)
        n = len(fc)
        device_cols: dict = {}
        if self.geom is not None:
            col = fc.columns[self.geom]
            if isinstance(col, PointColumn):
                device_cols["x"] = col.x.astype(np.float32)
                device_cols["y"] = col.y.astype(np.float32)
            elif isinstance(col, geo.PackedGeometryColumn):
                device_cols["gxmin"] = col.bboxes[:, 0]
                device_cols["gymin"] = col.bboxes[:, 1]
                device_cols["gxmax"] = col.bboxes[:, 2]
                device_cols["gymax"] = col.bboxes[:, 3]
        if self.dtg is not None:
            millis = np.asarray(fc.columns[self.dtg], dtype=np.int64)
            binned = self.binner.to_binned(millis)
            device_cols["tbin"] = binned.bin.astype(np.int32)
            device_cols["toff"] = binned.offset.astype(np.int32)
        # string values carry variable-width secondary sort words (lexicode
        # bytes past the 8-byte prefix) so prefix-tie runs stay value-
        # sorted and the scan side prunes boundary runs exactly (reference
        # AttributeIndexKey lexicodes FULL values; AttributeIndexKey.scala:
        # 21-70). Cost: 8 bytes/row/word, host-side only.
        sub = None
        if self._is_string:
            sub = lexicode.lex_string_words(fc.columns[self.attr])
        return WriteKeys(
            bins=np.zeros(n, dtype=np.int32),
            zs=codes.astype(np.uint64),
            device_cols=device_cols,
            sub=sub,
        )

    # -- read side -------------------------------------------------------
    def scan_config(self, f: Filter) -> Optional[ScanConfig]:
        bounds = extract_attribute_bounds(f, self.attr)
        if bounds.disjoint:
            return ScanConfig.empty(self.name)
        if not bounds.values:
            return None  # no bound on this attribute: index cannot serve
        los, his = [], []
        los2, his2 = [], []
        for b in bounds.values:
            lo, hi = lexicode.bounds_to_range(b.lo, b.hi, self.attr_type)
            los.append(lo)
            his.append(hi)
            if self._is_string:
                lo2, hi2 = lexicode.bounds_sub_words(b.lo, b.hi)
                los2.append(lo2)
                his2.append(hi2)

        # secondary spatial predicate (device mask inside candidate tiles)
        boxes = None
        geom_precise = True
        extent = self.geom is not None and not self.sft.is_points
        if self.geom is not None:
            geoms = extract_geometries(f, self.geom)
            if geoms.disjoint:
                return ScanConfig.empty(self.name)
            if geoms.values:
                boxes = widen_boxes(geometry_bounds(geoms))
                geom_precise = (
                    not extent and geoms.precise and _bounds_only(geoms.values)
                )

        # secondary temporal predicate
        windows = None
        time_precise = True
        if self.dtg is not None:
            intervals = extract_intervals(f, self.dtg)
            if intervals.disjoint:
                return ScanConfig.empty(self.name)
            if intervals.values:
                parts = []
                for iv in intervals.values:
                    b, lo, hi = self.binner.bins_for_interval(iv.lo, iv.hi - 1)
                    b, (lo, hi) = clamp_bins(self.bin_range, b, lo, hi)
                    if len(b) == 0:
                        continue
                    parts.append(np.stack([b, lo, hi], axis=1))
                if not parts:
                    # every queried time bin is absent from the store
                    return ScanConfig.empty(self.name)
                windows = np.concatenate(parts).astype(np.int32)
                time_precise = intervals.precise

        return ScanConfig(
            index=self.name,
            range_bins=np.zeros(len(los), dtype=np.int32),
            range_lo=np.array(los, dtype=np.uint64),
            range_hi=np.array(his, dtype=np.uint64),
            boxes=boxes,
            windows=windows,
            extent_mode=extent,
            geom_precise=geom_precise,
            time_precise=time_precise,
            # value-range spans are row-exact: kernel hits (block granular)
            # must clip back to them before refinement
            clip_rows=True,
            range_lo2=np.stack(los2).astype(np.uint64) if los2 else None,
            range_hi2=np.stack(his2).astype(np.uint64) if his2 else None,
        )
