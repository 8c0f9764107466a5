"""Z3 index: (time bin, z3) keys for point features with time.

The port's copy of geomesa_tpu/index/z3.py (reference Z3IndexKeySpace.scala
:63-95 write, :97-194 read), including packed time (`pack_tw` /
`windows_to_ticks`). A single polygon filter rides the scan kernel's
point-in-polygon and raster legs (``_polygon_legs``); its
z-ranges stay bbox-derived (z3 ranges interleave time, so the 2-D raster
cannot reshape them).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from geomesa_tpu_torch import native
from geomesa_tpu_torch.curve.binnedtime import MAX_BIN, MAX_OFFSET, BinnedTime, TimePeriod
from geomesa_tpu_torch.curve.z3sfc import Z3SFC
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.extract import extract_geometries, extract_intervals, geometry_bounds
from geomesa_tpu_torch.filter.predicates import Filter, PointColumn
from geomesa_tpu_torch.index.api import (
    IndexKeySpace, ScanConfig, WriteKeys, shrink_boxes, widen_boxes,
)
from geomesa_tpu_torch.sft import FeatureType

WHOLE_WORLD = (-180.0, -90.0, 180.0, 90.0)

# query-endpoint alignment unit: ms per offset unit (BinnedTime offsets are
# ms/sec/sec/min for day/week/month/year)
_OFFSET_UNIT_MS = {
    TimePeriod.DAY: 1,
    TimePeriod.WEEK: 1000,
    TimePeriod.MONTH: 1000,
    TimePeriod.YEAR: 60_000,
}

# packed-time tick shift per period (geomesa.z3.packed-time user-data
# flag; the 1B-row layout — see block_kernels.TW_BITS): device offsets
# store as (offset >> shift) so max_offset >> shift < 2^16. Ticks: day
# ~2 s, week/month 32 s, year 16 min. Bins must fit 15 bits (day-period
# data past 2059-09 must stay unpacked).
PACKED_SHIFT = {
    TimePeriod.DAY: 11,  # 86,400,000 ms >> 11 = 42,187 ticks (~2 s)
    TimePeriod.WEEK: 5,  # 604,800 s  >> 5 = 18,900 ticks (32 s)
    TimePeriod.MONTH: 6,  # 2,678,400 s >> 6 = 41,850 ticks (64 s)
    TimePeriod.YEAR: 4,  # 527,040 min >> 4 = 32,940 ticks (16 min)
}
PACKED_KEY = "geomesa.z3.packed-time"


def pack_tw(tbin: np.ndarray, toff: np.ndarray, shift: int) -> np.ndarray:
    """(tbin, toff) -> packed i32 tw column. Raises when a bin exceeds
    the 15-bit budget or a shifted offset the 16-bit tick field (both
    would silently corrupt neighbouring bits)."""
    from geomesa_tpu_torch.scan.block_kernels import TW_BITS, TW_MASK

    if len(tbin) and int(tbin.max()) >= (1 << (31 - TW_BITS)):
        raise ValueError(
            "packed-time bins exceed 15 bits; disable "
            f"{PACKED_KEY!r} for this data range"
        )
    ticks = toff.astype(np.int64) >> shift
    if len(ticks) and int(ticks.max()) > TW_MASK:
        raise ValueError(
            f"packed-time tick overflow (shift {shift}): offset "
            f"{int(toff.max())} >> {shift} exceeds {TW_MASK}"
        )
    return ((tbin.astype(np.int64) << TW_BITS) | ticks).astype(np.int32)


def unpack_tw(tw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Packed i32 tw -> (tbin, tick) — the ONE host-side unpack next to
    pack_tw (the jnp kernel shares the constants in block_kernels)."""
    from geomesa_tpu_torch.scan.block_kernels import TW_BITS, TW_MASK

    return tw >> TW_BITS, tw & TW_MASK


def windows_to_ticks(w: "np.ndarray | None", shift: int, inner: bool):
    """[W, 3] (bin, off_lo, off_hi) native-unit windows -> tick windows.
    Wide windows floor both ends (superset: a row's tick is its floored
    offset); inner windows shrink to ticks FULLY inside the interval so
    certainty never overclaims — boundary ticks refine on host."""
    if w is None or len(w) == 0:
        return w
    w = np.asarray(w, np.int64).copy()
    one = 1 << shift
    if inner:
        w[:, 1] = (w[:, 1] + one - 1) >> shift
        w[:, 2] = (w[:, 2] - one + 1) >> shift
    else:
        w[:, 1] >>= shift
        w[:, 2] >>= shift
    return w


class Z3Index:
    """Spatio-temporal point index."""

    def __init__(self, sft: FeatureType):
        self.sft = sft
        self.name = "z3"
        self.geom = sft.geom_field
        self.dtg = sft.dtg_field
        self.period = TimePeriod.parse(sft.z3_interval)
        self.sfc = Z3SFC.for_period(self.period)
        self.binner = BinnedTime(self.period)
        # packed-time device layout: one i32 tw column instead of
        # (tbin, toff) — 12 B/row, the 1e9-rows-on-one-chip budget.
        # Tables read this via getattr(keyspace, "packed_time", None)
        self.packed_time = (
            PACKED_SHIFT[self.period]
            if str(sft.user_data.get(PACKED_KEY, "")).lower() in ("true", "1")
            else None
        )
        # (min_bin, max_bin) actually present in the store, maintained by
        # DataStore on write: open-ended time predicates (dtg >= x) clamp
        # to it, so they cost the data's bins, not every representable bin
        # (an unclamped `dtg >= x` materializes tens of millions of
        # range rows — see clamp_bins)
        self.bin_range: "tuple[int, int] | None" = None

    def supports(self, sft: FeatureType) -> bool:
        return sft.is_points and sft.dtg_field is not None

    # -- write side ------------------------------------------------------
    def write_keys(self, fc: FeatureCollection) -> WriteKeys:
        col = fc.columns[self.geom]
        if not isinstance(col, PointColumn):
            raise TypeError("z3 index requires a point geometry column")
        millis = np.asarray(fc.columns[self.dtg], dtype=np.int64)

        # the native encoder (bit-exact with the numpy path below) for the
        # fixed-width periods; calendar periods take the numpy path
        fused = native.z3_write_keys(
            col.x, col.y, millis, self.period.value, MAX_OFFSET[self.period], MAX_BIN,
        )
        if fused is not None:
            bins, zs, device_cols = fused
            return WriteKeys(bins=bins, zs=zs, device_cols=self._pack_cols(device_cols))

        binned = self.binner.to_binned(millis)
        z = self.sfc.index(col.x, col.y, binned.offset.astype(np.float64))
        return WriteKeys(
            bins=binned.bin.astype(np.int32),
            zs=z.astype(np.uint64),
            device_cols=self._pack_cols({
                "x": col.x.astype(np.float32),
                "y": col.y.astype(np.float32),
                "tbin": binned.bin.astype(np.int32),
                "toff": binned.offset.astype(np.int32),
            }),
        )

    def _pack_cols(self, device_cols: dict) -> dict:
        """(tbin, toff) -> one packed tw column when packed-time is on."""
        if self.packed_time is None:
            return device_cols
        tw = pack_tw(
            device_cols.pop("tbin"), device_cols.pop("toff"), self.packed_time
        )
        device_cols["tw"] = tw
        return device_cols

    # -- read side -------------------------------------------------------
    def scan_config(self, f: Filter) -> Optional[ScanConfig]:
        if self.dtg is None:
            return None
        geoms = extract_geometries(f, self.geom)
        intervals = extract_intervals(f, self.dtg)
        if geoms.disjoint or intervals.disjoint:
            return ScanConfig.empty(self.name)
        if not intervals.values:
            return None  # unbounded time: z3 cannot serve (z2 should)
        # no spatial constraint -> no box predicate: the scan variant then
        # projects away the x/y columns entirely (ColumnGroups analogue)
        no_geom = not geoms.values
        bounds = geometry_bounds(geoms) if geoms.values else [WHOLE_WORLD]

        # per-bin time windows (reference timesByBin, Z3IndexKeySpace:132-158)
        # plus the *inner* windows: offsets certain to lie inside the query
        # at millisecond precision (offsets are unit-floored at ingest, so
        # an unaligned query endpoint leaves one boundary offset uncertain)
        unit = _OFFSET_UNIT_MS[self.period]
        bins_list, lo_list, hi_list = [], [], []
        ilo_list, ihi_list = [], []
        for iv in intervals.values:
            b, lo, hi = self.binner.bins_for_interval(iv.lo, iv.hi - 1)
            ilo, ihi = lo.copy(), hi.copy()
            if int(iv.lo) % unit != 0:
                ilo[0] += 1
            if int(iv.hi) % unit != 0:
                ihi[-1] -= 1
            b, (lo, hi, ilo, ihi) = clamp_bins(self.bin_range, b, lo, hi, ilo, ihi)
            if len(b) == 0:
                continue
            bins_list.append(b)
            lo_list.append(lo)
            hi_list.append(hi)
            ilo_list.append(ilo)
            ihi_list.append(ihi)
        if not bins_list:
            return ScanConfig.empty(self.name)
        bins = np.concatenate(bins_list)
        los = np.concatenate(lo_list)
        his = np.concatenate(hi_list)
        ilos = np.concatenate(ilo_list)
        ihis = np.concatenate(ihi_list)

        # z-ranges: one decomposition per distinct (lo, hi) offset window —
        # interior bins all share the full-offset window, so a long interval
        # costs one BFS, not one per bin (the reference recomputes per bin;
        # sharing is the columnar win since ranges are bin-independent)
        range_bins, range_lo, range_hi, range_cont = [], [], [], []
        windows = np.stack([bins, los, his], axis=1).astype(np.int64)
        windows_inner = np.stack([bins, ilos, ihis], axis=1).astype(np.int64)
        for lo_off, hi_off in set(zip(los.tolist(), his.tolist())):
            ranges = self.sfc.ranges(
                bounds, [(float(lo_off), float(hi_off))], inner=True
            )
            if not ranges:
                continue
            rlo = np.array([r.lower for r in ranges], dtype=np.uint64)
            rhi = np.array([r.upper for r in ranges], dtype=np.uint64)
            # the 2-cell inner margin (Z3SFC.ranges inner=True) exceeds one
            # offset unit in every period, so contained cells' offsets are
            # strictly inside the query interval even when its endpoints are
            # not offset-aligned — contained rows are certain at ms precision
            rc = np.array([r.contained for r in ranges], dtype=bool)
            for k in np.flatnonzero((los == lo_off) & (his == hi_off)):
                range_bins.append(np.full(len(rlo), bins[k], dtype=np.int32))
                range_lo.append(rlo)
                range_hi.append(rhi)
                range_cont.append(rc)
        if not range_bins:
            return ScanConfig.empty(self.name)
        bounds_exact = geoms.precise and _bounds_only(geoms.values)
        # the raster leg classifies rows in the kernel; the ranges stay
        # bbox-derived (z2 gets raster-derived ranges)
        poly, rast, _ = (
            (None, None, None) if (no_geom or bounds_exact) else _polygon_legs(geoms)
        )
        return ScanConfig(
            index=self.name,
            range_bins=np.concatenate(range_bins),
            range_lo=np.concatenate(range_lo),
            range_hi=np.concatenate(range_hi),
            boxes=None if no_geom else widen_boxes(bounds),
            windows=windows.astype(np.int32),
            # the polygon legs make single-polygon queries precise on the
            # device; contained certainty stays bbox-only here
            geom_precise=bounds_exact or poly is not None or rast is not None,
            time_precise=intervals.precise,
            range_contained=np.concatenate(range_cont),
            # contained certainty additionally requires the *filter* to be
            # decided by bbox+interval alone — the planner checks kinds; here
            # we require the geometry values themselves to be plain boxes
            contained_exact=bool(bounds_exact and intervals.precise),
            boxes_inner=None if no_geom else shrink_boxes(bounds),
            windows_inner=windows_inner.astype(np.int32),
            poly=poly,
            rast=rast,
        )


def clamp_bins(bin_range, b, *cols):
    """Drop per-bin window rows outside the store's known (min, max) bin
    range — exact for scanning (rows in absent bins do not exist), and the
    guard against open-ended time predicates materializing every
    representable bin."""
    if bin_range is None:
        return b, cols
    keep = (b >= bin_range[0]) & (b <= bin_range[1])
    if keep.all():
        return b, cols
    return b[keep], tuple(c[keep] for c in cols)


def _bounds_only(geom_values) -> bool:
    """True when every extracted geometry is its own bbox (the device box
    test is then exact up to f32); polygons need host refinement."""
    from geomesa_tpu_torch.filter.extract import _is_box

    return all(_is_box(g) for g in geom_values)


def _polygon_legs(geoms):
    """(edge block | None, raster block | None, RasterApprox | None) of a
    polygon extraction. With both legs possible, ``geomesa.raster.residue``
    decides where the partial cells' exact test runs: 'host' (the
    default) drops the edges, so those rows come back uncertain and refine
    on host in f64; 'device' keeps both legs in the kernel."""
    from geomesa_tpu_torch.conf import RASTER_RESIDUE

    poly = _poly_edges(geoms)
    rast, approx = _poly_raster(geoms)
    if rast is not None and poly is not None and str(RASTER_RESIDUE.get()).lower() != "device":
        poly = None
    return poly, rast, approx


def _poly_edges(geoms) -> "np.ndarray | None":
    """Packed edge block for the point-in-polygon leg, or None when the
    extraction cannot ride it: it needs one precisely extracted
    Polygon/MultiPolygon whose edge count fits the bucket ladder
    (block_kernels.pack_edges). Imprecise extractions keep the bbox and
    host refinement."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    if not geoms.precise or len(geoms.values) != 1:
        return None
    return bk.pack_edges(geoms.values[0])


def _poly_raster(geoms):
    """(packed [1 + R, 128] raster block, RasterApprox) for the raster leg
    (arXiv 2307.01716), or (None, None) when the extraction cannot ride
    it: the eligibility of _poly_edges without the edge-count cap (a
    raster approximates a polygon of any complexity)."""
    from geomesa_tpu_torch.conf import RASTER_KERNEL_INTERVALS
    from geomesa_tpu_torch.filter import raster as fr
    from geomesa_tpu_torch.scan import block_kernels as bk

    if not geoms.precise or len(geoms.values) != 1:
        return None, None
    approx = fr.raster_for(geoms.values[0])
    if approx is None:
        return None, None
    bucket = bk.r_bucket_of(
        min(len(approx.ilo), max(int(RASTER_KERNEL_INTERVALS.get()), 1))
    )
    return approx.pack_block(bucket), approx
