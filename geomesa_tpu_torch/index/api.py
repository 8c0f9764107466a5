"""Index key space API: write keys + scan configuration.

The port's copy of geomesa_tpu/index/api.py (reference geomesa-index-api
IndexKeySpace.scala:23-109). The write side emits columnar sort keys and
device columns; the read side emits a `ScanConfig` = host z-ranges (for
block pruning over the sorted table) plus the device predicate arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable

import numpy as np

from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import Filter
from geomesa_tpu_torch.sft import FeatureType


@dataclass
class WriteKeys:
    """Write-side output of a key space for a batch of features.

    - ``bins``: int32 [n] — coarse sort key (time bin; 0 for atemporal)
    - ``zs``:   uint64 [n] — fine sort key (z sequence code)
    - ``device_cols``: name -> numpy array [n], the columns the scan kernel
      tests (f32 coords / i32 time parts / f32 bboxes)
    - ``sub``: optional uint64 [n, W] — secondary sort words breaking
      ``zs`` ties (attribute indexes over strings: lexicode bytes past the
      8-byte prefix, so equality and range predicates prune exactly)
    """

    bins: np.ndarray
    zs: np.ndarray
    device_cols: dict
    sub: "np.ndarray | None" = None


@dataclass
class ScanConfig:
    """Read-side output: how to scan one index for one filter.

    - ``range_bins``/``range_lo``/``range_hi``: parallel arrays of covering
      z-ranges, inclusive, grouped per time bin (tile pruning input)
    - ``boxes``: f32 [B, 4] spatial boxes (xmin, ymin, xmax, ymax), widened
      one f32 ulp outward so the device mask never drops a true hit
    - ``windows``: i32 [W, 3] (bin, off_lo, off_hi) inclusive time windows,
      or None for atemporal indexes
    - ``extent_mode``: the device test is bbox-*intersects* against the
      per-feature extent columns (XZ indexes), never exact for extents
    - ``geom_precise``/``time_precise``: the device mask exactly answers the
      spatial/temporal constraint up to f32 widening (residual host
      refinement still applies exactness; these gate the `loose` fast path)
    """

    index: str
    range_bins: np.ndarray
    range_lo: np.ndarray
    range_hi: np.ndarray
    boxes: Optional[np.ndarray]
    windows: Optional[np.ndarray]
    extent_mode: bool = False
    geom_precise: bool = True
    time_precise: bool = True
    disjoint: bool = False
    # -- exactness tier (round-3; reference contained-range semantics,
    # ZN.scala:110-242, + useFullFilter, Z3IndexKeySpace.scala:240-254) --
    # per-range contained flags: rows in contained ranges are certain hits
    # when contained_exact (ranges were classified against shrunk *inner*
    # ordinals, so containment holds at f64, not just ordinal, precision)
    range_contained: Optional[np.ndarray] = None
    contained_exact: bool = False
    # inner (shrunk) predicate bounds: rows passing them are certain f64
    # hits -> host refinement touches only wide & ~inner boundary rows
    boxes_inner: Optional[np.ndarray] = None
    windows_inner: Optional[np.ndarray] = None
    # row spans are exact (attribute-index value ranges): kernel hits
    # (block granular) clip back to the spans before refinement
    clip_rows: bool = False
    # secondary sort-word bounds (string attribute indexes: lexicode bytes
    # past the 8-byte prefix) narrow the boundary tie-runs of each range
    range_lo2: Optional[np.ndarray] = None
    range_hi2: Optional[np.ndarray] = None
    # point-in-polygon leg: the query polygon's packed [E, 128] edge block
    # (block_kernels.pack_edges); the scan's spatial test is the even-odd
    # parity instead of the box slots, and only the f32-uncertainty band
    # refines on host. geom_precise is True with poly set, but the
    # gather-free aggregations must not take it (mask_decides_filter's
    # for_aggregation: their kernels evaluate the box wide plane only),
    # and contained-range certainty stays bbox-only.
    poly: Optional[np.ndarray] = None
    # raster leg: the query polygon's packed [1 + R, 128] interval stack
    # (filter.raster.RasterApprox.pack_block): full cells are certain hits,
    # out cells certain misses, and only the boundary residue pays the
    # exact PIP (``poly`` when set, else host refinement). On z2 the
    # ranges come from the raster too: full cells are contained ranges
    # (contained_exact is True), out cells inside the bbox are pruned.
    rast: Optional[np.ndarray] = None

    @staticmethod
    def empty(index: str) -> "ScanConfig":
        """A config for an unsatisfiable filter (returns nothing)."""
        return ScanConfig(
            index=index,
            range_bins=np.zeros(0, np.int32),
            range_lo=np.zeros(0, np.uint64),
            range_hi=np.zeros(0, np.uint64),
            boxes=None,
            windows=None,
            disjoint=True,
        )

    @property
    def n_ranges(self) -> int:
        return len(self.range_bins)


def widen_boxes(bounds) -> np.ndarray:
    """f64 boxes -> f32 boxes widened one ulp outward (superset semantics)."""
    b = np.asarray(bounds, dtype=np.float64).reshape(-1, 4)
    lo = np.nextafter(b[:, :2].astype(np.float32), np.float32(-np.inf))
    hi = np.nextafter(b[:, 2:].astype(np.float32), np.float32(np.inf))
    return np.concatenate([lo, hi], axis=1).astype(np.float32)


def shrink_boxes(bounds) -> np.ndarray:
    """f64 boxes -> f32 boxes shrunk two ulps inward (subset semantics).

    A stored f32 coordinate x32 = round(x64) differs from the true f64
    value by at most half an ulp; a point passing the 2-ulp-shrunk box test
    therefore passes the true f64 box test — the device *inner* mask, whose
    hits skip host refinement entirely."""
    b = np.asarray(bounds, dtype=np.float64).reshape(-1, 4)
    lo = b[:, :2].astype(np.float32)
    hi = b[:, 2:].astype(np.float32)
    for _ in range(2):
        lo = np.nextafter(lo, np.float32(np.inf))
        hi = np.nextafter(hi, np.float32(-np.inf))
    return np.concatenate([lo, hi], axis=1).astype(np.float32)


@runtime_checkable
class IndexKeySpace(Protocol):
    """One logical index over a feature type."""

    name: str

    def supports(self, sft: FeatureType) -> bool:
        """Can this index be built for the schema?"""
        ...

    def write_keys(self, fc: FeatureCollection) -> WriteKeys:
        """Sort keys + device columns for a batch (reference toIndexKey)."""
        ...

    def scan_config(self, f: Filter) -> Optional[ScanConfig]:
        """Scan configuration for a filter, or None when this index cannot
        serve it (reference getIndexValues + getRanges)."""
        ...
