"""Decomposition of query boxes into covering Z-curve ranges.

The port's copy of geomesa_tpu/curve/zranges.py
(reference geomesa-z3 ZN.scala:110-242): breadth-first quad/oct-tree
traversal from the longest common prefix of the query corners, emitting
*contained* ranges (cells fully inside the query; rows need no filter)
and *overlapping* ranges (rows need the device scan mask). The
traversal is budgeted by `max_ranges` (``geomesa.scan.ranges.target``)
and `max_recurse`; a hit budget emits coarse overlapping ranges, always
a superset of the query. The BFS runs in the native helper
(``native.zranges``); the numpy BFS below is its plain version, taken
only under ``native.disabled()``. The two may emit different (equally
covering) range lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from geomesa_tpu_torch import native
from geomesa_tpu_torch.curve.zorder import longest_common_prefix, zdiv

DEFAULT_MAX_RECURSE = 7


@dataclass(frozen=True)
class IndexRange:
    """Inclusive z-range [lower, upper]; contained = no row filter needed."""

    lower: int
    upper: int
    contained: bool


@dataclass(frozen=True)
class ZBox:
    """A query box in z-space: per-dimension normalized [min, max] ordinals."""

    mins: tuple[int, ...]
    maxes: tuple[int, ...]


def zranges(
    curve,
    boxes: Sequence[ZBox],
    max_ranges: int | None = None,
    max_recurse: int | None = None,
    inner_boxes: "Sequence[ZBox] | None" = None,
) -> list[IndexRange]:
    """Covering z-ranges for the union of ``boxes`` on ``curve``.

    curve: Z2 or Z3 from geomesa_tpu_torch.curve.zorder (needs .dims,
    .bits_per_dim, .index, .decode).

    ``inner_boxes`` (aligned with ``boxes``) classify *containment*: a cell
    is contained only when fully inside some inner box. Callers pass boxes
    shrunk below the f64 query bounds so contained-range rows are certain
    hits needing no refinement; default (None) classifies against the outer
    boxes — ordinal-level containment, the reference ZN.zranges behavior.
    Inner boxes may be inverted (mins > maxes) to mean "never contained".
    """
    if not boxes:
        return []
    if max_ranges is None:
        from geomesa_tpu_torch.conf import SCAN_RANGES_TARGET

        max_ranges = SCAN_RANGES_TARGET.get()
    if max_ranges < 1:
        raise ValueError(f"max_ranges must be >= 1: {max_ranges}")
    max_recurse = DEFAULT_MAX_RECURSE if max_recurse is None else max_recurse
    dims = curve.dims
    bits_per_dim = curve.bits_per_dim
    total_bits = dims * bits_per_dim
    children = 1 << dims

    for b in boxes:
        for d in range(dims):
            if b.mins[d] > b.maxes[d]:
                raise ValueError(f"inverted box on dim {d}: {b.mins} > {b.maxes}")

    mins = np.array([b.mins for b in boxes], dtype=np.uint64)  # [nbox, dims]
    maxes = np.array([b.maxes for b in boxes], dtype=np.uint64)
    if inner_boxes is None:
        imins, imaxes = mins, maxes
    else:
        # inverted inner dims (mins > maxes) never contain anything
        imins = np.array([b.mins for b in inner_boxes], dtype=np.uint64)
        imaxes = np.array([b.maxes for b in inner_boxes], dtype=np.uint64)

    nat = native.zranges(dims, bits_per_dim, mins, maxes, imins, imaxes, max_ranges, max_recurse)
    if nat is not None:
        lo, hi, cont = nat
        return [
            IndexRange(int(l), int(h), bool(c))
            for l, h, c in zip(lo.tolist(), hi.tolist(), cont.tolist())
        ]

    zmins = [int(curve.index(*b.mins)) for b in boxes]
    zmaxes = [int(curve.index(*b.maxes)) for b in boxes]

    # longest common prefix over all corner z-values, aligned to dims bits
    lcp = longest_common_prefix(curve, *(zmins + zmaxes))
    offset = lcp.offset
    prefix = lcp.prefix

    ranges: list[IndexRange] = []

    def cell_bounds(z_prefix: int, level_bits: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-dimension [lo, hi] ordinals of the cell with the given prefix;
        level_bits = number of low bits free within the cell."""
        zmin = z_prefix
        zmax = z_prefix | ((1 << level_bits) - 1)
        lo = np.array(curve.decode(zmin), dtype=np.uint64)
        hi = np.array(curve.decode(zmax), dtype=np.uint64)
        return lo, hi

    def classify(lo: np.ndarray, hi: np.ndarray) -> int:
        """2 = fully contained in some inner box, 1 = overlaps some box,
        0 = disjoint."""
        contained = np.all((lo >= imins) & (hi <= imaxes), axis=1)
        if contained.any():
            return 2
        overlaps = np.all((lo <= maxes) & (hi >= mins), axis=1)
        if overlaps.any():
            return 1
        return 0

    # BFS over cells. Each entry: (z_prefix, free_bits)
    level = [(prefix, offset)]
    recursions = 0
    while level and recursions < max_recurse and len(ranges) + len(level) * children < max_ranges * 2:
        nxt: list[tuple[int, int]] = []
        for z_prefix, free_bits in level:
            if free_bits == 0:
                lo, hi = cell_bounds(z_prefix, 0)
                c = classify(lo, hi)
                if c:
                    ranges.append(IndexRange(z_prefix, z_prefix, c == 2))
                continue
            child_bits = free_bits - dims
            for q in range(children):
                child_prefix = z_prefix | (q << child_bits)
                lo, hi = cell_bounds(child_prefix, child_bits)
                c = classify(lo, hi)
                if c == 2:
                    ranges.append(
                        IndexRange(child_prefix, child_prefix | ((1 << child_bits) - 1), True)
                    )
                elif c == 1:
                    if child_bits == 0:
                        ranges.append(IndexRange(child_prefix, child_prefix, False))
                    else:
                        nxt.append((child_prefix, child_bits))
        level = nxt
        recursions += 1

    # budget exhausted: emit remaining cells as coarse overlapping ranges
    for z_prefix, free_bits in level:
        ranges.append(IndexRange(z_prefix, z_prefix | ((1 << free_bits) - 1), False))

    merged = merge_ranges(ranges, max_ranges)
    return _tighten_ranges(curve, merged, zmins, zmaxes, mins, maxes)


def _tighten_ranges(
    curve,
    ranges: list[IndexRange],
    zmins: list[int],
    zmaxes: list[int],
    mins: np.ndarray,
    maxes: np.ndarray,
) -> list[IndexRange]:
    """Shrink range endpoints to in-union z-values via LITMAX/BIGMIN.

    The reference invokes zdiv from its range decomposition to skip the gap
    at a miss (ZN.scala:309-361 called from the zranges loop); here the BFS
    classifies whole cells, so the equivalent tightening runs as a post-pass
    against the union of query boxes: each range's lower endpoint advances to
    the smallest z >= it inside *some* box (min of per-box BIGMINs), the
    upper retracts to the largest z <= it inside some box (max of per-box
    LITMAXs), and ranges containing no in-union z are dropped. In Morton
    order the z of a box's min/max corner is that box's global min/max z,
    which bounds the per-box candidate search.
    """

    def in_box(z: int, b: int) -> bool:
        pt = np.array(curve.decode(z), dtype=np.uint64)
        return bool(np.all(pt >= mins[b]) & np.all(pt <= maxes[b]))

    nbox = len(zmins)
    out: list[IndexRange] = []
    for r in ranges:
        lo_cands: list[int] = []
        hi_cands: list[int] = []
        for b in range(nbox):
            zmin, zmax = zmins[b], zmaxes[b]
            if zmax < r.lower or zmin > r.upper:
                continue  # box b has no z in this range's window at all
            # smallest z of box b that is >= r.lower
            if r.lower <= zmin:
                cand = zmin
            elif in_box(r.lower, b):
                cand = r.lower
            else:
                _, cand = zdiv(curve, zmin, zmax, r.lower)
            if cand <= r.upper:
                lo_cands.append(cand)
            # largest z of box b that is <= r.upper
            if r.upper >= zmax:
                cand = zmax
            elif in_box(r.upper, b):
                cand = r.upper
            else:
                cand, _ = zdiv(curve, zmin, zmax, r.upper)
            if cand >= r.lower:
                hi_cands.append(cand)
        if not lo_cands or not hi_cands:
            continue
        lo, hi = min(lo_cands), max(hi_cands)
        if lo > hi:
            continue
        out.append(IndexRange(lo, hi, r.contained))
    return out


def merge_ranges(ranges: list[IndexRange], max_ranges: int | None = None) -> list[IndexRange]:
    """Sort, merge overlapping/adjacent ranges, and reduce below max_ranges
    by closing the smallest gaps first (over-covering, never dropping).

    Reference: the sort+merge at the tail of ZN.zranges (ZN.scala:198-242).
    """
    if not ranges:
        return []
    ranges = sorted(ranges, key=lambda r: (r.lower, r.upper))
    merged: list[IndexRange] = [ranges[0]]
    for r in ranges[1:]:
        last = merged[-1]
        # merge only same-kind neighbors: a contained range keeps its
        # no-refinement guarantee instead of degrading when glued to an
        # overlapping one (BFS cells are disjoint, so ranges only touch)
        if r.lower <= last.upper + 1 and r.contained == last.contained:
            merged[-1] = IndexRange(last.lower, max(last.upper, r.upper), last.contained)
        else:
            merged.append(r)
    if max_ranges is not None and len(merged) > max_ranges:
        # close smallest gaps until under budget
        gaps = np.array(
            [merged[i + 1].lower - merged[i].upper for i in range(len(merged) - 1)]
        )
        k = len(merged) - max_ranges
        cutoff_idx = np.argpartition(gaps, k - 1)[:k]
        close = np.zeros(len(gaps), dtype=bool)
        close[cutoff_idx] = True
        out: list[IndexRange] = [merged[0]]
        for i, r in enumerate(merged[1:]):
            if close[i]:
                last = out[-1]
                out[-1] = IndexRange(last.lower, max(last.upper, r.upper), False)
            else:
                out.append(r)
        merged = out
    return merged
