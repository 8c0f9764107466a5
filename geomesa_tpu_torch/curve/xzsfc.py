"""XZ-ordering (Boehm, Klump & Kriegel) for geometries *with extent*.

Generic N-dimensional core shared by XZ2 (2-D, polygons/lines) and XZ3
(3-D, extents + time). Functional parity with the reference's XZ2SFC
(geomesa-z3/src/main/scala/org/locationtech/geomesa/curve/XZ2SFC.scala:54-306)
and XZ3SFC (XZ3SFC.scala), re-derived from the published XZ-ordering
construction rather than translated:

- An element (an N-d box) is assigned the deepest tree level ``l`` at which
  it still fits inside an *enlarged* cell (a cell doubled in every
  dimension, anchored at the cell's low corner); its code is the preorder
  sequence number of the cell containing its low corner at level ``l``.
- A query box's covering ranges come from a BFS over the 2^N-ary tree:
  cells whose enlarged extent is contained in the query cover their whole
  subtree (*contained* ranges, no row filter needed); cells whose enlarged
  extent merely overlaps contribute their own code (*overlapping*) and
  recurse.

Sequence codes fit in int64 for the default precision g=12
(2-D: (4^13-1)/3 ~ 2.2e7; 3-D: (8^13-1)/7 ~ 7.8e10).

The port's copy of geomesa_tpu/curve/xzsfc.py. ``index`` and ``ranges``
run in the native helpers (``native.xz_index`` / ``native.xz_ranges``);
the numpy paths below are their plain versions, taken under
``native.disabled()``. The numpy ``index`` runs over rows in chunks of
``INDEX_CHUNK``, so a large ingest never holds more than a few
chunk-sized temporaries per tree level; the codes are those of one pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from geomesa_tpu_torch import native
from geomesa_tpu_torch.curve.zranges import IndexRange, merge_ranges

# rows per chunk of XZSFC.index
INDEX_CHUNK = 1 << 21


@dataclass(frozen=True)
class XElement:
    """A normalized query/element box: per-dim [lo, hi] in [0, 1]."""

    lo: tuple[float, ...]
    hi: tuple[float, ...]


class XZSFC:
    """N-dimensional XZ curve with ``g`` levels of resolution."""

    def __init__(self, g: int, dims: int):
        if dims * (g + 1) > 62:
            # preorder codes bounded by (2^dims)^(g+1)/(2^dims - 1)
            raise ValueError(f"g={g} too deep for {dims}-d int64 sequence codes")
        self.g = g
        self.dims = dims
        self.children = 1 << dims
        # subtree_size[l] = number of nodes in a subtree rooted at level l
        # (levels l..g): sum_{i=0..g-l} children^i
        sizes = []
        for l in range(g + 2):
            depth = g - l
            if depth < 0:
                sizes.append(0)
            else:
                sizes.append((self.children ** (depth + 1) - 1) // (self.children - 1))
        self.subtree_size = sizes  # index by level of the subtree root

    # -- write path ------------------------------------------------------

    def length_at(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Deepest level at which each element fits in an enlarged cell.

        Vectorized over elements: lo/hi are [n, dims] normalized to [0,1].
        Reference: the resolution computation in XZ2SFC.index:63-73.
        """
        extent = np.max(hi - lo, axis=1)
        with np.errstate(divide="ignore"):
            l1 = np.floor(np.log(np.maximum(extent, 1e-300)) / np.log(0.5)).astype(np.int64)
        l1 = np.minimum(l1, self.g)
        # can we go one level deeper? the enlarged cell at l1+1 anchored at
        # the element's low corner's cell must still contain the element.
        w2 = np.power(0.5, np.minimum(l1 + 1, self.g))  # cell width at l1+1
        fits = np.ones(len(l1), dtype=bool)
        for d in range(self.dims):
            anchor = np.floor(lo[:, d] / w2) * w2
            fits &= hi[:, d] <= anchor + 2 * w2
        length = np.where(fits, np.minimum(l1 + 1, self.g), np.maximum(l1, 0))
        return np.clip(length, 0, self.g)

    def sequence_code(self, point: np.ndarray, length: np.ndarray) -> np.ndarray:
        """Preorder code of the level-``length`` cell containing ``point``.

        Vectorized: point is [n, dims] in [0,1], length is [n].
        Reference: XZ2SFC.sequenceCode:264-286. The reference halves the
        cell per level and asks ``point >= centre``; the centres are dyadic
        fractions, exact in f64, so that answer is bit ``g - 1 - i`` of the
        point's cell index ``floor(point * 2^g)`` (clipped to the grid: a
        point on the upper edge takes the upper half at every level), and
        the codes are computed from those bits in integers.
        """
        top = (1 << self.g) - 1
        cells = np.clip(np.floor(point * float(1 << self.g)), 0, top).astype(np.int64)
        cs = np.zeros(len(point), dtype=np.int64)
        for i in range(self.g):
            active = i < length
            if not active.any():
                break
            q = np.zeros(len(point), dtype=np.int64)
            for d in range(self.dims):
                q |= ((cells[:, d] >> (self.g - 1 - i)) & 1) << d
            cs += np.where(active, 1 + q * self.subtree_size[i + 1], 0)
        return cs

    def index(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Element boxes [n, dims] -> XZ codes [n]. Reference XZ2SFC.index:54.

        The native helper's scalar pass; under ``native.disabled()``,
        chunks of INDEX_CHUNK rows, each through length_at and
        sequence_code (~2*g full passes of numpy per chunk)."""
        lo = np.atleast_2d(np.asarray(lo, dtype=np.float64))
        hi = np.atleast_2d(np.asarray(hi, dtype=np.float64))
        out = native.xz_index(lo, hi, self.dims, self.g, self.subtree_size)
        if out is not None:
            return out
        out = np.empty(len(lo), dtype=np.int64)
        for a in range(0, len(lo), INDEX_CHUNK):
            c_lo, c_hi = lo[a : a + INDEX_CHUNK], hi[a : a + INDEX_CHUNK]
            out[a : a + INDEX_CHUNK] = self.sequence_code(c_lo, self.length_at(c_lo, c_hi))
        return out

    # -- read path -------------------------------------------------------

    def ranges(
        self,
        queries: Sequence[XElement],
        max_ranges: int | None = None,
    ) -> list[IndexRange]:
        """Covering code ranges for the union of normalized query boxes.

        Reference: XZ2SFC.ranges:146-252. The native helper's BFS; under
        ``native.disabled()`` the numpy BFS, one tree level at a time over
        arrays of cells (the JAX package's numpy path walks the cells one
        by one; the ranges are the same).
        """
        if not queries:
            return []
        if max_ranges is None:
            from geomesa_tpu_torch.conf import SCAN_RANGES_TARGET

            max_ranges = SCAN_RANGES_TARGET.get()
        if max_ranges < 1:
            raise ValueError(f"max_ranges must be >= 1: {max_ranges}")
        nat = native.xz_ranges(
            self.dims, self.g, self.subtree_size,
            np.array([q.lo for q in queries]), np.array([q.hi for q in queries]), max_ranges,
        )
        if nat is not None:
            lo, hi, cont = nat
            return [
                IndexRange(int(a), int(b), bool(c))
                for a, b, c in zip(lo.tolist(), hi.tolist(), cont.tolist())
            ]
        qlo = np.array([q.lo for q in queries], dtype=np.float64)[None]  # [1, nq, dims]
        qhi = np.array([q.hi for q in queries], dtype=np.float64)[None]

        def touches(lo, hi):
            """[k] bool: cell boxes [k, dims] meeting any query box."""
            return np.any(np.all((qlo <= hi[:, None]) & (qhi >= lo[:, None]), axis=2), axis=1)

        ranges: list[IndexRange] = []
        # the BFS one tree level at a time, the level's cells as arrays:
        # low corners [k, dims] and preorder codes [k], the root first
        cell_lo = np.zeros((1, self.dims))
        cell_cs = np.zeros(1, dtype=np.int64)
        level = 0
        # child q's corner offset, in units of half the parent's width
        child_bits = np.array(
            [[(q >> d) & 1 for d in range(self.dims)] for q in range(self.children)], np.float64
        )
        while len(cell_cs):
            if max_ranges * 2 - len(ranges) <= 0:
                break
            w = 0.5**level
            enl_hi = cell_lo + 2 * w  # enlarged cells
            contained = np.any(
                np.all((qlo <= cell_lo[:, None]) & (qhi >= enl_hi[:, None]), axis=2), axis=1
            )
            overlaps = ~contained & touches(cell_lo, enl_hi)
            ranges += [
                IndexRange(c, c + self.subtree_size[level] - 1, True)
                for c in cell_cs[contained].tolist()
            ]
            ranges += [IndexRange(c, c, False) for c in cell_cs[overlaps].tolist()]
            if level >= self.g:
                cell_cs = cell_cs[:0]
                break
            # the overlapping cells' children, in (cell, child) order
            half = w * 0.5
            lo = cell_lo[overlaps]
            cell_lo = (lo[:, None, :] + child_bits[None] * half).reshape(-1, self.dims)
            subtree = self.subtree_size[level + 1]
            cell_cs = (
                cell_cs[overlaps][:, None] + 1 + np.arange(self.children) * subtree
            ).reshape(-1)
            level += 1

        # budget exhausted: emit whole subtrees for unprocessed cells
        if len(cell_cs):
            hit = touches(cell_lo, cell_lo + 2 * 0.5**level)
            ranges += [
                IndexRange(c, c + self.subtree_size[level] - 1, False)
                for c in cell_cs[hit].tolist()
            ]

        return merge_ranges(ranges, max_ranges)
