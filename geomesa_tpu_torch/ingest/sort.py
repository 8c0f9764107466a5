"""Sharded (bin, z) sort: fixed-size chunk radix sorts and a spanwise
k-way merge.

The port's copy of geomesa_tpu/ingest/sort.py, read by the pipelined bulk
loader (ingest.pipeline) and the stream flusher:

1. every fixed-size chunk of keys radix-sorts on its own (the native LSD
   pass, ``native.sort_bins_z``), in worker threads (ctypes releases the
   GIL);
2. at the finalize or commit, the sorted runs k-way merge per bin span: each run is
   sorted by (bin, z), so a bin's rows are one contiguous span per run,
   and bins merge independently. Within a bin the k spans merge by a
   positional two-run tree (searchsorted and scatter), ties resolved run
   first, so the result is exactly the stable sort of the concatenated
   chunks, as ``native.sort_bins_z`` would give over the whole batch.

The merge runs only when the batch has at least
``geomesa.ingest.merge.min.bins`` distinct bins; below that the caller
lets the whole-batch LSD sort run instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def sort_chunk(bins: np.ndarray, zs: np.ndarray) -> np.ndarray:
    """Stable argsort of one chunk by (bin, z): the native radix sort, or
    ``np.lexsort`` where it declines."""
    from geomesa_tpu_torch import native

    perm = native.sort_bins_z(bins, zs)
    if perm is None:
        perm = np.lexsort((zs, bins))
    return perm


@dataclass
class SortRun:
    """One sorted run: a chunk's (or shard's) keys in (bin, z) order plus
    the GLOBAL row ordinals they came from. Runs merge in list order,
    which must be ingest order for the merge to be stable."""

    bins: np.ndarray  # sorted asc
    zs: np.ndarray    # sorted asc within each bin
    gperm: np.ndarray  # int64 global ordinals, aligned with bins/zs

    @staticmethod
    def build(bins: np.ndarray, zs: np.ndarray, base: int) -> "SortRun":
        perm = sort_chunk(bins, zs)
        return SortRun(bins=bins[perm], zs=zs[perm], gperm=base + perm.astype(np.int64))


def shard_runs(bins: np.ndarray, zs: np.ndarray, base: int, shard_rows: int) -> list[SortRun]:
    """Split one chunk's keys into fixed-size shards and sort each: shard
    order keeps ingest order, so the runs stay merge-stable."""
    n = len(zs)
    shard_rows = max(int(shard_rows), 1)
    return [
        SortRun.build(bins[s : s + shard_rows], zs[s : s + shard_rows], base + s)
        for s in range(0, n, shard_rows)
    ]


def _merge2(z1, p1, z2, p2):
    """Stable positional merge of two sorted z runs: run-1 rows precede
    tied run-2 rows (searchsorted side='right' both ways)."""
    n1, n2 = len(z1), len(z2)
    if n2 == 0:
        return z1, p1
    if n1 == 0:
        return z2, p2
    pos = np.searchsorted(z1, z2, side="right")
    dest2 = pos + np.arange(n2, dtype=np.int64)
    dest1 = np.arange(n1, dtype=np.int64) + np.searchsorted(
        pos, np.arange(n1, dtype=np.int64), side="right"
    )
    z = np.empty(n1 + n2, dtype=z1.dtype)
    p = np.empty(n1 + n2, dtype=np.int64)
    z[dest1] = z1
    z[dest2] = z2
    p[dest1] = p1
    p[dest2] = p2
    return z, p


def _merge_tree(parts: list) -> np.ndarray:
    """[(zs, gperm)] in run order -> merged gperm. Adjacent pairs merge
    level by level, keeping list order so stability composes."""
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            z1, p1 = parts[i]
            z2, p2 = parts[i + 1]
            nxt.append(_merge2(z1, p1, z2, p2))
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0][1]


def distinct_bins(runs: list[SortRun]) -> np.ndarray:
    """Sorted distinct bins across all runs (each run's bins are sorted,
    so per-run uniques are cheap)."""
    if not runs:
        return np.zeros(0, np.int32)
    return np.unique(np.concatenate([np.unique(r.bins) for r in runs]))


def merge_runs(runs: list[SortRun], pool=None, bins: "np.ndarray | None" = None) -> np.ndarray:
    """K-way merge of sorted runs -> the global stable (bin, z) argsort
    (int64 ordinals). ``pool``: an optional executor with ``map`` (bins
    are independent spans, so they merge in parallel). ``bins``: the
    precomputed :func:`distinct_bins` result."""
    runs = [r for r in runs if len(r.zs)]
    if not runs:
        return np.zeros(0, np.int64)
    if len(runs) == 1:
        return runs[0].gperm
    n = sum(len(r.zs) for r in runs)
    if bins is None:
        bins = distinct_bins(runs)
    # run r's span for bins[i] is [lo[i], hi[i]) by searchsorted on its bins
    spans = []
    for r in runs:
        lo = np.searchsorted(r.bins, bins, side="left")
        hi = np.searchsorted(r.bins, bins, side="right")
        spans.append((lo, hi))
    counts = np.zeros(len(bins), np.int64)
    for lo, hi in spans:
        counts += hi - lo
    offs = np.concatenate([[0], np.cumsum(counts)])
    out = np.empty(n, np.int64)

    def merge_bin(i: int) -> None:
        parts = []
        for r, (lo, hi) in zip(runs, spans):
            s, e = int(lo[i]), int(hi[i])
            if e > s:
                parts.append((r.zs[s:e], r.gperm[s:e]))
        out[offs[i] : offs[i + 1]] = _merge_tree(parts)

    if pool is not None and len(bins) > 1:
        list(pool.map(merge_bin, range(len(bins))))
    else:
        for i in range(len(bins)):
            merge_bin(i)
    return out
