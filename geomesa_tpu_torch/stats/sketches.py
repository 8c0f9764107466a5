"""Stats sketches: MinMax, Histogram, Frequency (count-min), TopK, Z3Histogram.

The port's copy of geomesa_tpu/stats/sketches.py (numpy only; reference:
the `geomesa-utils` stats package, MinMax.scala, Histogram.scala,
Frequency.scala, TopK.scala, Z3Histogram.scala, parse DSL Stat.scala:30).
The reference observes one feature at a time inside server iterators;
here whole columns are observed with vectorized reductions and partial
sketches merge with `+=`.
"""

from __future__ import annotations


import numpy as np

__all__ = [
    "MinMax",
    "Histogram",
    "Frequency",
    "TopK",
    "Z3Histogram",
    "CountStat",
    "DescriptiveStats",
    "Z3Frequency",
]


class CountStat:
    """Total observed count (reference CountStat)."""

    def __init__(self):
        self.count = 0

    def observe(self, col: np.ndarray) -> None:
        self.count += len(col)

    def __iadd__(self, other: "CountStat") -> "CountStat":
        self.count += other.count
        return self

    def to_json(self):
        return {"count": int(self.count)}


class MinMax:
    """Min/max bounds of one attribute (reference MinMax.scala)."""

    def __init__(self):
        self.min = None
        self.max = None
        self.count = 0

    def observe(self, col: np.ndarray) -> None:
        col = np.asarray(col)
        if len(col) == 0:
            return
        self.count += len(col)
        lo, hi = col.min(), col.max()
        self.min = lo if self.min is None else min(self.min, lo)
        self.max = hi if self.max is None else max(self.max, hi)

    def __iadd__(self, other: "MinMax") -> "MinMax":
        if other.min is not None:
            self.observe(np.array([other.min, other.max]))
            self.count += other.count - 2
        return self

    @property
    def bounds(self):
        return None if self.min is None else (self.min, self.max)

    def to_json(self):
        if self.min is None:
            return {"min": None, "max": None, "count": 0}
        return {
            "min": self.min.item() if hasattr(self.min, "item") else self.min,
            "max": self.max.item() if hasattr(self.max, "item") else self.max,
            "count": int(self.count),
        }


class Histogram:
    """Fixed-width binned counts over [lo, hi] (reference Histogram.scala:
    the planner's range-selectivity input)."""

    def __init__(self, n_bins: int, lo: float, hi: float):
        if hi <= lo:
            hi = lo + 1.0
        self.n_bins = n_bins
        self.lo = float(lo)
        self.hi = float(hi)
        self.counts = np.zeros(n_bins, dtype=np.int64)

    def observe(self, col: np.ndarray) -> None:
        col = np.asarray(col, dtype=np.float64)
        if len(col) == 0:
            return
        idx = ((col - self.lo) / (self.hi - self.lo) * self.n_bins).astype(np.int64)
        idx = np.clip(idx, 0, self.n_bins - 1)
        # bincount is ~20x np.add.at — this runs per ingest batch
        self.counts += np.bincount(idx, minlength=self.n_bins)

    def __iadd__(self, other: "Histogram") -> "Histogram":
        if (other.lo, other.hi, other.n_bins) == (self.lo, self.hi, self.n_bins):
            self.counts += other.counts
            return self
        # bounds differ across batches: rebin both into the union span
        # (reference Histogram expands via its defined bounds; here bounds
        # are data-derived per batch so the merge rebins proportionally)
        lo, hi = min(self.lo, other.lo), max(self.hi, other.hi)
        n = max(self.n_bins, other.n_bins)
        out = Histogram(n, lo, hi)
        for h in (self, other):
            w = (h.hi - h.lo) / h.n_bins
            centers = h.lo + (np.arange(h.n_bins) + 0.5) * w
            idx = np.clip(
                ((centers - lo) / (hi - lo) * n).astype(np.int64), 0, n - 1
            )
            np.add.at(out.counts, idx, h.counts)
        self.n_bins, self.lo, self.hi, self.counts = n, lo, hi, out.counts
        return self

    def estimate_range(self, lo: float, hi: float) -> float:
        """Estimated count within [lo, hi] assuming uniform intra-bin mass.
        Vectorized: hot-path callers (estimate_bbox, the kNN radius
        refinement) probe this several times per query."""
        w = (self.hi - self.lo) / self.n_bins
        edges = self.lo + np.arange(self.n_bins + 1) * w
        overlap = np.clip(
            np.minimum(hi, edges[1:]) - np.maximum(lo, edges[:-1]), 0.0, w
        )
        return float((self.counts * (overlap / w)).sum())

    def to_json(self):
        return {
            "bins": self.n_bins,
            "lo": self.lo,
            "hi": self.hi,
            "counts": self.counts.tolist(),
        }


def _cm_hashes(keys: np.ndarray, depth: int, width: int) -> np.ndarray:
    """[depth, n] multiply-shift hashes of u64 keys."""
    keys = keys.astype(np.uint64)
    salts = np.array(
        [0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB, 0xD6E8FEB86659FD93],
        dtype=np.uint64,
    )[:depth, None]
    h = keys[None, :] * salts
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    return (h % np.uint64(width)).astype(np.int64)


def _to_u64_keys(col: np.ndarray) -> np.ndarray:
    col = np.asarray(col)
    if col.dtype.kind in "iu":
        return col.astype(np.uint64)
    if col.dtype.kind == "f":
        return col.astype(np.float64).view(np.uint64)
    from geomesa_tpu_torch.utils.hashing import fnv_fold

    return fnv_fold(col)


# rows of a string column whose distinct values seed the fast
# factorization in _unique_counts
_FACTOR_SAMPLE = 65_536


def _unique_counts(col: np.ndarray, inverse: bool = False):
    """``np.unique(col, return_counts=True)`` (with ``return_inverse``
    when asked), the same arrays, faster on a long fixed-width string
    column of few distinct values (an ingest batch's ``EventRootCode``):
    the rows hash on their raw words, each row finds its hash among the
    distinct hashes of a leading sample, and every row is checked equal
    to its representative. Any hash missing from the sample, or any
    mismatch (a collision), takes numpy's exact sort instead."""
    col = np.asarray(col)
    n = len(col)
    if col.dtype.kind not in "US" or n <= _FACTOR_SAMPLE or col.ndim != 1:
        return np.unique(col, return_inverse=inverse, return_counts=True)
    item = col.dtype.itemsize
    raw = np.ascontiguousarray(col).view(np.uint8).reshape(n, item)
    words = raw.view(np.uint64) if item % 8 == 0 else (
        raw.view(np.uint32) if item % 4 == 0 else raw)
    h = np.zeros(n, np.uint64)
    for j in range(words.shape[1]):
        h ^= words[:, j]
        h *= np.uint64(0x100000001B3)
        h ^= h >> np.uint64(29)
    cand, first = np.unique(h[:_FACTOR_SAMPLE], return_index=True)
    pos = np.minimum(np.searchsorted(cand, h), len(cand) - 1)
    reps = col[first]
    if not (np.array_equal(cand[pos], h) and np.array_equal(reps[pos], col)):
        return np.unique(col, return_inverse=inverse, return_counts=True)
    cnts = np.bincount(pos, minlength=len(cand))
    order = np.argsort(reps, kind="stable")  # distinct values: numpy's order
    if not inverse:
        return reps[order], cnts[order]
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return reps[order], rank[pos], cnts[order]


class Frequency:
    """Count-min sketch for equality selectivity (reference Frequency.scala)."""

    def __init__(self, depth: int = 4, width: int = 1024):
        self.depth = depth
        self.width = width
        self.table = np.zeros((depth, width), dtype=np.int64)
        self.count = 0

    def observe(self, col: np.ndarray) -> None:
        if len(col) == 0:
            return
        col = np.asarray(col)
        if col.dtype.kind in "US" and len(col) > _FACTOR_SAMPLE:
            self.observe_counts(*_unique_counts(col))
            return
        self.count += len(col)
        idx = _cm_hashes(_to_u64_keys(col), self.depth, self.width)
        for d in range(self.depth):
            # bincount is ~20x np.add.at; runs per ingest batch
            self.table[d] += np.bincount(idx[d], minlength=self.width)

    def observe_counts(self, vals: np.ndarray, cnts: np.ndarray) -> None:
        """Observe ``cnts[i]`` rows of each distinct ``vals[i]``: each
        value hashes once and adds its count, the same table as one
        increment per row."""
        self.count += int(cnts.sum())
        idx = _cm_hashes(_to_u64_keys(vals), self.depth, self.width)
        for d in range(self.depth):
            self.table[d] += np.bincount(idx[d], weights=cnts, minlength=self.width).astype(
                np.int64
            )

    def __iadd__(self, other: "Frequency") -> "Frequency":
        self.table += other.table
        self.count += other.count
        return self

    def estimate(self, value) -> int:
        idx = _cm_hashes(_to_u64_keys(np.array([value])), self.depth, self.width)
        return int(min(self.table[d, idx[d, 0]] for d in range(self.depth)))

    def to_json(self):
        return {"depth": self.depth, "width": self.width, "count": int(self.count)}


class TopK:
    """Heavy hitters. Columnar ingest makes exact per-batch counts cheap
    (np.unique); the sketch keeps the top-k across merges (reference
    TopK.scala wraps StreamSummary — same contract, batch-exact here)."""

    def __init__(self, k: int = 10, cap: int = 65536):
        self.k = k
        self.cap = cap
        self.counts: dict = {}

    def observe(self, col: np.ndarray) -> None:
        self.observe_counts(*_unique_counts(col))

    def observe_counts(self, vals: np.ndarray, cnts: np.ndarray) -> None:
        """Observe the distinct values ``vals`` (sorted, as np.unique
        gives them) with their counts."""
        for v, c in zip(vals.tolist(), cnts.tolist()):
            self.counts[v] = self.counts.get(v, 0) + c
        if len(self.counts) > self.cap:
            keep = sorted(self.counts.items(), key=lambda kv: -kv[1])[: self.cap // 2]
            self.counts = dict(keep)

    def __iadd__(self, other: "TopK") -> "TopK":
        for v, c in other.counts.items():
            self.counts[v] = self.counts.get(v, 0) + c
        return self

    def top(self, k: int | None = None) -> list[tuple]:
        return sorted(self.counts.items(), key=lambda kv: -kv[1])[: k or self.k]

    def to_json(self):
        return {"top": [[v, int(c)] for v, c in self.top()]}


class DescriptiveStats:
    """Mergeable moments over one or more numeric attributes: count, min,
    max, sum, mean, population/sample variance + stddev, skewness,
    kurtosis, and pairwise population/sample covariance + correlation
    (reference DescriptiveStats.scala, which wraps commons-math; here the
    moments are held directly and merged with Chan's parallel-update
    formulas, so per-shard sketches combine exactly).
    """

    def __init__(self, n_attrs: int = 1):
        d = n_attrs
        self.d = d
        self.count = 0
        self.min = np.full(d, np.inf)
        self.max = np.full(d, -np.inf)
        self.mean = np.zeros(d)
        self.m2 = np.zeros(d)  # sum of squared deviations (univariate)
        self.m3 = np.zeros(d)
        self.m4 = np.zeros(d)
        self.comoment = np.zeros((d, d))  # sum of deviation products

    def observe(self, *cols) -> None:
        x = np.stack(
            [np.asarray(c, dtype=np.float64) for c in cols], axis=1
        )  # [n, d]
        if x.shape[1] != self.d:
            raise ValueError(f"expected {self.d} columns, got {x.shape[1]}")
        # NaN is the null representation for numeric columns (see
        # filter/predicates IS NULL): a null in any attribute drops the
        # row, keeping the covariance pairing consistent (the reference
        # skips null attributes the same way)
        x = x[~np.isnan(x).any(axis=1)]
        n = len(x)
        if n == 0:
            return
        other = DescriptiveStats.__new__(DescriptiveStats)
        other.d = self.d
        other.count = n
        other.min = x.min(axis=0)
        other.max = x.max(axis=0)
        other.mean = x.mean(axis=0)
        dev = x - other.mean
        other.m2 = (dev**2).sum(axis=0)
        other.m3 = (dev**3).sum(axis=0)
        other.m4 = (dev**4).sum(axis=0)
        other.comoment = dev.T @ dev
        self += other

    def __iadd__(self, other: "DescriptiveStats") -> "DescriptiveStats":
        if other.count == 0:
            return self
        if self.count == 0:
            for f in ("count", "min", "max", "mean", "m2", "m3", "m4", "comoment"):
                setattr(self, f, getattr(other, f))
            return self
        na, nb = self.count, other.count
        n = na + nb
        delta = other.mean - self.mean
        # Chan et al. pairwise central-moment updates
        m2 = self.m2 + other.m2 + delta**2 * na * nb / n
        m3 = (
            self.m3
            + other.m3
            + delta**3 * na * nb * (na - nb) / n**2
            + 3.0 * delta * (na * other.m2 - nb * self.m2) / n
        )
        m4 = (
            self.m4
            + other.m4
            + delta**4 * na * nb * (na**2 - na * nb + nb**2) / n**3
            + 6.0 * delta**2 * (na**2 * other.m2 + nb**2 * self.m2) / n**2
            + 4.0 * delta * (na * other.m3 - nb * self.m3) / n
        )
        self.comoment = (
            self.comoment + other.comoment + np.outer(delta, delta) * na * nb / n
        )
        self.mean = self.mean + delta * nb / n
        self.m2, self.m3, self.m4 = m2, m3, m4
        self.min = np.minimum(self.min, other.min)
        self.max = np.maximum(self.max, other.max)
        self.count = n
        return self

    @property
    def sum(self) -> np.ndarray:
        return self.mean * self.count

    def variance(self, sample: bool = True) -> np.ndarray:
        div = max(self.count - 1, 1) if sample else max(self.count, 1)
        return self.m2 / div

    def stddev(self, sample: bool = True) -> np.ndarray:
        return np.sqrt(self.variance(sample))

    def skewness(self) -> np.ndarray:
        """Population skewness g1 = (M3/n) / (M2/n)^1.5."""
        n = max(self.count, 1)
        s2 = self.m2 / n
        with np.errstate(divide="ignore", invalid="ignore"):
            out = (self.m3 / n) / np.power(s2, 1.5)
        return np.where(s2 > 0, out, 0.0)

    def kurtosis(self) -> np.ndarray:
        """Population excess kurtosis g2 = n*M4/M2^2 - 3."""
        with np.errstate(divide="ignore", invalid="ignore"):
            out = self.count * self.m4 / self.m2**2 - 3.0
        return np.where(self.m2 > 0, out, 0.0)

    def covariance(self, sample: bool = True) -> np.ndarray:
        div = max(self.count - 1, 1) if sample else max(self.count, 1)
        return self.comoment / div

    def correlation(self) -> np.ndarray:
        sd = np.sqrt(np.diag(self.comoment))
        with np.errstate(divide="ignore", invalid="ignore"):
            out = self.comoment / np.outer(sd, sd)
        return np.where(np.outer(sd, sd) > 0, out, 0.0)

    def to_json(self):
        if self.count == 0:
            return {"count": 0}
        return {
            "count": int(self.count),
            "min": self.min.tolist(),
            "max": self.max.tolist(),
            "sum": self.sum.tolist(),
            "mean": self.mean.tolist(),
            "stddev_sample": self.stddev(True).tolist(),
            "variance_sample": self.variance(True).tolist(),
            "stddev_population": self.stddev(False).tolist(),
            "variance_population": self.variance(False).tolist(),
            "skewness": np.asarray(self.skewness()).tolist(),
            "kurtosis": np.asarray(self.kurtosis()).tolist(),
            "covariance_sample": self.covariance(True).tolist(),
            "correlation": self.correlation().tolist(),
        }


class Z3Frequency:
    """Count-min sketch keyed by (time bin, z3 prefix) cells: point-query
    selectivity for spatio-temporal values, complementing Z3Histogram's
    range estimates (reference Z3Frequency.scala)."""

    def __init__(self, total_bits: int, prefix_bits: int = 16,
                 depth: int = 4, width: int = 4096):
        if not 1 <= prefix_bits <= 48:
            raise ValueError(f"prefix_bits must be in [1, 48]: {prefix_bits}")
        self.shift = np.uint64(max(0, total_bits - prefix_bits))
        # retained z bits; bins occupy the field ABOVE them so distinct
        # (bin, prefix) cells can never alias
        self._prefix_bits = np.uint64(min(prefix_bits, total_bits))
        self.freq = Frequency(depth=depth, width=width)

    def _keys(self, bins, zs) -> np.ndarray:
        return (
            np.asarray(bins, dtype=np.uint64) << self._prefix_bits
        ) | (np.asarray(zs, dtype=np.uint64) >> self.shift)

    def observe(self, bins: np.ndarray, zs: np.ndarray) -> None:
        self.freq.observe(self._keys(bins, zs))

    def __iadd__(self, other: "Z3Frequency") -> "Z3Frequency":
        if (self.shift, self._prefix_bits) != (other.shift, other._prefix_bits):
            raise ValueError(
                "cannot merge Z3Frequency sketches with different "
                f"resolutions: {self.to_json()} vs {other.to_json()}"
            )
        self.freq += other.freq
        return self

    @property
    def count(self) -> int:
        return self.freq.count

    def estimate(self, tbin: int, z: int) -> int:
        """Upper-bound count of rows in the cell containing (bin, z)."""
        return self.freq.estimate(self._keys([tbin], [z])[0])

    def to_json(self):
        return {"shift": int(self.shift), **self.freq.to_json()}


class Z3Histogram:
    """Counts over coarse (time bin, z-prefix) cells: the spatio-temporal
    selectivity sketch (reference Z3Histogram.scala). Cells are the top
    ``prefix_bits`` of the z value per time bin; estimates sum matching
    cells for a set of z ranges."""

    def __init__(self, total_bits: int, prefix_bits: int = 16):
        # prefix 16 (round 4; was 12): 12-bit cells were ~6x off on
        # clustered data — too coarse for the kNN local-radius tier. Cells
        # live as parallel SORTED arrays (keys, counts) merged wholesale
        # per batch — a per-cell python dict loop dominated large ingests.
        self.total_bits = total_bits
        self.shift = np.uint64(max(0, total_bits - prefix_bits))
        self._keys = np.zeros(0, dtype=np.int64)
        self._counts = np.zeros(0, dtype=np.int64)

    # rows per observe() pass: larger batches stride-sample down to this
    # (a selectivity sketch needs distribution shape, not exact mass; the
    # full-array unique dominated large ingest batches)
    SAMPLE_CAP = 4_000_000

    @property
    def cells(self) -> dict:
        """(bin, z_prefix) -> count view (tests/inspection)."""
        return dict(zip(self._keys.tolist(), self._counts.tolist()))

    def _merge(self, vals: np.ndarray, cnts: np.ndarray) -> None:
        if len(self._keys) == 0:
            self._keys, self._counts = vals, cnts
            return
        uk, inv = np.unique(
            np.concatenate([self._keys, vals]), return_inverse=True
        )
        uc = np.bincount(
            inv, weights=np.concatenate([self._counts, cnts]), minlength=len(uk)
        ).astype(np.int64)
        self._keys, self._counts = uk, uc

    def observe(self, bins: np.ndarray, zs: np.ndarray) -> None:
        n = len(zs)
        weight = 1
        if n > self.SAMPLE_CAP:
            stride = -(-n // self.SAMPLE_CAP)
            bins = np.ascontiguousarray(bins[::stride])
            zs = np.ascontiguousarray(zs[::stride])
            weight = stride
        key = bins.astype(np.int64) * (1 << 32) + (
            zs.astype(np.uint64) >> self.shift
        ).astype(np.int64)
        vals, cnts = np.unique(key, return_counts=True)
        self._merge(vals, cnts.astype(np.int64) * weight)

    def __iadd__(self, other: "Z3Histogram") -> "Z3Histogram":
        self._merge(other._keys, other._counts)
        return self

    def estimate(self, range_bins, range_lo, range_hi) -> float:
        """Estimated rows covered by inclusive z ranges, assuming uniform
        intra-cell mass."""
        if len(self._keys) == 0:
            return 0.0
        keys, cnts = self._keys, self._counts
        cell = np.uint64(1) << self.shift
        est = 0.0
        for b, lo, hi in zip(
            np.asarray(range_bins).tolist(),
            np.asarray(range_lo, dtype=np.uint64).tolist(),
            np.asarray(range_hi, dtype=np.uint64).tolist(),
        ):
            p_lo = np.uint64(lo) >> self.shift
            p_hi = np.uint64(hi) >> self.shift
            k_lo = b * (1 << 32) + int(p_lo)
            k_hi = b * (1 << 32) + int(p_hi)
            i0 = np.searchsorted(keys, k_lo, side="left")
            i1 = np.searchsorted(keys, k_hi, side="right")
            if i1 <= i0:
                continue
            est += cnts[i0:i1].sum()
            # partial overlap of boundary cells
            frac_lo = float(np.uint64(lo) & (cell - np.uint64(1))) / float(cell)
            frac_hi = 1.0 - float(
                (np.uint64(hi) & (cell - np.uint64(1))) + np.uint64(1)
            ) / float(cell)
            if keys[i0] == k_lo:
                est -= cnts[i0] * frac_lo
            if keys[i1 - 1] == k_hi:
                est -= cnts[i1 - 1] * frac_hi
        return max(est, 0.0)

    def to_json(self):
        return {"cells": len(self._keys), "shift": int(self.shift)}
