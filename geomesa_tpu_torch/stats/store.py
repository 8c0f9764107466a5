"""StatsStore: per-schema sketches maintained at ingest, serving the
planner's row estimates and user-facing stats queries.

The port's copy of geomesa_tpu/stats/store.py (reference GeoMesaStats,
GeoMesaStats.scala:30-110: counts, bounds, min/max, histograms, persisted
as sketches by MetadataBackedStats). The sketches are built with one pass
of vectorized numpy reductions per write batch, in f64 on the host: a
histogram's edges (``float(max) + 1e-9``) must bin exactly as the JAX
package's do.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.stats.sketches import (
    CountStat,
    Frequency,
    Histogram,
    MinMax,
    TopK,
    Z3Histogram,
    _unique_counts,
)

HISTOGRAM_BINS = 1000


class StatsStore:
    """Sketch bundle for one feature type."""

    def __init__(self, sft):
        self.sft = sft
        self.count = CountStat()
        self.minmax: dict[str, MinMax] = {}
        self.histograms: dict[str, Histogram] = {}
        self.frequencies: dict[str, Frequency] = {}
        self.topk: dict[str, TopK] = {}
        self.z3: Z3Histogram | None = None
        # which index's keys feed the z sketch ("z3" or "z2"): estimates
        # are only valid for ranges in THAT index's key space — z2 ranges
        # against a z3-keyed sketch silently estimate ~0
        self.z_index: "str | None" = None

    # -- build -----------------------------------------------------------
    @staticmethod
    def build(sft, fc) -> "StatsStore":
        from geomesa_tpu_torch.filter.predicates import PointColumn

        st = StatsStore(sft)
        st.count.observe(fc.ids)
        for attr in sft.attributes:
            col = fc.columns.get(attr.name)
            if col is None:
                continue
            if attr.is_geometry:
                if isinstance(col, PointColumn):
                    xs, ys = col.x, col.y
                else:
                    b = col.bboxes  # [n, 4] xmin ymin xmax ymax
                    xs = np.concatenate([b[:, 0], b[:, 2]])
                    ys = np.concatenate([b[:, 1], b[:, 3]])
                mm_x, mm_y = MinMax(), MinMax()
                mm_x.observe(xs)
                mm_y.observe(ys)
                st.minmax[attr.name + ".x"] = mm_x
                st.minmax[attr.name + ".y"] = mm_y
                # marginal coordinate histograms: the bbox selectivity
                # estimator (independence product) — much finer spatial
                # resolution than the z-prefix sketch for bbox-only
                # probes on z3-keyed stores
                for suffix, vals, mm in ((".x", xs, mm_x), (".y", ys, mm_y)):
                    if mm.bounds is not None:
                        h = Histogram(
                            HISTOGRAM_BINS, float(mm.min), float(mm.max) + 1e-9
                        )
                        h.observe(np.asarray(vals, dtype=np.float64))
                        st.histograms[attr.name + suffix] = h
                continue
            if attr.type == "Bytes":
                # opaque blobs: equality/range selectivity sketches are
                # meaningless and str-hashing binary data crashes
                continue
            col = np.asarray(col)
            if col.dtype.kind in "iuf" or attr.type == "Date":
                mm = MinMax()
                mm.observe(col)
                st.minmax[attr.name] = mm
                if mm.bounds is not None:
                    h = Histogram(
                        HISTOGRAM_BINS, float(mm.min), float(mm.max) + 1e-9
                    )
                    h.observe(col.astype(np.float64))
                    st.histograms[attr.name] = h
            else:
                if col.dtype.kind == "O":
                    # nulls sketch as "" (IsNull's empty-string semantics);
                    # np.unique cannot sort mixed None/str
                    col = np.array(["" if v is None else str(v) for v in col])
                # one factorization feeds both sketches (the same sketches
                # as observing the column twice)
                vals, cnts = _unique_counts(col)
                f = Frequency()
                f.observe_counts(vals, cnts)
                st.frequencies[attr.name] = f
                tk = TopK()
                tk.observe_counts(vals, cnts)
                st.topk[attr.name] = tk
        return st

    def observe_index_keys(self, index_name: str, bins, zs, total_bits: int) -> None:
        """Feed (bin, z) write keys into the spatio-temporal sketch."""
        if index_name in ("z3", "z2"):
            if self.z3 is None:
                self.z3 = Z3Histogram(total_bits)
                self.z_index = index_name
            self.z3.observe(np.asarray(bins), np.asarray(zs))

    def merge(self, other: "StatsStore") -> "StatsStore":
        """Partial-sketch merge (per-shard stats -> one; the collective
        reduce analogue)."""
        self.count += other.count
        for d_name in ("minmax", "histograms", "frequencies", "topk"):
            mine, theirs = getattr(self, d_name), getattr(other, d_name)
            for k, v in theirs.items():
                if k in mine:
                    mine[k] += v
                else:
                    mine[k] = v
        if other.z3 is not None:
            if self.z3 is None:
                self.z3 = other.z3
                self.z_index = other.z_index
            else:
                self.z3 += other.z3
        return self

    # -- planner queries -------------------------------------------------
    def total_count(self) -> int:
        return self.count.count

    def estimate_scan(self, index_name: str, cfg) -> float | None:
        """Estimated rows a scan config touches (cost-model input)."""
        if self.z3 is not None and index_name == self.z_index:
            return self.z3.estimate(cfg.range_bins, cfg.range_lo, cfg.range_hi)
        return None

    def estimate_equality(self, attr: str, value) -> float | None:
        f = self.frequencies.get(attr)
        return float(f.estimate(value)) if f is not None else None

    def estimate_range(self, attr: str, lo: float, hi: float) -> float | None:
        h = self.histograms.get(attr)
        return h.estimate_range(lo, hi) if h is not None else None

    def estimate_bbox(self, geom: str, x0, y0, x1, y1) -> float | None:
        """Estimated rows intersecting a bbox from the marginal coordinate
        histograms under independence (reference StatsBasedEstimator's
        attribute-selectivity composition). Correlated multi-cluster data
        can overestimate; callers treat this as a selectivity hint."""
        hx = self.histograms.get(geom + ".x")
        hy = self.histograms.get(geom + ".y")
        n = self.total_count()
        if hx is None or hy is None or not n:
            return None
        tx = float(hx.counts.sum())
        ty = float(hy.counts.sum())
        if tx <= 0 or ty <= 0:
            return None
        fx = hx.estimate_range(float(x0), float(x1)) / tx
        fy = hy.estimate_range(float(y0), float(y1)) / ty
        return n * fx * fy

    def estimate_filter(self, sft, f) -> float | None:
        """Selectivity-product estimate for a filter's spatial and temporal
        parts: bbox marginals x date-histogram fraction. None when neither
        axis is constrained or sketches are missing."""
        from geomesa_tpu_torch.filter.extract import (
            extract_geometries, extract_intervals, geometry_bounds,
        )

        n = self.total_count()
        if not n or sft.geom_field is None:
            return None
        geoms = extract_geometries(f, sft.geom_field)
        if geoms.disjoint:
            return 0.0
        est = None
        if geoms.values:
            parts = [
                self.estimate_bbox(sft.geom_field, *b)
                for b in geometry_bounds(geoms)
            ]
            if any(p is None for p in parts):
                return None
            est = min(float(np.sum(parts)), float(n))
        if sft.dtg_field is not None:
            intervals = extract_intervals(f, sft.dtg_field)
            if intervals.disjoint:
                return 0.0
            if intervals.values:
                h = self.histograms.get(sft.dtg_field)
                if h is not None and h.counts.sum() > 0:
                    frac = sum(
                        h.estimate_range(float(iv.lo), float(iv.hi))
                        for iv in intervals.values
                    ) / float(h.counts.sum())
                    frac = min(frac, 1.0)
                    est = n * frac if est is None else est * frac
        return est

    def attribute_bounds(self, attr: str):
        mm = self.minmax.get(attr)
        return mm.bounds if mm is not None else None

    def to_json(self) -> dict:
        return {
            "count": self.count.to_json(),
            "minmax": {k: v.to_json() for k, v in self.minmax.items()},
            "topk": {k: v.to_json() for k, v in self.topk.items()},
        }
