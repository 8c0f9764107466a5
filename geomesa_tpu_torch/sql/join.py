"""Grid-partitioned spatial join with selectivity-adaptive planning.

Reference: GeoMesaJoinRelation — both sides are partitioned by an envelope
grid, candidate pairs form within each cell, and the exact JTS predicate
runs per pair (geomesa-spark/geomesa-spark-sql/src/main/
scala/org/locationtech/geomesa/spark/sql/GeoMesaRelation.scala:69-91,
RelationUtils.grid). The redesign keeps the grid partitioning but the
candidate stage is one vectorized bbox-overlap test per cell (the bbox
columns are exactly what the scan kernels use), with the exact geometry
predicate applied only to surviving pairs.

Adaptive planning (arXiv 1802.09488 + the cache tier's adaptive
cost gate, cache/tiles.py): no single strategy wins every partition, so
the join picks PER PARTITION from measured selectivity —

- ``spatial_join``: each polygon-left partition samples its candidates'
  raster-cell selectivity (filter.raster) and chooses between the plain
  vectorized bbox+exact pairing and the raster-filtered pairing
  (definite-in/definite-out by integer interval check, exact PIP only on
  the boundary residue), using live EWMAs of both predicates' measured
  unit costs;
- ``spatial_join_indexed``: polygons whose candidate spans cover more
  than ``geomesa.join.broad.fraction`` of the table skip the fused-scan
  probe and classify the whole point set against their raster on host
  (one vectorized pass beats scanning ~the entire store through the
  kernel); everything else keeps the fused-scan probe, which itself now
  rides the raster tier via ScanConfig.rast.

Either strategy returns bit-identical pairs — the adaptive layer moves
work, never answers.

The port's copy of geomesa_tpu/sql/join.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import PointColumn
from geomesa_tpu_torch.metrics import resolve as _resolve_metrics
from geomesa_tpu_torch.tuning.primitives import CostEwma


class _AdaptiveGate:
    """Measured-cost strategy picker (the tile cache's adaptive-gate
    pattern, shared mechanics in tuning/primitives.py): EWMAs of the
    exact predicate's per-(point x edge) cost and the raster
    classification's per-point cost, updated from every partition
    actually executed. Predictions are per partition:
    plain = n * E * pip vs raster = n * cls + boundary_frac * n * E * pip
    with ``boundary_frac`` the partition's sampled selectivity."""

    _ALPHA = 0.25

    def __init__(self):
        self._pip = CostEwma(self._ALPHA)  # seconds per point*edge
        self._cls = CostEwma(self._ALPHA)  # seconds per classified point
        self._lock = threading.Lock()

    @property
    def pip_s(self) -> "float | None":
        return self._pip.value

    @property
    def cls_s(self) -> "float | None":
        return self._cls.value

    def update(self, kind: str, seconds: float, units: int) -> None:
        ewma = self._pip if kind == "pip_s" else self._cls
        with self._lock:
            ewma.update_cost(seconds, units)

    def pick(self, n_cand: int, n_edges: int, boundary_frac: float) -> str:
        # cold-start priors (the JAX package's, measured on a CPU);
        # real measurements take over after the first partitions
        pip = self._pip.value_or(4e-9)
        cls = self._cls.value_or(2e-8)
        plain = n_cand * n_edges * pip
        rast = n_cand * cls + boundary_frac * n_cand * n_edges * pip
        return "raster" if rast < plain else "exact"


_GATE = _AdaptiveGate()


def _bboxes(fc: FeatureCollection) -> np.ndarray:
    """[n, 4] f64 per-feature bboxes."""
    col = fc.geom_column
    if isinstance(col, PointColumn):
        return np.stack([col.x, col.y, col.x, col.y], axis=1).astype(np.float64)
    return col.bboxes.astype(np.float64)


def _envelope(fc: FeatureCollection) -> tuple[float, float, float, float]:
    """(xmin, ymin, xmax, ymax) of a collection without materializing the
    [n, 4] bbox array (points: two reductions over the coordinate
    columns — the stack itself cost ~100 ms at 2M rows)."""
    col = fc.geom_column
    if isinstance(col, PointColumn):
        return (
            float(col.x.min()), float(col.y.min()),
            float(col.x.max()), float(col.y.max()),
        )
    b = col.bboxes
    return (
        float(b[:, 0].min()), float(b[:, 1].min()),
        float(b[:, 2].max()), float(b[:, 3].max()),
    )


def _cell_argsort(cell: np.ndarray, n_cells: int) -> np.ndarray:
    """Stable argsort of small-integer cell ids: O(n) native counting sort
    when available (np.argsort is n log n and dominated the point-side
    join setup at 2M rows), numpy stable sort fallback."""
    from geomesa_tpu_torch import native

    perm = native.counting_argsort(cell, n_cells)
    if perm is not None:
        return perm
    return np.argsort(cell, kind="stable")


def _cells_for(b: np.ndarray, x0, y0, inv_cx, inv_cy, nx, ny) -> list[np.ndarray]:
    """Per-feature arrays of covered cell ids."""
    i0 = np.clip(((b[:, 0] - x0) * inv_cx).astype(np.int64), 0, nx - 1)
    i1 = np.clip(((b[:, 2] - x0) * inv_cx).astype(np.int64), 0, nx - 1)
    j0 = np.clip(((b[:, 1] - y0) * inv_cy).astype(np.int64), 0, ny - 1)
    j1 = np.clip(((b[:, 3] - y0) * inv_cy).astype(np.int64), 0, ny - 1)
    out = []
    for a0, a1, c0, c1 in zip(i0, i1, j0, j1):
        ii, jj = np.meshgrid(np.arange(a0, a1 + 1), np.arange(c0, c1 + 1))
        out.append((jj * nx + ii).ravel())
    return out


def spatial_join(
    left: FeatureCollection,
    right: FeatureCollection,
    predicate: "str | Callable" = "intersects",
    grid: tuple[int, int] = (32, 32),
    max_distance: float | None = None,
    strategy: str = "auto",
    metrics=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Join two collections on a spatial predicate.

    Returns (left_idx, right_idx) — parallel arrays of matching row pairs,
    sorted by (left, right). ``predicate``: "intersects" | "contains"
    (left contains right) | "within" (left within right) | "dwithin"
    (requires ``max_distance``, planar degrees) | a callable
    (Geometry, Geometry) -> bool.

    ``strategy`` (polygon-left x point-right partitions only): "auto"
    picks per partition between the plain exact pairing and the
    raster-filtered pairing from sampled boundary-cell selectivity and
    measured costs (see module docstring); "exact" / "raster" force one
    side. Results are identical either way. ``metrics``: optional
    MetricsRegistry for the geomesa.join.strategy.* counters (the
    process-global registry by default).
    """
    if strategy not in ("auto", "exact", "raster"):
        raise ValueError(f"unknown join strategy {strategy!r}")
    if len(left) == 0 or len(right) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    pred = _predicate(predicate, max_distance)
    lb = _bboxes(left)
    renv = _envelope(right)
    pad = float(max_distance) if predicate == "dwithin" else 0.0
    if pad:
        lb = lb + np.array([-pad, -pad, pad, pad])

    # grid over the intersection of the two envelopes (only overlapping
    # space can produce pairs)
    x0 = max(lb[:, 0].min(), renv[0])
    y0 = max(lb[:, 1].min(), renv[1])
    x1 = min(lb[:, 2].max(), renv[2])
    y1 = min(lb[:, 3].max(), renv[3])
    if x1 < x0 or y1 < y0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    nx, ny = grid
    inv_cx = nx / max(x1 - x0, 1e-12)
    inv_cy = ny / max(y1 - y0, 1e-12)

    in_l = (lb[:, 2] >= x0) & (lb[:, 0] <= x1) & (lb[:, 3] >= y0) & (lb[:, 1] <= y1)
    li = np.nonzero(in_l)[0]

    # right-side points + containment-style predicate: the whole pipeline
    # vectorizes — points sort by grid cell once, each left feature's
    # covered cell rows slice out candidates with searchsorted, the bbox
    # test and geo.points_in_polygon run per-left over arrays. No Python
    # per-pair loop and no per-point cell materialization (both were the
    # join's bottleneck), no dedup needed (a point owns exactly one cell).
    if isinstance(right.geom_column, PointColumn) and predicate in (
        "contains", "intersects"
    ):
        return _join_points_right(
            left, right, lb, pred, predicate,
            x0, y0, inv_cx, inv_cy, nx, ny, li,
            strategy=strategy, metrics=metrics,
        )

    # assign features to covered cells (extents span multiple)
    rb = _bboxes(right)
    in_r = (rb[:, 2] >= x0) & (rb[:, 0] <= x1) & (rb[:, 3] >= y0) & (rb[:, 1] <= y1)
    ri = np.nonzero(in_r)[0]
    l_cells = _cells_for(lb[li], x0, y0, inv_cx, inv_cy, nx, ny)
    r_cells = _cells_for(rb[ri], x0, y0, inv_cx, inv_cy, nx, ny)

    by_cell_r: dict[int, list[int]] = {}
    for k, cells in zip(ri, r_cells):
        for c in cells.tolist():
            by_cell_r.setdefault(c, []).append(k)

    lgeoms: dict[int, geo.Geometry] = {}
    rgeoms: dict[int, geo.Geometry] = {}
    pairs: set[tuple[int, int]] = set()
    for k, cells in zip(li, l_cells):
        cand: set[int] = set()
        for c in cells.tolist():
            cand.update(by_cell_r.get(c, ()))
        if not cand:
            continue
        cand_arr = np.fromiter(cand, dtype=np.int64)
        # vectorized bbox prefilter
        ov = (
            (rb[cand_arr, 0] <= lb[k, 2])
            & (rb[cand_arr, 2] >= lb[k, 0])
            & (rb[cand_arr, 1] <= lb[k, 3])
            & (rb[cand_arr, 3] >= lb[k, 1])
        )
        hits = cand_arr[ov]
        if len(hits) == 0:
            continue
        ga = lgeoms.get(k)
        if ga is None:
            ga = lgeoms[k] = _geom(left, k)
        for j in hits.tolist():
            if (k, j) in pairs:
                continue
            gb = rgeoms.get(j)
            if gb is None:
                gb = rgeoms[j] = _geom(right, j)
            if pred(ga, gb):
                pairs.add((k, j))
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    out = np.array(sorted(pairs), dtype=np.int64)
    return out[:, 0], out[:, 1]


def _polygon_inside(xs, ys, ga, predicate, approx, metrics, cls=None):
    """Which candidate points satisfy ``predicate`` against polygon
    ``ga`` — the raster-filtered pairing: interval classification first
    (definite in/out need no geometry math), exact even-odd PIP +
    boundary test only on the boundary-cell residue. Bit-identical to
    the plain pairing: full cells are strictly interior (margin), out
    cells strictly exterior, so only partial-cell points can differ
    from — and they run — the exact code. ``cls``: optionally reuse an
    already-computed classification of exactly these points."""
    if cls is None:
        t0 = time.perf_counter()
        cls = approx.classify_points(xs, ys)
        _GATE.update("cls_s", time.perf_counter() - t0, len(xs))
    inside = cls == geo.RASTER_FULL
    bidx = np.flatnonzero(cls == geo.RASTER_PARTIAL)
    metrics.counter("geomesa.join.raster.decided", len(xs) - len(bidx))
    metrics.counter("geomesa.join.raster.residue", len(bidx))
    if len(bidx):
        t0 = time.perf_counter()
        inside[bidx] = geo.points_in_polygon(xs[bidx], ys[bidx], ga)
        if predicate != "contains":  # intersects counts boundary points
            nb = bidx[~inside[bidx]]
            if len(nb):
                onb = geo.points_on_boundary(xs[nb], ys[nb], ga)
                inside[nb[onb]] = True
        _GATE.update(
            "pip_s", time.perf_counter() - t0, len(bidx) * _edge_count(ga)
        )
    return inside


def _plain_inside(xs, ys, ga, predicate):
    """The pre-raster exact pairing: even-odd PIP over every candidate,
    boundary test on the non-interior residue for intersects."""
    t0 = time.perf_counter()
    inside = geo.points_in_polygon(xs, ys, ga)
    if predicate != "contains":  # intersects counts boundary points
        out_idx = np.flatnonzero(~inside)
        if len(out_idx):
            onb = geo.points_on_boundary(xs[out_idx], ys[out_idx], ga)
            inside[out_idx[onb]] = True
    _GATE.update("pip_s", time.perf_counter() - t0, len(xs) * _edge_count(ga))
    return inside


def _edge_count(ga) -> int:
    return sum(len(r) - 1 for r in geo._rings_of(ga))


def _pick_strategy(xs, ys, ga, approx, strategy):
    """Per-partition strategy decision (arXiv 1802.09488): sample the
    candidates' raster-cell selectivity, predict both strategies' costs
    from the gate's measured EWMAs, take the cheaper. Returns
    (strategy, full classification | None) — when the partition is
    smaller than the sample size the 'sample' covered every candidate,
    and the raster branch reuses it instead of classifying twice."""
    if approx is None:
        return "exact", None
    if strategy != "auto":
        return strategy, None
    from geomesa_tpu_torch.conf import JOIN_SAMPLE

    s = max(int(JOIN_SAMPLE.get()), 1)
    step = max(len(xs) // s, 1)
    t0 = time.perf_counter()
    sample = approx.classify_points(xs[::step], ys[::step])
    _GATE.update("cls_s", time.perf_counter() - t0, max(len(xs) // step, 1))
    frac_b = float((sample == geo.RASTER_PARTIAL).mean())
    chosen = _GATE.pick(len(xs), _edge_count(ga), frac_b)
    return chosen, sample if step == 1 else None


def _join_points_right(left, right, lb, pred, predicate, x0, y0, inv_cx,
                       inv_cy, nx, ny, li, strategy="auto", metrics=None):
    from geomesa_tpu_torch.conf import JOIN_ADAPTIVE
    from geomesa_tpu_torch.filter import raster as fr

    metrics = _resolve_metrics(metrics)
    adaptive = JOIN_ADAPTIVE.get() and strategy != "exact"
    col = right.geom_column
    px, py = col.x, col.y
    cx = np.clip(((px - x0) * inv_cx).astype(np.int64), 0, nx - 1)
    cy = np.clip(((py - y0) * inv_cy).astype(np.int64), 0, ny - 1)
    cell = cy * nx + cx
    n_cells = nx * ny
    # the O(n_cells) structures (counting sort, cumulative starts) only pay
    # off while the grid is not much larger than the point count; a huge
    # caller-supplied grid would allocate O(n_cells) memory for nothing
    dense_grid = n_cells <= max(4 * len(px), 1 << 20)
    order = _cell_argsort(cell, n_cells) if dense_grid else np.argsort(cell, kind="stable")
    cell_s = cell[order]
    px_s, py_s = px[order], py[order]
    if dense_grid:
        # per-cell start offsets: cell_s is sorted, so candidate slices
        # come from one cumulative count instead of per-poly searchsorteds
        cell_starts = np.zeros(n_cells + 1, dtype=np.int64)
        np.cumsum(np.bincount(cell_s, minlength=n_cells), out=cell_starts[1:])

    L: list[np.ndarray] = []
    R: list[np.ndarray] = []
    for k in li:
        bx0, by0, bx1, by1 = lb[k]
        cx0 = max(int((bx0 - x0) * inv_cx), 0)
        cx1 = min(int((bx1 - x0) * inv_cx), nx - 1)
        cy0 = max(int((by0 - y0) * inv_cy), 0)
        cy1 = min(int((by1 - y0) * inv_cy), ny - 1)
        if cx1 < cx0 or cy1 < cy0:
            continue
        row_base = np.arange(cy0, cy1 + 1, dtype=np.int64) * nx
        if dense_grid:
            starts = cell_starts[row_base + cx0]
            stops = cell_starts[row_base + cx1 + 1]
        else:
            starts = np.searchsorted(cell_s, row_base + cx0)
            stops = np.searchsorted(cell_s, row_base + cx1 + 1)
        chunks = [np.arange(a, z) for a, z in zip(starts, stops) if z > a]
        if not chunks:
            continue
        sel = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        if len(sel) == 0:
            continue
        xs, ys = px_s[sel], py_s[sel]
        m = (xs >= bx0) & (xs <= bx1) & (ys >= by0) & (ys <= by1)
        sel, xs, ys = sel[m], xs[m], ys[m]
        if len(sel) == 0:
            continue
        ga = _geom(left, int(k))
        if isinstance(ga, (geo.Polygon, geo.MultiPolygon)):
            approx = fr.raster_for(ga) if adaptive else None
            chosen, pre_cls = _pick_strategy(xs, ys, ga, approx, strategy)
            if chosen == "raster" and approx is not None:
                metrics.counter("geomesa.join.strategy.raster")
                inside = _polygon_inside(
                    xs, ys, ga, predicate, approx, metrics, cls=pre_cls
                )
            else:
                metrics.counter("geomesa.join.strategy.exact")
                inside = _plain_inside(xs, ys, ga, predicate)
            hit = sel[inside]
            if len(hit):
                L.append(np.full(len(hit), k, dtype=np.int64))
                R.append(order[hit])
        else:  # non-polygonal left (point/line): per-candidate exact
            keep = [
                s for s in sel.tolist()
                if pred(ga, geo.Point(float(px_s[s]), float(py_s[s])))
            ]
            if keep:
                L.append(np.full(len(keep), k, dtype=np.int64))
                R.append(order[np.array(keep)])
    if not L:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lo = np.concatenate(L)
    ro = np.concatenate(R).astype(np.int64)
    srt = np.lexsort((ro, lo))
    return lo[srt], ro[srt]


def _geom(fc: FeatureCollection, i: int) -> geo.Geometry:
    col = fc.geom_column
    if isinstance(col, PointColumn):
        return geo.Point(float(col.x[i]), float(col.y[i]))
    return col.geometry(int(i))


def _predicate(predicate, max_distance):
    if callable(predicate):
        return predicate
    if predicate == "intersects":
        return geo.intersects
    if predicate == "contains":
        return geo.contains
    if predicate == "within":
        return lambda a, b: geo.contains(b, a)
    if predicate == "dwithin":
        if max_distance is None:
            raise ValueError("dwithin requires max_distance")
        return lambda a, b: geo.distance(a, b) <= max_distance
    raise ValueError(f"unknown predicate {predicate!r}")


def spatial_join_indexed(
    ds,
    type_name: str,
    left: FeatureCollection,
    predicate: str = "contains",
    index: str = "z2",
    metrics=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Device-side spatial join against an INDEXED point store: every
    left geometry becomes one scan over the store's z2 table, all of
    them fused into the multi-query kernel (K2) — candidate blocks from
    each geometry's z-ranges, its box, point-in-polygon or raster leg
    masks points on the card, and ALL scans dispatch before any plane
    pulls (the same pipeline as query_many).

    Returns (left_idx, right_ordinal) pairs sorted by (left, right) —
    right ordinals index ``ds.features(type_name)``. This is the
    reference's broadcast join shape (geomesa-spark GeoMesaJoinRelation:
    the point side IS the GeoMesa-indexed relation); use
    :func:`spatial_join` for two bare collections.

    ``predicate``: "contains" (left polygon strictly contains the point)
    or "intersects" (boundary points count).
    """
    if predicate not in ("contains", "intersects"):
        raise ValueError(f"indexed join supports contains/intersects, got {predicate!r}")
    n_left = len(left)
    if n_left == 0 or len(ds.features(type_name)) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    from geomesa_tpu_torch.filter.predicates import BBox, Intersects

    sft = ds.get_schema(type_name)
    gf = sft.geom_field
    idx = next((i for i in ds.indexes(type_name) if i.name == index), None)
    if idx is None:
        have = [i.name for i in ds.indexes(type_name)]
        raise ValueError(
            f"indexed join needs the {index!r} index on {type_name!r}; "
            f"store has {have}"
        )
    table = ds.table(type_name, index)
    pts = ds.features(type_name).geom_column
    if not isinstance(pts, PointColumn):
        raise TypeError("indexed join requires a point store")

    from geomesa_tpu_torch.conf import JOIN_ADAPTIVE, JOIN_BROAD_FRACTION
    from geomesa_tpu_torch.filter import raster as fr

    metrics = _resolve_metrics(metrics)
    broad_frac = float(JOIN_BROAD_FRACTION.get())
    adaptive = bool(JOIN_ADAPTIVE.get())

    lgeoms = left.geometries()
    # ONE fused dispatch for all left geometries' scans: scan_submit_many
    # groups box, polygon-PIP, and raster-interval scans into shared
    # kernel chunks (the per-query edge/raster stacks), so a
    # polygon-heavy join pays O(chunks) dispatches instead of
    # O(polygons). Adaptive strategy (arXiv 1802.09488): a polygon whose
    # candidate spans cover most of the table would scan ~the whole
    # store through the kernel — ONE vectorized host pass over its
    # raster classes is cheaper, so broad partitions take that route
    # instead (measured selectivity = candidate rows / table rows).
    cfgs: list = []
    exacts: list[bool] = []
    host_results: dict[int, np.ndarray] = {}
    for k, g in enumerate(lgeoms):
        rect = geo.is_rectangle(g)
        f = BBox(gf, *g.bounds()) if rect else Intersects(gf, g)
        cfg = idx.scan_config(f)
        if cfg is None or cfg.disjoint:
            cfgs.append(None)
            exacts.append(False)
            continue
        if adaptive and not rect and not cfg.disjoint:
            spans = table.candidate_spans(cfg)
            cand_rows = sum(hi - lo for lo, hi in spans)
            if cand_rows > broad_frac * max(table.n, 1):
                approx = fr.raster_for(g)
                if approx is not None:
                    metrics.counter("geomesa.join.strategy.host_raster")
                    inside = _polygon_inside(
                        np.asarray(pts.x, np.float64),
                        np.asarray(pts.y, np.float64),
                        g, predicate, approx, metrics,
                    )
                    host_results[k] = np.flatnonzero(inside).astype(np.int64)
                    cfgs.append(None)
                    exacts.append(False)
                    continue
        metrics.counter("geomesa.join.strategy.probe")
        # certainty is only trustworthy when the device evaluated the
        # TRUE predicate: the shrunk box for rectangles, the PIP or
        # raster tiers for polygons. A polygon past the edge-bucket
        # ladder with no raster (cfg.poly and cfg.rast both None) gets
        # bbox certainty only — every row must host-refine or
        # bbox-inside-but-outside-polygon points would join as false
        # pairs
        cfgs.append(cfg)
        exacts.append(rect or cfg.poly is not None or cfg.rast is not None)
    live_idx = [k for k, c in enumerate(cfgs) if c is not None]
    fins = table.scan_submit_many([cfgs[k] for k in live_idx])

    # per-left ordinal results keyed by k, emitted in k order at the end
    # so the documented (left, right) sort holds across strategies
    per_left: dict[int, np.ndarray] = {
        k: ords for k, ords in host_results.items() if len(ords)
    }
    for k, fin in zip(live_idx, fins):
        ordinals, certain = fin()
        exact_on_device = exacts[k]
        if not exact_on_device:
            certain = np.zeros(len(ordinals), dtype=bool)
        if len(ordinals) == 0:
            continue
        g = lgeoms[k]
        unc = np.flatnonzero(~certain)
        if len(unc):
            # exact host check over the uncertainty band only (f32 box
            # rounding / PIP near band): vectorized rect compare or the
            # native threaded ray cast
            ux, uy = pts.x[ordinals[unc]], pts.y[ordinals[unc]]
            if geo.is_rectangle(g):
                x0, y0, x1, y1 = g.bounds()
                if predicate == "contains":
                    ok = (ux > x0) & (ux < x1) & (uy > y0) & (uy < y1)
                else:
                    ok = (ux >= x0) & (ux <= x1) & (uy >= y0) & (uy <= y1)
            else:
                ok = geo.points_in_polygon(ux, uy, g)
                if predicate == "intersects":
                    nb = np.flatnonzero(~ok)
                    if len(nb):
                        ok[nb] = geo.points_on_boundary(ux[nb], uy[nb], g)
            keep = certain.copy()
            keep[unc] = ok
            ordinals = ordinals[keep]
        if len(ordinals):
            # decode yields TABLE-row order; perm makes that
            # non-monotonic in feature ordinals — sort so the documented
            # (left, right) pair order actually holds
            per_left[k] = np.sort(ordinals)
    if not per_left:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lo_parts = []
    ro_parts = []
    for k in sorted(per_left):
        ords = per_left[k]
        lo_parts.append(np.full(len(ords), k, dtype=np.int64))
        ro_parts.append(ords)
    return np.concatenate(lo_parts), np.concatenate(ro_parts)
