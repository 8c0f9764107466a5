"""k-nearest-neighbour search over an indexed store.

Reference: KNearestNeighborSearchProcess (geomesa-process/
src/main/scala/org/locationtech/geomesa/process/query/
KNearestNeighborSearchProcess.scala:40) — seeds a search envelope from an
estimated distance, queries the store, and widens the window until k
neighbours are found or the cutoff is hit. Same expanding-window protocol
here; per-candidate distances are one vectorized haversine over the
gathered batch rather than a per-feature priority queue.

The port's copy of geomesa_tpu/process/knn.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import And, Filter, Include

EARTH_RADIUS_M = 6_371_000.0


def haversine_m(lon1, lat1, lon2, lat2) -> np.ndarray:
    """Great-circle distance in meters (vectorized)."""
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(v, dtype=np.float64)) for v in (lon1, lat1, lon2, lat2))
    dlon = lon2 - lon1
    dlat = lat2 - lat1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.minimum(1.0, np.sqrt(a)))


METERS_PER_DEGREE = 111_320.0  # one degree of latitude (~also longitude at equator)


def _meters_to_degrees(m: float, lat: float) -> float:
    """Conservative (over-wide) degree radius for a meter distance."""
    lat_deg = m / METERS_PER_DEGREE
    lon_deg = lat_deg / max(0.01, np.cos(np.radians(min(abs(lat), 89.0))))
    return float(max(lat_deg, lon_deg))


def _degrees_to_meters(deg: float, lat: float) -> float:
    """Meters spanned by a longitude extent of ``deg`` at ``lat`` (the
    inverse direction of _meters_to_degrees, same constants)."""
    return float(
        deg * METERS_PER_DEGREE * max(0.01, np.cos(np.radians(min(abs(lat), 89.0))))
    )


from geomesa_tpu_torch.filter.predicates import wrap_box as wrap_box_filter  # noqa: E402
# (one wrapping implementation — filter.predicates.wrap_box — shared by
# the kNN/proximity/route window builders and the planner's
# normalize_antimeridian rewrite)


def _window_filter(geom: str, x: float, y: float, deg: float) -> Filter:
    return wrap_box_filter(geom, x - deg, y - deg, x + deg, y + deg)


def knn_search(
    store,
    type_name: str,
    x: float,
    y: float,
    k: int,
    estimated_distance_m: "float | None" = None,
    max_distance_m: float = 1_000_000.0,
    filter: Filter = Include(),
) -> FeatureCollection:
    """The k features nearest (x, y), ordered nearest-first.

    Expands the query window from ``estimated_distance_m`` by doubling
    until k in-radius hits exist or ``max_distance_m`` is reached
    (reference's KNNQuery window protocol). With ``estimated_distance_m``
    None, the start radius comes from the store's statistics — mean point
    density refined by the local histogram probe (every extra expansion
    round costs a full store query). One implementation serves the
    single-point and batched forms: this is ``knn_many`` with one point."""
    return knn_many(
        store, type_name, [(x, y)], k,
        estimated_distance_m=estimated_distance_m,
        max_distance_m=max_distance_m, filter=filter,
    )[0]


def knn_many(
    store,
    type_name: str,
    points,
    k: int,
    estimated_distance_m: "float | None" = None,
    max_distance_m: float = 1_000_000.0,
    filter: Filter = Include(),
) -> list[FeatureCollection]:
    """k nearest neighbours for MANY query points with pipelined rounds.

    Each round plans every still-unsatisfied query's window, submits all
    device scans before pulling any result (planner.submit), then doubles
    the radius only for queries short of k — so a batch of Q queries pays
    ~max_rounds pipelined sweeps instead of Q x rounds sequential device
    round-trips. Results are identical to per-point :func:`knn_search`."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    sft = store.get_schema(type_name)
    geom = sft.geom_field
    out: list = [None] * len(pts)
    radii = np.empty(len(pts))
    for i, (x, y) in enumerate(pts):
        r = (
            _estimate_radius_m(store, type_name, k, float(x), float(y), max_distance_m)
            if estimated_distance_m is None
            else float(estimated_distance_m)
        )
        radii[i] = min(max(r, 1.0), float(max_distance_m))
    # speculative wide-window rounds: each pending query scans ONE window
    # at 4x its radius estimate per round — the estimate radius resolves
    # from the SAME result (the degree window is conservatively over-wide,
    # so every point within the estimate radius lies inside the estimate's
    # bbox, which the 4x bbox contains; filtering the wide result by
    # distance is therefore bit-equivalent to scanning the narrow window).
    # Rounds 5-10 dispatched BOTH windows speculatively; halving the
    # per-query dispatches this way is what lets a whole batch's window
    # probes pack into fewer fused block_scan_multi chunks (and halves
    # the plan/decomposition host work per round). A sketch
    # under-estimate still costs zero extra device round-trips — the 4x
    # acceptance check reads the already-pulled result. Radius jumps 16x
    # between rounds (a miss at 4x means the estimate was far off).
    SPEC = 4.0

    def _plan(i: int, r: float):
        x, y = pts[i]
        deg = _meters_to_degrees(r, float(y))
        box = _window_filter(geom, float(x), float(y), deg)
        f = box if isinstance(filter, Include) else And((box, filter))
        return store.planner.plan(type_name, f)

    def _top_k(res, d, in_radius):
        """The k nearest among ``in_radius`` rows, nearest-first — ties
        resolved by original position exactly like a full stable argsort
        (the argpartition prefilter keeps every kth-distance tie, so the
        stable sort of the survivors selects the same rows)."""
        sel = np.nonzero(in_radius)[0]
        ds = d[sel]
        if len(sel) > 4 * k + 64:
            kth = np.partition(ds, k - 1)[k - 1]
            sub = np.nonzero(ds <= kth)[0]
            order = sel[sub[np.argsort(ds[sub], kind="stable")]][:k]
        else:
            order = sel[np.argsort(ds, kind="stable")][:k]
        return res.take(order)

    def _resolve(i: int, res, radii_try):
        """First radius in ``radii_try`` (ascending) holding k-or-more
        hits -> its k nearest; else None (miss -> expand)."""
        x, y = pts[i]
        if len(res):
            cx, cy = res.representative_xy()
            d = haversine_m(x, y, cx, cy)
            for r in radii_try:
                in_radius = d <= r
                if in_radius.sum() >= k or r >= max_distance_m:
                    return _top_k(res, d, in_radius)
        elif radii_try[-1] >= max_distance_m:
            return res
        return None

    pending = list(range(len(pts)))
    while pending:
        # every pending query's window goes through ONE submit_many:
        # scans sharing the index fuse into a single kernel dispatch per
        # variant group (planner.submit_many -> table.scan_submit_many)
        wides = [min(float(radii[i]) * SPEC, max_distance_m) for i in pending]
        fins = store.planner.submit_many(
            [_plan(i, w) for i, w in zip(pending, wides)], hints=None
        )
        nxt = []
        for i, w, fin in zip(pending, wides, fins):
            r = float(radii[i])
            got = _resolve(i, fin(), [r, w] if w > r else [r])
            if got is not None:
                out[i] = got
                continue
            radii[i] = min(float(radii[i]) * SPEC * SPEC, max_distance_m)
            nxt.append(i)
        pending = nxt
    return out


def _estimate_radius_m(
    store,
    type_name: str,
    k: int,
    x: float,
    y: float,
    max_m: float,
    fallback: float = 10_000.0,
) -> float:
    """Start radius for the expanding-window search.

    Two tiers (each device-free):
    1. global mean density over the stats envelope — r such that a circle
       holds ~4k points under uniform density (4x cushion for clustering);
    2. *local* refinement against the Z-histogram sketch (the same
       StatsBasedEstimator tier the planner's cost model uses): grow the
       window host-side until the sketch predicts >= 4k hits near THIS
       query point. Every avoided doubling round saves a full store query
       (one device round-trip), which dominates kNN latency on sparse
       regions — global density badly underestimates the radius there."""
    import math

    stats = store.stats_for(type_name)
    if stats is None:
        return fallback
    geom = store.get_schema(type_name).geom_field
    bx = stats.attribute_bounds(f"{geom}.x")
    by = stats.attribute_bounds(f"{geom}.y")
    n = stats.total_count()
    if not n or bx is None or by is None:
        return fallback
    x0, x1 = float(bx[0]), float(bx[1])
    y0, y1 = float(by[0]), float(by[1])
    mid_lat = (y0 + y1) / 2.0
    area_m2 = _degrees_to_meters(max(x1 - x0, 1e-9), mid_lat) * (
        max(y1 - y0, 1e-9) * METERS_PER_DEGREE
    )
    density = n / area_m2  # points per m^2
    if density <= 0:
        return fallback
    r = math.sqrt(4.0 * k / (math.pi * density))
    # floor: a tight cluster yields a microscopic r, and a query point
    # outside the cluster would then pay many doubling rounds (each a full
    # store query) — never start below a tenth of the old fixed default
    r = max(r, fallback / 10.0)
    return _refine_radius_local(stats, geom, k, x, y, r, max_m)


def _refine_radius_local(
    stats, geom: str, k: int, x: float, y: float, r: float, max_m: float
) -> float:
    """Grow ``r`` until the marginal-histogram estimator predicts ~4k
    hits in the window around (x, y). Sketch-only: no device work, no
    range decomposition — each probe is two histogram range sums."""
    target = max(4 * k, 64)
    while r < max_m:
        deg = _meters_to_degrees(r, y)
        est = stats.estimate_bbox(
            geom, x - deg, max(y - deg, -90.0), x + deg, min(y + deg, 90.0)
        )
        if est is None or est >= target:
            break
        r = min(r * 2.0, max_m)
    return r
