"""Route search: features along a route, heading-matched to its direction.

Reference: RouteSearchProcess (geomesa-process/
geomesa-process-vector/src/main/scala/org/locationtech/geomesa/process/
query/RouteSearchProcess.scala:40-260) — buffers the route linestrings
(dwithin, meters), then keeps candidates whose heading matches the
heading of the *closest route segment* within a threshold (optionally
bidirectional, i.e. either direction along the path).

The columnar redesign: the per-feature JTS DistanceOp + GeodeticCalculator loop
becomes one store query over the buffered route envelopes followed by a
vectorized candidate x segment distance/bearing computation (chunked to
bound memory). Distances/bearings use a local equirectangular projection
per candidate (exact enough at buffer scale; the reference's geodetic
calculator differs sub-degree over typical buffers).

The port's copy of geomesa_tpu/process/route.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import And, Filter, Include, Or
from geomesa_tpu_torch.process.knn import (
    METERS_PER_DEGREE, _meters_to_degrees, wrap_box_filter,
)

_CHUNK = 4_000_000  # max candidate x segment pairs per vectorized block
_MAX_ENVELOPES = 128  # cap on buffered query boxes (segments chunk up)


def _route_coords(route) -> np.ndarray:
    """A route input (LineString, [m, 2] array, or WKT string) -> [m, 2]."""
    if isinstance(route, geo.LineString):
        return np.asarray(route.coords, dtype=np.float64)
    if isinstance(route, str):
        g = geo.from_wkt(route)
        if not isinstance(g, geo.LineString):
            raise ValueError("route WKT must be a LINESTRING")
        return np.asarray(g.coords, dtype=np.float64)
    a = np.asarray(route, dtype=np.float64)
    if a.ndim != 2 or a.shape[1] != 2 or len(a) < 2:
        raise ValueError("route must be an [m>=2, 2] coordinate array")
    return a


def _segment_bearings(a: np.ndarray, b: np.ndarray, lat_ref: np.ndarray) -> np.ndarray:
    """Compass bearings (degrees clockwise from north, [0, 360)) of
    segments a->b under the local equirectangular projection."""
    dx = (b[:, 0] - a[:, 0]) * np.cos(np.radians(lat_ref))
    dy = b[:, 1] - a[:, 1]
    return (np.degrees(np.arctan2(dx, dy)) + 360.0) % 360.0


def heading_diff(a, b) -> np.ndarray:
    """Absolute compass-heading difference in [0, 180]."""
    d = np.abs(np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64))
    return np.where(d > 180.0, np.abs(d - 360.0), d)


def route_search(
    store,
    type_name: str,
    routes,
    buffer_m: float,
    heading_threshold_deg: float,
    heading_field: "str | None" = None,
    bidirectional: bool = False,
    filter: Filter = Include(),
) -> FeatureCollection:
    """Features within ``buffer_m`` meters of any route whose heading
    matches the closest route segment within ``heading_threshold_deg``.

    ``heading_field``: attribute holding each feature's compass heading.
    Required for point features (reference behavior); linestring features
    default to the bearing of their last segment, compared at their end
    point (the track's "current" position/heading).
    """
    segs_a, segs_b = _route_segments(routes)
    if len(segs_a) == 0:
        return store.features(type_name).take(np.zeros(0, dtype=np.int64))

    sft = store.get_schema(type_name)
    geom = sft.geom_field
    if heading_field is None and sft.is_points:
        raise ValueError(
            "heading_field is required when the input geometries are points"
        )
    if heading_field is not None and not sft.has(heading_field):
        raise ValueError(f"heading field '{heading_field}' does not exist")

    # one store query over buffered envelopes. Segments chunk into at most
    # _MAX_ENVELOPES boxes (vectorized min/max reduce per chunk): a 50k-
    # vertex GPS track must not become a 50k-term Or filter, and route
    # segments are consecutive so chunk envelopes stay tight.
    lo = np.minimum(segs_a, segs_b)
    hi = np.maximum(segs_a, segs_b)
    s = len(lo)
    per = -(-s // _MAX_ENVELOPES)
    pad = per * _MAX_ENVELOPES - s
    if pad:
        lo = np.concatenate([lo, np.repeat(lo[-1:], pad, axis=0)])
        hi = np.concatenate([hi, np.repeat(hi[-1:], pad, axis=0)])
    clo = lo.reshape(-1, per, 2).min(axis=1)  # [chunks, 2]
    chi = hi.reshape(-1, per, 2).max(axis=1)
    degs = np.array([
        _meters_to_degrees(buffer_m, float(max(abs(a), abs(b))))
        for a, b in zip(clo[:, 1], chi[:, 1])
    ])
    boxes = [
        wrap_box_filter(
            geom, clo[i, 0] - degs[i], clo[i, 1] - degs[i],
            chi[i, 0] + degs[i], chi[i, 1] + degs[i],
        )
        for i in range(len(clo))
    ]
    spatial: Filter = boxes[0] if len(boxes) == 1 else Or(tuple(boxes))
    f = spatial if isinstance(filter, Include) else And((spatial, filter))
    out = store.query(type_name, f)
    if len(out) == 0:
        return out

    px, py, feat_heading = _comparison_points(out, geom, heading_field)

    # closest segment per candidate (chunked [n, s] distance matrix)
    n, s = len(px), len(segs_a)
    best_d = np.full(n, np.inf)
    best_bearing = np.zeros(n)
    rows_per = max(1, _CHUNK // s)
    for i in range(0, n, rows_per):
        j = slice(i, min(i + rows_per, n))
        d, bearing = _point_segment_distances(px[j], py[j], segs_a, segs_b)
        k = np.argmin(d, axis=1)
        rng = np.arange(len(k))
        best_d[j] = d[rng, k]
        best_bearing[j] = bearing[rng, k]

    keep = best_d <= buffer_m
    diff = heading_diff(best_bearing, feat_heading)
    match = diff <= heading_threshold_deg
    if bidirectional:
        match |= np.abs(diff - 180.0) <= heading_threshold_deg
    return out.mask(keep & match)


def _route_segments(routes):
    """Routes -> (starts [s, 2], ends [s, 2]) over all segments."""
    if isinstance(routes, (geo.LineString, str)) or (
        isinstance(routes, np.ndarray) and routes.ndim == 2
    ):
        routes = [routes]
    a_parts, b_parts = [], []
    for r in routes:
        c = _route_coords(r)
        a_parts.append(c[:-1])
        b_parts.append(c[1:])
    if not a_parts:
        return np.zeros((0, 2)), np.zeros((0, 2))
    return np.concatenate(a_parts), np.concatenate(b_parts)


def _comparison_points(fc: FeatureCollection, geom: str, heading_field):
    """(x, y, heading) per candidate: points use (x, y) + heading column;
    linestrings use their end point + last-segment bearing."""
    col = fc.columns[geom]
    from geomesa_tpu_torch.filter.predicates import PointColumn

    if isinstance(col, PointColumn):
        px, py = np.asarray(col.x, np.float64), np.asarray(col.y, np.float64)
        heading = np.asarray(fc.columns[heading_field], dtype=np.float64)
        return px, py, heading
    n = len(fc)
    px = np.empty(n)
    py = np.empty(n)
    heading = np.empty(n)
    for i in range(n):
        g = col.geometry(i)
        if not isinstance(g, geo.LineString) or len(g.coords) < 2:
            raise ValueError("route matching requires Point or LineString features")
        c = np.asarray(g.coords, dtype=np.float64)
        px[i], py[i] = c[-1]
        if heading_field is not None:
            heading[i] = float(fc.columns[heading_field][i])
        else:
            heading[i] = _segment_bearings(
                c[-2:-1], c[-1:], np.array([c[-1, 1]])
            )[0]
    return px, py, heading


def _point_segment_distances(px, py, a, b):
    """([n] points, [s] segments) -> (distance_m [n, s], bearing [n, s]).

    Local equirectangular projection anchored per candidate point: lon is
    scaled by cos(lat) so both distance and the projected nearest point
    are in meters."""
    lat_scale = np.cos(np.radians(py))[:, None]  # [n, 1]
    ax = (a[None, :, 0] - px[:, None]) * lat_scale * METERS_PER_DEGREE
    ay = (a[None, :, 1] - py[:, None]) * METERS_PER_DEGREE
    bx = (b[None, :, 0] - px[:, None]) * lat_scale * METERS_PER_DEGREE
    by = (b[None, :, 1] - py[:, None]) * METERS_PER_DEGREE
    dx = bx - ax
    dy = by - ay
    seg_len2 = dx * dx + dy * dy
    # projection parameter of the origin (the candidate) onto each segment
    t = np.clip(-(ax * dx + ay * dy) / np.maximum(seg_len2, 1e-12), 0.0, 1.0)
    cx = ax + t * dx
    cy = ay + t * dy
    d = np.sqrt(cx * cx + cy * cy)
    bearing = (np.degrees(np.arctan2(dx, dy)) + 360.0) % 360.0
    return d, bearing
