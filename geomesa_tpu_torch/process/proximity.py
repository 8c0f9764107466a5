"""Proximity search: features within a distance of a set of input points.

Reference: ProximitySearchProcess (geomesa-process/src/
main/scala/org/locationtech/geomesa/process/query/
ProximitySearchProcess.scala) — buffers each input geometry and unions the
results. Here: one store query over the union of buffered bboxes, then a
vectorized min-distance-to-any-input refinement.

The port's copy of geomesa_tpu/process/proximity.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import And, Filter, Include, Or
from geomesa_tpu_torch.process.knn import _meters_to_degrees, haversine_m, wrap_box_filter


def proximity_search(
    store,
    type_name: str,
    points: "np.ndarray | list",
    distance_m: float,
    filter: Filter = Include(),
) -> FeatureCollection:
    """Features within ``distance_m`` meters of any of the (x, y) points."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    if len(pts) == 0:
        return _empty(store, type_name)
    sft = store.get_schema(type_name)
    geom = sft.geom_field
    boxes = [
        wrap_box_filter(
            geom,
            x - (deg := _meters_to_degrees(distance_m, y)), y - deg,
            x + deg, y + deg,
        )
        for x, y in pts
    ]
    spatial: Filter = boxes[0] if len(boxes) == 1 else Or(tuple(boxes))
    f = spatial if isinstance(filter, Include) else And((spatial, filter))
    out = store.query(type_name, f)
    if len(out) == 0:
        return out
    cx, cy = out.representative_xy()
    # [n, p] pairwise distances; keep rows within range of any input
    d = haversine_m(
        cx[:, None], cy[:, None], pts[None, :, 0], pts[None, :, 1]
    )
    return out.mask(d.min(axis=1) <= distance_m)


def _empty(store, type_name: str) -> FeatureCollection:
    return store.features(type_name).take(np.zeros(0, dtype=np.int64))


def standing_proximity(
    lam,
    sub_id: str,
    points: "np.ndarray | list",
    distance_m: float,
    attrs: "dict | None" = None,
):
    """:func:`proximity_search`, STANDING (docs/standing.md): instead of
    one query over stored features, register a persistent subscription
    on a :class:`~geomesa_tpu_torch.streaming.LambdaStore` — every arriving
    batch routes through the inverted SubscriptionIndex and events
    within ``distance_m`` of any input point deliver alerts. Same
    refinement semantics as the one-shot process (haversine min-distance
    to any input). Returns the registered
    :class:`~geomesa_tpu_torch.streaming.Subscription`."""
    from geomesa_tpu_torch.streaming.standing import Subscription

    sub = Subscription(
        str(sub_id), "proximity",
        points=np.asarray(points, np.float64).reshape(-1, 2),
        distance_m=float(distance_m), attrs=dict(attrs or {}),
    )
    lam.subscribe(sub)
    return sub
