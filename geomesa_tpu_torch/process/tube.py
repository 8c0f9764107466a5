"""Tube select: spatio-temporal corridor search along a track.

Reference: TubeSelectProcess + TubeBuilder (
geomesa-process/src/main/scala/org/locationtech/geomesa/process/tube/
TubeSelectProcess.scala:36, TubeBuilder.scala) — bins an input track into
time slices, buffers each slice's geometry, and queries features that fall
inside the moving buffer both spatially and temporally. The columnar
redesign bins the track the same way (``bin_ms`` slices, interpolating
positions), issues one Or-of-(bbox And interval) indexed query, and
refines with a vectorized distance test against each row's own
time-matched tube center.

The port's copy of geomesa_tpu/process/tube.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import And, BBox, During, Filter, Include, Or
from geomesa_tpu_torch.process.knn import _meters_to_degrees, haversine_m


def tube_select(
    store,
    type_name: str,
    track_xy: "np.ndarray | list",
    track_times_ms: "np.ndarray | list",
    buffer_m: float,
    bin_ms: int | None = None,
    filter: Filter = Include(),
    max_bins: int = 256,
) -> FeatureCollection:
    """Features within ``buffer_m`` of the track position at their own time.

    ``track_xy``: [n, 2] lon/lat waypoints; ``track_times_ms``: [n] epoch
    millis, ascending. ``bin_ms`` defaults to the track duration / number
    of waypoints (the reference's default binning).
    """
    xy = np.asarray(track_xy, dtype=np.float64).reshape(-1, 2)
    ts = np.asarray(track_times_ms, dtype=np.int64)
    if len(xy) != len(ts) or len(xy) < 2:
        raise ValueError("track needs >= 2 (point, time) pairs")
    if not (np.diff(ts) >= 0).all():
        raise ValueError("track times must be ascending")
    sft = store.get_schema(type_name)
    if sft.dtg_field is None:
        raise ValueError("tube select requires a time attribute")
    geom, dtg = sft.geom_field, sft.dtg_field

    span = int(ts[-1] - ts[0])
    if bin_ms is None:
        bin_ms = max(1, span // max(1, len(xy)))
    n_bins = min(max_bins, max(1, -(-span // bin_ms)))
    bin_ms = -(-span // n_bins)

    # interpolated tube center per bin midpoint
    mids = ts[0] + bin_ms * np.arange(n_bins) + bin_ms // 2
    cx = np.interp(mids, ts, xy[:, 0])
    cy = np.interp(mids, ts, xy[:, 1])

    parts = []
    for i in range(n_bins):
        lo = int(ts[0] + i * bin_ms)
        hi = int(min(ts[0] + (i + 1) * bin_ms, ts[-1] + 1))
        deg = _meters_to_degrees(buffer_m, cy[i])
        # widen by the intra-bin track movement so interpolation error
        # cannot exclude a true hit
        j0, j1 = np.searchsorted(ts, [lo, hi])
        seg_x = np.concatenate([[cx[i]], xy[max(0, j0 - 1) : j1 + 1, 0]])
        seg_y = np.concatenate([[cy[i]], xy[max(0, j0 - 1) : j1 + 1, 1]])
        parts.append(
            And(
                (
                    BBox(
                        geom,
                        float(seg_x.min()) - deg,
                        max(float(seg_y.min()) - deg, -90.0),
                        float(seg_x.max()) + deg,
                        min(float(seg_y.max()) + deg, 90.0),
                    ),
                    During(dtg, lo, hi),
                )
            )
        )
    tube: Filter = parts[0] if len(parts) == 1 else Or(tuple(parts))
    f = tube if isinstance(filter, Include) else And((tube, filter))
    out = store.query(type_name, f)
    if len(out) == 0:
        return out

    # refine: distance from each hit to the track position at the hit's time
    hx, hy = out.representative_xy()
    ht = np.asarray(out.columns[dtg], dtype=np.int64)
    px = np.interp(ht, ts, xy[:, 0])
    py = np.interp(ht, ts, xy[:, 1])
    d = haversine_m(hx, hy, px, py)
    return out.mask(d <= buffer_m)


def standing_tube(
    lam,
    sub_id: str,
    track_xy: "np.ndarray | list",
    track_times_ms: "np.ndarray | list",
    buffer_m: float,
    attrs: "dict | None" = None,
):
    """:func:`tube_select`, STANDING (docs/standing.md): register the
    corridor as a persistent subscription on a
    :class:`~geomesa_tpu_torch.streaming.LambdaStore` — every arriving batch
    routes through the inverted SubscriptionIndex and events within
    ``buffer_m`` of the interpolated track position AT THE EVENT'S OWN
    TIME deliver alerts (events without a usable time never match, the
    TubeSelectProcess refinement). Returns the registered
    :class:`~geomesa_tpu_torch.streaming.Subscription`."""
    from geomesa_tpu_torch.streaming.standing import Subscription

    xy = np.asarray(track_xy, np.float64).reshape(-1, 2)
    ts = np.asarray(track_times_ms, np.int64)
    if len(xy) != len(ts) or len(xy) < 2:
        raise ValueError("track needs >= 2 (point, time) pairs")
    if not (np.diff(ts) >= 0).all():
        raise ValueError("track times must be ascending")
    sub = Subscription(
        str(sub_id), "tube", track_xy=xy, track_times_ms=ts,
        buffer_m=float(buffer_m), attrs=dict(attrs or {}),
    )
    lam.subscribe(sub)
    return sub
