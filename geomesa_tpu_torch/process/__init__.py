"""Analytics processes: the WPS-process tier of the reference
(geomesa-process, SURVEY.md §2.5) re-based on the DataStore query path.

Each process composes planner queries with vectorized post-compute:
k-nearest-neighbour search (single + pipelined batch), proximity and
route search, tube (spatio-temporal corridor) select, unique-value
enumeration, attribute joins, track transforms (point2point,
track_label, date_offset), BIN/Arrow conversion, and thin
query/sampling/minmax wrappers; density/stats wrap the DataStore
push-downs directly. All window-building processes wrap the
antimeridian.

Proximity and tube select also come in STANDING form
(:func:`standing_proximity` / :func:`standing_tube`): instead
of one query over stored features, they register persistent
subscriptions on a LambdaStore's inverted SubscriptionIndex — every
arriving batch is matched and alerts deliver continuously
(docs/standing.md).

The port's copy of geomesa_tpu/process/__init__.py,
held to it by the CPU parity tests.
"""

from geomesa_tpu_torch.process.join import join_search
from geomesa_tpu_torch.process.knn import knn_many, knn_search
from geomesa_tpu_torch.process.proximity import proximity_search, standing_proximity
from geomesa_tpu_torch.process.route import heading_diff, route_search
from geomesa_tpu_torch.process.transforms import (
    arrow_conversion,
    bin_conversion,
    date_offset,
    minmax_process,
    point2point,
    query_process,
    sampling_process,
    track_label,
)
from geomesa_tpu_torch.process.tube import standing_tube, tube_select
from geomesa_tpu_torch.process.unique import unique_values

__all__ = [
    "arrow_conversion",
    "bin_conversion",
    "date_offset",
    "heading_diff",
    "join_search",
    "knn_many",
    "knn_search",
    "minmax_process",
    "point2point",
    "proximity_search",
    "query_process",
    "route_search",
    "sampling_process",
    "standing_proximity",
    "standing_tube",
    "track_label",
    "tube_select",
    "unique_values",
]
