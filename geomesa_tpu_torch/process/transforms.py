"""Transform/analytic processes over feature collections.

Reference: geomesa-process-vector's collection transforms —
Point2PointProcess (geomesa-process/geomesa-process-vector/
src/main/scala/org/locationtech/geomesa/process/analytic/
Point2PointProcess.scala:36-116), TrackLabelProcess (analytic/
TrackLabelProcess.scala:27-60), DateOffsetProcess (transform/
DateOffsetProcess.scala:26-60), BinConversionProcess /
ArrowConversionProcess (transform/). The per-feature iterator pipelines
become grouped numpy passes: one lexsort by (group, time) and boundary
arithmetic over the sorted runs.

The port's copy of geomesa_tpu/process/transforms.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import PointColumn
from geomesa_tpu_torch.sft import FeatureType


def _group_sorted(fc: FeatureCollection, group_field: str, sort_field: str):
    """(order, starts): lexsort of rows by (group, sort) and the start
    offsets of each group run in that order."""
    g = np.asarray(fc.columns[group_field])
    s = np.asarray(fc.columns[sort_field])
    order = np.lexsort((s, g))
    gs = g[order]
    starts = np.concatenate(
        [[0], np.flatnonzero(gs[1:] != gs[:-1]) + 1, [len(gs)]]
    )
    return order, starts


def track_label(
    fc: FeatureCollection, track_field: str, dtg_field: "str | None" = None
) -> FeatureCollection:
    """One feature per track — the latest by ``dtg_field`` (or the last
    row in input order), for labelling (reference TrackLabelProcess)."""
    if len(fc) == 0:
        return fc
    # lexsort is stable, so sorting by (track, track) preserves input
    # order within each track — the dtg-less case needs no special path
    order, starts = _group_sorted(fc, track_field, dtg_field or track_field)
    last = order[starts[1:] - 1]
    return fc.take(np.sort(last))


def date_offset(
    fc: FeatureCollection, date_field: str, offset_ms: int
) -> FeatureCollection:
    """Shift a date column by ``offset_ms`` (reference DateOffsetProcess;
    the reference parses an ISO-8601 period — callers pass millis here)."""
    out = fc.take(np.arange(len(fc)))
    out.columns[date_field] = (
        np.asarray(out.columns[date_field], dtype=np.int64) + int(offset_ms)
    )
    return out


def point2point(
    fc: FeatureCollection,
    group_field: str,
    sort_field: str,
    min_points: int = 2,
    break_on_day: bool = False,
    filter_singular: bool = True,
) -> FeatureCollection:
    """Connect each group's time-ordered points into 2-point line segments
    (reference Point2PointProcess): output schema is
    ``*geom:LineString, <group>, <sort>_start:Date, <sort>_end:Date``,
    one feature per consecutive pair, ids ``<group>-<idx>``.

    ``min_points``: groups must have MORE than this many points (the
    reference's lengthCompare(minPoints) > 0). ``break_on_day`` splits
    runs at UTC day boundaries; ``filter_singular`` drops zero-length
    segments (both endpoints identical)."""
    col = fc.geom_column
    if not isinstance(col, PointColumn):
        raise ValueError("point2point requires point geometries")
    out_sft = FeatureType.from_spec(
        "point2point",
        f"*geom:LineString:srid=4326,{group_field}:String,"
        f"{sort_field}_start:Date,{sort_field}_end:Date",
    )
    if len(fc) == 0:
        return FeatureCollection.from_rows(out_sft, [])
    order, starts = _group_sorted(fc, group_field, sort_field)
    g = np.asarray(fc.columns[group_field])[order]
    t = np.asarray(fc.columns[sort_field], dtype=np.int64)[order]
    x = np.asarray(col.x, dtype=np.float64)[order]
    y = np.asarray(col.y, dtype=np.float64)[order]

    # pair i connects sorted rows i -> i+1; valid pairs stay inside one
    # group run of size > min_points (and one UTC day with break_on_day)
    n = len(g)
    valid = np.ones(max(n - 1, 0), dtype=bool)
    valid[starts[1:-1] - 1] = False  # pairs crossing group boundaries
    sizes = np.diff(starts)
    small = sizes <= min_points
    if small.any():
        drop = np.zeros(n, dtype=bool)
        for k in np.flatnonzero(small):
            drop[starts[k] : starts[k + 1]] = True
        valid &= ~(drop[:-1] | drop[1:])
    if break_on_day:
        day = t // 86_400_000
        valid &= day[:-1] == day[1:]
    if filter_singular:
        valid &= (x[:-1] != x[1:]) | (y[:-1] != y[1:])
    idx = np.flatnonzero(valid)
    if len(idx) == 0:
        return FeatureCollection.from_rows(out_sft, [])

    coords = np.empty((len(idx) * 2, 2), dtype=np.float64)
    coords[0::2, 0] = x[idx]
    coords[0::2, 1] = y[idx]
    coords[1::2, 0] = x[idx + 1]
    coords[1::2, 1] = y[idx + 1]
    two = np.arange(len(idx) + 1, dtype=np.int32)
    lo = np.nextafter(
        np.minimum(coords[0::2], coords[1::2]).astype(np.float32), -np.inf
    )
    hi = np.nextafter(
        np.maximum(coords[0::2], coords[1::2]).astype(np.float32), np.inf
    )
    lines = geo.PackedGeometryColumn(
        coords=coords,
        ring_offsets=two * 2,
        part_ring_offsets=two,
        geom_part_offsets=two,
        types=np.full(len(idx), geo.LINESTRING, dtype=np.int8),
        bboxes=np.concatenate([lo, hi], axis=1).astype(np.float32),
    )
    # per-group segment counter for the reference's "<group>-<idx>" ids
    grp = g[idx]
    seg_starts = np.concatenate(
        [[0], np.flatnonzero(grp[1:] != grp[:-1]) + 1]
    )
    within = np.arange(len(idx)) - np.repeat(seg_starts, np.diff(np.concatenate([seg_starts, [len(idx)]])))
    ids = [f"{v}-{i}" for v, i in zip(grp.tolist(), within.tolist())]
    return FeatureCollection.from_columns(
        out_sft,
        ids,
        {
            "geom": lines,
            group_field: grp.astype(str),
            f"{sort_field}_start": t[idx],
            f"{sort_field}_end": t[idx + 1],
        },
    )


def bin_conversion(
    fc: FeatureCollection,
    track_field: str,
    dtg_field: str,
    label_field: "str | None" = None,
    sort: bool = False,
) -> bytes:
    """Encode a collection to BIN records (reference
    BinConversionProcess; format utils/bin_format)."""
    from geomesa_tpu_torch.utils import bin_format

    x, y = fc.representative_xy()
    return bin_format.encode(
        x, y,
        np.asarray(fc.columns[dtg_field], dtype=np.int64),
        np.asarray(fc.columns[track_field]),
        label=None if label_field is None else np.asarray(fc.columns[label_field]),
        sort=sort,
    )


def arrow_conversion(fc: FeatureCollection, dictionary: bool = True) -> bytes:
    """Encode a collection to an Arrow IPC stream (reference
    ArrowConversionProcess; io/arrow dictionary-encoded batches)."""
    from geomesa_tpu_torch.io.arrow import arrow_stream

    return arrow_stream(fc, dictionary=dictionary)


def query_process(store, type_name: str, f, limit=None) -> FeatureCollection:
    """Thin QueryProcess analogue (reference query/QueryProcess.scala):
    evaluate a filter against a store through the planner."""
    return store.query(type_name, f, limit=limit)


def sampling_process(
    fc: FeatureCollection, fraction: float, threading_field: "str | None" = None
) -> FeatureCollection:
    """SamplingProcess analogue (reference analytic/SamplingProcess.scala):
    per-group deterministic thinning via FeatureCollection.sample."""
    return fc.sample(fraction, threading_field)


def minmax_process(store, type_name: str, attribute: str, cql="INCLUDE"):
    """MinMaxProcess analogue (reference analytic/MinMaxProcess.scala):
    (min, max) of an attribute under a filter. Served from the stats
    sketches only when the filter is INCLUDE AND no visibility or
    interceptor could hide rows (sketches see every row — the same gate
    every aggregate fast path in the store applies); exact via the
    planner otherwise."""
    from geomesa_tpu_torch.filter import ecql
    from geomesa_tpu_torch.filter.predicates import Include

    f = ecql.parse(cql) if isinstance(cql, str) else cql
    sketch_ok = (
        isinstance(f, Include)
        and not store._vis_active(type_name)
        and not store.interceptors
    )
    if sketch_ok:
        stats = store.stats_for(type_name)
        if stats is not None:
            b = stats.attribute_bounds(attribute)
            if b is not None:
                return b
    # exact path through the Stat DSL (handles geometry/point columns —
    # a bare np.min over a PointColumn would raise)
    results = store.stats_query(type_name, f"MinMax({attribute})", f)
    return results[0].bounds
