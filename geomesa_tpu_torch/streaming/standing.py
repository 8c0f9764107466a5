"""Standing queries at subscription scale: the inverted index.

The port's copy of geomesa_tpu/streaming/standing.py. Everything else
scans millions of rows with a few queries; this module inverts the roles
(the reference's Kafka Streams ``GeoMesaStreamsBuilder`` workload):
millions of *persistent* subscriptions (geofences, proximity alerts, tube
corridors) are probed by every arriving hot-tier batch. Naive matching is
O(batch x subscriptions); here the SUBSCRIPTIONS are indexed by their own
raster-classified grids and Z2 cells, so each arriving point routes to a
tiny candidate set:

- :class:`SubscriptionIndex`, the inverted index. Each subscription's
  covering cells at a global Z2 routing level
  (``geomesa.standing.grid.level``) classify FULL / PARTIAL with the
  raster machinery (``geometry.classify_raster_cells``, the same
  conservative margin): a point landing in a FULL cell matches with zero
  geometry work, a PARTIAL (boundary) cell routes the point into the
  exact evaluation, and OUT cells are never registered. Storage is CSR
  over morton cell keys with a small mutation overlay compacted on
  demand.

- the **fused matcher**: boundary-cell geofence candidates with enough
  routed points in a batch (``geomesa.standing.fused.min.points``) group
  into the ``FUSED_E_BUCKETS`` edge-stack ladder and evaluate one ingest
  batch against a candidate block per ``block_scan_multi`` launch (K2,
  ``csrc/block_scan_multi.cu`` on a CUDA batch, its plain PyTorch version
  on a CPU one): subscriptions play the role of queries and the
  point-in-polygon leg is reused as it is. Kernel-certain rows resolve on
  the device, the near band refines through the same f64 host ray cast
  the sparse path uses. Sparse candidates take one vectorized ragged host
  ray cast over all (point, subscription) pairs at once, the crossing
  construction of :func:`geomesa_tpu_torch.geometry.points_in_ring`.

- :class:`WindowedAggregator`: continuous windowed computation over a
  :class:`~geomesa_tpu_torch.streaming.stream.FeatureStream` (or the
  engine's batch feed): tumbling/sliding count/bounds/stats windows kept
  as per-pane partials, composed in pane order, so incremental upkeep is
  bit-identical to a recompute over the same panes.

- :class:`StandingQueryEngine` / :class:`AlertQueue`, delivery:
  ``LambdaStore.write`` (and ``StreamFlusher`` batch arrival) feed each
  batch through route -> match -> deliver under the tracing spans
  ``standing.route`` / ``standing.match`` / ``standing.deliver``, with
  matched pairs fanned into a bounded alert queue (overflow drops are
  counted, never block the ack path) and the batch's alert latency
  recorded into the ``geomesa.standing.latency`` histogram (a default SLO
  objective, ``geomesa.obs.slo.standing.p99.ms``). Matching is
  best-effort relative to the WRITE: a matcher fault never
  un-acknowledges an applied batch (alerts are at-most-once; the
  ``standing.match`` / ``standing.deliver`` fault points pin that).

Durability: subscriptions registered through ``LambdaStore.subscribe``
log a WAL ``s`` record BEFORE they are acknowledged, so
``LambdaStore.recover`` rebuilds the SubscriptionIndex: an acknowledged
registration survives ``kill -9``.

The device: the engine takes its device from the cold store
(``LambdaStore.standing``) or its ``device`` argument. A batch's fused
columns are built on it in one host->device copy, and each fused launch
returns both planes in one device->host copy.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from geomesa_tpu_torch import fault
from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.curve.zorder import Z2
from geomesa_tpu_torch.filter.raster import RASTER_MARGIN
from geomesa_tpu_torch.obs.trace import span as _ospan
from geomesa_tpu_torch.scan import block_kernels as bk

log = logging.getLogger(__name__)

# matcher-local scan-block geometry: the batch is the "table", so blocks
# are small (one 20k-row ingest batch is a handful of blocks) — SUB must
# stay a multiple of 32 for the bitmask pack
MATCH_SUB = 32
MATCH_BLOCK = MATCH_SUB * bk.LANES  # 4096 rows per matcher scan block

_KIND_GEOFENCE = 0
_KIND_PROXIMITY = 1
_KIND_TUBE = 2
# edge floor for building a match-time raster grid (below it the ragged
# ray cast is already cheap per pair)
_RASTER_MIN_EDGES = 16
_KINDS = {"geofence": _KIND_GEOFENCE, "proximity": _KIND_PROXIMITY,
          "tube": _KIND_TUBE}
_KIND_NAMES = {v: k for k, v in _KINDS.items()}


@dataclass
class StandingConfig:
    """Standing-query knobs; ``from_properties`` resolves each from the
    typed property tier (geomesa_tpu_torch.conf)."""

    grid_level: int = 12          # Z2 routing-grid level (2^g per dim)
    classify_cells: int = 16384   # max cells classified FULL/PARTIAL
    fused_min_points: int = 64    # candidate rows before the fused kernel
    fused_gate: bool = True       # measured fused/host cost gate
    raster_cells: int = 1048576   # match-time raster budget (0 = off)
    queue_max: int = 65536        # bounded alert-queue capacity
    window_panes: int = 512       # retained panes per window aggregate

    @staticmethod
    def from_properties() -> "StandingConfig":
        from geomesa_tpu_torch import conf

        return StandingConfig(
            grid_level=int(conf.STANDING_GRID_LEVEL.get()),
            classify_cells=int(conf.STANDING_CLASSIFY_CELLS.get()),
            fused_min_points=int(conf.STANDING_FUSED_MIN_POINTS.get()),
            fused_gate=bool(conf.STANDING_FUSED_GATE.get()),
            raster_cells=int(conf.STANDING_RASTER_CELLS.get()),
            queue_max=int(conf.STANDING_QUEUE_MAX.get()),
            window_panes=int(conf.STANDING_WINDOW_PANES.get()),
        )


@dataclass
class Subscription:
    """One persistent standing query. Kinds:

    - ``geofence``  — ``geom`` (Polygon/MultiPolygon): match = exact
      even-odd point-in-polygon (the scan tier's predicate semantics);
    - ``proximity`` — ``points`` [k, 2] lon/lat + ``distance_m``: match
      = haversine distance to ANY input point <= distance_m (the
      ProximitySearchProcess refinement, standing);
    - ``tube``      — ``track_xy`` [n, 2] + ``track_times_ms`` [n] +
      ``buffer_m``: match = event within buffer_m of the interpolated
      track position AT THE EVENT'S OWN TIME (TubeSelectProcess
      refinement, standing; events without a time never match).

    ``attrs`` is an opaque user payload delivered with every alert.
    """

    sub_id: str
    kind: str
    geom: "geo.Geometry | None" = None
    points: "np.ndarray | None" = None
    distance_m: float = 0.0
    track_xy: "np.ndarray | None" = None
    track_times_ms: "np.ndarray | None" = None
    buffer_m: float = 0.0
    attrs: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown subscription kind {self.kind!r}: "
                f"one of {sorted(_KINDS)}"
            )
        if self.points is not None:
            self.points = np.asarray(self.points, np.float64).reshape(-1, 2)
        if self.track_xy is not None:
            self.track_xy = np.asarray(
                self.track_xy, np.float64
            ).reshape(-1, 2)
            self.track_times_ms = np.asarray(
                self.track_times_ms, np.int64
            )

    def validate(self) -> "Subscription":
        """Raise ``ValueError`` unless the body can actually register.
        ``LambdaStore.subscribe`` calls this BEFORE logging the WAL
        ``'s'`` record: a body that cannot register must never reach
        the log, or the record would poison every later recovery
        (replay re-registers it and hits the same error). The cover
        classification (:meth:`SubscriptionIndex._cover`) raises
        through here too — one validator, no drift."""
        if self.kind == "geofence":
            if not isinstance(self.geom, (geo.Polygon, geo.MultiPolygon)):
                raise ValueError(
                    f"geofence subscription {self.sub_id!r} needs a "
                    "Polygon/MultiPolygon geometry"
                )
        elif self.kind == "proximity":
            if (self.points is None or len(self.points) == 0
                    or self.distance_m <= 0):
                raise ValueError(
                    f"proximity subscription {self.sub_id!r} needs points "
                    "and a positive distance_m"
                )
        else:
            if self.track_xy is None or len(self.track_xy) < 2:
                raise ValueError(
                    f"tube subscription {self.sub_id!r} needs >= 2 "
                    "track points"
                )
            if (self.track_times_ms is None
                    or len(self.track_times_ms) != len(self.track_xy)):
                raise ValueError(
                    f"tube subscription {self.sub_id!r} needs one time "
                    "per track point"
                )
            if not (np.diff(self.track_times_ms) >= 0).all():
                # np.interp with unsorted xp returns silently wrong
                # positions — wrong matches, not an error
                raise ValueError(
                    f"tube subscription {self.sub_id!r} track times "
                    "must be ascending"
                )
        return self

    # -- WAL codec (the 's' record body; geometry rides the shared WKB
    # value codec in streaming/wal.py) ------------------------------------
    def to_record(self) -> dict:
        rec: dict = {"id": self.sub_id, "kind": self.kind}
        if self.geom is not None:
            rec["geom"] = self.geom
        if self.points is not None:
            rec["pts"] = self.points.ravel().tolist()
            rec["dist"] = float(self.distance_m)
        if self.track_xy is not None:
            rec["track"] = self.track_xy.ravel().tolist()
            rec["ts"] = self.track_times_ms.tolist()
            rec["buf"] = float(self.buffer_m)
        if self.attrs:
            rec["attrs"] = dict(self.attrs)
        return rec

    @classmethod
    def from_record(cls, rec: Mapping) -> "Subscription":
        from geomesa_tpu_torch.streaming.wal import _dec_value

        geom = rec.get("geom")
        if geom is not None:
            geom = _dec_value(geom)
        points = rec.get("pts")
        if points is not None:
            points = np.asarray(points, np.float64).reshape(-1, 2)
        track = rec.get("track")
        ts = None
        if track is not None:
            track = np.asarray(track, np.float64).reshape(-1, 2)
            ts = np.asarray(rec["ts"], np.int64)
        return cls(
            sub_id=str(rec["id"]), kind=str(rec["kind"]), geom=geom,
            points=points, distance_m=float(rec.get("dist", 0.0)),
            track_xy=track, track_times_ms=ts,
            buffer_m=float(rec.get("buf", 0.0)),
            attrs=dict(rec.get("attrs", {})),
        )


# precomputed <= 2x2 window index arrays + all-false flags (tiny
# geofences register every window cell PARTIAL; see _classify_window)
_TINY_IJ = {
    (nx, ny): (
        np.tile(np.arange(nx, dtype=np.int64), ny),
        np.repeat(np.arange(ny, dtype=np.int64), nx),
    )
    for nx in (1, 2) for ny in (1, 2)
}
_TINY_FALSE = {n: np.zeros(n, bool) for n in (1, 2, 4)}
# shared bbox row installed into a dead ordinal's slot (_drop_locked):
# never consulted by matching (dead ordinals are filtered from the CSR),
# a stale route snapshot reading it sees an empty box that matches nothing
_DEAD_BBOX = np.zeros((1, 4), np.float64)


def _sub_segments(geom) -> "np.ndarray | None":
    """[n, 4] (x0, y0, x1, y1) closed-ring segments over every ring of a
    Polygon/MultiPolygon — the flat form the index stores instead of the
    geometry object (1M Subscription geometries would be ~a GB of Python
    objects; the flat CSR is tens of MB)."""
    rings = geo._rings_of(geom) if isinstance(
        geom, (geo.Polygon, geo.MultiPolygon)
    ) else []
    segs = []
    for r in rings:
        c = np.asarray(r, np.float64)
        if len(c) < 2:
            continue
        if c[0, 0] != c[-1, 0] or c[0, 1] != c[-1, 1]:
            c = np.vstack([c, c[:1]])
        # direct column assignment, not np.stack: this runs once per
        # RING at million-subscription registration scale
        s = np.empty((len(c) - 1, 4), np.float64)
        s[:, 0] = c[:-1, 0]
        s[:, 1] = c[:-1, 1]
        s[:, 2] = c[1:, 0]
        s[:, 3] = c[1:, 1]
        segs.append(s)
    if not segs:
        return None
    return segs[0] if len(segs) == 1 else np.concatenate(segs)


def _is_axis_rect(segs: "np.ndarray | None", bbox) -> bool:
    """True when a geofence's segments are EXACTLY the four axis-aligned
    edges of its bbox. For such a rectangle the even-odd ray cast
    (horizontal edges never cross; each vertical edge crosses iff
    ``min(y0, y1) <= py < max(y0, y1)`` and its x exceeds px) reduces to
    the half-open box test ``x0 <= px < x1 and y0 <= py < y1`` —
    bit-identical to :func:`_ragged_pip`, two compares per axis instead
    of the ragged pair expansion. Tiny geofences (the
    million-subscription population) are overwhelmingly rectangles."""
    if segs is None or len(segs) != 4:
        return False
    x0, y0, x1, y1 = bbox
    if not (x0 < x1 and y0 < y1):
        return False
    seen = set()
    for sx0, sy0, sx1, sy1 in segs.tolist():
        if sx0 == sx1:  # vertical: must span the full bbox y-range
            if sx0 != x0 and sx0 != x1:
                return False
            if min(sy0, sy1) != y0 or max(sy0, sy1) != y1:
                return False
            seen.add((0, sx0))
        elif sy0 == sy1:  # horizontal: must span the full bbox x-range
            if sy0 != y0 and sy0 != y1:
                return False
            if min(sx0, sx1) != x0 or max(sx0, sx1) != x1:
                return False
            seen.add((1, sy0))
        else:
            return False
    return len(seen) == 4


def _axis_rects(segs: np.ndarray, bbox: np.ndarray) -> np.ndarray:
    """:func:`_is_axis_rect` over a stack: ``segs`` [k, 4, 4] four
    segments each, ``bbox`` [k, 4]. True where a subscription's segments
    are exactly the four axis-aligned edges of its bbox: every segment
    vertical on x0 or x1 spanning y0..y1 (checked first, as the scalar
    test does) or horizontal on y0 or y1 spanning x0..x1, and the four
    edges each present."""
    x0, y0, x1, y1 = (bbox[:, i:i + 1] for i in range(4))
    sx0, sy0, sx1, sy1 = (segs[:, :, i] for i in range(4))
    vert = sx0 == sx1
    horiz = ~vert & (sy0 == sy1)
    ok_v = ((sx0 == x0) | (sx0 == x1)) & (np.minimum(sy0, sy1) == y0) & (np.maximum(sy0, sy1) == y1)
    ok_h = ((sy0 == y0) | (sy0 == y1)) & (np.minimum(sx0, sx1) == x0) & (np.maximum(sx0, sx1) == x1)
    seg_ok = np.where(vert, ok_v, horiz & ok_h)
    edges_seen = (
        (vert & (sx0 == x0)).any(1) & (vert & (sx0 == x1)).any(1)
        & (horiz & (sy0 == y0)).any(1) & (horiz & (sy0 == y1)).any(1)
    )
    return (x0[:, 0] < x1[:, 0]) & (y0[:, 0] < y1[:, 0]) & seg_ok.all(1) & edges_seen


class _MatchGate:
    """Measured-cost fused/host picker (the tile cache's adaptive-gate
    pattern): EWMAs of the host ray cast's per-(pair x edge)
    cost and the fused dispatch's per-(slot x row x edge-row) cost,
    updated from every path actually executed. Until the fused side has
    a measurement, ONE bounded probe chunk runs fused per batch so the
    gate decides on THIS host's numbers, not a prior — on a CPU-only
    host the fused dispatch loses to the vectorized ray cast and
    self-disables after the probe. The fused EWMA is seconds per unit
    with no fixed-cost term: a dispatch's staging, copies and launch
    divide over its real members' units only. Seeded from a one-member
    dispatch (``FusedMatcher.warmup`` with ``gate``), it charges every
    candidate a whole dispatch, about FUSED_CHUNK_Q times its share in
    a full chunk, so on the card too the gate keeps candidates on the
    host ray cast."""

    _ALPHA = 0.25
    _HOST_PRIOR = 4e-9  # seconds per pair*edge (the reference's CPU pip prior)

    def __init__(self):
        from geomesa_tpu_torch.lockwitness import witness
        from geomesa_tpu_torch.tuning.primitives import CostEwma

        self._host = CostEwma(self._ALPHA)   # guarded-by: _lock
        self._fused = CostEwma(self._ALPHA)  # guarded-by: _lock
        self._lock = witness(threading.Lock(), "_MatchGate._lock")

    @property
    def host_s(self) -> "float | None":
        return self._host.value

    @property
    def fused_s(self) -> "float | None":
        return self._fused.value

    def update(self, kind: str, seconds: float, units: int) -> None:
        ewma = self._host if kind == "host_s" else self._fused
        with self._lock:
            ewma.update_cost(seconds, units)

    def pick(self, host_units: np.ndarray,
             fused_units: np.ndarray) -> "np.ndarray | None":
        """Per-candidate fused-wins mask, or None when the fused side is
        still unmeasured (the caller runs the bounded probe)."""
        with self._lock:
            fused_s = self._fused.value
            host_s = self._host.value
        if fused_s is None:
            return None
        if host_s is None:
            host_s = self._HOST_PRIOR
        return fused_units * fused_s < host_units * host_s


class SubscriptionIndex:
    """The inverted index: subscriptions -> routing cells, points ->
    candidate subscriptions.

    Registration classifies each subscription's covering cells at the
    routing level (``StandingConfig.grid_level``) as FULL (any point in
    the cell is a guaranteed match — zero geometry work at match time)
    or PARTIAL (boundary residue — exact evaluation), using
    ``geometry.classify_raster_cells`` with the raster tier's conservative
    margin; windows past ``classify_cells`` (and non-polygon kinds)
    register every bbox cell PARTIAL — a superset, never wrong.
    ``route()`` is one vectorized pass: cell ids for the whole batch,
    CSR candidate expansion, (point, subscription) pair arrays out.

    Thread-safe: mutations and the route-time snapshot serialize on
    ``_lock`` (hot: the route body is pure numpy; the CSR arrays are
    immutable once built, so candidate expansion runs outside the
    lock)."""

    def __init__(self, config: "StandingConfig | None" = None,
                 metrics=None):
        from geomesa_tpu_torch.lockwitness import witness
        from geomesa_tpu_torch.metrics import resolve

        self.config = config if config is not None else StandingConfig.from_properties()
        self.metrics = resolve(metrics)
        level = int(self.config.grid_level)
        if not 1 <= level <= 24:
            raise ValueError(f"geomesa.standing.grid.level out of range: {level}")
        self.level = level
        self.cell_w = 360.0 / (1 << level)
        self.cell_h = 180.0 / (1 << level)
        # cells small enough that the conservative margin would eat them
        # cannot classify FULL safely — everything registers PARTIAL
        self._can_classify = (
            self.cell_w >= 8 * RASTER_MARGIN and self.cell_h >= 8 * RASTER_MARGIN
        )
        self._lock = witness(
            threading.RLock(), "SubscriptionIndex._lock"
        )
        # subscription registry: ordinal SLOTS are append-only — never
        # reused or shifted, so in-flight routed pairs and queued alert
        # blocks stay label-consistent across mutations. A dead slot's
        # payload (its edge array, side-table params, kernel block) is
        # freed by _drop_locked; what a dead slot retains is O(1).
        self._ids: list[str] = []            # guarded-by: _lock
        self._by_id: dict[str, int] = {}     # guarded-by: _lock
        self._alive: list[bool] = []         # guarded-by: _lock
        self._alive_arr: "np.ndarray | None" = None  # guarded-by: _lock
        self._kind_l: list[int] = []         # guarded-by: _lock
        self._attrs: dict[int, dict] = {}    # guarded-by: _lock
        # geofence edge CSR (built lazily from _edges_l); bboxes are
        # [k, 4] f64 BLOCKS in ordinal order (a million per-subscription
        # tuples were gc-tracked objects — full collections swept them
        # on every ingest batch; numpy blocks are invisible to the gc)
        self._edges_l: list = []             # guarded-by: _lock
        self._bbox_l: list = []              # guarded-by: _lock
        self._rect_l: list[bool] = []        # guarded-by: _lock
        # proximity / tube parameter side tables
        self._prox: dict[int, tuple] = {}    # guarded-by: _lock
        self._tube: dict[int, tuple] = {}    # guarded-by: _lock
        # match-time raster grids for dense geofences (built at
        # registration while the geometry object is still in hand)
        self._rast: dict[int, object] = {}   # guarded-by: _lock
        # cell -> candidates: frozen CSR + mutation overlay + the bulk
        # registration arrays (merged by the same compaction)
        self._csr: "tuple | None" = None     # guarded-by: _lock
        self._overlay: dict[int, list] = {}  # guarded-by: _lock
        self._overlay_n = 0                  # guarded-by: _lock
        self._bulk: list = []                # guarded-by: _lock
        self._arrays: "tuple | None" = None  # guarded-by: _lock
        # packed f32 kernel edge blocks, built lazily per fused batch
        self._kernel_blocks: OrderedDict = OrderedDict()  # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_id)

    def subscription_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._by_id)

    # -- registration -----------------------------------------------------
    def register(self, sub: Subscription) -> int:
        """Register (or replace) one subscription; returns its ordinal."""
        cells, full, segs, bbox, rast = self._cover(sub)
        with self._lock:
            prev = self._by_id.get(sub.sub_id)
            if prev is not None:
                self._drop_locked(prev)
            ord_ = len(self._ids)
            self._ids.append(sub.sub_id)
            self._by_id[sub.sub_id] = ord_
            self._alive.append(True)
            self._kind_l.append(_KINDS[sub.kind])
            if sub.attrs:
                self._attrs[ord_] = dict(sub.attrs)
            self._edges_l.append(segs)
            self._bbox_l.append(
                np.asarray(bbox, np.float64).reshape(1, 4)
            )
            self._rect_l.append(
                sub.kind == "geofence" and _is_axis_rect(segs, bbox)
            )
            if rast is not None:
                self._rast[ord_] = rast
            if sub.kind == "proximity":
                self._prox[ord_] = (sub.points, float(sub.distance_m))
            elif sub.kind == "tube":
                self._tube[ord_] = (
                    sub.track_xy, sub.track_times_ms, float(sub.buffer_m)
                )
            self._add_cells_locked(ord_, cells, full)
            self._arrays = None
            self._alive_arr = None
            n = len(self._by_id)
        self.metrics.gauge("geomesa.standing.subscriptions", n)
        return ord_

    def register_geofences(self, ids: Sequence[str],
                           geoms: Sequence) -> int:
        """Bulk geofence registration (the million-subscription path):
        identical semantics to per-subscription :meth:`register`, one
        lock hold per chunk, ONE morton interleave per chunk (absolute
        cell coords accumulate across subscriptions — per-subscription
        ``Z2.index`` calls on 1-4 cells were the registration
        bottleneck), cell arrays appended whole for the single CSR
        merge at the end. A chunk's plain quadrilaterals (the tiny-fence
        population) cover in whole-chunk array passes
        (:meth:`_cover_chunk`); the registry state is the one the
        per-subscription path leaves, element for element (both timed by
        ``geomesa_tpu_torch/scripts/register_ab.py``)."""
        for s in range(0, len(ids), 8192):
            e = min(s + 8192, len(ids))
            chunk_ids = [str(ids[i]) for i in range(s, e)]
            counts, ii, jj, fulls, segs, bboxes, rects, rasts = self._cover_chunk(
                chunk_ids, [geoms[i] for i in range(s, e)]
            )
            cells = np.asarray(Z2.index(ii, jj)).astype(np.int64)
            with self._lock:
                ords = np.empty(len(chunk_ids), np.int64)
                for k, sub_id in enumerate(chunk_ids):
                    prev = self._by_id.get(sub_id)
                    if prev is not None:
                        self._drop_locked(prev)
                    ord_ = len(self._ids)
                    ords[k] = ord_
                    self._ids.append(sub_id)
                    self._by_id[sub_id] = ord_
                    self._alive.append(True)
                    self._kind_l.append(_KIND_GEOFENCE)
                    self._edges_l.append(segs[k])
                    self._bbox_l.append(bboxes[k])
                    self._rect_l.append(rects[k])
                    if k in rasts:
                        self._rast[ord_] = rasts[k]
                self._bulk.append((cells, np.repeat(ords, counts), fulls))
                self._arrays = None
                self._alive_arr = None
        with self._lock:
            self._compact_locked()
            # live count read HERE, not carried out of the chunk loop:
            # an empty ids list must leave the gauge at the true count
            n = len(self._by_id)
        self.metrics.gauge("geomesa.standing.subscriptions", n)
        return n

    def _cover_chunk(self, sub_ids: Sequence[str], geoms: Sequence):
        """The registration side of one bulk chunk: (counts, ii, jj,
        fulls, segs, bboxes, rects, rasts) — per subscription its cell
        count, edge segments, (1, 4) bbox block and rect flag, the
        chunk's cells as absolute grid coordinates in subscription order,
        and {chunk position: match-time raster}. Plain quadrilaterals
        (one closed 5-point shell, no hole, a bbox in the plane) whose
        window is at most 2 x 2 cells take whole-chunk array passes that
        compute what :meth:`_cover_geofence_ij` and :func:`_is_axis_rect`
        compute for one (the same f64 arithmetic, every cell PARTIAL);
        every other geometry takes that per-subscription path."""
        n = len(geoms)
        quad = np.fromiter(
            (isinstance(g, geo.Polygon) and not g.holes and len(g.shell) == 5 for g in geoms),
            bool, count=n,
        )
        qi = np.flatnonzero(quad)
        fast = np.zeros(n, bool)
        if len(qi):
            sh = np.stack([geoms[i].shell for i in qi.tolist()]).astype(np.float64)
            bx = np.stack([sh[:, :, 0].min(1), sh[:, :, 1].min(1),
                           sh[:, :, 0].max(1), sh[:, :, 1].max(1)], axis=1)
            top = (1 << self.level) - 1
            i0 = np.clip(np.trunc((np.maximum(bx[:, 0], -180.0) + 180.0) / self.cell_w), 0, top)
            i1 = np.clip(np.trunc((np.minimum(bx[:, 2], 180.0) + 180.0) / self.cell_w), 0, top)
            j0 = np.clip(np.trunc((np.maximum(bx[:, 1], -90.0) + 90.0) / self.cell_h), 0, top)
            j1 = np.clip(np.trunc((np.minimum(bx[:, 3], 90.0) + 90.0) / self.cell_h), 0, top)
            ok = (
                (np.abs(bx) <= 360.0).all(axis=1)  # finite and in the plane
                & (sh[:, 0, 0] == sh[:, 4, 0]) & (sh[:, 0, 1] == sh[:, 4, 1])
                & (i1 - i0 <= 1) & (j1 - j0 <= 1)
            )
            qi, sh, bx = qi[ok], sh[ok], bx[ok]
            i0, i1, j0, j1 = (v[ok].astype(np.int64) for v in (i0, i1, j0, j1))
            fast[qi] = True
        # the per-subscription path for every other geometry (in chunk
        # order, so an invalid body raises before anything registers)
        slow = {
            k: self._cover_geofence_ij(Subscription(sub_ids[k], "geofence", geom=geoms[k]))
            for k in np.flatnonzero(~fast).tolist()
        }
        counts = np.zeros(n, np.int64)
        segs: list = [None] * n
        bboxes: list = [None] * n
        rects: list = [False] * n
        rasts = {k: c[5] for k, c in slow.items() if c[5] is not None}
        for k, c in slow.items():
            counts[k] = len(c[0])
            segs[k] = c[3]
            bboxes[k] = np.asarray(c[4], np.float64).reshape(1, 4)
            rects[k] = _is_axis_rect(c[3], c[4])
        if len(qi):
            nx, ny = i1 - i0 + 1, j1 - j0 + 1
            counts[qi] = nx * ny
            sg = np.empty((len(qi), 4, 4), np.float64)
            sg[:, :, 0] = sh[:, :-1, 0]
            sg[:, :, 1] = sh[:, :-1, 1]
            sg[:, :, 2] = sh[:, 1:, 0]
            sg[:, :, 3] = sh[:, 1:, 1]
            rect = _axis_rects(sg, bx)
            blocks = bx.reshape(-1, 1, 4)
            for k, q in enumerate(qi.tolist()):
                segs[q] = sg[k]
                bboxes[q] = blocks[k]
            rq = rect.tolist()
            for k, q in enumerate(qi.tolist()):
                rects[q] = rq[k]
        starts = np.concatenate(([0], np.cumsum(counts)))
        total = int(starts[-1])
        ii = np.empty(total, np.uint64)
        jj = np.empty(total, np.uint64)
        fulls = np.zeros(total, bool)
        for k, c in slow.items():
            ii[starts[k]: starts[k + 1]] = c[0]
            jj[starts[k]: starts[k + 1]] = c[1]
            fulls[starts[k]: starts[k + 1]] = c[2]
        if len(qi):
            # the <= 2 x 2 window in _classify_window's order: x fastest
            rep = np.repeat(np.arange(len(qi)), nx * ny)
            local = np.arange(len(rep)) - np.repeat(
                np.concatenate(([0], np.cumsum(nx * ny)[:-1])), nx * ny)
            at = np.repeat(starts[qi], nx * ny) + local
            ii[at] = (i0[rep] + local % nx[rep]).astype(np.uint64)
            jj[at] = (j0[rep] + local // nx[rep]).astype(np.uint64)
        return counts, ii, jj, fulls, segs, bboxes, rects, rasts

    def unregister(self, sub_id: str) -> bool:
        with self._lock:
            ord_ = self._by_id.get(str(sub_id))
            if ord_ is None:
                return False
            self._drop_locked(ord_)
            n = len(self._by_id)
        self.metrics.gauge("geomesa.standing.subscriptions", n)
        return True

    def _alive_locked(self) -> np.ndarray:
        """The cached alive bool array (``np.asarray`` over a 1M-entry
        Python list per routed batch was measurable on the ack path)."""
        # holds-lock: _lock
        if self._alive_arr is None or len(self._alive_arr) != len(self._alive):
            self._alive_arr = np.asarray(self._alive, bool)
        return self._alive_arr

    def has_tube(self) -> bool:
        with self._lock:
            return bool(self._tube)

    def raster_of(self, ord_: int):
        """The match-time :class:`RasterApprox` for one dense geofence
        ordinal, or None (sparse / rectangle / disabled)."""
        with self._lock:
            return self._rast.get(int(ord_))

    def prox_of(self, ord_: int) -> "tuple | None":
        """(centers, distance_m) for one proximity ordinal, or None —
        a locked get, like :meth:`raster_of`: the matcher resolves
        side-table params AFTER the route snapshot, so a concurrent
        unsubscribe may have popped the entry (the pair is then simply
        skipped; a raw subscript here KeyError'd the whole batch)."""
        with self._lock:
            return self._prox.get(int(ord_))

    def tube_of(self, ord_: int) -> "tuple | None":
        """(track_xy, track_times_ms, buffer_m) for one tube ordinal,
        or None (same contract as :meth:`prox_of`)."""
        with self._lock:
            return self._tube.get(int(ord_))

    def has_rasters(self) -> bool:
        with self._lock:
            return bool(self._rast)

    def _drop_locked(self, ord_: int) -> None:
        # holds-lock: _lock
        self._alive[ord_] = False
        self._by_id.pop(self._ids[ord_], None)
        self._attrs.pop(ord_, None)
        self._prox.pop(ord_, None)
        self._tube.pop(ord_, None)
        self._rast.pop(ord_, None)
        self._kernel_blocks.pop(ord_, None)
        # free the dead slot's payload: a churning population (a moving
        # geofence re-registered per tick) must not retain every old
        # boundary's [n, 4] edge array, nor keep feeding dead edges
        # into _ensure_arrays' whole-registry segment concat
        self._edges_l[ord_] = None
        self._bbox_l[ord_] = _DEAD_BBOX
        self._rect_l[ord_] = False
        self._arrays = None
        self._alive_arr = None

    def _add_cells_locked(self, ord_: int, cells: np.ndarray,
                          full: np.ndarray) -> None:
        # holds-lock: _lock
        if len(cells) > 4096:
            # wide covers (a 1000km proximity radius spans ~100k+
            # routing cells) skip the per-cell Python loop — held under
            # _lock, it would stall every concurrent batch's route() —
            # and ride the bulk arrays the next compaction merges in
            # one vectorized pass
            self._bulk.append((
                cells, np.full(len(cells), ord_, np.int64), full,
            ))
            return
        for c, f in zip(cells.tolist(), full.tolist()):
            self._overlay.setdefault(c, []).append((ord_, f))
        self._overlay_n += len(cells)
        if self._overlay_n > 262_144:
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Merge the overlay and the bulk-registration arrays (and drop
        dead ordinals) into one frozen CSR: sorted morton cell keys,
        start offsets, candidate ordinal + full-flag arrays."""
        # holds-lock: _lock
        parts_c: list = []
        parts_o: list = []
        parts_f: list = []
        if self._csr is not None:
            keys, starts, ords, fulls = self._csr
            counts = np.diff(starts)
            parts_c.append(np.repeat(keys, counts))
            parts_o.append(ords)
            parts_f.append(fulls)
        for cells, ords, fulls in self._bulk:
            parts_c.append(cells)
            parts_o.append(ords)
            parts_f.append(fulls)
        self._bulk = []
        if self._overlay:
            oc = np.fromiter(
                (c for c, lst in self._overlay.items() for _ in lst),
                np.int64, count=self._overlay_n,
            )
            oo = np.fromiter(
                (o for lst in self._overlay.values() for o, _ in lst),
                np.int64, count=self._overlay_n,
            )
            of = np.fromiter(
                (f for lst in self._overlay.values() for _, f in lst),
                bool, count=self._overlay_n,
            )
            parts_c.append(oc)
            parts_o.append(oo)
            parts_f.append(of)
        self._overlay = {}
        self._overlay_n = 0
        if not parts_c:
            self._csr = None
            return
        c = np.concatenate(parts_c)
        o = np.concatenate(parts_o)
        f = np.concatenate(parts_f)
        keep = self._alive_locked()[o]
        c, o, f = c[keep], o[keep], f[keep]
        if len(c) == 0:
            # every registered cell belonged to a dead ordinal: an
            # EMPTY (non-None) CSR would send route() into keys[-1] on
            # a zero-length array — None is the no-candidates shape
            self._csr = None
            return
        order = np.argsort(c, kind="stable")
        c, o, f = c[order], o[order], f[order]
        keys, first = np.unique(c, return_index=True)
        starts = np.append(first, len(c)).astype(np.int64)
        self._csr = (keys, starts, o.astype(np.int64), f)

    # -- cover classification ---------------------------------------------
    def _cover(self, sub: Subscription):
        """(cells u64 morton keys, full bool, edge segments | None,
        bbox) — the registration-side classification (no lock held:
        classification is the expensive part and pure)."""
        sub.validate()
        if sub.kind == "geofence":
            ii, jj, full, segs, bbox, rast = self._cover_geofence_ij(sub)
            cells = np.asarray(Z2.index(ii, jj)).astype(np.int64)
            return cells, full, segs, bbox, rast
        if sub.kind == "proximity":
            boxes = _proximity_boxes(sub.points, sub.distance_m)
            cells = _boxes_cells(boxes, self.level)
            bbox = (
                float(boxes[:, 0].min()), float(boxes[:, 1].min()),
                float(boxes[:, 2].max()), float(boxes[:, 3].max()),
            )
            return cells, np.zeros(len(cells), bool), None, bbox, None
        # tube: per-bin segment bboxes, like tube_select's window parts —
        # conservative (all PARTIAL; exact refinement interpolates the
        # track at the event's own time)
        boxes = _tube_boxes(sub.track_xy, sub.track_times_ms, sub.buffer_m)
        cells = _boxes_cells(boxes, self.level)
        bbox = (
            float(boxes[:, 0].min()), float(boxes[:, 1].min()),
            float(boxes[:, 2].max()), float(boxes[:, 3].max()),
        )
        return cells, np.zeros(len(cells), bool), None, bbox, None

    def _cover_geofence_ij(self, sub: Subscription):
        """(ii, jj, full, segs, bbox, rast) — a geofence's covering
        cells as ABSOLUTE grid coordinates (u64), morton conversion
        deferred so the bulk path interleaves one whole chunk per
        ``Z2.index`` call instead of paying the call overhead per
        subscription. ``rast`` is the MATCH-TIME raster grid for dense
        non-rectangle geofences (``geomesa.standing.raster.cells``):
        built here, while the geometry object is still in hand — the
        index stores flat segments only."""
        if not isinstance(sub.geom, (geo.Polygon, geo.MultiPolygon)):
            raise ValueError(
                f"geofence subscription {sub.sub_id!r} needs a "
                "Polygon/MultiPolygon geometry"
            )
        segs = _sub_segments(sub.geom)
        bbox = sub.geom.bounds()
        ii, jj, full = self._classify_window(sub.geom, bbox)
        rast = None
        if (
            int(self.config.raster_cells) > 0 and segs is not None
            and len(segs) >= _RASTER_MIN_EDGES
            and not _is_axis_rect(segs, bbox)
        ):
            from geomesa_tpu_torch.filter.raster import build_raster

            rast = build_raster(
                sub.geom, max_cells=int(self.config.raster_cells)
            )
        return ii, jj, full, segs, bbox, rast

    def _classify_window(self, geom, bbox):
        """(ii, jj, full) covering cells of one polygon at the routing
        level, as absolute grid coordinates: FULL / PARTIAL classified
        exactly (with margin) when the window fits the
        ``classify_cells`` budget; bigger windows register every bbox
        cell PARTIAL (superset-safe — boundary evaluation
        re-excludes)."""
        bx0 = max(bbox[0], -180.0)
        by0 = max(bbox[1], -90.0)
        bx1 = min(bbox[2], 180.0)
        by1 = min(bbox[3], 90.0)
        top = (1 << self.level) - 1
        i0 = min(max(int((bx0 + 180.0) / self.cell_w), 0), top)
        i1 = min(max(int((bx1 + 180.0) / self.cell_w), 0), top)
        j0 = min(max(int((by0 + 90.0) / self.cell_h), 0), top)
        j1 = min(max(int((by1 + 90.0) / self.cell_h), 0), top)
        nx, ny = i1 - i0 + 1, j1 - j0 + 1
        # a FULL cell needs the margin-EXPANDED cell covered, so the
        # polygon's bbox must overhang it by the margin on every side —
        # a window of <= 2 cells per axis can never produce one. Tiny
        # geofences (the million-subscription case) therefore skip
        # classification outright: identical registration, none of the
        # per-polygon classify cost (precomputed window index arrays —
        # even a tiny meshgrid per subscription is measurable at 1M).
        if nx <= 2 and ny <= 2:
            ii, jj = _TINY_IJ[(nx, ny)]
            full = _TINY_FALSE[nx * ny]
        elif self._can_classify and nx * ny <= max(
            int(self.config.classify_cells), 1
        ):
            x_edges = -180.0 + (i0 + np.arange(nx + 1)) * self.cell_w
            y_edges = -90.0 + (j0 + np.arange(ny + 1)) * self.cell_h
            classes = geo.classify_raster_cells(
                geom, x_edges, y_edges, RASTER_MARGIN
            )
            jj, ii = np.nonzero(classes != geo.RASTER_OUT)
            full = classes[jj, ii] == geo.RASTER_FULL
        else:
            jj, ii = np.meshgrid(
                np.arange(ny), np.arange(nx), indexing="ij"
            )
            jj, ii = jj.ravel(), ii.ravel()
            full = np.zeros(len(jj), bool)
        return (
            (ii + i0).astype(np.uint64), (jj + j0).astype(np.uint64), full
        )

    # -- routing ----------------------------------------------------------
    def point_cells(self, x, y) -> np.ndarray:
        """Morton routing-cell key per point (vectorized; clamped into
        the grid like the registration side)."""
        top = (1 << self.level) - 1
        i = np.clip(
            np.floor((np.asarray(x, np.float64) + 180.0) / self.cell_w),
            0, top,
        ).astype(np.uint64)
        j = np.clip(
            np.floor((np.asarray(y, np.float64) + 90.0) / self.cell_h),
            0, top,
        ).astype(np.uint64)
        return np.asarray(Z2.index(i, j)).astype(np.int64)

    def route(self, x, y):
        """(pt_idx, ords, full) candidate pair arrays for one batch:
        ``pt_idx[k]`` is a row of the batch, ``ords[k]`` a live
        subscription ordinal whose cover includes that row's cell, and
        ``full[k]`` True when the cell classified FULL (a certain match,
        zero geometry work)."""
        with self._lock:
            if self._overlay or self._bulk:
                self._compact_locked()
            csr = self._csr
            # no dead ordinals -> skip the per-pair liveness mask below
            none_dead = len(self._by_id) == len(self._ids)
            alive = None if none_dead else self._alive_locked()
        if csr is None:
            z = np.zeros(0, np.int64)
            return z, z.copy(), np.zeros(0, bool)
        keys, starts, ords, fulls = csr
        cells = self.point_cells(x, y)
        order = np.argsort(cells, kind="stable")
        sorted_cells = cells[order]
        uniq, first = np.unique(sorted_cells, return_index=True)
        npts = np.diff(np.append(first, len(sorted_cells)))
        pos = np.searchsorted(keys, uniq)
        pos_c = np.minimum(pos, len(keys) - 1)
        hit = keys[pos_c] == uniq
        lo = np.where(hit, starts[pos_c], 0)
        nsubs = np.where(hit, starts[pos_c + 1] - starts[pos_c], 0)
        # expansion: group k contributes npts[k] * nsubs[k] pairs, laid
        # out point-major (p0 x subs, p1 x subs, ...)
        per_point = np.repeat(nsubs, npts)          # [n points], grouped
        total = int(per_point.sum())
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, z.copy(), np.zeros(0, bool)
        pt = np.repeat(order, per_point)
        bstart = np.concatenate(([0], np.cumsum(per_point[:-1])))
        within = np.arange(total) - np.repeat(bstart, per_point)
        slot = np.repeat(np.repeat(lo, npts), per_point) + within
        o = ords[slot]
        f = fulls[slot]
        if alive is not None:
            live = alive[o]
            if not live.all():
                pt, o, f = pt[live], o[live], f[live]
        return pt, o, f

    # -- match-side array views -------------------------------------------
    def _ensure_arrays(self):
        """(kind i8 [n], edge offsets i64 [n+1], ex0/ey0/ex1/ey1 f64,
        bbox f64 [n, 4], rect bool [n]) — flat per-ordinal views rebuilt
        after registration changes; immutable once built. ``rect`` marks
        geofences that are exact axis-aligned rectangles (see
        :func:`_is_axis_rect` — matched by two compares per axis)."""
        with self._lock:
            if self._arrays is not None:
                return self._arrays
            n = len(self._ids)
            kind = np.asarray(self._kind_l, np.int8)
            counts = np.fromiter(
                (0 if e is None else len(e) for e in self._edges_l),
                np.int64, count=n,
            )
            eoff = np.concatenate(([0], np.cumsum(counts)))
            if n and eoff[-1]:
                segs = np.concatenate(
                    [e for e in self._edges_l if e is not None]
                )
            else:
                segs = np.zeros((0, 4), np.float64)
            bbox = (
                np.asarray(self._bbox_l, np.float64).reshape(n, 4)
                if n else np.zeros((0, 4), np.float64)
            )
            rect = np.asarray(self._rect_l, bool)
            self._arrays = (kind, eoff, segs, bbox, rect)
            return self._arrays

    def kernel_block(self, ord_: int) -> "np.ndarray | None":
        """The [E, 128] f32 PIP kernel block for one geofence ordinal
        (pack_edge_segments — identical packing to the query path), or
        None past the E ladder. LRU-memoized: fused batches revisit hot
        subscriptions."""
        with self._lock:
            blk = self._kernel_blocks.get(ord_)
            if blk is not None:
                self._kernel_blocks.move_to_end(ord_)
                return blk
        _, eoff, segs, _, _ = self._ensure_arrays()
        e = segs[eoff[ord_] : eoff[ord_ + 1]]
        blk = bk.pack_edge_segments(e) if len(e) else None
        with self._lock:
            if blk is not None:
                self._kernel_blocks[ord_] = blk
                while len(self._kernel_blocks) > 4096:
                    self._kernel_blocks.popitem(last=False)
        return blk


def _proximity_boxes(points: np.ndarray, distance_m: float) -> np.ndarray:
    """Conservative per-center covering boxes in degrees (the
    process/knn widening, vectorized)."""
    lat = np.clip(np.abs(points[:, 1]) + 1e-9, 0, 89.0)
    dx = distance_m / (111_320.0 * np.cos(np.radians(lat)))
    dy = distance_m / 110_540.0
    return np.stack([
        points[:, 0] - dx, np.maximum(points[:, 1] - dy, -90.0),
        points[:, 0] + dx, np.minimum(points[:, 1] + dy, 90.0),
    ], axis=1)


def _tube_boxes(xy: np.ndarray, ts: np.ndarray, buffer_m: float,
                max_bins: int = 256) -> np.ndarray:
    """Per-segment covering boxes along a track, widened by the buffer
    (the TubeBuilder binning, reduced to routing cover)."""
    n = min(len(xy) - 1, max_bins)
    idx = np.linspace(0, len(xy) - 1, n + 1).astype(np.int64)
    boxes = []
    for k in range(n):
        a, b = idx[k], idx[k + 1] + 1
        seg = xy[a:b]
        lat = np.clip(np.abs(seg[:, 1]).max() + 1e-9, 0, 89.0)
        dx = buffer_m / (111_320.0 * math.cos(math.radians(lat)))
        dy = buffer_m / 110_540.0
        boxes.append((
            seg[:, 0].min() - dx, max(seg[:, 1].min() - dy, -90.0),
            seg[:, 0].max() + dx, min(seg[:, 1].max() + dy, 90.0),
        ))
    return np.asarray(boxes, np.float64)


def _boxes_cells(boxes: np.ndarray, level: int) -> np.ndarray:
    """Unique morton cells covering a set of lon/lat boxes."""
    cw = 360.0 / (1 << level)
    ch = 180.0 / (1 << level)
    top = (1 << level) - 1
    out = []
    for x0, y0, x1, y1 in boxes:
        i0 = min(max(int((x0 + 180.0) / cw), 0), top)
        i1 = min(max(int((x1 + 180.0) / cw), 0), top)
        j0 = min(max(int((y0 + 90.0) / ch), 0), top)
        j1 = min(max(int((y1 + 90.0) / ch), 0), top)
        jj, ii = np.meshgrid(
            np.arange(j0, j1 + 1), np.arange(i0, i1 + 1), indexing="ij"
        )
        out.append(np.asarray(
            Z2.index(ii.ravel().astype(np.uint64),
                     jj.ravel().astype(np.uint64))
        ).astype(np.int64))
    return np.unique(np.concatenate(out)) if out else np.zeros(0, np.int64)


# -- the matcher ------------------------------------------------------------


def _ragged_pip(px: np.ndarray, py: np.ndarray, ords: np.ndarray,
                eoff: np.ndarray, segs: np.ndarray) -> np.ndarray:
    """Vectorized even-odd ray cast over (point, subscription) PAIRS:
    pair k tests point (px[k], py[k]) against subscription ords[k]'s
    edges — the identical crossing construction as
    :func:`geomesa_tpu_torch.geometry.points_in_ring` (holes included via
    parity over all rings), evaluated for every pair at once instead of
    one polygon at a time."""
    cnt = eoff[ords + 1] - eoff[ords]
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(len(ords), bool)
    pair = np.repeat(np.arange(len(ords)), cnt)
    base = np.repeat(eoff[ords], cnt)
    csum = np.concatenate(([0], np.cumsum(cnt[:-1])))
    ei = base + (np.arange(total) - np.repeat(csum, cnt))
    y1 = segs[ei, 1]
    y2 = segs[ei, 3]
    ppy = py[pair]
    spans = (y1 <= ppy) != (y2 <= ppy)
    # only span-crossing (pair, edge) entries need the intersection —
    # typically a small fraction; compressing first drops the divide
    # and the f64 bincount weights from the full expansion
    sidx = np.flatnonzero(spans)
    if len(sidx) == 0:
        return np.zeros(len(ords), bool)
    sei = ei[sidx]
    sy1 = y1[sidx]
    sy2 = y2[sidx]
    sx1 = segs[sei, 0]
    t = (py[pair[sidx]] - sy1) / (sy2 - sy1)  # spans => y2 != y1
    xi = sx1 + t * (segs[sei, 2] - sx1)
    cross = pair[sidx[xi > px[pair[sidx]]]]
    crossings = np.bincount(cross, minlength=len(ords))
    return crossings % 2 == 1


class _BatchColumns:
    """The batch's [n_blocks, SUB, 128] f32 column layout on the
    matcher's device, built lazily (only fused-kernel batches pay it) in
    ONE host->device copy: both columns stage into one host array
    [2, n_blocks, SUB, 128] and travel together; ``x`` and ``y`` are
    its two halves (each contiguous and 16-byte aligned, as the kernels
    read them). Pad rows carry +inf — never inside any polygon, never
    near any edge."""

    def __init__(self, x: np.ndarray, y: np.ndarray, device="cuda"):
        self.n = len(x)
        self.n_blocks = max(1, -(-self.n // MATCH_BLOCK))
        self.device = torch.device(device)
        self._x64, self._y64 = x, y
        self._cols: "tuple | None" = None

    def cols3(self) -> tuple:
        if self._cols is None:
            host = np.full(
                (2, self.n_blocks, MATCH_SUB, bk.LANES), np.inf, np.float32
            )
            host[0].reshape(-1)[: self.n] = self._x64.astype(np.float32)
            host[1].reshape(-1)[: self.n] = self._y64.astype(np.float32)
            both = torch.from_numpy(host).to(self.device)
            self._cols = (both[0], both[1])
        return self._cols


class FusedMatcher:
    """Evaluate many boundary-candidate geofences against one batch in
    fused ``block_scan_multi`` dispatches: candidate subscriptions group
    by their FUSED_E_BUCKETS edge bucket (the grouping KEY carries the
    bucket — the fused-key discipline of the query path), each chunk scans every
    batch block per member slot, kernel-certain rows resolve on device
    and near-band rows refine through the same f64 host ray cast the
    sparse path uses."""

    def __init__(self, index: SubscriptionIndex, device="cuda"):
        self.index = index
        self.device = torch.device(device)

    def warmup(self, n_edges: int = bk.FUSED_E_BUCKETS[0],
               n_rows: int = 1, gate: "_MatchGate | None" = None) -> None:
        """Warm the matcher for one E bucket at the caller's batch size (a
        benchmark warms every bucket at the REAL ingest batch shape before
        timing; tests run cold). Dispatches always pad to a full
        FUSED_CHUNK_Q chunk, so the launch shape is exactly (E bucket,
        batch blocks). On a CUDA matcher the first dispatch is where the
        kernel library builds and loads. With ``gate``, a
        SECOND dispatch (build excluded) seeds the fused cost EWMA at the
        exact steady-state shape — the gate then decides from measurement
        on the very first batch, and the in-window probe never fires.
        Its time ends after the dispatch's device->host copy, which
        synchronizes, so an asynchronous launch never reads as free."""
        x = np.zeros(max(int(n_rows), 1), np.float64)
        cols = _BatchColumns(x, x, self.device)
        blk = np.zeros((bk.fused_e_bucket(n_edges), bk.LANES), np.float32)
        self._dispatch(cols, [(0, blk)], {})
        if gate is not None:
            t0 = time.perf_counter()
            units = self._dispatch(cols, [(0, blk)], {})
            gate.update("fused_s", time.perf_counter() - t0, units)

    def match(self, cols: _BatchColumns, ords: Sequence[int],
              gate: "_MatchGate | None" = None):
        """{ord: (rows, certain)} — per subscription the batch rows its
        polygon matched (f32-certain) plus the near band still needing
        f64 refinement. Members group by edge bucket; subscriptions past
        the E ladder are returned in the third slot for host evaluation.
        ``gate`` (when given) learns the measured per-unit dispatch cost
        from the real dispatches (warmups never update it)."""
        groups: dict = {}
        host_ords: list[int] = []
        for o in ords:
            blk = self.index.kernel_block(int(o))
            if blk is None:
                host_ords.append(int(o))
                continue
            key = (bk.fused_e_bucket(blk.shape[0]),)
            groups.setdefault(key, []).append((int(o), blk))
        out: dict = {}
        t0 = time.perf_counter()
        units = 0
        for (chunk_e,), members in sorted(groups.items()):
            from geomesa_tpu_torch.storage.table import FUSED_CHUNK_Q

            for s in range(0, len(members), FUSED_CHUNK_Q):
                units += self._dispatch(
                    cols, members[s : s + FUSED_CHUNK_Q], out
                )
        if gate is not None:
            gate.update("fused_s", time.perf_counter() - t0, units)
        return out, host_ords

    def _dispatch(self, cols: _BatchColumns, members, out: dict) -> int:
        """One fused dispatch: slot i scans batch block ``bids[i]`` with
        member ``qids[i]``'s edge stack through ``block_scan_multi``'s
        PIP leg (:meth:`stage`). Returns the dispatch's work units
        (slots x edge bucket x block rows — the ``_MatchGate`` cost
        denominator)."""
        staged = self.stage(cols, members)
        planes = bk.scan_planes_multi(cols.cols3(), **staged)
        # both planes in ONE device->host copy (it synchronizes, so the
        # gate's clock, read after it, covers the launch)
        wide, inner = planes.cpu().numpy()
        nb = cols.n_blocks
        seq = np.arange(nb)
        for q, (o, _) in enumerate(members):
            s = q * nb
            rows, certain = bk.decode_bits_pair(
                np.ascontiguousarray(wide[s : s + nb]),
                np.ascontiguousarray(inner[s : s + nb]),
                seq, nb,
            )
            keep = rows < cols.n
            out[o] = (rows[keep], certain[keep])
        # units = REAL slots' edge work (pad slots take the cheap
        # no-predicate leg; counting them would let a small probe's
        # per-unit cost read artificially low and flip the gate)
        return len(members) * nb * staged["n_edges"] * MATCH_BLOCK

    @staticmethod
    def stage(cols: _BatchColumns, members) -> dict:
        """The keyword arguments of one fused dispatch's
        ``bk.scan_planes_multi`` over ``cols`` for ``members`` [(ordinal,
        [E, 128] kernel block)]: spip = 1 on every real slot; pad slots
        keep the cheap no-predicate leg and are never decoded. Member
        blocks zero-pad to the chunk's FUSED_E_BUCKETS bucket (an E=32
        pack and an E=64 pack share the fused-64 chunk; zero edge rows are
        the pack_edges pad convention — y0 == y1, never a crossing)."""
        from geomesa_tpu_torch.storage.table import FUSED_CHUNK_Q

        chunk_e = bk.fused_e_bucket(members[0][1].shape[0])
        nb = cols.n_blocks
        nq = len(members)
        edges = np.zeros((FUSED_CHUNK_Q, chunk_e, bk.LANES), np.float32)
        for q, (_, blk) in enumerate(members):
            edges[q, : blk.shape[0]] = blk
        boxes = np.zeros((FUSED_CHUNK_Q, 8, bk.LANES), np.float32)
        wins = np.zeros((FUSED_CHUNK_Q, 8, bk.LANES), np.int32)
        # FIXED slot shape: always pad to a full FUSED_CHUNK_Q chunk so
        # the launch shape is exactly (E bucket, nb) — a partial chunk
        # (the probe, the E-ladder tail) takes the warmed shape.
        n_real = nq * nb
        bids = np.zeros(bk.bucket_of(FUSED_CHUNK_Q * nb), np.int32)
        qids = np.zeros(len(bids), np.int32)
        spip = np.zeros(len(bids), np.int32)
        bids[:n_real] = np.tile(np.arange(nb, dtype=np.int32), nq)
        qids[:n_real] = np.repeat(np.arange(nq, dtype=np.int32), nb)
        spip[:n_real] = 1
        return dict(
            bids=bids, qids=qids, boxes=boxes, wins=wins, col_names=("x", "y"),
            has_boxes=False, has_windows=False, extent=False, edges=edges,
            spip=spip, n_edges=chunk_e,
        )


# -- windowed continuous computation ----------------------------------------


@dataclass(frozen=True)
class WindowSpec:
    """One continuous window: tumbling (``slide_ms`` None) or sliding,
    over event time, producing ``count`` / ``bounds`` / ``stats``
    aggregates. Windows align to multiples of the slide; panes are the
    gcd of size and slide, so sliding windows COMPOSE pane partials
    instead of recounting rows (the TileAggregateCache pattern)."""

    size_ms: int
    slide_ms: "int | None" = None
    agg: str = "count"          # count | bounds | stats
    fieldname: "str | None" = None  # numeric field for stats

    def __post_init__(self):
        if self.size_ms <= 0:
            raise ValueError("window size_ms must be positive")
        if self.agg not in ("count", "bounds", "stats"):
            raise ValueError(f"unknown window agg {self.agg!r}")
        if self.agg == "stats" and not self.fieldname:
            raise ValueError("stats windows need fieldname")
        if self.slide_ms is not None and self.slide_ms <= 0:
            raise ValueError("slide_ms must be positive")

    @property
    def pane_ms(self) -> int:
        slide = self.slide_ms if self.slide_ms is not None else self.size_ms
        return math.gcd(int(self.size_ms), int(slide))

    @property
    def effective_slide_ms(self) -> int:
        return int(self.slide_ms if self.slide_ms is not None else self.size_ms)


def compose_partials(spec: WindowSpec, parts: Sequence[dict]) -> dict:
    """Left-fold pane partials IN PANE ORDER into one window aggregate —
    the pure composition the bit-identity test pins: maintaining panes
    incrementally and composing equals recomputing the same fold from
    raw rows grouped by pane."""
    out: "dict | None" = None
    for p in parts:
        if p is None or p["n"] == 0:
            continue
        if out is None:
            out = dict(p)
            continue
        out["n"] += p["n"]
        if spec.agg == "bounds":
            out["minx"] = min(out["minx"], p["minx"])
            out["miny"] = min(out["miny"], p["miny"])
            out["maxx"] = max(out["maxx"], p["maxx"])
            out["maxy"] = max(out["maxy"], p["maxy"])
        elif spec.agg == "stats":
            out["sum"] = out["sum"] + p["sum"]
            out["min"] = min(out["min"], p["min"])
            out["max"] = max(out["max"], p["max"])
    if out is None:
        return {"n": 0}
    return out


class WindowedAggregator:
    """Continuous windowed aggregation over a feature stream.

    Usable directly as a :meth:`FeatureStream.to` sink (it is a callable
    ``(action, fid, row)`` — upserts accumulate, deletes are ignored:
    windows aggregate the EVENT stream, the streams-tier semantics) or
    fed in batches by :class:`StandingQueryEngine`. State is one partial
    per pane; reads compose the covering panes
    (:func:`compose_partials`). Pane retention is bounded
    (``geomesa.standing.window.panes``): panes older than the newest
    ``window_panes`` drop, counted by
    ``geomesa.standing.window.dropped``."""

    def __init__(self, spec: WindowSpec, time_field: "str | None" = None,
                 metrics=None, max_panes: "int | None" = None):
        from geomesa_tpu_torch.lockwitness import witness
        from geomesa_tpu_torch.metrics import resolve

        self.spec = spec
        self.time_field = time_field
        self.metrics = resolve(metrics)
        if max_panes is None:
            max_panes = StandingConfig.from_properties().window_panes
        self.max_panes = max(int(max_panes), 1)
        self._lock = witness(threading.Lock(), "WindowedAggregator._lock")
        self._panes: dict[int, dict] = {}  # guarded-by: _lock

    @staticmethod
    def _ms(v) -> int:
        if isinstance(v, np.datetime64):
            return int(v.astype("datetime64[ms]").astype(np.int64))
        return int(v)

    def __call__(self, action: str, fid, row) -> None:
        if action == "upsert" and row is not None:
            self.accept_rows([row])

    def accept_rows(self, rows: Sequence[Mapping],
                    times_ms: "Sequence[int] | None" = None,
                    xs: "np.ndarray | None" = None,
                    ys: "np.ndarray | None" = None) -> int:
        """Fold a batch of event rows into their panes. ``times_ms``
        overrides the per-row ``time_field`` read (the engine passes
        the batch's already-extracted columns); rows without a usable
        event time — None, or the engine's negative no-time sentinel —
        are skipped (a -1 folded as-is would seed pane -1 and stretch
        :meth:`windows`' slide walk across the whole epoch)."""
        spec = self.spec
        pane_ms = spec.pane_ms
        n = 0
        dropped = 0
        with self._lock:
            for i, row in enumerate(rows):
                if times_ms is not None:
                    t = times_ms[i]
                elif self.time_field is not None:
                    t = row.get(self.time_field)
                else:
                    t = int(time.time() * 1000)
                if t is None:
                    continue
                t = self._ms(t)
                if t < 0:
                    continue
                pane = t // pane_ms
                p = self._panes.get(pane)
                if p is None:
                    p = self._panes[pane] = self._zero()
                self._fold_row(p, row, i, xs, ys)
                n += 1
            if len(self._panes) > self.max_panes:
                for k in sorted(self._panes)[: len(self._panes) - self.max_panes]:
                    del self._panes[k]
                    dropped += 1
        if dropped:
            self.metrics.counter("geomesa.standing.window.dropped", dropped)
        return n

    def _zero(self) -> dict:
        if self.spec.agg == "bounds":
            return {"n": 0, "minx": np.inf, "miny": np.inf,
                    "maxx": -np.inf, "maxy": -np.inf}
        if self.spec.agg == "stats":
            return {"n": 0, "sum": 0.0, "min": np.inf, "max": -np.inf}
        return {"n": 0}

    def _fold_row(self, p: dict, row, i, xs, ys) -> None:
        # holds-lock: _lock
        p["n"] += 1
        if self.spec.agg == "bounds":
            if xs is not None:
                x, y = float(xs[i]), float(ys[i])
            else:
                g = row.get("__xy__")
                if g is None:
                    for v in row.values():
                        if isinstance(v, geo.Point):
                            g = (v.x, v.y)
                            break
                if g is None:
                    return
                x, y = float(g[0]), float(g[1])
            p["minx"] = min(p["minx"], x)
            p["miny"] = min(p["miny"], y)
            p["maxx"] = max(p["maxx"], x)
            p["maxy"] = max(p["maxy"], y)
        elif self.spec.agg == "stats":
            v = row.get(self.spec.fieldname)
            if v is None:
                p["n"] -= 1
                return
            v = float(v)
            p["sum"] = p["sum"] + v
            p["min"] = min(p["min"], v)
            p["max"] = max(p["max"], v)

    def partials(self) -> dict:
        """{pane index: partial} snapshot (copies — callers compose or
        inspect freely)."""
        with self._lock:
            return {k: dict(v) for k, v in self._panes.items()}

    def value(self, end_ms: int) -> dict:
        """The composed aggregate of the window ENDING at ``end_ms``
        (covering ``[end_ms - size_ms, end_ms)``), from pane partials in
        pane order."""
        spec = self.spec
        pane_ms = spec.pane_ms
        lo = (int(end_ms) - spec.size_ms) // pane_ms
        hi = int(end_ms) // pane_ms
        with self._lock:
            parts = [
                dict(self._panes[k])
                for k in range(lo, hi)
                if k in self._panes
            ]
        return compose_partials(spec, parts)

    def windows(self, upto_ms: int) -> list[tuple[int, dict]]:
        """[(window start ms, composed aggregate)] for every
        slide-aligned window fully contained before ``upto_ms``, oldest
        first, over the retained panes."""
        spec = self.spec
        with self._lock:
            if not self._panes:
                return []
            first = min(self._panes) * spec.pane_ms
        slide = spec.effective_slide_ms
        start = (first // slide) * slide
        out = []
        while start + spec.size_ms <= upto_ms:
            v = self.value(start + spec.size_ms)
            if v["n"]:
                out.append((start, v))
            start += slide
        return out


# -- delivery ---------------------------------------------------------------


class _AlertBlock:
    """One matched batch's alerts in COLUMNAR form: the ack path stores
    the matched (row, ordinal) arrays plus shared references; per-alert
    dicts materialize at drain time, on the consumer's clock — building
    ~10k dicts per hotspot batch on the write ack path was measurable
    against the 0.9x ingest-ratio gate. ``attrs`` is snapshotted per
    block at delivery time, so a later unregister cannot change a
    delivered alert's payload."""

    __slots__ = ("pt", "ords", "ids", "sub_ids", "kinds", "attrs", "start")

    def __init__(self, pt: np.ndarray, ords: np.ndarray,
                 ids: Sequence[str], sub_ids: Sequence[str],
                 kinds: np.ndarray, attrs: Mapping[int, dict]):
        self.pt = pt
        self.ords = ords
        self.ids = ids
        self.sub_ids = sub_ids
        self.kinds = kinds
        self.attrs = attrs
        self.start = 0

    def __len__(self) -> int:
        return len(self.ords) - self.start

    def drop(self, n: int) -> None:
        self.start += n

    def to_dicts(self, lo: "int | None" = None,
                 hi: "int | None" = None) -> list[dict]:
        lo = self.start if lo is None else lo
        hi = len(self.ords) if hi is None else hi
        out = []
        for k in range(lo, hi):
            o = int(self.ords[k])
            a = {
                "sub": self.sub_ids[o],
                "kind": _KIND_NAMES[int(self.kinds[o])],
                "id": str(self.ids[int(self.pt[k])]),
            }
            at = self.attrs.get(o)
            if at is not None:
                a["attrs"] = at
            out.append(a)
        return out


class _ListBlock:
    """Already-materialized alerts behind the same block protocol
    (:meth:`AlertQueue.put_many` / the ``on_alerts`` push path)."""

    __slots__ = ("alerts", "start")

    def __init__(self, alerts: Sequence[dict]):
        self.alerts = list(alerts)
        self.start = 0

    def __len__(self) -> int:
        return len(self.alerts) - self.start

    def drop(self, n: int) -> None:
        self.start += n

    def to_dicts(self, lo: int, hi: int) -> list[dict]:
        return self.alerts[lo:hi]


class AlertQueue:
    """Bounded in-process alert queue: delivery never blocks the write
    ack path — past capacity the OLDEST alerts drop (counted by
    ``geomesa.standing.dropped``), the live tail is what a consumer
    drains. Alerts arrive as columnar blocks (:class:`_AlertBlock`) or
    materialized lists; bounding and drops count individual alerts
    either way."""

    def __init__(self, maxlen: int, metrics=None):
        from geomesa_tpu_torch.lockwitness import witness
        from geomesa_tpu_torch.metrics import resolve

        self.maxlen = max(int(maxlen), 1)
        self.metrics = resolve(metrics)
        self._lock = witness(threading.Lock(), "AlertQueue._lock")
        self._q: deque = deque()     # guarded-by: _lock
        self._n = 0                  # guarded-by: _lock
        self._dropped = 0            # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return self._n

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def put_many(self, alerts: Sequence[dict]) -> int:
        """Enqueue a materialized batch; returns alerts dropped to stay
        bounded."""
        if not alerts:
            return 0
        return self.put_block(_ListBlock(alerts))

    def put_block(self, block) -> int:
        """Enqueue one alert block; returns alerts dropped (oldest
        first, possibly from the new block itself) to stay bounded."""
        n = len(block)
        if n == 0:
            return 0
        dropped = 0
        with self._lock:
            self._q.append(block)
            self._n += n
            over = self._n - self.maxlen
            while dropped < over:
                head = self._q[0]
                k = min(len(head), over - dropped)
                head.drop(k)
                dropped += k
                if len(head) == 0:
                    self._q.popleft()
            self._n -= dropped
            self._dropped += dropped
        if dropped:
            self.metrics.counter("geomesa.standing.dropped", dropped)
        return dropped

    def drain(self, max_n: "int | None" = None) -> list[dict]:
        # CLAIM slices under the lock, materialize after releasing it:
        # building tens of thousands of per-alert dicts while holding
        # _lock would stall put_block on the write ack path — the exact
        # cost the columnar blocks defer to the consumer's clock. The
        # claimed ranges are safe to read unlocked: block arrays are
        # immutable; only the start cursor moves, and ours advanced
        # past the claim before the lock released.
        taken: list[tuple] = []
        with self._lock:
            n = self._n if max_n is None else min(max_n, self._n)
            while n > 0:
                head = self._q[0]
                k = min(len(head), n)
                taken.append((head, head.start, head.start + k))
                head.drop(k)
                n -= k
                self._n -= k
                if len(head) == 0:
                    self._q.popleft()
        out: list[dict] = []
        for head, lo, hi in taken:
            out.extend(head.to_dicts(lo, hi))
        return out


class StandingQueryEngine:
    """Route -> match -> deliver for every arriving batch.

    Attach to a :class:`LambdaStore` via ``lam.standing()`` (its
    ``write`` feeds every acknowledged batch here) or to a
    :class:`StreamFlusher` via :meth:`attach_flusher` (batches match at
    flush arrival — for stores fed through the flusher directly; attach
    ONE arrival hook per engine or batches match twice). Matching is
    guarded: a matcher fault is counted (``geomesa.standing.errors``)
    and logged, never propagated into the acknowledged write."""

    # optional push consumer: called with each delivered alert list
    # (after the bounded queue accepts them)
    on_alerts: "Callable | None" = None

    def __init__(self, sft, config: "StandingConfig | None" = None,
                 metrics=None, device="cuda"):
        from geomesa_tpu_torch.datastore import resolve_device
        from geomesa_tpu_torch.metrics import resolve

        self.sft = sft
        self.config = config if config is not None else StandingConfig.from_properties()
        self.metrics = resolve(metrics)
        # the fused matcher's device: a CUDA engine launches K2, a CPU one
        # takes its plain version (LambdaStore.standing passes the cold
        # store's device)
        self.device = resolve_device(device)
        self.index = SubscriptionIndex(self.config, metrics=self.metrics)
        self.matcher = FusedMatcher(self.index, self.device)
        self.gate = _MatchGate()
        self.alerts = AlertQueue(self.config.queue_max, metrics=self.metrics)
        self.windows: dict[str, WindowedAggregator] = {}

    # -- subscriptions ----------------------------------------------------
    def register(self, sub: Subscription) -> None:
        self.index.register(sub)

    def unregister(self, sub_id: str) -> bool:
        return self.index.unregister(sub_id)

    def add_window(self, name: str, spec: WindowSpec) -> WindowedAggregator:
        """Attach a continuous window over the engine's batch feed (event
        time = the schema's dtg field when present)."""
        agg = WindowedAggregator(
            spec, time_field=getattr(self.sft, "dtg_field", None),
            metrics=self.metrics, max_panes=self.config.window_panes,
        )
        self.windows[name] = agg
        return agg

    def attach_flusher(self, flusher) -> None:
        """Match batches at StreamFlusher arrival (``flush(snapshot)``
        entry) instead of at ``LambdaStore.write``."""
        flusher.on_batch = self._on_flush_batch

    def _on_flush_batch(self, snapshot: Sequence[tuple]) -> None:
        ids = [fid for fid, _ in snapshot]
        rows = [row for _, row in snapshot]
        self.on_batch(ids, rows, time.perf_counter())

    # -- the per-batch pipeline -------------------------------------------
    def _columns(self, rows: Sequence[Mapping], need_t: bool = True):
        g = self.sft.geom_field
        n = len(rows)
        try:
            # point fast path: one fromiter per axis (the matcher rides
            # the write ack path — a per-row isinstance ladder here is
            # measurable against the 0.9x ingest-ratio bound)
            x = np.fromiter((r[g].x for r in rows), np.float64, count=n)
            y = np.fromiter((r[g].y for r in rows), np.float64, count=n)
        except AttributeError:  # WKT strings / extents in the batch
            x = np.empty(n, np.float64)
            y = np.empty(n, np.float64)
            for i, r in enumerate(rows):
                p = r[g]
                if isinstance(p, str):
                    p = geo.from_wkt(p)
                b = p.bounds() if not isinstance(p, geo.Point) else None
                if b is not None:  # non-points match by representative
                    x[i] = (b[0] + b[2]) / 2.0
                    y[i] = (b[1] + b[3]) / 2.0
                else:
                    x[i] = p.x
                    y[i] = p.y
        t = None
        dtg = getattr(self.sft, "dtg_field", None) if need_t else None
        if dtg is not None:
            vals = [r.get(dtg) for r in rows]
            try:
                a = np.asarray(vals)
                if np.issubdtype(a.dtype, np.datetime64):
                    t = a.astype("datetime64[ms]").astype(np.int64)
                elif np.issubdtype(a.dtype, np.integer) or np.issubdtype(
                    a.dtype, np.floating
                ):
                    t = a.astype(np.int64)
            except (TypeError, ValueError):
                t = None
            if t is None:  # mixed / None-bearing: per-row fallback
                t = np.empty(n, np.int64)
                for i, v in enumerate(vals):
                    t[i] = (
                        WindowedAggregator._ms(v) if v is not None else -1
                    )
        return x, y, t

    def on_batch(self, ids: Sequence[str], rows: Sequence[Mapping],
                 t_arrival: "float | None" = None) -> int:
        """One arriving batch: route to candidates, match, deliver.
        Returns alerts produced. NEVER raises — the batch is already
        acknowledged; matcher faults count ``geomesa.standing.errors``
        and the batch's alerts are dropped (at-most-once delivery)."""
        if not rows:
            return 0
        t0 = time.perf_counter() if t_arrival is None else t_arrival
        try:
            return self._on_batch(ids, rows, t0)
        except Exception:
            log.warning("standing matcher failed on a %d-row batch; "
                        "alerts dropped", len(rows), exc_info=True)
            self.metrics.counter("geomesa.standing.errors")
            return 0

    def _on_batch(self, ids, rows, t0: float) -> int:
        # event time is only consumed by tube refinement and windows —
        # a pure-geofence engine skips the per-batch dtg extraction
        need_t = bool(self.windows) or self.index.has_tube()
        x, y, t = self._columns(rows, need_t=need_t)
        fault.fault_point("standing.match")
        tm0 = time.perf_counter()
        pt, ords = self.match_points(x, y, t_ms=t)
        self.metrics.observe(
            "geomesa.standing.match", time.perf_counter() - tm0
        )
        n_alerts = 0
        with _ospan("standing.deliver", pairs=len(pt)):
            fault.fault_point("standing.deliver")
            if len(pt):
                kind, _, _, _, _ = self.index._ensure_arrays()
                attrs = self.index._attrs
                snap: dict[int, dict] = {}
                if attrs:
                    for o in np.unique(ords).tolist():
                        a = attrs.get(int(o))
                        if a is not None:
                            snap[int(o)] = a
                # retain only the MATCHED rows' ids: a block pinning the
                # whole 20k-row batch id list per ~handful of alerts
                # would let an undrained queue cap alert COUNT while
                # retaining unbounded id-list memory
                upt, inv = np.unique(pt, return_inverse=True)
                block = _AlertBlock(
                    inv.astype(np.int64), ords,
                    [str(ids[int(i)]) for i in upt],
                    self.index._ids, kind, snap,
                )
                n_alerts = len(pt)
                self.metrics.counter("geomesa.standing.alerts", n_alerts)
                if self.on_alerts is not None:
                    alerts = block.to_dicts()
                    self.alerts.put_many(alerts)
                    self.on_alerts(alerts)
                else:
                    self.alerts.put_block(block)
            for agg in list(self.windows.values()):
                agg.accept_rows(rows, times_ms=t, xs=x, ys=y)
        # alert latency: batch arrival (ack path entry) -> delivered
        self.metrics.observe(
            "geomesa.standing.latency", time.perf_counter() - t0
        )
        return n_alerts

    # -- matching ---------------------------------------------------------
    def match_points(self, x, y, t_ms: "np.ndarray | None" = None):
        """(pt_idx, ords) matched pairs for a point batch — the exact
        standing-query answer (a benchmark's oracle surface). Routing
        produces the candidate pairs; FULL cells match with zero
        geometry work; boundary candidates evaluate exactly (fused
        kernel for dense geofences, vectorized host ray cast for the
        sparse rest, haversine for proximity/tube)."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        with _ospan("standing.route", rows=len(x)):
            pt, ords, full = self.index.route(x, y)
        self.metrics.counter("geomesa.standing.candidates", len(pt))
        if len(pt) == 0:
            z = np.zeros(0, np.int64)
            return z, z.copy()
        with _ospan("standing.match", pairs=len(pt)):
            out_pt, out_ord = self._match_pairs(
                x, y, t_ms, pt, ords, full
            )
        self.metrics.counter("geomesa.standing.matched", len(out_pt))
        return out_pt, out_ord

    def _match_pairs(self, x, y, t_ms, pt, ords, full):
        kind, eoff, segs, bbox, rect = self.index._ensure_arrays()
        k = kind[ords]
        hits_pt: list = []
        hits_ord: list = []
        fused_ords = self._fused_candidates(
            ords[k == _KIND_GEOFENCE], eoff, rect, len(x)
        )
        if fused_ords:
            # the kernel result is the COMPLETE match set for these
            # subscriptions (full-cell points are inside by
            # classification, and the kernel finds them too) — drop ALL
            # their routed pairs so nothing double-delivers
            drop = np.isin(ords, np.asarray(fused_ords, np.int64))
            fpt, fords = self._match_fused(x, y, fused_ords, eoff, segs)
            hits_pt.append(fpt)
            hits_ord.append(fords)
            pt, ords, full, k = pt[~drop], ords[~drop], full[~drop], k[~drop]
        hits_pt.append(pt[full])
        hits_ord.append(ords[full])
        pt, ords, k = pt[~full], ords[~full], k[~full]
        if len(pt) == 0:
            return np.concatenate(hits_pt), np.concatenate(hits_ord)
        gf = k == _KIND_GEOFENCE
        if gf.any():
            gpt, gord = pt[gf], ords[gf]
            r = rect[gord]
            if r.any():
                # axis-aligned rectangles (the bulk of a tiny-geofence
                # population): the half-open box test IS the ray cast
                # (_is_axis_rect) — two compares per axis per pair
                rpt, rord = gpt[r], gord[r]
                b = bbox[rord]
                rx, ry = x[rpt], y[rpt]
                inside = (
                    (rx >= b[:, 0]) & (rx < b[:, 2])
                    & (ry >= b[:, 1]) & (ry < b[:, 3])
                )
                hits_pt.append(rpt[inside])
                hits_ord.append(rord[inside])
                gpt, gord = gpt[~r], gord[~r]
            if len(gpt):
                # dense geofences carry a match-time raster grid: one
                # cell lookup decides FULL (match) / OUT (miss), only
                # the fine-grid boundary residue pays the ray cast —
                # the raster-interval economics with roles
                # reversed (exact: FULL/OUT honor the conservative
                # margin, PARTIAL refines through the identical f64
                # crossing construction)
                res_pt, res_ord = gpt, gord
                if self.index.has_rasters():
                    order_ = np.argsort(gord, kind="stable")
                    gpt_s, gord_s = gpt[order_], gord[order_]
                    uniq, first = np.unique(gord_s, return_index=True)
                    bounds = np.append(first, len(gord_s))
                    res_p: list = []
                    res_o: list = []
                    for u, o in enumerate(uniq.tolist()):
                        ppt = gpt_s[bounds[u] : bounds[u + 1]]
                        ra = self.index.raster_of(o)
                        if ra is None:
                            res_p.append(ppt)
                            res_o.append(gord_s[bounds[u] : bounds[u + 1]])
                            continue
                        cls = ra.classify_points(x[ppt], y[ppt])
                        fullm = cls == geo.RASTER_FULL
                        if fullm.any():
                            hits_pt.append(ppt[fullm])
                            hits_ord.append(
                                np.full(int(fullm.sum()), o, np.int64)
                            )
                        part = cls == geo.RASTER_PARTIAL
                        if part.any():
                            res_p.append(ppt[part])
                            res_o.append(
                                np.full(int(part.sum()), o, np.int64)
                            )
                    if res_p:
                        res_pt = np.concatenate(res_p)
                        res_ord = np.concatenate(res_o)
                    else:
                        res_pt = np.zeros(0, np.int64)
                        res_ord = np.zeros(0, np.int64)
                if len(res_pt):
                    th0 = time.perf_counter()
                    inside = _ragged_pip(
                        x[res_pt], y[res_pt], res_ord, eoff, segs
                    )
                    self.gate.update(
                        "host_s", time.perf_counter() - th0,
                        int((eoff[res_ord + 1] - eoff[res_ord]).sum()),
                    )
                    hits_pt.append(res_pt[inside])
                    hits_ord.append(res_ord[inside])
        pr = k == _KIND_PROXIMITY
        if pr.any():
            ppt, pord = pt[pr], ords[pr]
            keep = self._match_proximity(x[ppt], y[ppt], pord)
            hits_pt.append(ppt[keep])
            hits_ord.append(pord[keep])
        tb = k == _KIND_TUBE
        if tb.any():
            tpt, tord = pt[tb], ords[tb]
            keep = self._match_tube(x[tpt], y[tpt], tpt, tord, t_ms)
            hits_pt.append(tpt[keep])
            hits_ord.append(tord[keep])
        return np.concatenate(hits_pt), np.concatenate(hits_ord)

    def _fused_candidates(self, gord: np.ndarray, eoff: np.ndarray,
                          rect: np.ndarray, n_rows: int) -> list[int]:
        """Geofence ordinals this batch evaluates through the fused
        kernel: enough routed candidate rows to amortize a slot
        (``geomesa.standing.fused.min.points``; <= 0 keeps everything
        on the vectorized host ray cast), not an axis-aligned rectangle
        (two compares beat any kernel), within the E ladder (past it
        the routed-pair ray cast is exact and strictly cheaper than the
        whole-batch fallback), and — with ``geomesa.standing.fused.gate``
        armed — predicted cheaper fused than host by the measured
        :class:`_MatchGate` (one bounded probe chunk seeds the fused
        measurement; host-kept candidates count
        ``geomesa.standing.gate.host``)."""
        min_pts = int(self.config.fused_min_points)
        if min_pts <= 0 or len(gord) == 0:
            return []
        uniq, counts = np.unique(gord, return_counts=True)
        edges = eoff[uniq + 1] - eoff[uniq]
        elig = (
            (counts >= min_pts) & ~rect[uniq]
            & (edges > 0) & (edges <= bk.E_BUCKETS[-1])
        )
        uniq, counts, edges = uniq[elig], counts[elig], edges[elig]
        if len(uniq) == 0:
            return []
        if not self.config.fused_gate:
            return [int(o) for o in uniq]
        from geomesa_tpu_torch.storage.table import FUSED_CHUNK_Q

        nb = max(1, -(-n_rows // MATCH_BLOCK))
        buckets = np.fromiter(
            (bk.fused_e_bucket(int(e)) for e in edges), np.int64,
            count=len(edges),
        )
        win = self.gate.pick(counts * edges, nb * MATCH_BLOCK * buckets)
        if win is None:
            # fused side unmeasured: probe ONE member (deterministic —
            # np.unique order; a full chunk of 256-edge members costs
            # seconds of real slot work on a 1-core host), everything
            # else stays host this batch
            win = np.zeros(len(uniq), bool)
            win[:1] = True
        n_host = int((~win).sum())
        if n_host:
            self.metrics.counter("geomesa.standing.gate.host", n_host)
        return [int(o) for o in uniq[win]]

    def _match_fused(self, x, y, fused_ords, eoff, segs):
        """Fused kernel evaluation for the selected geofences: the whole
        batch scans against each member's edge stack in one dispatch per
        E-bucket chunk; near-band rows refine through the same f64 ray
        cast as the sparse path (bit-identical semantics)."""
        cols = _BatchColumns(x, y, self.device)
        results, leftovers = self.matcher.match(
            cols, fused_ords, gate=self.gate
        )
        self.metrics.counter("geomesa.standing.fused", len(results))
        out_pt: list = []
        out_ord: list = []
        for o, (rows, certain) in results.items():
            sure = rows[certain]
            near = rows[~certain]
            if len(near):
                ok = _ragged_pip(
                    x[near], y[near],
                    np.full(len(near), o, np.int64), eoff, segs,
                )
                sure = np.concatenate([sure, near[ok]])
            out_pt.append(np.sort(sure))
            out_ord.append(np.full(len(sure), o, np.int64))
        for o in leftovers:
            # past the E ladder (no kernel block): exact whole-batch
            # host ray cast. _fused_candidates already filters these
            # out, so the engine never lands here — this keeps a DIRECT
            # matcher.match caller (unfiltered ords) exact
            inside = _ragged_pip(
                x, y, np.full(len(x), o, np.int64), eoff, segs
            )
            rows = np.flatnonzero(inside)
            out_pt.append(rows)
            out_ord.append(np.full(len(rows), o, np.int64))
        if not out_pt:
            z = np.zeros(0, np.int64)
            return z, z.copy()
        return np.concatenate(out_pt), np.concatenate(out_ord)

    def _match_proximity(self, px, py, pord) -> np.ndarray:
        from geomesa_tpu_torch.process.knn import haversine_m

        keep = np.zeros(len(pord), bool)
        for o in np.unique(pord):
            params = self.index.prox_of(int(o))
            if params is None:  # unsubscribed since the route snapshot
                continue
            centers, dist = params
            m = pord == o
            d = haversine_m(
                px[m][:, None], py[m][:, None],
                centers[None, :, 0], centers[None, :, 1],
            )
            keep[m] = d.min(axis=1) <= dist
        return keep

    def _match_tube(self, px, py, pt, tord, t_ms) -> np.ndarray:
        from geomesa_tpu_torch.process.knn import haversine_m

        keep = np.zeros(len(tord), bool)
        if t_ms is None:
            return keep
        tt = t_ms[pt]
        for o in np.unique(tord):
            params = self.index.tube_of(int(o))
            if params is None:  # unsubscribed since the route snapshot
                continue
            xy, ts, buf = params
            m = (tord == o) & (tt >= ts[0]) & (tt <= ts[-1])
            if not m.any():
                continue
            cx = np.interp(tt[m], ts, xy[:, 0])
            cy = np.interp(tt[m], ts, xy[:, 1])
            keep[m] = haversine_m(px[m], py[m], cx, cy) <= buf
        return keep
