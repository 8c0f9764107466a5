"""Streaming hot tier: a live, mutable feature cache with expiry and
event listeners.

The port's copy of geomesa_tpu/streaming/cache.py (reference
KafkaFeatureCacheImpl.scala:30-120 over BucketIndex): the *current state*
of a stream in an in-memory grid-indexed cache. Queries snapshot the live
state into a columnar batch and run the same host filter evaluation as
the store's refinement tier; ids come back in ``sorted`` order of the
bucket-pruned candidates, as the reference returns them.

Thread-safe: every mutation and every snapshot serializes on one
re-entrant lock (listeners fire under it: a listener calling back into the
cache re-enters; a listener blocking on another thread's cache access
would deadlock). Reads that need a consistent (result, live-id) pair use
:meth:`StreamingFeatureCache.query_shadow`.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Callable, Mapping, Optional, Sequence

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import Filter, Include, INCLUDE
from geomesa_tpu_torch.sft import FeatureType
from geomesa_tpu_torch.utils.spatial_index import BucketIndex


class StreamingFeatureCache:
    """Live keyed feature state over a bucket grid (KafkaFeatureCacheImpl).

    - ``upsert(rows)``: latest message per id wins
    - ``delete(ids)``
    - ``expiry_ms``: features older than this (by ingest wall-clock) are
      swept by ``expire()`` (reference feature-expiry config)
    - listeners: callables ``(event, id, row)`` with event in
      {"added", "updated", "removed", "expired"} (reference
      KafkaFeatureCache listeners)

    Thread-safe (see module docstring): mutations, snapshots and queries
    serialize on ``_lock``.
    """

    def __init__(self, sft: FeatureType, expiry_ms: Optional[int] = None,
                 grid: tuple[int, int] = (360, 180), metrics=None):
        from geomesa_tpu_torch.lockwitness import witness

        self.sft = sft
        self.expiry_ms = expiry_ms
        self._lock = witness(
            threading.RLock(), "StreamingFeatureCache._lock"
        )
        self.index = BucketIndex(*grid)           # guarded-by: _lock
        self._rows: dict[str, dict] = {}          # guarded-by: _lock
        self._ingest_ms: dict[str, int] = {}      # guarded-by: _lock
        # WAL-replay mode: while
        # set, grid-index maintenance is DEFERRED — most replayed rows
        # are published and evicted again by later flush-watermark
        # records, so indexing them is pure waste; end_replay() rebuilds
        # the index from the rows that actually survived
        self._replaying = False                   # guarded-by: _lock
        self._next_id = 0                         # guarded-by: _lock
        # live-id set cache for query_shadow: rebuilding a frozenset of
        # every live id per query is O(hot) and dominated read latency
        # under a deep pending-update overlay; membership only changes
        # on id add/remove (NOT value updates), so the set is memoized
        # against a membership version counter
        self._ids_version = 0                     # guarded-by: _lock
        self._live_cache: tuple = (-1, frozenset())  # guarded-by: _lock
        # (monotonic: survives deletes without colliding)
        self.listeners: list[Callable] = []
        self.metrics = metrics  # MetricsRegistry (default: global fallback)
        # generation hook: a LambdaStore over a
        # cache-enabled cold store points these at the cold cache's
        # GenerationTracker so hot-tier mutations invalidate overlapping
        # cached results too. Conservative: the merge shadows cold rows by
        # live hot ids, so a hot write can change a merged answer even
        # before any flush — bumping here keeps every cache tier honest.
        self.generations = None
        self.gen_type: Optional[str] = None

    def _bump_gen(self, rows: Sequence[Mapping] = ()) -> None:
        """Bump the wired generation tracker over the mutated rows' bbox
        union (falls back to a whole-type bump when bounds are unknown)."""
        if self.generations is None or self.gen_type is None:
            return
        bounds = None
        try:
            boxes = [self._bbox(r) for r in rows if r is not None]
            if boxes:
                bounds = (
                    min(b[0] for b in boxes), min(b[1] for b in boxes),
                    max(b[2] for b in boxes), max(b[3] for b in boxes),
                )
        except Exception:
            bounds = None
        self.generations.bump(self.gen_type, bounds=bounds, time_range=None)

    def __len__(self) -> int:
        return len(self._rows)

    def _notify(self, event: str, fid: str, row, guard: bool = False) -> None:
        """``guard=True``: a raising listener is logged + counted instead
        of propagating — maintenance sweeps (expire) must finish even when
        a derived view misbehaves, or expired rows stay resident."""
        for fn in self.listeners:
            if not guard:
                fn(event, fid, row)
                continue
            try:
                fn(event, fid, row)
            except Exception:
                import logging

                logging.getLogger(__name__).warning(
                    "stream listener %r raised on %s(%s); sweep continues",
                    fn, event, fid, exc_info=True,
                )
                from geomesa_tpu_torch.metrics import resolve

                resolve(self.metrics).counter("geomesa.stream.listener_errors")

    def _bbox(self, row: Mapping) -> tuple:
        # upsert has already converted WKT strings to Geometry objects
        return row[self.sft.geom_field].bounds()

    # rows applied per lock hold: a live query must not wait behind an
    # entire 100k-row producer batch (message-level atomicity is the
    # stream model — the Kafka cache applies messages one by one)
    _LOCK_CHUNK = 4096

    def upsert(self, rows: Sequence[Mapping], ids: Sequence[str] | None = None) -> int:
        """Apply a batch of messages; returns the number applied.

        Row dicts are adopted, NOT copied (the per-row copy taxed the
        sustained hot write rate ~25%): callers hand over ownership and
        must not mutate a dict after upserting it. The cache itself
        replaces rows wholesale on update, never mutates in place.
        Large batches apply in lock-hold chunks (readers interleave
        between chunks; each MESSAGE applies atomically, the batch does
        not — the stream contract)."""
        n = 0
        for s in range(0, len(rows), self._LOCK_CHUNK):
            n += self._upsert_chunk(
                rows[s : s + self._LOCK_CHUNK],
                None if ids is None else ids[s : s + self._LOCK_CHUNK],
            )
        return n

    def _resolve_id_locked(self, row, ids, i) -> str:
        """The ONE id-resolution precedence (explicit ids -> ``__id__``
        -> auto counter), shared by :meth:`upsert` and
        :meth:`assign_ids` so the id the WAL logs can never drift from
        the id the hot tier applies."""
        if ids is not None:
            return str(ids[i])
        if "__id__" in row:
            return str(row["__id__"])
        fid = str(self._next_id)
        self._next_id += 1
        return fid

    def _upsert_chunk(self, rows, ids) -> int:
        now = int(_time.time() * 1000)
        with self._lock:
            applied = []
            for i, row in enumerate(rows):
                fid = self._resolve_id_locked(row, ids, i)
                if "__id__" in row:
                    row = {k: v for k, v in row.items() if k != "__id__"}
                g = row.get(self.sft.geom_field)
                if isinstance(g, str):
                    # the parse mutates a copy: callers own their dicts
                    row = dict(row)
                    row[self.sft.geom_field] = geo.from_wkt(g)
                event = "updated" if fid in self._rows else "added"
                if event == "added":
                    self._ids_version += 1
                self._rows[fid] = row
                self._ingest_ms[fid] = now
                if not self._replaying:
                    self.index.insert(fid, self._bbox(row))
                self._notify(event, fid, row)
                applied.append(row)
            if applied:
                self._bump_gen(applied)
            return len(rows)

    def replay_upsert(self, rows: Sequence[Mapping], ids: Sequence[str],
                      xy=None) -> int:
        """Recovery-side BULK apply: identical end state to :meth:`upsert` over the same
        ``(rows, ids)`` — latest message per id wins — but in ONE lock
        hold with a vectorized grid-index pass. Recovery is
        single-threaded (there are no readers to interleave with), so
        the live tier's reader-friendly ``_LOCK_CHUNK`` chunking buys
        nothing here, and the per-record apply loop was the WAL replay
        bottleneck. ``xy``: the batch's
        decoded [n, 2] point coordinates when the WAL record carried
        the geometry column packed (``unpack_upsert_xy``) — skips
        per-row Point attribute reads. Falls back to :meth:`upsert`
        when listeners are attached (events must fire per message)."""
        if self.listeners or not len(rows):
            return self.upsert(rows, ids)
        gf = self.sft.geom_field
        now = int(_time.time() * 1000)
        with self._lock:
            parsed = []
            for row in rows:
                if "__id__" in row:
                    row = {k: v for k, v in row.items() if k != "__id__"}
                g = row.get(gf)
                if isinstance(g, str):
                    row = dict(row)
                    row[gf] = geo.from_wkt(g)
                parsed.append(row)
            sids = [str(i) for i in ids]
            self._rows.update(zip(sids, parsed))
            self._ingest_ms.update((fid, now) for fid in sids)
            self._ids_version += 1
            if self._replaying:
                pass  # end_replay() rebuilds from survivors
            elif xy is not None and len(xy) == len(parsed):
                self.index.bulk_insert_points(sids, xy[:, 0], xy[:, 1])
            else:
                for fid, row in zip(sids, parsed):
                    self.index.insert(fid, self._bbox(row))
            if self.generations is not None and self.gen_type is not None:
                if xy is not None and len(xy):
                    self.generations.bump(self.gen_type, bounds=(
                        float(xy[:, 0].min()), float(xy[:, 1].min()),
                        float(xy[:, 0].max()), float(xy[:, 1].max()),
                    ), time_range=None)
                else:
                    self._bump_gen(parsed)
        return len(rows)

    def begin_replay(self) -> None:
        """Enter WAL-replay mode: grid-index maintenance is suspended
        until :meth:`end_replay` rebuilds it from the surviving rows.
        Replay interleaves bulk upserts with flush-watermark evictions
        that drain most of them right back out — at 1M replayed rows
        the per-row index insert/remove churn was the single largest
        recovery cost, all of it for entries
        that never serve a query (recovery is single-threaded; the
        store is not visible until ``recover`` returns)."""
        with self._lock:
            self._replaying = True

    def end_replay(self) -> None:
        """Leave replay mode and rebuild the grid index from the rows
        that survived — identical to the index a never-crashed store
        holds (it is purely derived state: exactly one entry per
        resident row, keyed by that row's bbox). Point rows go through
        the vectorized bulk insert; anything else falls back to per-row
        inserts. Safe to call after a partial replay (crash-prefix
        semantics): the rebuilt index reflects whatever prefix applied."""
        with self._lock:
            if not self._replaying:
                return
            self._replaying = False
            self.index = BucketIndex(self.index.nx, self.index.ny)
            gf = self.sft.geom_field
            pk: list = []
            px: list = []
            py: list = []
            for fid, row in self._rows.items():
                g = row.get(gf)
                if type(g) is geo.Point:
                    pk.append(fid)
                    px.append(g.x)
                    py.append(g.y)
                else:
                    self.index.insert(fid, self._bbox(row))
            if pk:
                self.index.bulk_insert_points(pk, px, py)

    def assign_ids(self, rows: Sequence[Mapping],
                   ids: Sequence[str] | None) -> tuple[list, int]:
        """Resolve the id each row of a batch will upsert under —
        explicit ``ids``, the row's ``__id__``, or the auto-id counter
        (CONSUMED here, exactly as :meth:`upsert` would) — without
        applying anything. The WAL path uses this so the log records
        resolved ids and recovery never re-draws the counter (a replayed
        auto-id colliding with a fresh one would silently replace a
        live row). Returns ``(ids, next auto-id counter value)``; pass
        the ids back into :meth:`upsert`."""
        with self._lock:
            out = [self._resolve_id_locked(row, ids, i)
                   for i, row in enumerate(rows)]
            return out, self._next_id

    def bump_next_id(self, value: int) -> None:
        """Raise the auto-id counter to at least ``value`` (WAL replay:
        restores the counter recorded at append time so post-recovery
        auto-ids continue past every replayed one)."""
        with self._lock:
            self._next_id = max(self._next_id, int(value))

    def snapshot_pairs(self, ids: Sequence[str]) -> list[tuple[str, dict]]:
        """The resident ``(id, row)`` pairs for a subset of ids, in the
        given order, skipping absent ids — the WAL flush-watermark
        replay's input (same shared-row contract as
        :meth:`snapshot_rows`)."""
        with self._lock:
            get = self._rows.get
            return [
                (fid, row)
                for fid in map(str, ids)
                if (row := get(fid)) is not None
            ]

    def delete(self, ids: Sequence[str],
               after_remove: Optional[Callable] = None) -> int:
        """Remove rows by id. ``after_remove(removed_ids)`` runs under
        the lock AFTER the removals — the WAL hook: the record is
        logged atomically with its application, so no write serialized
        after this delete can be outrun by the delete's record on
        replay. A raising hook leaves the removals applied (the op is
        then un-acknowledged but consistent either way on recovery:
        record durable -> replay deletes too; record lost -> the
        unacknowledged delete is undone). Same caveat as listeners: the
        hook must not block on another thread's cache access."""
        with self._lock:
            n = 0
            removed = []
            removed_ids = []
            for fid in ids:
                fid = str(fid)
                row = self._rows.pop(fid, None)
                if row is not None:
                    self._ids_version += 1
                    self._ingest_ms.pop(fid, None)
                    if not self._replaying:
                        self.index.remove(fid)
                    self._notify("removed", fid, row)
                    removed.append(row)
                    removed_ids.append(fid)
                    n += 1
            if removed:
                self._bump_gen(removed)
            if removed_ids and after_remove is not None:
                after_remove(removed_ids)
            return n

    def evict(self, pairs: Sequence[tuple]) -> int:
        """Remove snapshotted ``(id, row)`` pairs whose resident entry is
        STILL the snapshotted object (identity check — rows are adopted
        and replaced wholesale, never mutated in place). The flush uses
        this instead of ``delete``: a concurrent upsert that replaced a
        row AFTER the flush snapshot keeps its newer, not-yet-persisted
        version resident — a plain delete-by-id would silently drop a
        write the flush never saw. Evicts in lock-hold chunks like
        ``upsert`` (readers interleave between chunks).

        Full-drain fast path: when the snapshot covers the ENTIRE
        resident state, nothing raced it, and no listeners watch, the
        grid index and bookkeeping reset wholesale instead of removing
        hundreds of thousands of entries one by one — a real fraction
        of the fold pause at production overlay depths."""
        with self._lock:
            if (
                not self.listeners
                and len(pairs) == len(self._rows)
                and all(self._rows.get(f) is r for f, r in pairs)
            ):
                removed = [r for _, r in pairs]
                self._rows = {}
                self._ingest_ms = {}
                self.index = BucketIndex(self.index.nx, self.index.ny)
                self._ids_version += 1
                if removed:
                    self._bump_gen(removed)
                return len(removed)
        n = 0
        for s in range(0, len(pairs), self._LOCK_CHUNK):
            n += self._evict_chunk(pairs[s : s + self._LOCK_CHUNK])
        return n

    def _evict_chunk(self, pairs) -> int:
        with self._lock:
            n = 0
            removed = []
            for fid, row in pairs:
                fid = str(fid)
                if self._rows.get(fid) is not row:
                    continue
                self._rows.pop(fid)
                self._ids_version += 1
                self._ingest_ms.pop(fid, None)
                if not self._replaying:
                    self.index.remove(fid)
                self._notify("removed", fid, row)
                removed.append(row)
                n += 1
            if removed:
                self._bump_gen(removed)
            return n

    def clear(self) -> None:
        with self._lock:
            for fid in list(self._rows):
                self.delete([fid])

    def expire(self, now_ms: Optional[int] = None,
               on_swept: Optional[Callable] = None) -> int:
        """Sweep features older than expiry_ms; returns count expired.
        ``on_swept(stale_ids)`` runs under the lock AFTER the removals —
        the WAL hook: the sweep is wall-clock-driven (not replayable),
        so the exact swept ids hit the log, atomically with their
        application (an upsert serialized after the sweep can never be
        outrun by the sweep's record on replay). A raising hook leaves
        the sweep applied — consistent either way on recovery, like
        :meth:`delete`'s hook. Same caveat as listeners: the hook must
        not block on another thread's cache access."""
        if self.expiry_ms is None:
            return 0
        now = int(_time.time() * 1000) if now_ms is None else now_ms
        cutoff = now - self.expiry_ms
        with self._lock:
            stale = [fid for fid, t in self._ingest_ms.items() if t <= cutoff]
            expired = []
            for fid in stale:
                row = self._rows.pop(fid)
                self._ids_version += 1
                self._ingest_ms.pop(fid)
                if not self._replaying:
                    self.index.remove(fid)
                self._notify("expired", fid, row, guard=True)
                expired.append(row)
            if expired:
                self._bump_gen(expired)
            if stale and on_swept is not None:
                on_swept(list(stale))
            return len(stale)

    # -- queries ---------------------------------------------------------
    def snapshot_rows(self) -> list[tuple[str, dict]]:
        """A consistent [(id, row dict)] snapshot of the live state — the
        stream flusher's input (row dicts are shared, not copied: the
        cache replaces rows wholesale on upsert, never mutates in place)."""
        with self._lock:
            return list(self._rows.items())

    def snapshot(self, ids: Sequence[str] | None = None) -> FeatureCollection:
        """Columnar snapshot of (a subset of) the live state."""
        with self._lock:
            if ids is None:
                ids = list(self._rows)
            rows = [self._rows[f] for f in ids]
            return FeatureCollection.from_rows(self.sft, rows, ids=list(ids))

    def query(self, f: "Filter | str" = INCLUDE) -> FeatureCollection:
        """Filter the live state (LocalQueryRunner: bucket-index spatial
        pre-prune when the filter has a bbox, then exact evaluation)."""
        return self.query_shadow(f)[0]

    def query_shadow(self, f: "Filter | str" = INCLUDE):
        """(query result, frozenset of ALL live ids), captured atomically
        under one lock hold. The hot/cold merge needs the pair to be
        consistent: reading the live-id set after the query races a
        concurrent flush eviction — the evicted rows would appear in the
        hot result AND survive the cold shadow mask, double-counting."""
        from geomesa_tpu_torch.filter import ecql
        from geomesa_tpu_torch.filter.extract import extract_geometries, geometry_bounds

        if isinstance(f, str):
            f = ecql.parse(f)
        with self._lock:
            if self._live_cache[0] != self._ids_version:
                self._live_cache = (self._ids_version, frozenset(self._rows))
            live = self._live_cache[1]
            ids: Sequence[str] | None = None
            if self.sft.geom_field and not isinstance(f, Include):
                geoms = extract_geometries(f, self.sft.geom_field)
                if geoms.disjoint:
                    return self.snapshot([]), live
                if geoms.values:
                    hit: set = set()
                    for b in geometry_bounds(geoms):
                        hit.update(self.index.query(b))
                    ids = sorted(hit)
            fc = self.snapshot(ids)
        if isinstance(f, Include) or len(fc) == 0:
            return fc, live
        return fc.mask(f.evaluate(fc.batch)), live
