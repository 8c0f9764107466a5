"""LambdaStore: the hot/cold hybrid store (reference LambdaDataStore).

The port's copy of geomesa_tpu/streaming/store.py. Writes land in the
transient hot tier (StreamingFeatureCache); ``flush()`` folds the hot state
into the persistent cold DataStore through the pipelined StreamFlusher (one
atomic publish per flush, cold tables merged incrementally on the cold
store's device); queries merge both tiers with hot-wins-by-id semantics,
exactly, under concurrent flushes. With a write-ahead log attached every
hot-tier mutation is logged before it is acknowledged, and
:meth:`LambdaStore.recover` replays the log over the last checkpoint.

Standing queries ride the write path: once ``standing()`` or
``subscribe()`` attaches the engine (on the cold store's device), every
acknowledged batch routes through its SubscriptionIndex
(streaming/standing.py). The network data plane (``serve(port=...)``)
belongs to a later tier of the port (ROADMAP A12b) and raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Mapping, Optional, Sequence

import numpy as np

from geomesa_tpu_torch import fault
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import INCLUDE
from geomesa_tpu_torch.streaming.cache import StreamingFeatureCache
from geomesa_tpu_torch.streaming.flush import StreamConfig, StreamFlusher
from geomesa_tpu_torch.streaming.wal import WalConfig, WalError, WriteAheadLog, unpack_upsert

log = logging.getLogger(__name__)

WAL_DIR = "_wal"  # default WAL location under a store root


class RecordApplier:
    """Incremental WAL-record applier: ONE implementation of the record
    semantics (upsert/delete/expire/watermark/subscription), shared by
    open-time recovery (:meth:`LambdaStore._replay`) and a follower's
    continuous replay (:class:`~geomesa_tpu_torch.streaming.replica.
    ReplicaStore`): the follower is "recovery that never stops", the same
    apply path.

    Stateful so records can arrive in chunks over time: contiguous upsert
    records coalesce into bulk hot-tier applies of up to
    ``geomesa.stream.wal.replay.batch.rows`` rows
    (``StreamingFeatureCache.replay_upsert``: one lock hold, one
    vectorised grid-index pass); the pending batch always drains before
    any non-upsert record applies, so ordering semantics match
    record-at-a-time application exactly. Callers that stop feeding
    records MUST call :meth:`drain` to flush the trailing upsert batch.

    Subscription records (``s``) register into ``store.standing()`` and
    an ``rm`` record unregisters; each live registration body is also
    retained in ``LambdaStore._sub_records``, so the next checkpoint
    re-logs it above its cover. A body that cannot register is skipped
    with a warning (it was never acknowledged)."""

    def __init__(self, store: "LambdaStore"):
        from geomesa_tpu_torch import conf

        self.store = store
        self.batch_rows = int(conf.STREAM_WAL_REPLAY_BATCH.get())
        self._geom_field = store.hot.sft.geom_field
        self._pend_rows: list = []
        self._pend_ids: list = []
        self._pend_xy: list = []
        self._pend_nid = 0

    def drain(self) -> None:
        """Apply the pending coalesced upsert batch (bulk one-lock
        apply + next-id bump). Idempotent when empty."""
        if not self._pend_ids:
            return
        xy = None
        if self._pend_xy and all(a is not None for a in self._pend_xy):
            xy = (
                self._pend_xy[0] if len(self._pend_xy) == 1
                else np.concatenate(self._pend_xy)
            )
        self.store.hot.replay_upsert(self._pend_rows, self._pend_ids, xy=xy)
        self.store.hot.bump_next_id(self._pend_nid)
        self._pend_rows, self._pend_ids = [], []
        self._pend_xy, self._pend_nid = [], 0

    def apply(self, rec: Mapping) -> None:
        """Apply one WAL record to the store (coalescing upserts —
        see :meth:`drain`). Unknown kinds are ignored, matching
        ``WriteAheadLog.replay``'s forward-compatibility contract."""
        store = self.store
        kind = rec.get("k")
        if kind == "u":
            if self.batch_rows <= 0:  # record-at-a-time
                store.hot.upsert(unpack_upsert(rec), rec["ids"])
                store.hot.bump_next_id(rec.get("nid", 0))
                return
            from geomesa_tpu_torch.streaming.wal import unpack_upsert_xy

            rows, xy = unpack_upsert_xy(rec, self._geom_field)
            self._pend_rows.extend(rows)
            self._pend_ids.extend(rec["ids"])
            self._pend_xy.append(xy)
            self._pend_nid = max(self._pend_nid, int(rec.get("nid", 0)))
            if len(self._pend_ids) >= self.batch_rows:
                self.drain()
            return
        self.drain()
        if kind in ("d", "x"):  # delete/expiry sweep: same effect
            store.hot.delete(rec["ids"])
        elif kind == "w":
            pairs = store.hot.snapshot_pairs(rec["ids"])
            if pairs:
                store.flusher.flush(
                    pairs, incremental=bool(rec.get("inc", True))
                )
                store._known_cold.update(fid for fid, _ in pairs)
                store.hot.evict(pairs)
        elif kind == "s":
            rm = rec.get("rm")
            if rm is not None:
                with store._sub_lock:
                    store._sub_records.pop(str(rm), None)
                if store._standing is not None:
                    store._standing.unregister(str(rm))
                return
            from geomesa_tpu_torch.streaming.standing import Subscription

            try:
                store.standing().register(Subscription.from_record(rec["sub"]))
            except (ValueError, TypeError, KeyError):
                # a body that cannot register was never acknowledged
                # (subscribe() validates before logging; an old or
                # hand-written WAL may still carry one): skipping loses
                # nothing, while raising would poison every recovery
                log.warning(
                    "skipping unregistrable WAL subscription record %r",
                    rec.get("sub", {}).get("id"), exc_info=True,
                )
                return
            with store._sub_lock:
                store._sub_records[str(rec["sub"]["id"])] = rec["sub"]


class LambdaStore:
    """Hot/cold hybrid: transient streaming cache + persistent DataStore
    (reference LambdaDataStore). Writes land hot; ``flush()`` (alias
    ``persist_hot()``) folds the hot tier into the cold store; queries
    merge both tiers with hot-wins-by-id semantics.

    - flushes route through a persistent pipelined
      :class:`~geomesa_tpu_torch.streaming.flush.StreamFlusher` into
      :meth:`~geomesa_tpu_torch.datastore.DataStore.fold_upsert`, an
      incremental merge bit-identical to a full recompaction, with cache
      invalidation scoped to the touched key ranges;
    - reads are EXACT under concurrent flushes: the hot result and the
      live-id shadow set capture atomically, cold rows shadowed by any
      live hot id drop, and the final merge dedups by feature id (hot
      wins), so a row mid-flush (in both tiers between the cold commit and
      the hot eviction, the ``streaming.evict`` fault point) is returned
      once;
    - with a serving tier attached (``cold.serve()`` / :meth:`serve`) the
      cold half of every query is admitted through the QueryScheduler, so
      concurrent readers fuse into shared launches while ingest runs.
    """

    def __init__(self, cold, type_name: str, expiry_ms: Optional[int] = None,
                 config: "StreamConfig | None" = None,
                 wal: "WriteAheadLog | None" = None,
                 wal_dir: "str | None" = None,
                 wal_config: "WalConfig | None" = None):
        self.cold = cold
        self.type_name = type_name
        self.config = config if config is not None else StreamConfig.from_properties()
        # durability: with a WAL attached, every hot-tier mutation is
        # logged BEFORE it is acknowledged; recover(root) replays the log
        # over the last checkpointed cold store. Without one the hot tier
        # is process memory, durable only from the last checkpoint
        if wal is None and wal_dir is not None:
            wal = WriteAheadLog(wal_dir, config=wal_config, metrics=getattr(cold, "metrics", None))
            if wal.needs_recovery:
                # continuing over unreplayed records would let the next
                # checkpoint cover and RETIRE them without their effects
                # ever reaching a store
                wal.close()  # release the fd and the interval sync thread
                raise WalError(
                    f"WAL at {wal_dir!r} holds records past its last "
                    "checkpoint — open this store with "
                    "LambdaStore.recover(root) so they replay (or pass "
                    "an explicitly replayed WriteAheadLog via wal=)"
                )
        self.wal = wal
        self.hot = StreamingFeatureCache(
            cold.get_schema(type_name), expiry_ms, metrics=getattr(cold, "metrics", None),
        )
        self.flusher = StreamFlusher(
            cold, type_name, config=self.config, metrics=getattr(cold, "metrics", None),
        )
        # ids known to exist in the cold store (flushed before, or probed
        # by an earlier flush): the split probe runs only over ids NOT in
        # this set, so a long-lived overlay of pending updates is never
        # re-probed against the cold id index every flush. A stale entry
        # (an id a direct cold delete removed) only downgrades that id's
        # fold to an append inside fold_upsert
        self._known_cold: set = set()
        # standing-query engine: attached lazily by standing()/subscribe();
        # write() feeds it every acknowledged batch. _sub_records retains
        # WAL-logged registration bodies so checkpoint() can re-log the
        # live set above its cover (segment retirement must never drop an
        # acknowledged registration). _sub_lock serializes
        # subscribe/unsubscribe against that re-log: without it, a
        # checkpoint could snapshot a subscription, lose the race to an
        # acknowledged unsubscribe's rm record, and re-log the
        # registration ABOVE it (recovery would resurrect an acknowledged
        # removal)
        from geomesa_tpu_torch.lockwitness import witness

        self._sub_lock = witness(threading.Lock(), "LambdaStore._sub_lock")
        self._sub_records: dict[str, dict] = {}  # guarded-by: _sub_lock
        self._standing = None
        # a cache-enabled cold store: hot-tier upsert/delete/expiry bump
        # the shared generations, so merged answers over a mutated hot
        # tier never compose against stale cold cache entries
        cache = getattr(cold, "cache", None)
        if cache is not None:
            self.hot.generations = cache.generations
            self.hot.gen_type = type_name

    # -- writes ----------------------------------------------------------
    def write(self, rows: Sequence[Mapping], ids: Sequence[str] | None = None) -> int:
        """Apply a batch to the hot tier. With a WAL attached the batch is
        logged (ids resolved, auto-ids consumed) and made durable to the
        sync policy's guarantee BEFORE it applies: the return is the
        acknowledgment, so under ``sync=always`` an acknowledged batch
        survives ``kill -9``. When tracing is armed the acknowledged write
        is one trace (WAL append and fsync spans under it)."""
        from geomesa_tpu_torch.obs.trace import tracer

        eng = self._standing
        t0 = time.perf_counter() if eng is not None else None
        with tracer().trace("write", type=self.type_name, rows=len(rows)):
            if self.wal is not None or eng is not None:
                # the standing matcher needs the batch's RESOLVED ids for
                # its alerts, as the WAL needs them for replay: one
                # resolution, shared
                ids, next_id = self.hot.assign_ids(rows, ids)
            if self.wal is not None:
                seq = self.wal.log_upsert(ids, rows, next_id)
                try:
                    n = self.hot.upsert(rows, ids)
                finally:
                    # logged -> applied: the checkpoint cover (applied
                    # horizon) may now pass this record
                    self.wal.applied(seq)
            else:
                n = self.hot.upsert(rows, ids)
            self._gauge_hot()
            if eng is not None:
                # AFTER the ack path: a matcher fault never
                # un-acknowledges the applied batch (on_batch never
                # raises; alerts are at-most-once)
                eng.on_batch(ids, rows, t0)
            return n

    def delete(self, ids: Sequence[str]) -> int:
        """Remove live hot rows by id (the Kafka cache's delete messages).
        Cold-resident copies of the ids are untouched.

        Destructive ops log APPLY-THEN-RECORD, atomically under the hot
        lock (the inverse of :meth:`write`): a delete record on disk can
        never outrun a later acknowledged re-upsert on replay, and a record
        whose append failed describes a removal that really happened."""
        ids = [str(i) for i in ids]
        n = self.hot.delete(ids, after_remove=self._removed_hook)
        self._gauge_hot()
        return n

    def _removed_hook(self, removed: Sequence[str]) -> None:
        """Runs under the hot lock after a delete's removals: log to the
        WAL and drop the removed rows' pre-staged fold state."""
        if self.wal is not None:
            self.wal.log_delete(removed)
        self.flusher.unstage(removed)

    def _swept_hook(self, stale: Sequence[str]) -> None:
        """The expiry-sweep twin of :meth:`_removed_hook` (the WAL logs the
        exact swept ids: the sweep is wall-clock-driven)."""
        if self.wal is not None:
            self.wal.log_expire(stale)
        self.flusher.unstage(stale)

    def expire(self, now_ms: Optional[int] = None) -> int:
        """TTL sweep of the hot tier (requires ``expiry_ms``); the swept
        ids hit the WAL atomically with the sweep."""
        n = self.hot.expire(now_ms=now_ms, on_swept=self._swept_hook)
        self._gauge_hot()
        return n

    def _gauge_hot(self) -> None:
        metrics = getattr(self.cold, "metrics", None)
        if metrics is not None:
            metrics.gauge("geomesa.stream.hot_rows", len(self.hot))

    # -- standing queries ------------------------------------------------
    def standing(self, config=None):
        """The store's :class:`~geomesa_tpu_torch.streaming.standing.
        StandingQueryEngine` (created on first use, on the cold store's
        device): once attached, every acknowledged :meth:`write` batch
        routes through its inverted SubscriptionIndex, matches, and
        delivers alerts; see :meth:`subscribe`."""
        if self._standing is None:
            from geomesa_tpu_torch.streaming.standing import StandingQueryEngine

            # double-checked under _sub_lock: two concurrent first
            # subscribes must not build two engines (the loser's
            # acknowledged, WAL-logged registration would land in an
            # orphaned engine that write() never feeds)
            with self._sub_lock:
                if self._standing is None:
                    self._standing = StandingQueryEngine(
                        self.cold.get_schema(self.type_name), config,
                        metrics=getattr(self.cold, "metrics", None),
                        device=self.cold.device,
                    )
        return self._standing

    def subscribe(self, sub) -> None:
        """Register one standing subscription (a
        :class:`~geomesa_tpu_torch.streaming.standing.Subscription`). With
        a WAL attached the registration logs an ``s`` record BEFORE it is
        acknowledged: like :meth:`write`, the return is the durability
        guarantee (``recover`` rebuilds the SubscriptionIndex from the
        log)."""
        eng = self.standing()
        # validate BEFORE the record lands: a body that cannot register
        # must never reach the log (replay re-registers every 's' record,
        # so a poison body would abort all future recoveries)
        sub.validate()
        with self._sub_lock:
            if self.wal is not None:
                rec = sub.to_record()
                seq = self.wal.log_subscribe(rec)
                try:
                    eng.register(sub)
                    self._sub_records[sub.sub_id] = rec
                finally:
                    self.wal.applied(seq)
            else:
                eng.register(sub)

    def unsubscribe(self, sub_id: str) -> bool:
        """Remove a standing subscription (apply-then-record, like
        :meth:`delete`: a failed append describes a removal that really
        happened, so recovery can only resurrect an unacknowledged
        unsubscribe, never lose an acknowledged registration)."""
        if self._standing is None:
            return False
        with self._sub_lock:
            ok = self._standing.unregister(str(sub_id))
            if ok:
                self._sub_records.pop(str(sub_id), None)
                if self.wal is not None:
                    self.wal.log_unsubscribe(str(sub_id))
        return ok

    # -- flush -----------------------------------------------------------
    def flush(self, incremental: "bool | None" = None, full: bool = False) -> int:
        """Micro-batch persist: returns rows published to the cold store.

        LSM-shaped amortization: hot rows whose ids are NEW to the cold
        store flush every call through the O(batch) delta-tier append;
        rows that *update* persisted ids stay resident in the hot overlay
        (reads remain exact through the hot-wins-by-id merge) until the
        pending updates reach ``geomesa.stream.fold.rows`` (or
        ``full=True``), when ONE atomic fold publishes everything
        (``DataStore.fold_upsert``).

        The publish runs under bounded retry for transient IO faults
        (``streaming.persist``); hot copies are dropped only AFTER the
        cold publish commits (the ``streaming.evict`` fault point sits
        between the two): a failed flush leaves the cold tier intact and
        every hot row resident for the next attempt.

        With ``expiry_ms`` configured, every flush drains fully: an
        ``expire()`` sweep between flushes must never drop an update the
        overlay had not yet persisted.

        ``incremental=False`` (or ``geomesa.stream.incremental``) takes
        the legacy delete-and-rewrite ``cold.upsert`` flush of the WHOLE
        hot state instead."""
        snapshot = self.hot.snapshot_rows()
        if not snapshot:
            return 0
        if incremental is None:
            incremental = self.config.incremental
        if self.hot.expiry_ms is not None:
            full = True
        if not incremental:
            n = self.flusher.flush(snapshot, incremental=False)
            self._log_watermark(snapshot, incremental=False)
            fault.fault_point("streaming.evict")
            self.hot.evict(snapshot)
            self._gauge_hot()
            return n
        known = self._known_cold
        unknown = [fid for fid, _ in snapshot if fid not in known]
        if unknown:
            mask = self.cold.id_exists_mask(self.type_name, unknown)
            known.update(fid for fid, e in zip(unknown, mask) if e)
        exists = [fid in known for fid, _ in snapshot]
        n_upd = sum(exists)
        if full or n_upd >= max(int(self.config.fold_rows), 1):
            batch = snapshot  # fold everything: updates + appends, one publish
        elif n_upd:
            batch = [sn for sn, e in zip(snapshot, exists) if not e]
            if self.config.prestage:
                # pre-stage the deferred updates now: their parse/keys run
                # through the warm workers while they wait in the overlay
                self.flusher.stage([sn for sn, e in zip(snapshot, exists) if e])
        else:
            batch = snapshot
        if not batch:
            return 0
        n = self.flusher.flush(
            batch, incremental=True,
            pacer=self._fold_pacer, on_slice=self._fold_slice_published,
        )
        # no trailing watermark: fold_upsert called on_slice after every
        # atomic publish, so the WAL watermark covers exactly the
        # published ids, slice by slice
        fault.fault_point("streaming.evict")
        known.update(fid for fid, _ in batch)  # published: now cold-resident
        # identity-checked eviction: a write racing the publish keeps its
        # newer hot version resident for the next flush
        self.hot.evict(batch)
        self._gauge_hot()
        return n

    def _fold_slice_published(self, ids: Sequence[str]) -> None:
        """One atomic fold publish landed (a slice, or the whole batch):
        advance the WAL flush watermark over exactly those ids. Written
        AFTER the publish (a crash between publish and watermark recovers
        the rows HOT, never a loss)."""
        if self.wal is not None:
            self.wal.log_watermark(list(ids), True)

    def _fold_pacer(self) -> None:
        """Between-slice yield: with a serving tier attached, wait (bounded
        by ``geomesa.stream.fold.yield.ms``) for the QueryScheduler's
        admission queue to drain so live queries interleave with the fold;
        otherwise just yield the interpreter."""
        sched = getattr(self.cold, "scheduler", None)
        wait_s = max(float(self.config.fold_yield_ms), 0.0) / 1e3
        if sched is not None and not sched.closed and wait_s > 0:
            sched.admission_gap(wait_s)
        else:
            time.sleep(0)

    def _log_watermark(self, batch: Sequence[tuple], incremental: bool) -> None:
        """Flush watermark after a legacy publish, so replay re-folds
        exactly this batch. Watermarks do NOT retire segments; only a
        checkpoint (durable save) does."""
        if self.wal is not None:
            self.wal.log_watermark([fid for fid, _ in batch], incremental)

    def persist_hot(self, incremental: "bool | None" = None) -> int:
        """Full persist: drain the ENTIRE hot tier (pending updates fold
        regardless of ``geomesa.stream.fold.rows``); returns rows
        published."""
        return self.flush(incremental=incremental, full=True)

    def checkpoint(self, root: str) -> int:
        """Periodic persistence: flush the hot tier, then write the cold
        store to disk through the crash-safe v3 path (``persist.save``).
        A failure at any point leaves the previous on-disk store and the
        hot/cold state consistent. Returns rows flushed.

        With a WAL attached, the checkpoint watermark lands (force-synced)
        only AFTER ``persist.save`` commits, and sealed segments it covers
        retire; a crash inside the save leaves the watermark unwritten, so
        ``recover(root)`` replays the retained records over the previous
        on-disk store."""
        from geomesa_tpu_torch.storage import persist

        # the cover is captured BEFORE the drain, and only up to the
        # APPLIED horizon: a write racing the checkpoint keeps its record
        cover = self.wal.applied_horizon() if self.wal is not None else 0
        n = self.flush(full=True)
        persist.save(self.cold, root)
        if self.wal is not None:
            # re-log the live subscription set ABOVE the cover before the
            # watermark lands: the checkpoint retires the segments their
            # original records live in, and subscriptions (unlike rows)
            # are not part of the persisted cold store. Under _sub_lock so
            # an unsubscribe cannot land its rm record between our
            # snapshot and our re-logged registration
            with self._sub_lock:
                for rec in self._sub_records.values():
                    self.wal.append("s", {"sub": rec})
            self.wal.checkpoint(cover)
        return n

    # -- recovery ---------------------------------------------------------
    @classmethod
    def recover(cls, root: str, type_name: "str | None" = None,
                wal_dir: "str | None" = None,
                expiry_ms: Optional[int] = None,
                config: "StreamConfig | None" = None,
                wal_config: "WalConfig | None" = None,
                on_damage: str = "quarantine",
                on_progress=None,
                quarantine_root: "str | None" = None,
                **load_kwargs) -> "LambdaStore":
        """Open-time crash recovery: load the cold store from ``root``
        (``persist.load``, on the card unless ``device=`` says otherwise),
        open the WAL at ``wal_dir`` (default ``<root>/_wal``), and replay
        every record past the last checkpoint watermark — re-applying
        acknowledged mutations to the hot tier and re-folding flush
        watermarks into the cold tier — so the recovered store answers
        queries as the never-crashed store would. Torn WAL tails truncate;
        checksum-damaged tails quarantine under ``<root>/_quarantine/_wal/``
        and surface on ``cold.store_health``. The returned store continues
        logging to the same WAL, whose ``needs_recovery`` is cleared once
        the replay has applied every record.

        ``on_progress(seqno, segment, bytes)`` fires after each replayed
        segment; progress also lands on the
        ``geomesa.replica.replay.progress`` gauge."""
        from geomesa_tpu_torch.storage import persist

        cold = persist.load(root, on_damage=on_damage, **load_kwargs)
        if type_name is None:
            names = cold.type_names()
            if len(names) != 1:
                raise ValueError(
                    f"recover() needs type_name for a multi-type store "
                    f"(found {sorted(names)!r})"
                )
            type_name = names[0]
        if wal_dir is None:
            wal_dir = os.path.join(str(root), WAL_DIR)
        wal = WriteAheadLog(
            wal_dir, config=wal_config, metrics=getattr(cold, "metrics", None),
            quarantine_root=str(root) if quarantine_root is None else str(quarantine_root),
        )
        store = cls(cold, type_name, expiry_ms=expiry_ms, config=config, wal=wal)
        store._replay(on_progress=on_progress)
        # every record past the cover is applied now: the log no longer
        # needs a recovery (the JAX package leaves the flag set after its
        # replay, so its /health calls a recovered store unhealthy)
        wal.needs_recovery = False
        if wal.damage:
            # WAL damage joins the store's health surface (type "_wal")
            cold.health.damage.extend(wal.damage)
        return store

    def _replay(self, on_progress=None) -> None:
        """Apply the WAL's post-checkpoint records in order through the
        shared :class:`RecordApplier`: upserts/deletes/expiry sweeps
        rebuild the hot tier; flush watermarks re-publish exactly the
        batch the live store published (through the same flusher and
        fold), so hot/cold placement matches the never-crashed store.
        The whole replay runs in the hot tier's replay mode: grid-index
        churn for rows a later watermark evicts again is skipped, and the
        index rebuilds once from the survivors."""
        applier = RecordApplier(self)
        metrics = getattr(self.cold, "metrics", None)

        def progress(seq: int, segment: str, read: int) -> None:
            if metrics is not None:
                metrics.gauge("geomesa.replica.replay.progress", seq)
            if on_progress is not None:
                on_progress(seq, segment, read)

        self.hot.begin_replay()
        try:
            for rec in self.wal.replay(on_progress=progress):
                applier.apply(rec)
            applier.drain()
        finally:
            # rebuild even after a partial replay: the index must reflect
            # the applied prefix
            self.hot.end_replay()
        self._gauge_hot()

    # -- serving ---------------------------------------------------------
    def serve(self, config=None, port: "int | None" = None,
              host: "str | None" = None, **server_kwargs):
        """Attach (or return) the cold store's serving tier: with a
        scheduler attached, the cold half of every :meth:`query` is
        admitted through it. Returns the scheduler. ``port`` (the network
        data plane) is not ported yet (ROADMAP A12b) and raises."""
        if port is not None:
            raise NotImplementedError(
                "serve(port=...) mounts the network data plane, which is not "
                "ported yet (ROADMAP A12b)"
            )
        return self.cold.serve(config)

    def serve_ops(self, port: int = 0, host: "str | None" = None):
        """Attach (or return) the ops plane on the cold store with THIS
        store's streaming surfaces joined in: ``/health`` then also
        watches the hot tier's occupancy against the fold threshold and
        the WAL's recovery state. Returns the OpsServer."""
        return self.cold.serve_ops(port=port, host=host, lam=self)

    def _cold_query(self, f, hints=None, tenant=None, block: bool = True) -> FeatureCollection:
        sched = getattr(self.cold, "scheduler", None)
        if sched is not None and not sched.closed:
            return sched.submit(
                self.type_name, f, hints=hints, block=block, tenant=tenant
            ).result()
        return self.cold.query(self.type_name, f, hints=hints)

    # -- reads -----------------------------------------------------------
    def query(self, f=INCLUDE, hints=None, tenant=None, block: bool = True) -> FeatureCollection:
        """Exact hot+cold merge. The hot result and live-id shadow
        snapshot come FIRST (atomically), the cold scan after: a row
        evicted from hot before the snapshot is already committed cold,
        and a row still hot shadows its (possibly stale) cold copy. The
        final id dedup (hot first) catches the both-tiers window
        mid-flush."""
        from geomesa_tpu_torch.filter import ecql

        if isinstance(f, str):
            f = ecql.parse(f)
        hot, live = self.hot.query_shadow(f)
        cold = self._cold_query(f, hints=hints, tenant=tenant, block=block)
        # shadow cold rows by EVERY live hot id, not just the hot hits: a
        # hot update that moved a feature out of the window must hide the
        # stale persisted row too. Set probes over the (small) cold result
        if live and len(cold):
            ids = np.asarray(cold.ids).tolist()
            keep = np.fromiter((str(i) not in live for i in ids), bool, count=len(ids))
            if not keep.all():
                cold = cold.mask(keep)
        if len(hot) == 0:
            return cold
        if len(cold) == 0:
            return hot
        out = FeatureCollection.concat([hot, cold])
        # dedup by feature id, first occurrence (= hot) wins
        ids = np.asarray(out.ids).astype(str)
        _, first = np.unique(ids, return_index=True)
        if len(first) != len(out):
            out = out.take(np.sort(first))
        return out

    def count(self, f=INCLUDE) -> int:
        return len(self.query(f))

    def close(self) -> None:
        """Release the flusher's worker pool and the WAL (its interval
        sync thread included). Idempotent. The cold store's own services
        (scheduler, ops plane) close with ``cold.close()``."""
        self.flusher.close()
        if self.wal is not None:
            self.wal.close()
