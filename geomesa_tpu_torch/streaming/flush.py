"""StreamFlusher: the persistent pipelined hot->cold flush engine.

The port's copy of geomesa_tpu/streaming/flush.py. The engine holds its
worker pool WARM across flushes (a sustained stream flushes every few
hundred ms). Stages:

1. **parse** — the hot snapshot's row dicts become columnar
   FeatureCollections in fixed-size micro-chunks
   (``geomesa.stream.chunk.rows``), in pool workers;
2. **keys**  — ``DataStore._encode_batch`` per chunk (every index's write
   keys and the stats sketch);
3. **sort**  — each chunk's (bin, z) keys shard-radix-sort
   (``ingest.sort.shard_runs``); at the commit the runs k-way merge into
   the flush batch's stable argsort, handed to the fold so it never
   re-sorts the batch;
4. **commit** — ONE atomic publish: ``DataStore.fold_upsert`` folds the
   batch into the cold tables (on the cold store's device: with a CUDA
   store the fold's table build runs there), under ``fault.with_retries``
   at the ``streaming.persist`` fault point.

A bounded admission window (``geomesa.stream.queue.depth`` chunks)
backpressures staging; overflow waits count ``geomesa.stream.queue_full``.
Every stage records wall time into the ``geomesa.stream.*`` histograms.

Failure semantics: any stage failure — including injected faults
(``stream.flush.parse`` / ``stream.flush.keys`` / ``stream.flush.sort`` /
``stream.fold.stage`` / ``streaming.persist``) — aborts the flush BEFORE
the publish, so the cold store is untouched and every hot row stays
resident for the next attempt. Transient IO errors at the commit point
retry with bounded backoff.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from geomesa_tpu_torch import fault
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.ingest import sort as shsort
from geomesa_tpu_torch.obs.trace import span as _ospan
from geomesa_tpu_torch.obs.trace import tracer as _otracer

STAGES = ("parse", "keys", "sort", "commit")


@dataclass
class StreamConfig:
    """Streaming-tier knobs; ``from_properties`` resolves each from the
    typed property tier (geomesa_tpu_torch.conf)."""

    workers: int = 0        # 0 = one per host core
    chunk_rows: int = 65536  # rows per flush micro-chunk
    queue_depth: int = 4    # chunks staged ahead of the commit stage
    fold_rows: int = 131_072  # pending updates that trigger the fold
    incremental: bool = True  # fold flushes (False = legacy upsert flush)
    # fold-pause knobs
    slice_rows: int = 65_536   # fold slice size (0 = monolithic)
    fold_yield_ms: float = 15.0  # between-slice scheduler-drain cap
    prestage: bool = True      # parse/key deferred updates at flush time

    @staticmethod
    def from_properties() -> "StreamConfig":
        from geomesa_tpu_torch import conf

        return StreamConfig(
            workers=conf.STREAM_WORKERS.get(),
            chunk_rows=conf.STREAM_CHUNK_ROWS.get(),
            queue_depth=conf.STREAM_QUEUE_DEPTH.get(),
            fold_rows=conf.STREAM_FOLD_ROWS.get(),
            incremental=conf.STREAM_INCREMENTAL.get(),
            slice_rows=conf.STREAM_FOLD_SLICE_ROWS.get(),
            fold_yield_ms=conf.STREAM_FOLD_YIELD_MS.get(),
            prestage=conf.STREAM_FOLD_PRESTAGE.get(),
        )

    def resolved_workers(self) -> int:
        import os

        if self.workers and self.workers > 0:
            return int(self.workers)
        return max(1, os.cpu_count() or 1)


class _FlushChunk:
    __slots__ = ("base", "rows", "ids", "fc", "keys", "stats", "runs",
                 "src_rows")

    def __init__(self, base: int, rows: list, ids: list):
        self.base = base  # global row offset within the flush batch
        self.rows = rows
        self.ids = ids
        self.fc: "FeatureCollection | None" = None
        self.keys: dict = {}
        self.stats = None
        self.runs: dict = {}  # index name -> list[SortRun]
        # pre-staged chunks retain their source row-dict REFERENCES (no
        # copies — the hot tier owns the dicts) so the fold can identity-
        # check each staged row against the live hot state: a row
        # re-updated after staging re-stages, never folds stale
        self.src_rows: "list | None" = None


class StreamFlusher:
    """Persistent flush engine for ONE (cold store, feature type): the
    worker pool and stage accounting live across flushes; each
    :meth:`flush` call is one atomic hot->cold publish. ``close()``
    releases the pool (idempotent; a closed flusher rebuilds it on the
    next flush, so a long-lived LambdaStore never wedges)."""

    def __init__(self, store, type_name: str,
                 config: "StreamConfig | None" = None, metrics=None):
        from geomesa_tpu_torch.metrics import resolve

        self.store = store
        self.type_name = type_name
        self.config = config if config is not None else StreamConfig.from_properties()
        self.metrics = resolve(
            metrics if metrics is not None else getattr(store, "metrics", None)
        )
        from geomesa_tpu_torch.lockwitness import witness

        self._pool_lock = witness(
            threading.Lock(), "StreamFlusher._pool_lock"
        )
        self._pool: "ThreadPoolExecutor | None" = None  # guarded-by: _pool_lock
        self._sem = threading.Semaphore(max(1, self.config.queue_depth))
        self.flushes = 0  # total successful flushes (bench/introspection)
        # pre-staged update chunks:
        # parse/keys run at micro-flush time, consumed by the next fold
        self._stage_lock = witness(
            threading.Lock(), "StreamFlusher._stage_lock"
        )
        self._staged: list = []        # guarded-by: _stage_lock
        self._staged_rows: dict = {}   # guarded-by: _stage_lock

    # -- pool lifecycle ---------------------------------------------------
    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=max(2, self.config.resolved_workers()),
                    thread_name_prefix="geomesa-stream",
                )
            return self._pool

    def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # -- stages -----------------------------------------------------------
    def _stage_time(self, stage: str, seconds: float) -> None:
        # live histograms, not mean-only timers:
        # per-stage p99s read straight off the registry
        self.metrics.observe(f"geomesa.stream.{stage}", seconds)

    def _run_chunk(
        self, ch: _FlushChunk, incremental: bool = True,
        retain: bool = False, sort: bool = True, tspan=None,
    ) -> None:
        """parse -> keys -> sort for one micro-chunk (one pool task:
        chunks overlap across workers; stages attribute separately).
        Non-incremental flushes parse only: the legacy ``cold.upsert``
        commit re-encodes keys itself, so encoding+sorting here would be
        discarded work that also taxes the bench baseline unfairly.
        ``retain`` keeps the source row references + ids for the
        pre-stage identity check; ``sort=False`` defers the shard sort
        (a pre-staged chunk's batch offset is unknown until the fold
        assigns final chunk order — :meth:`_sort_chunk` runs then).
        ``tspan``: the submitting flush's active span, re-activated in
        this pool thread so the chunk's stage spans join its trace."""
        with _otracer().activate(tspan):
            sft = self.store.get_schema(self.type_name)
            fault.fault_point("stream.flush.parse")
            t0 = time.perf_counter()
            with _ospan("flush.parse", rows=len(ch.ids or ())):
                ch.fc = FeatureCollection.from_rows(sft, ch.rows, ids=ch.ids)
            if retain:
                ch.src_rows, ch.rows = ch.rows, None
            else:
                ch.rows = ch.ids = None  # staged scratch: release as consumed
            t1 = time.perf_counter()
            self._stage_time("parse", t1 - t0)
            if not incremental:
                return
            fault.fault_point("stream.flush.keys")
            with _ospan("flush.keys"):
                _, ch.keys, ch.stats = self.store._encode_batch(
                    self.type_name, ch.fc
                )
            t2 = time.perf_counter()
            self._stage_time("keys", t2 - t1)
            if sort:
                self._sort_chunk(ch)

    def _sort_chunk(self, ch: _FlushChunk, tspan=None) -> None:
        """Shard-radix-sort one chunk's (bin, z) keys at its assigned
        batch offset (the 'sort' stage; split out so pre-staged chunks
        can sort once their final base is known)."""
        with _otracer().activate(tspan):
            fault.fault_point("stream.flush.sort")
            t0 = time.perf_counter()
            with _ospan("flush.sort"):
                for name, k in ch.keys.items():
                    if len(k.zs) and k.sub is None:
                        ch.runs[name] = shsort.shard_runs(
                            k.bins, k.zs, ch.base,
                            max(self.config.chunk_rows, 1),
                        )
            self._stage_time("sort", time.perf_counter() - t0)

    # -- pre-staging (parse/keys leave the fold window) -------------------
    def stage(self, pairs: Sequence[tuple]) -> int:
        """Stage deferred update rows NOW, at micro-flush time: parse +
        key-encode them through the warm pool so the eventual fold pays
        only sort+merge+publish. Rows already staged under the same row
        object are skipped; a row re-updated later is re-staged by the
        next call (latest object wins at fold via the identity check).
        Returns rows submitted for staging."""
        if not pairs:
            return 0
        fault.fault_point("stream.fold.stage")
        pool = self._ensure_pool()
        chunk_rows = max(int(self.config.chunk_rows), 1)
        with self._stage_lock:
            fresh = [
                (str(fid), row) for fid, row in pairs
                if self._staged_rows.get(str(fid)) is not row
            ]
            if not fresh:
                return 0
            for fid, row in fresh:
                self._staged_rows[fid] = row
            for s in range(0, len(fresh), chunk_rows):
                part = fresh[s : s + chunk_rows]
                ch = _FlushChunk(
                    0, [r for _, r in part], [fid for fid, _ in part]
                )
                fut = pool.submit(
                    self._run_chunk, ch, True, retain=True, sort=False
                )
                self._staged.append((ch, fut))
        self.metrics.counter("geomesa.stream.fold.prestaged", len(fresh))
        return len(fresh)

    def _discard_staged(self) -> None:
        with self._stage_lock:
            self._staged, self._staged_rows = [], {}

    def unstage(self, ids: Sequence[str]) -> int:
        """Drop staged state for rows REMOVED from the hot tier
        (delete / expiry sweep): a removed row never appears in another
        flush snapshot, so its staged chunk would otherwise be retained
        forever (an unbounded leak under update-then-delete workloads).
        Chunks left with no staged-live row drop whole; a chunk that
        still carries live staged rows stays (its dead rows mask out at
        the fold's identity check). Returns chunks dropped."""
        dead = {str(i) for i in ids}
        if not dead:
            return 0
        with self._stage_lock:
            if not self._staged and not self._staged_rows:
                return 0
            for fid in dead:
                self._staged_rows.pop(fid, None)
            kept = [
                e for e in self._staged
                if any(fid in self._staged_rows for fid in e[0].ids)
            ]
            dropped = len(self._staged) - len(kept)
            self._staged = kept
        return dropped

    def _take_staged(self, snapshot: Sequence[tuple]):
        """Consume the pre-staged chunks whose rows this batch is about
        to publish: await their parse/keys futures, identity-check every
        staged row against the CURRENT batch (a re-updated or deleted
        row never folds stale; the newest staging of an id wins), and
        return ``(usable chunks, leftover (id, row) pairs)`` — leftovers
        stage freshly in the fold window. Chunks whose rows are NOT in
        this batch stay staged untouched — an appends-only micro-flush
        must not burn the overlay's staging (the batch and the staged
        rows are disjoint there). A staged chunk that failed (injected
        fault, bad row) is dropped whole — its rows revert to fresh
        staging — and the first failure aborts this flush attempt like
        any stage fault (cold store untouched; the retry re-stages)."""
        with self._stage_lock:
            staged = list(self._staged)
        if not staged:
            return [], list(snapshot)
        current = {str(fid): row for fid, row in snapshot}
        error: "BaseException | None" = None
        retained: list = []   # (ch, fut), oldest-first after reverse
        consumed: list = []
        claimed: set = set()
        # fid -> the ROW OBJECT whose staging this fold spent: the
        # bookkeeping pop below is identity-conditional, so a concurrent
        # stage() that re-registered the id with a NEWER row keeps its
        # entry (popping it would double-stage the row later)
        spent: dict = {}
        for ch, fut in reversed(staged):  # newest staging of an id wins
            if not any(fid in current for fid in ch.ids):
                retained.append((ch, fut))
                continue
            try:
                fut.result()
            except BaseException as e:
                if error is None:
                    error = e
                rows_src = ch.src_rows if ch.src_rows is not None else ch.rows
                if rows_src is not None:
                    spent.update(zip(ch.ids, rows_src))
                continue
            spent.update(zip(ch.ids, ch.src_rows))
            keep = np.fromiter(
                (
                    fid not in claimed and current.get(fid) is row
                    for fid, row in zip(ch.ids, ch.src_rows)
                ),
                bool, count=len(ch.ids),
            )
            if not keep.any():
                continue
            claimed.update(
                fid for fid, k in zip(ch.ids, keep.tolist()) if k
            )
            if not keep.all():
                # partially stale (or straddling the batch): mask the
                # columnar rows and re-encode keys/stats for the kept
                # subset (the expensive parse is already done; only
                # re-updated rows pay again, freshly)
                ch.fc = ch.fc.mask(keep)
                ch.ids = [
                    fid for fid, k in zip(ch.ids, keep.tolist()) if k
                ]
                _, ch.keys, ch.stats = self.store._encode_batch(
                    self.type_name, ch.fc
                )
            ch.src_rows = None
            consumed.append(ch)
        retained.reverse()
        consumed.reverse()
        with self._stage_lock:
            still = {id(e[0]) for e in self._staged}
            tapped = {id(e[0]) for e in staged}
            # write back: a retained chunk survives only if it is STILL
            # registered — a concurrent unstage() (hot-tier delete/expire
            # during our future wait) must stay dropped, not resurrect —
            # alongside anything staged since our snapshot
            self._staged = [
                e for e in retained if id(e[0]) in still
            ] + [e for e in self._staged if id(e[0]) not in tapped]
            for fid, row in spent.items():
                if self._staged_rows.get(fid) is row:
                    del self._staged_rows[fid]
        if error is not None:
            raise error
        rest = [
            (fid, row) for fid, row in snapshot if str(fid) not in claimed
        ]
        return consumed, rest

    # -- the flush --------------------------------------------------------
    def flush(
        self, snapshot: Sequence[tuple], incremental: "bool | None" = None,
        pacer=None, on_slice=None,
    ) -> int:
        """Fold one hot snapshot (``[(id, row dict)]``) into the cold
        store: consume any pre-staged update chunks (their parse/keys ran
        at micro-flush time), stage the rest through the warm
        parse/keys/sort workers under the bounded admission window, then
        publish — atomically per fold slice (``pacer``/``on_slice``
        thread through to :meth:`DataStore.fold_upsert`'s sliced fold).
        Returns rows flushed. ``incremental=False`` (or the
        ``geomesa.stream.incremental`` knob) routes the commit through
        the legacy ``cold.upsert`` delete-and-rewrite instead — the
        bench baseline and the escape hatch for adapters without the
        fold seam."""
        n = len(snapshot)
        if n == 0:
            return 0
        if incremental is None:
            incremental = self.config.incremental
        # one trace per flush (sampling decides retention): stage spans
        # from the pool workers re-attach via the captured parent span
        with _otracer().trace(
            "flush", type=self.type_name, rows=n
        ) as trace:
            tspan = trace.root if trace is not None else None
            pool = self._ensure_pool()
            chunk_rows = max(int(self.config.chunk_rows), 1)
            if incremental and self.config.prestage:
                chunks, rest = self._take_staged(snapshot)
            else:
                if not incremental:
                    # the legacy path re-publishes the whole hot state; any
                    # staged scratch is superseded by this full drain
                    self._discard_staged()
                chunks, rest = [], list(snapshot)
            base = 0
            for ch in chunks:  # final batch order: staged first, then fresh
                ch.base = base
                base += len(ch.fc)
            futures = []
            error: "BaseException | None" = None
            try:
                if incremental:
                    for ch in chunks:
                        # pre-staged chunks deferred their shard sort until
                        # this flush assigned their batch offsets
                        futures.append(
                            pool.submit(self._sort_chunk, ch, tspan=tspan)
                        )
                for s in range(0, len(rest), chunk_rows):
                    part = rest[s : s + chunk_rows]
                    if not self._sem.acquire(blocking=False):
                        # bounded admission window: backpressures staging so
                        # at most queue_depth chunks sit in the pool at once
                        # (see the module docstring for what is and is NOT
                        # bounded)
                        self.metrics.counter("geomesa.stream.queue_full")
                        self._sem.acquire()
                    ch = _FlushChunk(
                        base + s, [r for _, r in part], [fid for fid, _ in part]
                    )
                    chunks.append(ch)
                    try:
                        fut = pool.submit(
                            self._run_chunk, ch, incremental, tspan=tspan
                        )
                    except BaseException:
                        # submit failed (e.g. close() raced the flush and
                        # shut the pool): the permit has no completion
                        # callback to release it — leaking it here would
                        # wedge every future flush once the window drains
                        # to zero
                        self._sem.release()
                        raise
                    fut.add_done_callback(lambda _f: self._sem.release())
                    futures.append(fut)
            except BaseException as e:
                error = e
            for fut in futures:
                try:
                    fut.result()
                except BaseException as e:  # first stage failure wins
                    if error is None:
                        error = e
            if error is not None:
                raise error

            t0 = time.perf_counter()
            with _ospan("flush.commit", chunks=len(chunks)):
                out = self._commit(chunks, incremental, pacer, on_slice)
            self._stage_time("commit", time.perf_counter() - t0)
            self.flushes += 1
            self.metrics.counter("geomesa.stream.flushes")
            self.metrics.counter("geomesa.stream.rows", out)
            return out

    def _commit(
        self, chunks: list, incremental: bool, pacer=None, on_slice=None
    ) -> int:
        """The publish: concat the staged chunks, k-way-merge the sorted
        runs into per-index batch argsorts, and fold (or legacy-upsert)
        under bounded retry at the ``streaming.persist`` point. Fold
        publishes land per slice;
        the retry re-folds the whole batch, which is idempotent over any
        already-published slice prefix."""
        from geomesa_tpu_torch.storage.delta import concat_keys

        fcs = [ch.fc for ch in chunks]
        fc = fcs[0] if len(fcs) == 1 else FeatureCollection.concat(fcs)
        if not incremental:
            def attempt_legacy():
                fault.fault_point("streaming.persist")
                return self.store.upsert(self.type_name, fc)

            return fault.with_retries(attempt_legacy, metrics=self.metrics)

        keys: dict = {}
        presorted: dict = {}
        stats = None
        for ch in chunks:
            stats = ch.stats if stats is None else stats.merge(ch.stats)
        pool = self._ensure_pool()
        from geomesa_tpu_torch import conf

        for name in chunks[0].keys:
            runs = [r for ch in chunks for r in ch.runs.get(name, [])]
            keys[name] = concat_keys(
                [ch.keys[name] for ch in chunks], consume=True
            )
            if not runs:
                continue
            bins = shsort.distinct_bins(runs)
            if len(bins) < conf.INGEST_MERGE_MIN_BINS.get():
                continue  # few bins: let the fold's LSD sort run
            perm = shsort.merge_runs(runs, pool=pool, bins=bins)
            if len(perm) == len(keys[name].zs):
                presorted[name] = perm
        for ch in chunks:
            ch.runs.clear()

        def attempt():
            fault.fault_point("streaming.persist")
            return self.store.fold_upsert(
                self.type_name, fc, keys=keys, stats=stats,
                presorted=presorted or None,
                slice_rows=self.config.slice_rows,
                pacer=pacer, on_slice=on_slice,
            )

        return fault.with_retries(attempt, metrics=self.metrics)
