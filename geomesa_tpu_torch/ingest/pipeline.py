"""Staged multi-core ingest pipeline (docs/ingest.md).

The port's copy of geomesa_tpu/ingest/pipeline.py. The pipeline overlaps
the write path's stages across host cores (the 3DPipe build/probe-overlap
argument, arxiv 2604.19982, and the saturate-the-host-cores case of
arxiv 1802.09488):

1. **parse** — converter workers over input splits (a process pool; the
   distributed-MapReduce-ingest analogue, see ``ingest.splits``). The
   workers stay on the host: converters, numpy and WKB, never the card;
2. **keys**  — z2/z3/xz write-key encoding per chunk in worker threads
   (the native passes release the GIL), plus the chunk's stats sketch;
3. **sort**  — fixed-size shards of each chunk's (bin, z) keys radix-sort
   in parallel (``ingest.sort``); the sorted runs k-way merge at finalize
   (or fall back to the whole-table LSD when bins are few: a spanwise
   merge has nothing to parallelize over few bins);
4. **write** — an ordered writer thread accounts each chunk and releases
   backpressure; the single ``finalize`` publishes every chunk atomically
   under the store's write lock and builds the device tables from the
   pre-merged permutations.

Backpressure: a bounded admission window (``geomesa.ingest.queue.depth``
chunks) gates ``put()`` until the ordered writer catches up, so stage
scratch (unsorted key copies, sort shards) stays bounded; the committed
data itself is host-resident by design (this is an in-process store).

Failure semantics: ANY stage failure — including injected faults
(geomesa_tpu_torch.fault: ``ingest.split.read`` / ``ingest.parse`` /
``ingest.keys`` / ``ingest.sort`` / ``ingest.commit`` /
``ingest.finalize``) — aborts the whole ingest BEFORE the single publish
point, so the store never shows a partial bulk load and ``_quarantine/``
is untouched. Transient IO errors on split reads retry with bounded
backoff first (fault.with_retries).

Every stage records wall time into the ``geomesa.ingest.*`` metrics
family, so a bulk-load profile shows where the time lives.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

import numpy as np

from geomesa_tpu_torch.fault import fault_point
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.ingest import sort as shsort
from geomesa_tpu_torch.ingest.splits import (
    ConverterConfig,
    feed_in_split_order,
    plan_splits,
    run_split_guarded,
)

STAGES = ("parse", "keys", "sort", "commit", "finalize")


class IngestError(RuntimeError):
    """An ingest failed; for parse-worker failures carries the worker's
    split index and formatted traceback (forked workers lose their stack
    otherwise)."""

    def __init__(self, message: str, split_index: "int | None" = None,
                 worker_traceback: "str | None" = None):
        super().__init__(message)
        self.split_index = split_index
        self.worker_traceback = worker_traceback


@dataclass
class IngestResult:
    written: int = 0
    errors: int = 0
    splits: int = 0
    # per-split parse-error counts, ordered by SPLIT index (not worker
    # completion): deterministic across runs and worker counts
    split_errors: list = field(default_factory=list)
    # per-stage wall seconds (geomesa.ingest.* timer mirror)
    stage_seconds: dict = field(default_factory=dict)
    # per-reason error counts aggregated over splits ("parse", or a
    # validator's "name: reason" — the CqlValidatorFactory-style
    # accounting; io.validators). errors == sum(error_reasons.values())
    error_reasons: dict = field(default_factory=dict)

    def add_reasons(self, reasons: dict) -> None:
        for r, n in reasons.items():
            self.error_reasons[r] = self.error_reasons.get(r, 0) + n


@dataclass
class PipelineConfig:
    """Knobs for the staged pipeline; ``from_properties`` resolves each
    from the typed property tier (geomesa_tpu_torch.conf)."""

    workers: int = 0          # 0 = one per host core
    queue_depth: int = 4      # chunks admitted ahead of the ordered writer
    chunk_rows: int = 1 << 20  # fixed-size sort shard rows
    merge_min_bins: int = 2   # below this, finalize uses whole-table LSD

    @staticmethod
    def from_properties() -> "PipelineConfig":
        from geomesa_tpu_torch import conf

        return PipelineConfig(
            workers=conf.INGEST_WORKERS.get(),
            queue_depth=conf.INGEST_QUEUE_DEPTH.get(),
            chunk_rows=conf.INGEST_CHUNK_ROWS.get(),
            merge_min_bins=conf.INGEST_MERGE_MIN_BINS.get(),
        )

    def resolved_workers(self) -> int:
        import os

        if self.workers and self.workers > 0:
            return int(self.workers)
        return max(1, os.cpu_count() or 1)


def _col_nbytes(col) -> int:
    if hasattr(col, "nbytes"):
        return int(col.nbytes)
    if hasattr(col, "x") and hasattr(col, "y"):  # PointColumn
        return int(col.x.nbytes) + int(col.y.nbytes)
    if hasattr(col, "coords"):  # PackedGeometryColumn
        return int(col.coords.nbytes) + int(col.bboxes.nbytes)
    return 0


def _chunk_nbytes(fc: FeatureCollection, keys_by_index: dict) -> int:
    total = int(np.asarray(fc.ids).nbytes)
    for col in fc.columns.values():
        total += _col_nbytes(col)
    for keys in keys_by_index.values():
        total += int(keys.bins.nbytes) + int(keys.zs.nbytes)
        total += sum(int(v.nbytes) for v in keys.device_cols.values())
        if keys.sub is not None:
            total += int(keys.sub.nbytes)
    return total


class _Chunk:
    __slots__ = ("idx", "base", "fc", "keys", "stats", "runs", "event", "error",
                 "slot_held")

    def __init__(self, idx: int, base: int, fc: FeatureCollection):
        self.idx = idx
        self.base = base  # global row offset among staged chunks
        self.fc = fc
        self.keys: dict = {}
        self.stats = None
        self.runs: dict = {}  # index name -> list[SortRun]
        self.event = threading.Event()
        self.error: "BaseException | None" = None
        self.slot_held = True  # guarded-by: BulkLoader._cv


class BulkLoader:
    """Staged multi-core bulk ingest for ONE feature type: ``put()``
    chunks (FeatureCollections or row mappings), then ``close()`` — the
    single atomic publish. Nothing is visible in the store until close()
    returns; any failure before that leaves the store untouched."""

    def __init__(self, store, type_name: str, config: "PipelineConfig | None" = None,
                 metrics=None, check_ids: bool = True):
        self.store = store
        self.type_name = type_name
        self.config = config if config is not None else PipelineConfig.from_properties()
        self.metrics = metrics if metrics is not None else getattr(store, "metrics", None)
        self.check_ids = check_ids
        workers = self.config.resolved_workers()
        # one shared pool for key + sort (+ finalize merge) tasks: no task
        # ever blocks on another task, so a bounded pool cannot deadlock
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, workers), thread_name_prefix="geomesa-ingest"
        )
        from geomesa_tpu_torch.lockwitness import witness

        self._sem = threading.Semaphore(max(1, self.config.queue_depth))
        self._cv = witness(threading.Condition(), "BulkLoader._cv")
        self._chunks: list[_Chunk] = []           # guarded-by: _cv
        self._rows_staged = 0                     # guarded-by: _cv
        self._closed = False                      # guarded-by: _cv
        self._error: "BaseException | None" = None  # guarded-by: _cv
        self._writer: "threading.Thread | None" = None  # guarded-by: _cv
        self._stage_lock = witness(threading.Lock(), "BulkLoader._stage_lock")
        self._stage_s = {s: 0.0 for s in STAGES}  # guarded-by: _stage_lock
        self._peak_chunk_bytes = 0                # guarded-by: _stage_lock

    # -- bookkeeping ------------------------------------------------------
    def _count(self, name: str, inc: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter(name, inc)

    def _stage_time(self, stage: str, seconds: float) -> None:
        with self._stage_lock:
            self._stage_s[stage] += seconds
        if self.metrics is not None:
            self.metrics.timer_update(f"geomesa.ingest.{stage}", seconds)

    def _note_chunk_bytes(self, nbytes: int) -> None:
        with self._stage_lock:
            if nbytes > self._peak_chunk_bytes:
                self._peak_chunk_bytes = nbytes
        if self.metrics is not None:
            self.metrics.gauge(
                "geomesa.ingest.chunk_bytes_peak", self._peak_chunk_bytes
            )

    def _fail(self, e: BaseException) -> None:
        with self._cv:
            if self._error is None:
                self._error = e
            chunks = list(self._chunks)
            self._cv.notify_all()
        # release every chunk event: a cancelled encode/sort future would
        # otherwise never set its chunk's event and the writer (and any
        # join on it) would hang waiting for a stage that will never run
        for ch in chunks:
            ch.event.set()
        # the pipeline is dead: reap the worker threads NOW, not at some
        # later close()/abort() a caller whose put() raised may never
        # reach (a service doing repeated failing loads would otherwise
        # accumulate idle pools). Safe from inside a worker thread
        # (wait=False never joins); close()'s shutdown stays idempotent.
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise self._error

    def _release_slot(self, ch: _Chunk) -> None:
        """Give the chunk's admission slot back, once: the writer and a
        put() whose submit met a dead pool can both reach one chunk."""
        with self._cv:
            held, ch.slot_held = ch.slot_held, False
        if held:
            self._sem.release()

    # -- producer ---------------------------------------------------------
    def put(self, features: "FeatureCollection | Sequence") -> int:
        """Stage one chunk. Blocks when the admission window is full
        (bounded backpressure, counted by geomesa.ingest.queue_full).
        Raises immediately if any pipeline stage already failed."""
        if self._closed:
            raise RuntimeError("BulkLoader is closed")
        self._raise_if_failed()
        sft = self.store.get_schema(self.type_name)
        if not isinstance(features, FeatureCollection):
            features = FeatureCollection.from_rows(sft, features)
        if len(features) == 0:
            return 0  # empty chunks are a no-op, exactly like write()
        if not self._sem.acquire(blocking=False):
            self._count("geomesa.ingest.queue_full")
            while not self._sem.acquire(timeout=0.05):
                self._raise_if_failed()
        try:
            self._raise_if_failed()
        except BaseException:
            self._sem.release()
            raise
        with self._cv:
            # chunk index and global base offset assign under the lock:
            # concurrent producers must never mint overlapping ordinal
            # ranges (the sort permutation is built from these bases)
            ch = _Chunk(len(self._chunks), self._rows_staged, features)
            self._rows_staged += len(features)
            self._chunks.append(ch)
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop, name="geomesa-ingest-writer",
                    daemon=True,
                )
                self._writer.start()
            self._cv.notify_all()
        try:
            self._pool.submit(self._encode, ch)
        except RuntimeError:
            # a stage failed after the check above and _fail shut the
            # pool: this chunk never runs. Free its slot and its event
            # (_fail may have listed the chunks before this one joined)
            # and raise the pipeline's first error, not the pool's.
            with self._cv:
                error = self._error
            if error is None:
                raise
            ch.error = error
            ch.event.set()
            self._release_slot(ch)
            raise error from None
        self._count("geomesa.ingest.chunks")
        return len(features)

    # -- key + sort stages --------------------------------------------------
    def _encode(self, ch: _Chunk) -> None:
        try:
            fault_point("ingest.keys")
            t0 = time.perf_counter()
            _, keys, stats = self.store._encode_batch(self.type_name, ch.fc)
            ch.keys, ch.stats = keys, stats
            self._stage_time("keys", time.perf_counter() - t0)
            self._note_chunk_bytes(_chunk_nbytes(ch.fc, keys))
            # sub-keyed indexes (string attribute indexes) keep the
            # lexsort path at compact; no run to pre-sort
            pending = [
                name for name, k in keys.items() if len(k.zs) and k.sub is None
            ]
            if not pending:
                ch.event.set()
                return
            remaining = [len(pending)]
            lock = threading.Lock()
            for name in pending:
                self._pool.submit(self._sort_index, ch, name, remaining, lock)
        except BaseException as e:
            ch.error = e
            ch.event.set()
            self._fail(e)

    def _sort_index(self, ch: _Chunk, name: str, remaining: list, lock) -> None:
        try:
            fault_point("ingest.sort")
            t0 = time.perf_counter()
            k = ch.keys[name]
            ch.runs[name] = shsort.shard_runs(
                k.bins, k.zs, ch.base, self.config.chunk_rows
            )
            self._stage_time("sort", time.perf_counter() - t0)
        except BaseException as e:
            ch.error = e
            self._fail(e)
        finally:
            with lock:
                remaining[0] -= 1
                done = remaining[0] == 0
            if done:
                ch.event.set()

    # -- ordered writer stage ----------------------------------------------
    def _writer_loop(self) -> None:
        i = 0
        while True:
            with self._cv:
                while (
                    not self._closed
                    and i >= len(self._chunks)
                    and self._error is None
                ):
                    self._cv.wait()
                if self._error is not None:
                    return
                if i >= len(self._chunks):
                    return  # closed and drained
                ch = self._chunks[i]
            ch.event.wait()
            if ch.error is not None:
                self._release_slot(ch)
                return  # _fail already recorded it
            try:
                t0 = time.perf_counter()
                fault_point("ingest.commit")
                self._stage_time("commit", time.perf_counter() - t0)
            except BaseException as e:
                self._fail(e)
                return
            finally:
                self._release_slot(ch)
            i += 1

    # -- finalize -----------------------------------------------------------
    def abort(self) -> None:
        """Tear the pipeline down without publishing (the store stays
        untouched). Used by ingest loops whose OWN stage failed (e.g. a parse
        worker) — close() after abort() re-raises."""
        self._fail(IngestError("ingest aborted"))
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._writer is not None:
            self._writer.join()
        self._pool.shutdown(wait=True, cancel_futures=True)

    def close(self) -> IngestResult:
        """Drain the stages, k-way-merge the sorted runs, and publish every
        staged chunk ATOMICALLY (one write-lock section: either all rows
        become visible, compacted, or none do)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._writer is not None:
            self._writer.join()
        try:
            self._raise_if_failed()
            result = IngestResult(stage_seconds=self._stage_s)
            if not self._chunks:
                return result
            t0 = time.perf_counter()
            fault_point("ingest.finalize")
            result.written = self._publish()
            self._stage_time("finalize", time.perf_counter() - t0)
            self._count("geomesa.ingest.rows", result.written)
            result.stage_seconds = dict(self._stage_s)
            return result
        finally:
            self._pool.shutdown(wait=True, cancel_futures=True)

    def _publish(self) -> int:
        from geomesa_tpu_torch.storage.delta import concat_keys

        chunks = self._chunks
        fcs = [ch.fc for ch in chunks]
        stats_list = [ch.stats for ch in chunks]
        # one concatenated WriteKeys per index; the chunk keys are
        # loader-private until this point, so consume= frees each chunk's
        # arrays as its columns concatenate (bounded transient, not 2x)
        keys_by_index: dict = {}
        runs_by_index: dict = {}
        for name in chunks[0].keys:
            runs_by_index[name] = [
                r for ch in chunks for r in ch.runs.get(name, [])
            ]
            keys_by_index[name] = concat_keys(
                [ch.keys[name] for ch in chunks], consume=True
            )
        presorted: dict = {}
        # a presorted perm only applies when the new rows ARE the whole
        # table (_bulk_commit discards it otherwise): skip the O(n log k)
        # merge + n*8B perm allocation entirely for appends to non-empty
        # stores — the normal delta compaction handles those. (A writer
        # racing this unlocked peek just downgrades to the same fallback.)
        store_not_empty = any(
            len(c) for c in self.store._chunks.get(self.type_name, [])
        )
        for name in list(runs_by_index):
            runs = runs_by_index.pop(name)  # released once merged
            keys = keys_by_index[name]
            if store_not_empty or keys.sub is not None or not runs:
                continue
            bins = shsort.distinct_bins(runs)
            if len(bins) < self.config.merge_min_bins:
                # few bins -> the spanwise merge has nothing to
                # parallelize; let compact run the whole-table LSD instead
                continue
            perm = shsort.merge_runs(runs, pool=self._pool, bins=bins)
            del runs
            if len(perm) != len(keys.zs):
                continue
            if len(perm) < 2**32:
                perm = perm.astype(np.uint32)  # native take() fast path
            presorted[name] = perm
        # the sorted run copies (~20 B/row per z index) are merge input
        # only: drop them BEFORE the publish + device build, so they
        # don't ride on top of the compaction's bounded peak
        for ch in chunks:
            ch.runs.clear()
        return self.store._bulk_commit(
            self.type_name,
            fcs,
            keys_by_index,
            stats_list,
            check_ids=self.check_ids,
            presorted=presorted or None,
        )


def raise_split_failure(failure, splits) -> None:
    """Re-raise a worker-side SplitFailure as IngestError (shared by the
    pipelined and sequential-commit ingest paths so message format and
    attributes can never diverge)."""
    raise IngestError(
        f"ingest split {failure.split_index} "
        f"({splits[failure.split_index].path}) failed in a worker "
        f"[{failure.exc_type}]:\n{failure.tb}",
        split_index=failure.split_index,
        worker_traceback=failure.tb,
    )


def rebase_ids(fc: FeatureCollection, base: int) -> FeatureCollection:
    """Running-index ids restart per split AND per run: rebase onto the
    store's row count (same semantics as the sequential CLI path) so
    repeat ingests and multi-split inputs never collide."""
    return FeatureCollection(
        fc.sft, np.arange(base, base + len(fc)).astype(str), fc.columns
    )


def ingest_files(
    store,
    converter,
    paths: Sequence[str],
    workers: Optional[int] = None,
    id_prefix_splits: bool = True,
    split_bytes: "int | None" = None,
    config: "PipelineConfig | None" = None,
    metrics=None,
) -> IngestResult:
    """Pipelined file ingest: a process pool parses input splits (stage 1)
    feeding a :class:`BulkLoader` (stages 2-4). ``workers=0/1`` parses
    in-process (the reference's local ingest mode) but still pipelines key
    computation and sorting. Split parse-error counts aggregate into
    ``IngestResult.split_errors`` ordered by split; a failed worker raises
    :class:`IngestError` carrying the worker traceback, and the store is
    left untouched (atomic ingest)."""
    cfg = config if config is not None else PipelineConfig.from_properties()
    if workers is not None and workers > 0:
        cfg = replace(cfg, workers=workers)
    conv_cfg = ConverterConfig.of(converter)
    type_name = converter.sft.name
    splits = plan_splits(paths, converter.fmt, split_bytes)
    result = IngestResult(splits=len(splits))
    if not splits:
        return result
    if workers is None:
        import os

        workers = min(len(splits), os.cpu_count() or 1)
    loader = BulkLoader(store, type_name, config=cfg, metrics=metrics)
    rebase = id_prefix_splits and converter.id_field is None
    # running-index rebase: seed from the store ONCE, then track locally;
    # the loader publishes atomically so no other count can interleave
    base = len(store.features(type_name)) if rebase else 0

    def feed(res) -> None:
        nonlocal base
        idx, fc, errors, reasons, parse_s, failure = res
        loader._stage_time("parse", parse_s)
        if failure is not None:
            raise_split_failure(failure, splits)
        result.split_errors.append(errors)
        result.errors += errors
        result.add_reasons(reasons)
        loader._count("geomesa.ingest.errors", errors)
        if len(fc) == 0:
            return
        if rebase:
            fc = rebase_ids(fc, base)
            base += len(fc)
        loader.put(fc)

    tasks = [(conv_cfg, sp, i) for i, sp in enumerate(splits)]
    try:
        if workers <= 1 or len(splits) <= 1:
            for t in tasks:
                feed(run_split_guarded(t))
        else:
            import multiprocessing as mp

            ctx = mp.get_context("fork")
            with ctx.Pool(min(workers, len(splits))) as pool:
                # imap streams results in SPLIT order: the ordered feed
                # overlaps conversion, and error aggregation stays
                # deterministic whatever the completion order was
                feed_in_split_order(pool, tasks, feed)
    except BaseException:
        loader.abort()
        raise
    closed = loader.close()
    result.written = closed.written
    result.stage_seconds = closed.stage_seconds
    return result
