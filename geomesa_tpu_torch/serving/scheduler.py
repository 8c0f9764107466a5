"""QueryScheduler: coalesce concurrent callers into fused device launches.

The port of the core of geomesa_tpu/serving/scheduler.py. N independent
threads each calling ``DataStore.query()`` get N single-query launches;
the scheduler puts an admission layer in front of the device instead:

- callers ``submit()`` a query into a bounded queue and receive a future;
  planning runs in the CALLER's thread, so plan-time errors (parse,
  schema) raise synchronously at submit;
- a dispatcher thread drains the queue (FIFO, up to ``batch_max``) after
  a short micro-batch window that ADAPTS: it halves toward zero when
  drains come back singular (an idle store adds no latency) and doubles
  toward the ``geomesa.serving.window_ms`` cap when drains fuse;
- each drained batch goes through ``QueryPlanner.submit_many``, which
  fuses compatible index scans per (type, index) into one kernel launch
  per chunk;
- a full queue blocks the caller (backpressure) or, with
  ``block=False``, sheds it with :class:`ServingRejected`.

Counters are plain attributes: ``submitted``, ``shed``, ``batches`` and
``batched_queries`` (mean fused batch size = batched_queries / batches).
Results equal sequential ``DataStore.query()``: the scheduler reuses the
planner's plan/refine/post pipeline end to end.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import Optional


class ServingRejected(Exception):
    """The bounded admission queue was full and the caller asked not to
    wait (``submit(block=False)``): the query was shed, not queued."""


def _resolve(fut: Future, value=None, exc: Optional[BaseException] = None) -> None:
    """Resolve a caller future, tolerating a client-side ``cancel()``: a
    cancelled future has no listener, and a bare set_result on it raises
    InvalidStateError, which must not fail the co-batched queries."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except InvalidStateError:
        pass


@dataclass
class ServingConfig:
    """Scheduler knobs. Every field left unset resolves from the conf.py
    property tier (environment-overridable), so a partial override like
    ``ServingConfig(window_ms=5.0)`` keeps the other knobs' settings."""

    window_ms: "float | None" = None   # adaptive micro-batch window CAP
    queue_max: "int | None" = None     # bounded admission queue depth
    batch_max: "int | None" = None     # max queries per fused dispatch

    def __post_init__(self):
        from geomesa_tpu_torch import conf

        if self.window_ms is None:
            self.window_ms = conf.SERVING_WINDOW_MS.get()
        if self.queue_max is None:
            self.queue_max = conf.SERVING_QUEUE_MAX.get()
        if self.batch_max is None:
            self.batch_max = conf.SERVING_BATCH_MAX.get()


@dataclass
class _Item:
    """One admitted query waiting for dispatch."""

    plan: object
    future: Future


class QueryScheduler:
    """Micro-batch scheduler between concurrent callers and one
    DataStore's planner. ``DataStore.serve()`` builds, starts and attaches
    one; construction + ``start()`` works too (an unstarted scheduler
    stages a deterministic queue)."""

    def __init__(self, store, config: "ServingConfig | None" = None):
        self.store = store
        self.conf = config or ServingConfig()
        from geomesa_tpu_torch.lockwitness import witness

        self._cond = witness(threading.Condition(), "QueryScheduler._cond")
        self._queue: "deque[_Item]" = deque()  # guarded-by: _cond
        self._closed = False                   # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None  # guarded-by: _cond
        # adaptive window: only the dispatcher thread writes it; submit()
        # never reads it
        self._window_s = 0.0
        # counters: submitted and shed under _cond (any caller thread),
        # batches and batched_queries by the dispatcher thread only
        self.submitted = 0
        self.shed = 0
        self.batches = 0
        self.batched_queries = 0

    # -- lifecycle -------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def window_s(self) -> float:
        """The current adaptive micro-batch window in seconds."""
        return self._window_s

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def start(self) -> "QueryScheduler":
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="geomesa-serving", daemon=True
                )
                self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting queries, let the dispatcher drain what is queued,
        then fail anything still pending (a never-started scheduler, or a
        drain past ``timeout``)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout)
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
        for it in pending:
            _resolve(it.future, exc=RuntimeError("scheduler closed"))

    def __enter__(self) -> "QueryScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission -------------------------------------------------------
    def submit(
        self,
        type_name: str,
        f="INCLUDE",
        limit: Optional[int] = None,
        block: bool = True,
    ) -> Future:
        """Admit one query; returns a Future resolving to its
        FeatureCollection. Plan-time errors raise here, in the caller's
        thread; execution errors land on the future. ``block``: whether a
        full queue blocks the caller or sheds with ServingRejected."""
        if self._closed:
            raise RuntimeError("scheduler is closed")
        plan = self.store.planner.plan(type_name, f, limit=limit)
        fut: Future = Future()
        with self._cond:
            self.submitted += 1
            while not self._closed and len(self._queue) >= self.conf.queue_max:
                if not block:
                    self.shed += 1
                    _resolve(fut, exc=ServingRejected(
                        f"admission queue full ({self.conf.queue_max})"
                    ))
                    return fut
                self._cond.wait(0.1)
            if self._closed:
                _resolve(fut, exc=RuntimeError("scheduler closed"))
                return fut
            self._queue.append(_Item(plan, fut))
            self._cond.notify_all()
        return fut

    def query(self, type_name: str, f="INCLUDE", limit: Optional[int] = None,
              wait: Optional[float] = None):
        """Synchronous submit + wait; ``wait`` bounds the caller's wait."""
        return self.submit(type_name, f, limit=limit).result(wait)

    # -- dispatcher ------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
            # micro-batch window: linger for more arrivals, up to the
            # adaptive window or the batch cap (skipped when idle-shrunk
            # to zero: a lone query dispatches at once)
            w = self._window_s
            if w > 0:
                end = time.monotonic() + w
                with self._cond:
                    while len(self._queue) < self.conf.batch_max and not self._closed:
                        rem = end - time.monotonic()
                        if rem <= 0:
                            break
                        self._cond.wait(rem)
            with self._cond:
                batch = self._take_locked()
                self._cond.notify_all()  # wake producers blocked on space
            self._adapt(len(batch))
            try:
                self._dispatch(batch)
            except Exception as exc:  # the loop must outlive one bad batch
                for it in batch:
                    if not it.future.done():
                        _resolve(it.future, exc=exc)

    def _take_locked(self) -> list:
        """Drain up to ``batch_max`` items, FIFO, under ``_cond``."""
        batch: "list[_Item]" = []
        while self._queue and len(batch) < self.conf.batch_max:
            batch.append(self._queue.popleft())
        return batch

    def _adapt(self, drained: int) -> None:
        """Grow the window under load, shrink it when idle: a drain that
        fused (> 1 query) doubles the window toward the cap; a singular
        drain halves it toward zero."""
        cap = max(self.conf.window_ms, 0.0) / 1e3
        if drained > 1:
            self._window_s = min(cap, max(self._window_s * 2.0, cap / 8.0))
        elif self._window_s < cap / 16.0:
            self._window_s = 0.0
        else:
            self._window_s = self._window_s / 2.0

    def _dispatch(self, batch: list) -> None:
        self.batches += 1
        self.batched_queries += len(batch)
        try:
            finishes = self.store.planner.submit_many([it.plan for it in batch])
        except Exception as exc:
            for it in batch:
                _resolve(it.future, exc=exc)
            return
        for it, fin in zip(batch, finishes):
            try:
                value = fin()
            except Exception as exc:
                _resolve(it.future, exc=exc)
                continue
            _resolve(it.future, value)
