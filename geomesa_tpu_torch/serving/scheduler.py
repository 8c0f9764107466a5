"""QueryScheduler: coalesce concurrent callers into fused device launches.

The port of geomesa_tpu/serving/scheduler.py. N independent threads each
calling ``DataStore.query()`` get N single-query launches; the scheduler
puts an admission layer in front of the device instead:

- callers ``submit()`` (plan, hints) into a bounded queue and receive a
  future; planning runs in the CALLER's thread, so plan-time errors
  (parse, guards, visibility, bad hints) raise synchronously at submit;
- a dispatcher thread drains the queue after a short micro-batch window
  that ADAPTS: it halves toward zero when drains come back singular (an
  idle store adds no latency) and doubles toward the
  ``geomesa.serving.window_ms`` cap when drains fuse;
- each drained batch goes through ``QueryPlanner.submit_many``, which
  fuses compatible index scans per (type, index) into one kernel launch
  per chunk (unions, id lookups and full scans ride along on their
  synchronous path);
- admission is cache-aware: a ResultCache peek before enqueue serves hits
  in the caller's thread (hits never queue), and identical fingerprints
  admitted in one mutation epoch and drained in one window collapse onto
  one slot; computed results populate the cache under its normal
  admission policy;
- admission is deadline-aware: a query whose timeout cannot survive the
  current window (or expired while queued) is shed with QueryTimeout,
  and a full bounded queue blocks the caller (backpressure) or, with
  ``block=False``, sheds it with :class:`ServingRejected`;
- admission is tenant-aware: with a
  :class:`~geomesa_tpu_torch.serving.tenancy.TenantRegistry` each tenant
  has its own FIFO queue and quota, and several backlogged tenants drain
  by weighted deficit round-robin.

Metrics, in the store's registry (or the process-global one): counters
geomesa.serving.submitted / .shed / .coalesced / .batches /
.batched_queries (leaders only: mean fused batch = batched_queries /
batches) and geomesa.tuning.shed (the burn gate's sheds); gauge
geomesa.serving.window_ms; histogram geomesa.serving.queue_wait (through
``DataStore.record_query``).

Results equal sequential ``DataStore.query()``: the scheduler reuses the
planner's plan/refine/post pipeline end to end. A query racing a write
answers as of its ADMISSION (plans are built at submit).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import Optional


class ServingRejected(Exception):
    """The caller's admission was refused without waiting: the bounded
    queue or the tenant's quota was full under ``submit(block=False)``, or
    the burn gate shed it. The query was shed, not queued."""


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

    @staticmethod
    def from_properties() -> "ServingConfig":
        return ServingConfig()


class _Item:
    """One admitted query waiting for dispatch."""

    __slots__ = (
        "plan", "hints", "future", "key", "key_range", "epoch", "timeout",
        "deadline", "t_enqueue", "t_admit", "explain", "trace", "tenant",
    )

    def __init__(self, plan, hints, future, explain):
        self.plan = plan
        self.hints = hints
        self.future = future
        self.explain = explain
        self.tenant = None     # fairness queue key (None = the default pool)
        self.trace = None      # trace root (None when disarmed): the span
        #                        tree follows the item across the thread hop
        self.key = None        # cache fingerprint
        self.key_range = None  # cache invalidation range (cached stores)
        self.epoch = 0         # the store's mutation epoch at admission: the
        #                        coalescing key is (key, epoch), so a query
        #                        admitted after a write never shares a
        #                        pre-write leader's result
        self.timeout = None    # resolved budget in seconds
        self.deadline = None   # monotonic cutoff from admission
        self.t_enqueue = 0.0
        self.t_admit = 0.0     # perf_counter after planning: the admit phase
        #                        is t_admit -> t_enqueue on the trace


class QueryScheduler:
    """Micro-batch scheduler between concurrent callers and one
    DataStore's planner. ``DataStore.serve()`` builds, starts and attaches
    one; construction + ``start()`` works too (an unstarted scheduler
    stages a deterministic queue)."""

    def __init__(self, store, config: "ServingConfig | None" = None,
                 metrics=None, tenants=None):
        from geomesa_tpu_torch.lockwitness import witness
        from geomesa_tpu_torch.metrics import resolve

        self.store = store
        self.conf = config or ServingConfig()
        self.metrics = resolve(metrics if metrics is not None else store.metrics)
        # per-tenant quota and DRR weights. The registry's lock is never
        # taken under _cond: quotas are read before admission takes it,
        # weights are snapshot before each drain
        self.tenants = tenants
        self._cond = witness(threading.Condition(), "QueryScheduler._cond")
        # per-tenant FIFO queues (key None = the default pool); one
        # populated queue drains as plain FIFO, several by weighted DRR
        self._queues: "dict[Optional[str], deque[_Item]]" = {}  # guarded-by: _cond
        self._depth = 0                # guarded-by: _cond
        self._closed = False           # guarded-by: _cond
        # DRR credit per backlogged tenant: dispatcher-thread-only state
        self._deficit: "dict[Optional[str], float]" = {}
        # adaptive window: only the dispatcher thread writes it; submit()'s
        # lock-free read of a stale value only mistimes one shed decision
        self._window_s = 0.0
        self._thread: Optional[threading.Thread] = None  # guarded-by: _cond
        # SLO-burn admission gate: any object whose should_shed(tenant)
        # returns a reason (shed) or None (admit). None keeps admission to
        # physical backpressure alone. Consulted before _cond is taken,
        # so the gate's own reads never nest under the condition
        self.burn_gate = None

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
        """Queries waiting in the admission queue, across all tenants
        (a locked read: ``/health``'s scheduler check)."""
        with self._cond:
            return self._depth

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
            pending = [it for q in self._queues.values() for it in q]
            self._queues.clear()
            self._depth = 0
        for it in pending:
            if not it.future.done():
                if it.trace is not None:
                    from geomesa_tpu_torch.obs.trace import tracer

                    tracer().end(it.trace)
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
        hints=None,
        explain=None,
        block: bool = True,
        tenant: Optional[str] = None,
    ) -> Future:
        """Admit one query; returns a Future resolving to its
        FeatureCollection. Plan-time errors (parse, guards, visibility,
        hints) raise HERE, in the caller's thread; execution errors
        (QueryTimeout, scan failures) land on the future. ``block``:
        whether a full queue blocks the caller or sheds with
        ServingRejected. ``tenant`` routes the query into that tenant's
        queue (its quota and DRR share when a TenantRegistry is attached;
        None = the default pool)."""
        if self._closed:
            raise RuntimeError("scheduler is closed")
        from geomesa_tpu_torch.obs.trace import tracer

        planner = self.store.planner
        # read BEFORE planning: the submitter's own completed writes have
        # already bumped it, so read-your-writes holds at admission
        epoch = planner.mutation_epoch
        # the trace roots HERE, in the caller's thread: planning spans land
        # now; queue, dispatch and scan attach later from the dispatcher
        otr = tracer()
        trace = otr.begin("query", type=type_name, serving=True)
        try:
            with otr.activate(trace.root if trace is not None else None):
                plan = planner.plan(type_name, f, limit=limit, explain=explain)
                if hints is not None:
                    # one submitter's bad hints raise here, not in the
                    # co-batched dispatch
                    hints.validate()
        except BaseException:
            otr.end(trace)  # a plan-time error still closes the trace
            raise
        if trace is not None:
            trace.fingerprint = {
                "type": type_name,
                "strategy": plan.strategy,
                "filter": str(plan.filter),
            }
        fut: Future = Future()
        it = _Item(plan, hints, fut, explain)
        it.epoch = epoch
        it.trace = trace
        it.t_admit = time.perf_counter()
        it.timeout = getattr(hints, "timeout", None) if hints is not None else None
        if it.timeout is None:
            it.timeout = self.store.query_timeout
        if it.timeout is not None:
            it.deadline = time.monotonic() + it.timeout
        self.metrics.counter("geomesa.serving.submitted")
        # the tenant's quota is read HERE, before the condition is taken:
        # TenantRegistry._lock never nests under QueryScheduler._cond
        it.tenant = tenant
        tcap = None
        if self.tenants is not None and tenant is not None:
            tcap = self.tenants.queue_cap(tenant)
            self.tenants.note_submitted(tenant)

        # cache-aware admission: the fingerprint for in-window coalescing
        # (always, cache or not), and a result-cache peek: a hit is served
        # in the caller's thread through the planner's normal cached
        # execute (counted once) and never queues
        cache = getattr(self.store, "cache", None)
        mode = getattr(hints, "cache", None) if hints is not None else None
        if mode != "bypass":
            sft = self.store.get_schema(type_name)
            auths = getattr(self.store, "auths", None)
            if cache is not None:
                it.key = cache.fingerprint_plan(plan, hints, sft, auths)
                it.key_range = cache.key_range(plan.filter, sft)
                if cache.result.enabled and cache.result.peek(it.key) is not None:
                    try:
                        with otr.activate(trace.root if trace is not None else None):
                            _resolve(fut, planner.execute(plan, explain=explain, hints=hints))
                    except BaseException as exc:
                        _resolve(fut, exc=exc)
                    finally:
                        otr.end(trace)
                    if self.tenants is not None and tenant is not None:
                        self.tenants.note_cache_hit(tenant)
                    return fut
            else:
                from geomesa_tpu_torch.cache.fingerprint import fingerprint_plan

                it.key = fingerprint_plan(plan, hints, sft, auths)

        # deadline-aware shed: a budget that cannot survive the current
        # batch window is refused now, not after holding a queue slot
        if it.timeout is not None and it.timeout <= self._window_s:
            self._shed(it, (
                f"timeout {it.timeout:.3f}s cannot survive the "
                f"{self._window_s * 1e3:.1f}ms batch window"
            ))
            return fut

        # the burn gate: while an SLO burns its budget, it may shed
        # below-top-weight work before the queue is physically full. No
        # lock is held here
        gate = self.burn_gate
        if gate is not None:
            burn_why = gate.should_shed(tenant)
            if burn_why is not None:
                self.metrics.counter("geomesa.tuning.shed")
                self._shed(it, burn_why, ServingRejected(burn_why))
                return fut

        # backpressure: the shared bound AND (with tenancy) the caller's
        # quota — a flooding tenant sheds at its own quota while the other
        # tenants' queues stay open. Sheds resolve outside the condition
        shed_why = shed_exc = None
        with self._cond:
            while not self._closed:
                tq = self._queues.get(tenant)
                over_tenant = tcap is not None and (len(tq) if tq is not None else 0) >= tcap
                if self._depth < self.conf.queue_max and not over_tenant:
                    break
                if not block:
                    if over_tenant and self._depth < self.conf.queue_max:
                        shed_why = "tenant admission quota full"
                        shed_exc = ServingRejected(
                            f"tenant {tenant!r} admission quota full ({tcap})"
                        )
                    else:
                        shed_why = "admission queue full"
                        shed_exc = ServingRejected(f"admission queue full ({self.conf.queue_max})")
                    break
                rem = None
                if it.deadline is not None:
                    rem = it.deadline - time.monotonic()
                    if rem <= 0:
                        shed_why = "admission queue full past the deadline"
                        break
                self._cond.wait(rem if rem is not None else 0.1)
            if shed_why is None:
                if self._closed:
                    otr.end(trace)
                    _resolve(fut, exc=RuntimeError("scheduler closed"))
                    return fut
                it.t_enqueue = time.perf_counter()
                q = self._queues.get(tenant)
                if q is None:
                    q = self._queues[tenant] = deque()
                q.append(it)
                self._depth += 1
                self._cond.notify_all()
        if shed_why is not None:
            self._shed(it, shed_why, shed_exc)
        return fut

    def admission_gap(self, max_wait_s: float = 0.05) -> bool:
        """Wait (bounded) for the admission queue to drain — every query
        admitted so far handed to the dispatcher — and return whether it
        did. A maintenance thread (a sliced fold) that yields here lets
        queued queries dispatch before its next slice competes for the
        host. An idle queue returns at once; the bound keeps a saturating
        load from stalling the caller forever."""
        deadline = time.monotonic() + max(max_wait_s, 0.0)
        with self._cond:
            while self._depth and not self._closed:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                self._cond.wait(rem)
            return True

    def query(
        self,
        type_name: str,
        f="INCLUDE",
        limit: Optional[int] = None,
        hints=None,
        explain=None,
        wait: Optional[float] = None,
    ):
        """Synchronous submit + wait. ``wait`` bounds the caller's wait
        only (the query's own budget is the hint or store timeout)."""
        return self.submit(type_name, f, limit=limit, hints=hints, explain=explain).result(wait)

    def _shed(self, it: _Item, why: str, exc: Optional[BaseException] = None) -> None:
        self.metrics.counter("geomesa.serving.shed")
        if self.tenants is not None and it.tenant is not None:
            self.tenants.note_shed(it.tenant)
        if exc is None:
            from geomesa_tpu_torch.planning.errors import QueryTimeout

            exc = QueryTimeout(f"shed before dispatch: {why}", budget_s=it.timeout)
        if it.explain is not None:
            it.explain.warn(f"serving: shed ({why})")
        if it.trace is not None:
            from geomesa_tpu_torch.obs.trace import tracer

            it.trace.root.annotate(shed=why)
            tracer().end(it.trace)
        _resolve(it.future, exc=exc)

    # -- dispatcher ------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._depth and not self._closed:
                    self._cond.wait()
                if not self._depth and self._closed:
                    return
            # micro-batch window: linger for more arrivals, up to the
            # adaptive window or the batch cap (skipped when idle-shrunk
            # to zero: a lone query dispatches at once)
            w = self._window_s
            if w > 0:
                end = time.monotonic() + w
                with self._cond:
                    while self._depth < self.conf.batch_max and not self._closed:
                        rem = end - time.monotonic()
                        if rem <= 0:
                            break
                        self._cond.wait(rem)
            # the DRR weights are snapshot BEFORE the condition
            weights = self.tenants.weights() if self.tenants is not None else None
            with self._cond:
                batch = self._take_locked(weights)
                self._cond.notify_all()  # wake producers blocked on space
            self._adapt(len(batch))
            try:
                self._dispatch(batch)
            except BaseException as exc:  # the loop must outlive one bad batch
                for it in batch:
                    if not it.future.done():
                        _resolve(it.future, exc=exc)

    def _take_locked(self, weights: "dict | None") -> list:
        """Drain up to ``batch_max`` items under ``_cond``. One backlogged
        tenant drains plain FIFO; several interleave by weighted deficit
        round-robin: each pass, in sorted tenant order (the default pool
        last), grants every backlogged tenant ``weight / w_min`` credit
        (at least 1, so every pass progresses; capped at ``batch_max``)
        and takes that many of its items; an emptied queue forfeits its
        leftover credit."""
        nmax = self.conf.batch_max
        batch: "list[_Item]" = []
        live = [t for t, q in self._queues.items() if q]
        if not live:
            return batch
        if len(live) == 1:
            q = self._queues[live[0]]
            while q and len(batch) < nmax:
                batch.append(q.popleft())
            self._deficit.clear()
            self._depth -= len(batch)
            return batch
        live.sort(key=lambda t: (t is None, t))  # deterministic order
        w_min = 1.0
        if weights:
            w_min = min(max(weights.get(t, 1.0), 1e-3) for t in live)
        while live and len(batch) < nmax:
            for t in list(live):
                q = self._queues[t]
                w = max(weights.get(t, 1.0), 1e-3) if weights else 1.0
                cred = min(self._deficit.get(t, 0.0) + w / w_min, float(nmax))
                take = min(int(cred), len(q), nmax - len(batch))
                for _ in range(take):
                    batch.append(q.popleft())
                if q:
                    self._deficit[t] = cred - take
                else:
                    self._deficit.pop(t, None)
                    live.remove(t)
                if len(batch) >= nmax:
                    break
        self._depth -= len(batch)
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
        self.metrics.gauge("geomesa.serving.window_ms", self._window_s * 1e3)

    def _dispatch(self, batch: list) -> None:
        # late deadline shed: the budget expired while queued
        now = time.monotonic()
        live: list[_Item] = []
        for it in batch:
            if it.deadline is not None and now > it.deadline:
                self._shed(it, "deadline expired waiting for dispatch")
            else:
                live.append(it)
        if not live:
            return

        # identical-fingerprint coalescing: the same (schema, strategy,
        # filter, limit, result hints, auths) admitted in the SAME mutation
        # epoch and drained in one window share ONE slot and one result
        leaders: list[_Item] = []
        followers: dict[int, list[_Item]] = {}
        by_key: dict[tuple, int] = {}
        for it in live:
            ck = (it.key, it.epoch) if it.key is not None else None
            j = by_key.get(ck) if ck is not None else None
            if j is None:
                if ck is not None:
                    by_key[ck] = len(leaders)
                leaders.append(it)
            else:
                followers.setdefault(j, []).append(it)
                self.metrics.counter("geomesa.serving.coalesced")

        cache = getattr(self.store, "cache", None)
        # captured before the scan reads store state: an entry a mid-scan
        # write staled is rejected at admit
        tick = cache.generations.tick() if cache is not None else None
        self.metrics.counter("geomesa.serving.batches")
        self.metrics.counter("geomesa.serving.batched_queries", len(leaders))

        from geomesa_tpu_torch.obs.trace import phase_breakdown, tracer
        from geomesa_tpu_torch.planning.errors import Deadline

        otr = tracer()
        try:
            # per-leader explains, and deadlines anchored at ADMISSION:
            # queue wait is charged against the caller's budget. A
            # follower shares its leader's deadline and fate
            t_sm0 = time.perf_counter()
            finishes = self.store.planner.submit_many(
                [it.plan for it in leaders],
                hints=[it.hints for it in leaders],
                explains=[it.explain for it in leaders],
                deadlines=[
                    None if it.deadline is None else Deadline(
                        start=it.deadline - it.timeout,
                        budget_s=it.timeout,
                        cutoff=it.deadline,
                    )
                    for it in leaders
                ],
            )
        except BaseException as exc:
            for it in live:
                if not it.future.done():
                    if it.trace is not None:
                        otr.end(it.trace)
                    _resolve(it.future, exc=exc)
            return

        t_dispatch = time.perf_counter()
        for it in live:
            if it.trace is not None:
                # the cross-thread phases, recorded onto the caller's
                # trace: admission in the caller's thread, the wait behind
                # the window, then the fused dispatch's staging
                root = it.trace.root
                otr.add_span(root, "admit", t0=it.t_admit, end=it.t_enqueue)
                otr.add_span(root, "queue", t0=it.t_enqueue, end=t_sm0)
                otr.add_span(root, "dispatch", t0=t_sm0, end=t_dispatch, batch=len(leaders))
        for j, (it, fin) in enumerate(zip(leaders, finishes)):
            group = [it] + followers.get(j, [])
            for g in group:
                # queue wait lands on the plan BEFORE fin(), so the
                # leader's record_query observes it
                g.plan.queue_wait_s = t_dispatch - g.t_enqueue
            t0 = time.perf_counter()
            for g in group:
                if g.trace is not None:
                    # the wait between the fused dispatch and this member's
                    # turn in the pull loop
                    otr.add_span(g.trace.root, "batch.wait", t0=t_dispatch, end=t0, position=j)
            try:
                # the leader's span tree continues in THIS thread: the
                # device pull's scan and decode attach under its root
                with otr.activate(it.trace.root if it.trace is not None else None):
                    value = fin()
            except BaseException as exc:
                for g in group:
                    if g.trace is not None:
                        otr.end(g.trace)
                    if self.tenants is not None and g.tenant is not None:
                        self.tenants.note_error(g.tenant)
                    _resolve(g.future, exc=exc)
                continue
            cost_s = time.perf_counter() - t0
            mode = getattr(it.hints, "cache", None) if it.hints is not None else None
            if cache is not None and it.key is not None and it.key_range is not None \
                    and mode != "bypass":
                cache.result.admit(
                    it.key, it.plan.type_name, it.key_range, value,
                    cost_s, tick, pinned=(mode == "pin"),
                )
            for g in followers.get(j, []):
                # a follower is audited like its own query; "coalesced"
                # keeps its shared timing out of the tile tier's baseline
                g.plan.cache_status = "coalesced"
                self.store.record_query(g.plan, len(value), cost_s)
            for g in group:
                if self.tenants is not None and g.tenant is not None:
                    # no scheduler lock is held here
                    self.tenants.note_wait(g.tenant, g.plan.queue_wait_s)
                    self.tenants.note_served(g.tenant, time.perf_counter() - g.t_admit)
                if g.trace is not None:
                    if g is not it:
                        g.trace.root.annotate(coalesced=True)
                    otr.end(g.trace)
                if g.explain is not None:
                    g.explain(
                        f"serving: queue wait {g.plan.queue_wait_s * 1e3:.3f}ms, "
                        f"scan {cost_s * 1e3:.3f}ms, fused batch of {len(leaders)}"
                    )
                    if g.trace is not None:
                        for line in phase_breakdown(g.trace):
                            g.explain(line)
                        g.explain.trace = g.trace
                _resolve(g.future, value)
