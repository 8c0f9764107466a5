"""Structured tracing: spans, thread-local propagation, trace retention.

The port's copy of geomesa_tpu/obs/trace.py.

The span model (docs/observability.md): a **root** span opens a
:class:`Trace` at an operation entry point (a query, a flush, a hot
write); **child** spans mark phases and attach to whichever span is
active on the current thread. Cross-thread hops — the serving
scheduler's dispatcher, the flush worker pool — re-activate the parent
span explicitly (:meth:`Tracer.activate`), so one query's trace stays
one tree across the caller thread, the dispatcher and the device pull.

Arming and cost: tracing is armed when ``geomesa.obs.trace.sample`` > 0
or ``geomesa.obs.slow.ms`` > 0 (the always-on slow-query log needs span
trees to capture). The knobs are read once per ROOT; a child
:func:`span` on a thread with no active trace is a single thread-local
probe returning a shared null context — the disarmed no-op. Armed, a span is one small
object append; sampling decides at root creation whether the finished
tree is RETAINED in the bounded :class:`TraceBuffer` (slow roots are
always retained into the slow-query ring, independent of sampling).

Span timestamps are ``time.perf_counter`` (monotonic); each trace also
records a wall-clock anchor so exports are absolute. ``Tracer.dump``
writes Chrome trace-event JSON (``chrome://tracing`` / Perfetto
``ph:"X"`` complete events, microsecond units): ``ts`` is Unix-epoch
microseconds, mapped from ``perf_counter`` through one anchor pair taken
with ``time.time_ns`` when the module loads, the clock ``torch.profiler``
stamps its events with, so an export lays over a profiler capture; each
event's ``args`` carry the thread id that opened the span.

Locking: ``Tracer._lock`` (hot) guards only the
retention rings and the sampling counter — it is taken once per root
begin/end, never per child span (children append to their trace's own
span list, a GIL-atomic ``list.append``; see :class:`Span`), and
nothing blocking runs under it. Span finish never acquires it, so
spans are safe to close while arbitrary store locks are held.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Optional

from geomesa_tpu_torch import conf

_ids = itertools.count(1)
_tls = threading.local()
# perf_counter -> Unix-epoch microseconds, from one pair of readings
_ANCHOR_PC, _ANCHOR_NS = time.perf_counter(), time.time_ns()


def _epoch_us(t: float) -> float:
    return _ANCHOR_NS / 1e3 + (t - _ANCHOR_PC) * 1e6


class Span:
    """One timed phase. ``finish()`` stamps the duration and appends the
    span to its trace — no lock: concurrent appends DO happen (flush
    pool workers finish stage spans of the same trace in parallel) and
    rely on ``list.append`` being atomic under the GIL. Only the append
    is concurrent; no span is ever mutated after finish, and readers
    (retention, export) run after the root ends. A free-threaded
    runtime would need a per-trace lock here."""

    __slots__ = (
        "trace", "span_id", "parent_id", "name", "attrs", "t0", "dur_s",
        "tid",
    )

    def __init__(self, trace: "Trace", name: str, parent_id: Optional[int],
                 attrs: Optional[dict] = None, t0: Optional[float] = None):
        self.trace = trace
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self.t0 = time.perf_counter() if t0 is None else t0
        self.dur_s = 0.0
        self.tid = threading.get_ident()

    def annotate(self, **attrs) -> "Span":
        """Attach attributes after the fact (hit counts, strategies)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def finish(self, end: Optional[float] = None) -> None:
        self.dur_s = (time.perf_counter() if end is None else end) - self.t0
        self.trace.spans.append(self)


class Trace:
    """One operation's span tree: the root span plus every finished
    child, flat with parent ids (tree shape reconstructs from ids)."""

    __slots__ = (
        "trace_id", "name", "spans", "root", "t_wall", "retain",
        "fingerprint",
    )

    def __init__(self, name: str, retain: bool):
        self.trace_id = next(_ids)
        self.name = name
        self.spans: list[Span] = []
        self.t_wall = time.time()
        self.retain = retain
        # slow-log identity (set by the query path once planned): the
        # plan fingerprint the capture carries
        self.fingerprint: Optional[dict] = None
        self.root = Span(self, name, None)

    @property
    def wall_s(self) -> float:
        return self.root.dur_s

    def phases(self) -> list[Span]:
        """Top-level phases: the root's direct children, in start order."""
        rid = self.root.span_id
        return sorted(
            (s for s in self.spans if s.parent_id == rid),
            key=lambda s: s.t0,
        )

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "wall_ms": round(self.wall_s * 1e3, 3),
            "t_wall": self.t_wall,
            "t0_epoch_us": _epoch_us(self.root.t0),
            "spans": [
                {
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    "name": s.name,
                    "start_ms": round((s.t0 - self.root.t0) * 1e3, 3),
                    "dur_ms": round(s.dur_s * 1e3, 3),
                    "tid": s.tid,
                    **({"attrs": s.attrs} if s.attrs else {}),
                }
                for s in sorted(self.spans, key=lambda s: s.t0)
            ],
        }


class _NullSpan:
    """The shared disarmed context: every tracing entry point on an
    untraced thread returns THIS singleton — no allocation, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def annotate(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager activating a child span on this thread."""

    __slots__ = ("span", "_prev")

    def __init__(self, span: Span):
        self.span = span
        self._prev = None

    def __enter__(self) -> Span:
        self._prev = getattr(_tls, "span", None)
        _tls.span = self.span
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.finish()
        _tls.span = self._prev


class _Activation:
    """Cross-thread hop: re-activate an existing span on this thread
    without finishing it on exit (the span belongs to another scope)."""

    __slots__ = ("_span", "_prev")

    def __init__(self, span: Optional[Span]):
        self._span = span
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "span", None)
        if self._span is not None:
            _tls.span = self._span
        return self._span

    def __exit__(self, *exc) -> None:
        if self._span is not None:
            _tls.span = self._prev


class TraceBuffer:
    """Bounded ring of finished traces (plain list + cap: the buffer is
    only touched under ``Tracer._lock``)."""

    __slots__ = ("cap", "_items")

    def __init__(self, cap: int):
        self.cap = max(int(cap), 1)
        self._items: list[Trace] = []

    def append(self, trace: Trace) -> None:
        self._items.append(trace)
        if len(self._items) > self.cap:
            del self._items[: len(self._items) - self.cap]

    def items(self) -> list[Trace]:
        return list(self._items)

    def __len__(self) -> int:
        return len(self._items)


class Tracer:
    """The process tracing runtime: sampling, retention, export.

    One installed instance (:func:`tracer` / :func:`install`) serves
    every store in the process — the serving scheduler, flush workers
    and WAL all record into the same buffer, which is what makes a
    cross-tier trace one tree."""

    def __init__(self, metrics=None):
        from geomesa_tpu_torch.lockwitness import witness

        self._lock = witness(threading.Lock(), "Tracer._lock")
        self.buffer = TraceBuffer(conf.OBS_TRACE_BUFFER.get())  # guarded-by: _lock
        self.slow: list[dict] = []   # guarded-by: _lock
        self._n_roots = 0            # guarded-by: _lock
        self.metrics = metrics

    # -- arming / roots ---------------------------------------------------
    @property
    def armed(self) -> bool:
        return conf.OBS_TRACE_SAMPLE.get() > 0 or conf.OBS_SLOW_MS.get() > 0

    def begin(self, name: str, **attrs) -> Optional[Trace]:
        """Open a root trace (sampling decided here), or None when
        disarmed. Does NOT activate it — pair with :meth:`activate`
        (the serving scheduler begins in the caller thread and
        activates per hop); :meth:`trace` composes both.

        Sampling gates the whole tree, not just retention: with the
        slow log off, a sampled-out root returns None and its operation
        records NO spans — 1/N sampling costs ~1/N of full-tracing
        overhead. With the slow log armed every root builds its tree
        (the capture decision needs it), sampling only decides buffer
        retention."""
        sample = conf.OBS_TRACE_SAMPLE.get()
        slow_ms = conf.OBS_SLOW_MS.get()
        if sample <= 0 and slow_ms <= 0:
            return None
        retain = False
        if sample > 0:
            with self._lock:
                self._n_roots += 1
                retain = self._n_roots % sample == 0
        if not retain and slow_ms <= 0:
            return None  # never retained, never slow-captured: free
        tr = Trace(name, retain)
        if attrs:
            tr.root.annotate(**attrs)
        return tr

    def end(self, trace: Optional[Trace], fingerprint: Optional[dict] = None) -> None:
        """Finish a root: stamp the wall, retain per sampling, capture
        into the slow ring when over ``geomesa.obs.slow.ms``. Metrics
        (retention counters) record after the lock is released."""
        if trace is None:
            return
        trace.root.finish()
        slow_ms = conf.OBS_SLOW_MS.get()
        is_slow = slow_ms > 0 and trace.wall_s * 1e3 >= slow_ms
        retained = trace.retain
        if not (retained or is_slow):
            return
        entry = None
        if is_slow:
            entry = {
                "captured_at": trace.t_wall,
                "wall_ms": round(trace.wall_s * 1e3, 3),
                "fingerprint": fingerprint or trace.fingerprint or {},
                "trace": trace.to_dict(),
            }
        with self._lock:
            if retained:
                self.buffer.append(trace)
            if entry is not None:
                self.slow.append(entry)
                cap = max(int(conf.OBS_SLOW_MAX.get()), 1)
                if len(self.slow) > cap:
                    del self.slow[: len(self.slow) - cap]
        # retention counters land on the configured registry, or the
        # process-global fallback like every other unconfigured
        # component — recorded AFTER the tracer lock releases (rank 76
        # -> 80, the declared order)
        from geomesa_tpu_torch.metrics import resolve

        m = resolve(self.metrics)
        if retained:
            m.counter("geomesa.obs.traces")
        if is_slow:
            m.counter("geomesa.obs.slow_queries")

    def trace(self, name: str, **attrs):
        """``begin`` + activate + ``end`` as one context manager,
        yielding the Trace (or None when disarmed)."""
        return _RootCtx(self, name, attrs)

    # -- propagation ------------------------------------------------------
    def current(self) -> Optional[Span]:
        return getattr(_tls, "span", None)

    def span(self, name: str, **attrs):
        """A child span under this thread's active span — the hot-path
        entry: one thread-local probe and the shared null context when
        untraced."""
        cur = getattr(_tls, "span", None)
        if cur is None:
            return NULL_SPAN
        return _SpanCtx(Span(cur.trace, name, cur.span_id, attrs or None))

    def activate(self, span: Optional[Span]):
        """Adopt an existing span as this thread's active context (the
        scheduler dispatcher / flush-worker hop); no-op on None."""
        return _Activation(span)

    def add_span(self, parent: Optional[Span], name: str, t0: float,
                 end: float, **attrs) -> Optional[Span]:
        """Record a phase measured elsewhere (queue wait between
        threads): explicit start/end, finished immediately."""
        if parent is None:
            return None
        s = Span(parent.trace, name, parent.span_id, attrs or None, t0=t0)
        s.finish(end=end)
        return s

    # -- surfaces ---------------------------------------------------------
    def traces(self) -> list[Trace]:
        with self._lock:
            return self.buffer.items()

    def slow_queries(self, type_name: "str | None" = None) -> list[dict]:
        """The slow-query ring, newest last: each entry carries the
        wall, the plan fingerprint and the full span tree.
        ``type_name`` filters to captures whose fingerprint names that
        schema (ops-plane ``/debug/slow?type=``)."""
        with self._lock:
            out = [dict(e) for e in self.slow]
        if type_name is not None:
            out = [
                e for e in out
                if e.get("fingerprint", {}).get("type") == type_name
            ]
        return out

    def reset(self) -> None:
        with self._lock:
            self.buffer = TraceBuffer(conf.OBS_TRACE_BUFFER.get())
            self.slow = []
            self._n_roots = 0

    def chrome_payload(self) -> dict:
        """Every retained trace (buffer + slow ring, deduped by trace
        id) as a Chrome trace-event payload — the ``/debug/trace``
        body, and what :meth:`dump` writes."""
        with self._lock:
            traces = self.buffer.items()
            slow = [e["trace"] for e in self.slow]
        events = []
        for tr in traces:
            events.extend(_chrome_events(tr.to_dict()))
        seen = {tr.trace_id for tr in traces}
        for td in slow:
            if td["trace_id"] not in seen:
                events.extend(_chrome_events(td))
        return {"traceEvents": events}

    def dump(self, path: str) -> str:
        """Write every retained trace (buffer + slow ring) as Chrome
        trace-event JSON — openable in chrome://tracing or Perfetto —
        and return the path."""
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.chrome_payload(), fh, indent=1)
        return path


class _RootCtx:
    __slots__ = ("_tracer", "_name", "_attrs", "_trace", "_act")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._trace = None
        self._act = None

    def __enter__(self) -> Optional[Trace]:
        self._trace = self._tracer.begin(self._name, **self._attrs)
        if self._trace is not None:
            self._act = _Activation(self._trace.root)
            self._act.__enter__()
        return self._trace

    def __exit__(self, *exc) -> None:
        if self._act is not None:
            self._act.__exit__(*exc)
        self._tracer.end(self._trace)


def _chrome_events(td: dict) -> list[dict]:
    """Chrome trace-event ``ph:"X"`` complete events for one trace
    dict, pid = trace id (one lane per trace), ts in Unix-epoch
    microseconds, the span's thread id in ``args``."""
    out = []
    for s in td["spans"]:
        out.append({
            "name": s["name"],
            "ph": "X",
            "pid": td["trace_id"],
            "tid": 0 if s["parent_id"] is None else s["parent_id"],
            "ts": round(td["t0_epoch_us"] + s["start_ms"] * 1e3, 1),
            "dur": round(s["dur_ms"] * 1e3, 1),
            "args": {**s.get("attrs", {}), "tid": s["tid"]},
        })
    return out


def phase_breakdown(trace: Optional[Trace]) -> list[str]:
    """Human-readable top-level phase lines for explain trails:
    ``trace: <phase> <dur>ms`` per phase plus the covered fraction."""
    if trace is None or trace.wall_s <= 0:
        return []
    lines = []
    covered = 0.0
    for s in trace.phases():
        covered += s.dur_s
        lines.append(f"trace: {s.name} {s.dur_s * 1e3:.3f}ms")
    lines.append(
        f"trace: wall {trace.wall_s * 1e3:.3f}ms, phases cover "
        f"{100.0 * covered / trace.wall_s:.1f}%"
    )
    return lines


# the installed process tracer; install() swaps it (tests install a
# fresh instance to start from empty rings)
TRACER = Tracer()


def tracer() -> Tracer:
    """The installed process :class:`Tracer`."""
    return TRACER


def install(t: Tracer) -> Tracer:
    """Replace the installed tracer (tests; custom retention) and
    return it."""
    global TRACER
    TRACER = t
    return t


def span(name: str, **attrs):
    """Module-level child-span helper — ``obs.span("scan")`` from any
    hot path; the disarmed cost is one thread-local probe."""
    return TRACER.span(name, **attrs)
