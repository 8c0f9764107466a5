"""Per-phase time of the scan path, and the serving path's stage clock.

A DataStore carries a clock (``NULL_CLOCK`` by default, which records
nothing and reads no clock). ``PhaseClock`` splits query time into host
phases, timed by the wall clock, and device phases, timed by CUDA events
on the current stream (h2d, kernel, d2h). Device spans settle after the
stream has passed them, so recording them never synchronizes the query.
On CPU tensors the device phases are timed by the wall clock. One clock
is entered from every client thread and the scheduler's dispatcher, so
every update is locked; ``settle()`` may run while others record.

``settle()`` gives one dict of name -> number: seconds, except the names
that start with ``n.``, which are counts. The names:

- host phases (``host``, or ``launching`` where the block launches
  device work; a ``phase.<name>`` profiler range while a profiler
  records): ``plan`` (a client thread's planning, wall time),
  ``dispatch`` (the scheduler's ``submit_many``: pruning, packing, the
  launches), ``decode`` (bit planes to rows, gather), ``refine`` (f64
  tests of the uncertain rows), ``post`` (visibility, sample, sort,
  page, projection);
- device phases (``device``): ``h2d``, ``kernel``, ``d2h``;
- stages measured after the fact (``add``; no profiler range):
  ``queue`` (enqueue to the dispatcher's drain, the micro-batch window
  included), ``batch.wait`` (a fused batch's dispatch to this member's
  turn in the dispatcher's pull loop), ``dispatcher`` (the dispatcher
  thread's busy time: each ``_dispatch(batch)``);
- ``plan.cpu``: the planning thread's CPU time (``thread_cpu``);
- ``cpu``: the process's CPU time from the clock's construction to
  ``settle()``;
- ``gc``: the collector's pauses while the clock lives (``gc.callbacks``,
  held weakly; a ``phase.gc`` profiler range while a profiler records);
- counts (``count``): ``n.memo.hit`` / ``n.memo.miss`` (the planner's
  scan-config memo), ``n.rows.matched`` (rows after refinement),
  ``n.rows.scanned`` (rows of the candidate blocks handed to a kernel),
  ``n.launch.single`` (K1 launches) and ``n.launch.fused`` (K2 launches).

``event_ms`` and ``wall_ms`` are the one timer of the chip-side
measurements (chip_smoke.py, the probes in geomesa_tpu_torch/scripts/):
the median of ``TIMED_RUNS`` runs after a warm-up (``statistics.median``); ``max_abs_err`` is
their one comparison of a kernel with its plain version. ``queued_ms``
times calls queued back to back, which ``kernel_ab`` reports beside
``event_ms`` to show how much of a short kernel's time is the host's
submission.
"""

from __future__ import annotations

import gc
import statistics
import threading
import time
import weakref
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch

TIMED_RUNS = 25
EVENT_WARMUP = 3
WALL_WARMUP = 2


class PhaseClock:
    """Accumulated seconds per phase name, and counts (module doc)."""

    armed = True

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self._pending: list = []
        # every update of seconds and _pending, and settle(), hold it; a
        # subclass may keep a lock of its own under the name _lock
        self._guard = threading.Lock()
        self._cpu0 = time.process_time()
        # the collector's pauses: written only by the gc callback (one
        # collection runs at a time), so they take no lock a thread
        # that allocates may already hold
        self._gc_s = 0.0
        self._gc_t0: "float | None" = None
        self._gc_range = None
        ref = weakref.ref(self)

        def on_gc(phase, info):
            clock = ref()
            if clock is not None:
                clock._on_gc(phase)

        gc.callbacks.append(on_gc)
        weakref.finalize(self, _remove_gc_callback, on_gc)

    @contextmanager
    def host(self, name: str):
        rf = _profiler_range(f"phase.{name}")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            with self._guard:
                self.seconds[name] += dt

    # a host phase whose block launches device work (the scheduler's
    # ``dispatch``): the base ``host`` even where a subclass overrides it,
    # since a user-annotation range around kernels is mirrored onto the
    # device's timeline and would read as device activity
    launching = host

    @contextmanager
    def device(self, name: str, device: torch.device):
        if device.type != "cuda":
            with self.host(name):
                yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            with self._guard:
                self._pending.append((name, start, end))

    @contextmanager
    def thread_cpu(self, name: str):
        """The calling thread's CPU time over the block, under ``name``."""
        t0 = time.thread_time()
        try:
            yield
        finally:
            self.add(name, time.thread_time() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Seconds of a stage measured after the fact, across threads
        (no profiler range: a wait claims no idle gap of the trace)."""
        with self._guard:
            self.seconds[name] += seconds

    def count(self, name: str, n: int = 1) -> None:
        """A tally, under a name that starts with ``n.``."""
        with self._guard:
            self.seconds[name] = self.seconds.get(name, 0) + n

    def _on_gc(self, phase: str) -> None:
        if phase == "start":
            self._gc_range = _profiler_range("phase.gc")
            self._gc_t0 = time.perf_counter()
            return
        if self._gc_t0 is not None:
            self._gc_s += time.perf_counter() - self._gc_t0
            self._gc_t0 = None
        rf, self._gc_range = self._gc_range, None
        if rf is not None:
            rf.__exit__(None, None, None)

    def settle(self) -> dict[str, float]:
        """Fold finished device spans in; returns seconds per phase (and
        the counts, module doc)."""
        with self._guard:
            for name, start, end in self._pending:
                end.synchronize()
                self.seconds[name] += start.elapsed_time(end) / 1e3
            self._pending.clear()
            out = dict(self.seconds)
        out["cpu"] = time.process_time() - self._cpu0
        out["gc"] = self._gc_s
        return out


def _remove_gc_callback(cb) -> None:
    try:
        gc.callbacks.remove(cb)
    except ValueError:
        pass


def _profiler_range(name: str):
    """An entered profiler range while a profiler records, else None. An
    operator range (``cpu_op``), not a ``record_function`` user
    annotation: the profiler mirrors a user annotation onto the device's
    timeline over the kernels it encloses."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return None
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


_NULL = nullcontext()


class _NullClock:
    """The clock that records nothing."""

    armed = False

    def host(self, name: str):
        return _NULL

    launching = host

    def device(self, name: str, device):
        return _NULL

    def thread_cpu(self, name: str):
        return _NULL

    def add(self, name: str, seconds: float) -> None:
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass


NULL_CLOCK = _NullClock()


def event_ms(fn, runs: int = TIMED_RUNS, warmup: int = EVENT_WARMUP) -> float:
    """Median device time in ms of ``fn()`` over ``runs`` calls, each
    between two CUDA events on the current stream, after ``warmup`` calls
    (fewer of both for plain versions that take seconds). Needs a CUDA
    device: a CPU has no device time to read."""
    if not torch.cuda.is_available():
        raise RuntimeError("event_ms times a CUDA device; there is none")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, launches: int = 20, runs: int = 5) -> float:
    """Median device time in ms a call of ``fn()`` over ``runs`` runs of
    ``launches`` calls queued back to back between two CUDA events: unlike
    :func:`event_ms`, the host's time to submit a call hides behind the
    calls queued ahead of it, so a short kernel's time is the device's
    alone."""
    if not torch.cuda.is_available():
        raise RuntimeError("queued_ms times a CUDA device; there is none")
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def wall_ms(fn) -> float:
    """Median host wall time in ms of ``fn()`` over ``TIMED_RUNS`` calls
    after ``WALL_WARMUP`` calls; ``fn`` itself waits for whatever device
    work it needs (a device-to-host copy does)."""
    for _ in range(WALL_WARMUP):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the elements (0 where equal, infinities
    included): how a kernel's output is held against its plain version."""
    d = (a.double() - b.double()).abs()
    d[a == b] = 0
    return float(d.max()) if d.numel() else 0.0
