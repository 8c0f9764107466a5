"""Per-phase time of the scan path.

A DataStore carries a clock (``NULL_CLOCK`` by default, which records
nothing). ``PhaseClock`` splits query time into host phases, timed by the
wall clock (plan, decode, refine), and device phases, timed by CUDA events
on the current stream (h2d, kernel, d2h). Device spans settle after the
stream has passed them, so recording them never synchronizes the query.
On CPU tensors the device phases are timed by the wall clock.

``event_ms`` and ``wall_ms`` are the one timer of the chip-side
measurements (chip_smoke.py, the probes in geomesa_tpu_torch/scripts/):
the median of ``TIMED_RUNS`` runs after a warm-up (``statistics.median``); ``max_abs_err`` is
their one comparison of a kernel with its plain version.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch

TIMED_RUNS = 25
EVENT_WARMUP = 3
WALL_WARMUP = 2


class PhaseClock:
    """Accumulated seconds per phase name."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self._pending: list = []

    @contextmanager
    def host(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0

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
            self._pending.append((name, start, end))

    def settle(self) -> dict[str, float]:
        """Fold finished device spans in; returns seconds per phase."""
        for name, start, end in self._pending:
            end.synchronize()
            self.seconds[name] += start.elapsed_time(end) / 1e3
        self._pending.clear()
        return dict(self.seconds)


class _NullClock:
    """The clock that records nothing."""

    def host(self, name: str):
        return nullcontext()

    def device(self, name: str, device):
        return nullcontext()


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
