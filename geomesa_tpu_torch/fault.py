"""Fault injection and bounded retry for the persistence boundary.

The port's copy of geomesa_tpu/fault.py. Named fault points mark every
IO step of the persist and load path, the catalog's file writes, the
adapter's table builds and the incremental fold, where tests (or an
operator, through the environment) can inject IO errors, simulated
crashes, partial writes, bit flips or latency.

Fault kinds:

- ``io_error``  raises :class:`InjectedIOError` (an ``OSError``;
  *transient*, absorbed by :func:`with_retries`);
- ``crash``     raises :class:`InjectedCrash` (a ``BaseException``: no
  retry or ``except Exception`` handler survives it, like a real
  ``kill -9`` in the middle of a save);
- ``partial_write`` truncates the file at the fault point to half its
  bytes, then crashes (a torn write);
- ``bit_flip``  flips one bit of the file at the fault point and
  *continues* (silent media corruption, caught later by checksums);
- ``latency``   sleeps ``delay_s`` and continues.

Usage (tests)::

    with fault.inject("persist.manifest.rename", kind="crash"):
        persist.save(store, root)   # raises InjectedCrash at that point

Usage (environment)::

    GEOMESA_TPU_FAULTS="persist.partition.write:io_error:0:1"

comma-separated ``point:kind[:after[:times[:delay_s]]]`` entries
(``times`` ``-1`` = every hit; ``delay_s`` is the sleep of ``latency``
faults; empty fields take their defaults, e.g.
``persist.*:latency::-1:0.05``); ``point`` is an ``fnmatch`` pattern.
Retry tuning: ``GEOMESA_TPU_IO_RETRIES`` (attempts, default 3) and
``GEOMESA_TPU_IO_BACKOFF_S`` (initial backoff, default 0.01; the sleeps
use decorrelated jitter). These variables arm faults and tune retries;
none selects a kernel or a backend. ``geomesa.fault.retry`` counts every
absorbed transient failure and ``geomesa.fault.retries_exhausted`` every
operation that failed past its budget.

Seeded background chaos::

    with fault.chaos(seed=7, rate=0.02, points="persist.*"):
        run_workload()

fires random faults from a deterministic (seeded) schedule at every
matching fault point while the workload runs.
"""

from __future__ import annotations

import fnmatch
import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from geomesa_tpu_torch import lockwitness as _lockwitness

DEFAULT_RETRIES = 3
DEFAULT_BACKOFF_S = 0.01

KINDS = ("io_error", "crash", "partial_write", "bit_flip", "latency")


class InjectedIOError(OSError):
    """A transient injected IO failure — retryable (an OSError)."""


class InjectedCrash(BaseException):
    """Simulated process death at a fault point. Derives from
    ``BaseException`` so neither :func:`with_retries` nor a blanket
    ``except Exception`` can ride over it — the operation aborts exactly
    where a real kill would leave it."""


@dataclass
class FaultSpec:
    """One armed fault: fires at fault points matching ``point``."""

    point: str                    # fnmatch pattern over fault-point names
    kind: str = "io_error"
    after: int = 0                # skip the first ``after`` matching hits
    times: Optional[int] = 1     # fire at most this many times (None = every hit)
    delay_s: float = 0.0          # latency kind
    hits: int = field(default=0, repr=False)
    fired: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {KINDS})")


def _corrupt_file(path: Optional[str], kind: str) -> None:
    """Apply on-disk damage for partial_write/bit_flip kinds; a fault
    point without a file path degrades to the no-damage behavior."""
    if path is None or not os.path.exists(path):
        return
    size = os.path.getsize(path)
    if size == 0:
        return
    if kind == "partial_write":
        with open(path, "rb+") as fh:
            fh.truncate(size // 2)
    else:  # bit_flip
        with open(path, "rb+") as fh:
            fh.seek(size // 2)
            b = fh.read(1)
            fh.seek(size // 2)
            fh.write(bytes([b[0] ^ 0x40]))


class ChaosSpec:
    """A seeded random fault schedule: at every fault point matching one
    of ``points`` (comma-separated fnmatch patterns), fire with
    probability ``rate``, picking the kind uniformly from ``kinds``
    (repeat a kind to weight it). Deterministic: the schedule is a pure
    function of the seed and the sequence of matching hits — rerunning
    the same single-threaded workload replays the same faults; under
    concurrency the hit ORDER may interleave differently, but the
    decision stream itself never changes."""

    def __init__(self, seed: int, rate: float = 0.02,
                 points: str = "stream.*,streaming.*,persist.*",
                 kinds: tuple = ("io_error", "latency"),
                 delay_s: float = 0.001):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"chaos rate must be in [0, 1], got {rate!r}")
        for k in kinds:
            if k not in KINDS:
                raise ValueError(f"unknown fault kind {k!r} (one of {KINDS})")
        self.seed = int(seed)
        self.rate = float(rate)
        self.patterns = tuple(
            p.strip() for p in str(points).split(",") if p.strip()
        )
        self.kinds = tuple(kinds)
        self.delay_s = float(delay_s)
        self._rng = random.Random(self.seed)
        self._lock = _lockwitness.witness(threading.Lock(), "ChaosSpec._lock")
        self.hits = 0   # guarded-by: _lock
        self.fired = 0  # guarded-by: _lock
        self.log: list[tuple[int, str, str]] = []  # guarded-by: _lock

    def decide(self, point: str) -> Optional[str]:
        """The kind to fire at this hit, or None. One rng draw per
        MATCHING hit (so the schedule depends only on the matching-hit
        sequence, not on unrelated fault points)."""
        if not any(fnmatch.fnmatch(point, p) for p in self.patterns):
            return None
        with self._lock:
            self.hits += 1
            if self._rng.random() >= self.rate:
                return None
            kind = self._rng.choice(self.kinds)
            self.fired += 1
            self.log.append((self.hits, point, kind))
            return kind


class FaultInjector:
    """Registry of armed :class:`FaultSpec`s (and at most one
    :class:`ChaosSpec`), consulted at every :func:`fault_point`.
    Process-global; deterministic (specs fire by hit count, chaos by a
    seeded schedule — nothing draws from global randomness)."""

    def __init__(self):
        self.specs: list[FaultSpec] = []
        self.chaos_spec: Optional[ChaosSpec] = None

    def install(self, spec: FaultSpec) -> FaultSpec:
        self.specs.append(spec)
        return spec

    def remove(self, spec: FaultSpec) -> None:
        if spec in self.specs:
            self.specs.remove(spec)

    def install_chaos(self, spec: ChaosSpec) -> ChaosSpec:
        if self.chaos_spec is not None:
            raise RuntimeError("a chaos schedule is already installed")
        self.chaos_spec = spec
        return spec

    def remove_chaos(self, spec: ChaosSpec) -> None:
        if self.chaos_spec is spec:
            self.chaos_spec = None

    def reset(self) -> None:
        self.specs.clear()
        self.chaos_spec = None

    @property
    def armed(self) -> bool:
        return bool(self.specs) or self.chaos_spec is not None

    def load_env(self, env: Optional[dict] = None, strict: bool = True) -> list[FaultSpec]:
        """Arm faults from ``GEOMESA_TPU_FAULTS`` (see module docstring);
        returns the installed specs so callers can remove them.
        ``strict=False`` (the import-time mode): a malformed entry is
        logged and skipped instead of raised — a chaos-config typo must
        not turn into an import failure of the whole library."""
        raw = (env if env is not None else os.environ).get("GEOMESA_TPU_FAULTS", "")
        out: list[FaultSpec] = []
        for entry in filter(None, (e.strip() for e in raw.split(","))):
            try:
                parts = entry.split(":")
                if len(parts) < 2:
                    raise ValueError("need point:kind")

                def _field(i: int, default, conv):
                    return conv(parts[i]) if len(parts) > i and parts[i] else default

                times = _field(3, 1, int)
                spec = FaultSpec(
                    point=parts[0],
                    kind=parts[1],
                    after=_field(2, 0, int),
                    times=None if times < 0 else times,
                    delay_s=_field(4, 0.0, float),
                )
            except ValueError as e:
                if strict:
                    raise ValueError(
                        f"bad GEOMESA_TPU_FAULTS entry {entry!r}: {e}"
                    ) from e
                import logging

                logging.getLogger(__name__).warning(
                    "ignoring bad GEOMESA_TPU_FAULTS entry %r: %s", entry, e
                )
                continue
            out.append(self.install(spec))
        return out

    def on(self, point: str, path: Optional[str] = None) -> None:
        """Fire any armed spec (then the chaos schedule) matching this
        fault point."""
        for spec in list(self.specs):
            if not fnmatch.fnmatch(point, spec.point):
                continue
            spec.hits += 1
            if spec.hits <= spec.after:
                continue
            if spec.times is not None and spec.fired >= spec.times:
                continue
            spec.fired += 1
            _fire(spec.kind, point, path, spec.delay_s)
        chaos_spec = self.chaos_spec
        if chaos_spec is not None:
            kind = chaos_spec.decide(point)
            if kind is not None:
                _fire(kind, point, path, chaos_spec.delay_s)


def _fire(kind: str, point: str, path: Optional[str], delay_s: float) -> None:
    """Apply one fault kind at a point (shared by armed specs and the
    chaos schedule)."""
    if kind == "latency":
        time.sleep(delay_s)
    elif kind == "io_error":
        raise InjectedIOError(f"injected IO error at {point}")
    elif kind == "bit_flip":
        _corrupt_file(path, "bit_flip")
    elif kind == "partial_write":
        _corrupt_file(path, "partial_write")
        raise InjectedCrash(f"injected crash (partial write) at {point}")
    else:  # crash
        raise InjectedCrash(f"injected crash at {point}")


_GLOBAL = FaultInjector()
_GLOBAL.load_env(strict=False)


def fsync_dir(path: str) -> None:
    """Durably record a rename in its directory — the second half of the
    tmp+``os.replace`` discipline every durable writer here uses
    (best-effort: not every platform/filesystem supports directory
    fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes, point: Optional[str] = None) -> None:
    """The durable-write ritual every writer here shares: ``<path>.tmp``
    + flush + fsync + ``os.replace`` + directory fsync — no reader ever
    sees a torn file under the final name. ``point`` names the two
    fault-injectable steps, both targeting the TMP file: ``<point>.write``
    fires before any bytes land (damage kinds no-op on the not-yet-written
    tmp), ``<point>.rename`` fires after the full write, just before the
    replace — a damage kind there simulates corruption in flight, which
    commits and is caught later only where a checksum covers the file."""
    tmp = path + ".tmp"
    if point is not None:
        fault_point(f"{point}.write", tmp)
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    if point is not None:
        fault_point(f"{point}.rename", tmp)
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def injector() -> FaultInjector:
    """The process-global injector (env-armed at import)."""
    return _GLOBAL


def fault_point(name: str, path: Optional[str] = None) -> None:
    """Mark an injectable point; no-op unless a matching fault (or a
    chaos schedule) is armed. ``path``: the file the point is about to
    (or just did) touch — the target for partial_write/bit_flip damage.

    Fault points mark exactly the IO/latency steps, so they double as
    the lock witness's held-while-blocking probes: with the witness
    armed (lockwitness), reaching one while a witnessed lock is held
    records a blocking event."""
    if _lockwitness.ENABLED:
        _lockwitness.note_blocking(name)
    if _GLOBAL.armed:
        _GLOBAL.on(name, path)


@contextmanager
def inject(
    point: str,
    kind: str = "io_error",
    after: int = 0,
    times: Optional[int] = 1,
    delay_s: float = 0.0,
) -> Iterator[FaultSpec]:
    """Arm one fault for the duration of a ``with`` block."""
    spec = _GLOBAL.install(
        FaultSpec(point=point, kind=kind, after=after, times=times, delay_s=delay_s)
    )
    try:
        yield spec
    finally:
        _GLOBAL.remove(spec)


@contextmanager
def chaos(
    seed: int,
    rate: float = 0.02,
    points: str = "stream.*,streaming.*,persist.*",
    kinds: tuple = ("io_error", "latency"),
    delay_s: float = 0.001,
) -> Iterator[ChaosSpec]:
    """Arm a seeded background chaos schedule for the duration of a
    ``with`` block (at most one at a time): every fault point matching
    ``points`` fires with probability ``rate``, kind drawn from
    ``kinds``. The schedule is a pure function of ``seed``. Yields the spec so callers can
    inspect ``hits`` / ``fired`` / ``log`` afterwards."""
    spec = _GLOBAL.install_chaos(
        ChaosSpec(seed, rate=rate, points=points, kinds=kinds, delay_s=delay_s)
    )
    try:
        yield spec
    finally:
        _GLOBAL.remove_chaos(spec)


def with_retries(
    fn: Callable,
    attempts: Optional[int] = None,
    backoff_s: Optional[float] = None,
    retry_on: tuple = (OSError,),
    sleep: Callable = time.sleep,
    metrics=None,
    rng: Optional[Callable] = None,
    max_elapsed_s: Optional[float] = None,
):
    """Run ``fn()`` with bounded decorrelated-jitter retries on transient
    IO errors. :class:`InjectedCrash` is a BaseException and always
    propagates — a crash is not a transient fault.

    Backoff: decorrelated jitter — ``sleep_i ~ U(base, min(cap,
    3 * sleep_{i-1}))`` with ``cap = base * 2**(attempts - 1)`` — so N
    concurrent flush workers tripping over the same transient point
    spread their retries instead of re-colliding in exponential
    lockstep (the thundering-herd fix). ``rng(lo, hi)`` overrides the
    draw for deterministic tests (default: ``random.uniform``).

    ``max_elapsed_s`` is a TOTAL elapsed-time budget on top of the
    attempt count: once ``fn()`` has been failing for that long, the
    next transient failure re-raises immediately instead of sleeping —
    an io_error storm can no longer spin a caller in backoff far past
    its deadline. The budget is checked between attempts, never
    mid-``fn()``.

    Observability: ``geomesa.fault.retry`` counts every absorbed
    transient failure, ``geomesa.fault.retries_exhausted`` every
    operation re-raised past its attempt budget;
    ``geomesa.fault.retry.giveup.ms`` records (in seconds, histogram
    convention) the total time burned whenever EITHER budget gives up;
    ``metrics`` is a MetricsRegistry (None = the process-global
    fallback)."""
    from geomesa_tpu_torch.metrics import resolve

    if attempts is None:
        attempts = int(os.environ.get("GEOMESA_TPU_IO_RETRIES", DEFAULT_RETRIES))
    if backoff_s is None:
        backoff_s = float(
            os.environ.get("GEOMESA_TPU_IO_BACKOFF_S", DEFAULT_BACKOFF_S)
        )
    if rng is None:
        rng = random.uniform
    attempts = max(1, attempts)
    cap = backoff_s * (2 ** (attempts - 1))
    prev = backoff_s
    t0 = time.monotonic()
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on:
            elapsed = time.monotonic() - t0
            if attempt == attempts - 1 or (
                max_elapsed_s is not None and elapsed >= max_elapsed_s
            ):
                resolve(metrics).counter("geomesa.fault.retries_exhausted")
                resolve(metrics).observe(
                    "geomesa.fault.retry.giveup.ms", elapsed
                )
                raise
            resolve(metrics).counter("geomesa.fault.retry")
            prev = rng(backoff_s, max(min(cap, prev * 3), backoff_s))
            sleep(prev)
