"""Dynamic lock witness: prove the static lock model against reality.

The port's copy of geomesa_tpu/lockwitness.py. The static tier
(``analysis/lockmodel.py`` + the concurrency rules) derives the
lock-acquisition graph from the AST and checks it against the declared
rank order. A static model can drift from runtime truth in both
directions: an edge real control flow takes through a callback the AST
cannot resolve, or a registry entry for a lock nothing ever acquires.
This module closes the loop: every
:data:`~geomesa_tpu_torch.analysis.lockmodel.LOCKS` lock is constructed
through :func:`witness`, and when the witness is ARMED
(``geomesa.tpu.lock.witness`` / env ``GEOMESA_TPU_LOCK_WITNESS=1``, or
:func:`enable` in a test) the lock wraps in a recording proxy:

- every acquisition while other witnessed locks are held records an
  acquisition-order EDGE ``held -> acquired`` (per thread, via a
  thread-local held stack; re-entrant re-acquisition of the same
  instance records nothing);
- two DISTINCT instances under the same name nesting records an
  ``aliased`` event instead of an edge (an instance-order hazard the
  name-level graph cannot express);
- every :func:`geomesa_tpu_torch.fault.fault_point` reached while a
  witnessed lock is held records a ``blocking`` event (fault points mark
  the IO and latency steps).

``tests/test_torch_lockwitness.py`` drives workloads over the
concurrent tiers under an armed witness and asserts both directions:
every registry lock was witnessed, the observed graph is acyclic, and
it is a subgraph of the static model's predicted edges (AST-derived +
declared callback edges). :func:`dump` writes the observed graph to
``geomesa.tpu.lock.witness.artifact`` (default
``/tmp/lock_witness.json``), or to the path it is given.

Disarmed (the default), :func:`witness` returns the lock it was given:
no wrapper sits in the acquire path. Armed, the cost is one
thread-local list push and pop per acquire plus a dict probe per new
edge.

This module records NO metrics (the MetricsRegistry lock is itself
witnessed, so instrumenting the witness would recurse) and imports
nothing heavier than conf.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from geomesa_tpu_torch import conf

#: module-level arm flag, mirrored by enable()/disable(); read on the
#: witness() construction path and by fault.fault_point's blocking hook
ENABLED: bool = bool(conf.LOCK_WITNESS.get())

_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


class WitnessReport:
    """The process-global observation collector."""

    def __init__(self):
        self._lock = threading.Lock()
        self.edges: dict[tuple[str, str], int] = {}     # guarded-by: _lock
        self.aliased: dict[tuple[str, str], int] = {}   # guarded-by: _lock
        self.seen: set[str] = set()                     # guarded-by: _lock
        self.blocking: dict[tuple[str, str], int] = {}  # guarded-by: _lock

    def reset(self) -> None:
        with self._lock:
            self.edges = {}
            self.aliased = {}
            self.seen = set()
            self.blocking = {}

    def note_acquire(self, name: str, key: int) -> None:
        stack = _stack()
        pairs = []
        aliased = []
        fresh = name not in self.seen
        for held_name, held_key in stack:
            if held_name == name:
                if held_key != key:
                    aliased.append((held_name, name))
                continue
            pairs.append((held_name, name))
        if fresh or pairs or aliased:
            with self._lock:
                self.seen.add(name)
                for p in pairs:
                    self.edges[p] = self.edges.get(p, 0) + 1
                for p in aliased:
                    self.aliased[p] = self.aliased.get(p, 0) + 1
        stack.append((name, key))

    def note_release(self, name: str, key: int) -> None:
        stack = _stack()
        # LIFO in practice; an out-of-order release removes the LAST
        # matching frame
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == (name, key):
                del stack[i]
                return

    def note_blocking(self, point: str) -> None:
        stack = _stack()
        if not stack:
            return
        held = tuple(sorted({n for n, _ in stack}))
        with self._lock:
            for h in held:
                k = (h, point)
                self.blocking[k] = self.blocking.get(k, 0) + 1

    # -- analysis ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seen": sorted(self.seen),
                "edges": sorted(self.edges),
                "edge_counts": {
                    f"{a} -> {b}": n for (a, b), n in sorted(self.edges.items())
                },
                "aliased": {
                    f"{a} ~ {b}": n for (a, b), n in sorted(self.aliased.items())
                },
                "blocking": {
                    f"{lock} @ {point}": n
                    for (lock, point), n in sorted(self.blocking.items())
                },
            }

    def cycle(self) -> Optional[list[str]]:
        """One observed acquisition-order cycle (as a lock-name path), or
        None. Self-loops cannot occur: same-name pairs are recorded as
        aliased, never as edges."""
        with self._lock:
            graph: dict[str, set[str]] = {}
            for a, b in self.edges:
                graph.setdefault(a, set()).add(b)
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        path: list[str] = []

        def dfs(n: str) -> Optional[list[str]]:
            color[n] = GRAY
            path.append(n)
            for m in sorted(graph.get(n, ())):
                c = color.get(m, WHITE)
                if c == GRAY:
                    return path[path.index(m):] + [m]
                if c == WHITE:
                    found = dfs(m)
                    if found is not None:
                        return found
            path.pop()
            color[n] = BLACK
            return None

        for n in sorted(graph):
            if color[n] == WHITE:
                found = dfs(n)
                if found is not None:
                    return found
        return None


REPORT = WitnessReport()


class _WitnessedLock:
    """Recording proxy over a Lock/RLock. Delegates everything; the
    held-stack bookkeeping happens on a successful acquire and release."""

    __slots__ = ("_inner", "_name")

    def __init__(self, inner, name: str):
        self._inner = inner
        self._name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            REPORT.note_acquire(self._name, id(self._inner))
        return ok

    def release(self) -> None:
        self._inner.release()
        REPORT.note_release(self._name, id(self._inner))

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _WitnessedCondition(_WitnessedLock):
    """Recording proxy over a Condition: wait() releases the underlying
    lock, so the held frame pops for the wait and pushes again after
    (without recording edges: the held set across a wait was recorded at
    the original acquire)."""

    __slots__ = ()

    def _pop_frames(self) -> int:
        stack = _stack()
        key = (self._name, id(self._inner))
        n = 0
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == key:
                del stack[i]
                n += 1
        return n

    def _push_frames(self, n: int) -> None:
        stack = _stack()
        key = (self._name, id(self._inner))
        for _ in range(n):
            stack.append(key)

    def wait(self, timeout: Optional[float] = None) -> bool:
        n = self._pop_frames()
        try:
            return self._inner.wait(timeout)
        finally:
            self._push_frames(max(n, 1))

    def wait_for(self, predicate, timeout: Optional[float] = None):
        n = self._pop_frames()
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._push_frames(max(n, 1))

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def witness(lock, name: str):
    """Wrap one declared lock in the recording proxy when the witness is
    armed; return it unchanged otherwise. ``name`` is ``Class.attr``,
    the reference's registry key for the same lock."""
    if not ENABLED:
        return lock
    if isinstance(lock, threading.Condition):
        return _WitnessedCondition(lock, name)
    return _WitnessedLock(lock, name)


def note_blocking(point: str) -> None:
    """fault.fault_point's hook: a fault point (an IO or latency step)
    was reached; record it against every witnessed lock now held."""
    if ENABLED:
        REPORT.note_blocking(point)


def held_locks() -> tuple:
    """The witnessed locks the CALLING thread holds now (tests)."""
    return tuple(n for n, _ in _stack())


def enable(reset: bool = True) -> None:
    """Arm the witness for locks constructed FROM NOW ON (existing
    objects keep their bare locks: construct the workload's stores after
    arming)."""
    global ENABLED
    ENABLED = True
    if reset:
        REPORT.reset()


def disable() -> None:
    global ENABLED
    ENABLED = False


def dump(path: "str | None" = None) -> str:
    """Write the observed graph and events as JSON to ``path`` (default:
    the ``geomesa.tpu.lock.witness.artifact`` knob) and return the
    path."""
    if path is None:
        path = str(conf.LOCK_WITNESS_ARTIFACT.get())
    payload = REPORT.snapshot()
    payload["cycle"] = REPORT.cycle()
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
    return path
