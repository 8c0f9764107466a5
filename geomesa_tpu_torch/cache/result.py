"""Result cache: LRU + TTL + cost-aware admission + single-flight.

The port's copy of geomesa_tpu/cache/result.py. Entries are materialized
FeatureCollections keyed by canonical fingerprints (cache.fingerprint);
the port's collections hold host numpy arrays, so an entry never aliases
a device tensor a later fold frees. Correctness comes from generation
validation at serve time (cache.generations): an entry overlapping any
newer mutation is dropped, never served.

- LRU over a byte budget (pinned entries skip eviction, not validation);
- TTL: entries past ``ttl_s`` compute again even when generations are
  clean (an operator hedge against bugs in bump coverage);
- cost-aware admission: only results whose measured scan took at least
  ``min_cost_s`` are admitted;
- single-flight: N concurrent identical queries coalesce onto one scan.
  The leader computes; waiters block on its flight and share the result
  after checking its start tick again (a write landing mid-flight makes
  late waiters compute rather than adopt a pre-write snapshot).

Metrics (counters unless noted): geomesa.cache.hit / .miss /
.stampede.coalesced / .eviction / .invalidation / .expired / .reject;
gauges geomesa.cache.bytes / .entries.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from geomesa_tpu_torch.cache.generations import GenerationTracker, KeyRange


def collection_nbytes(fc) -> int:
    """Approximate resident bytes of a cached value: a FeatureCollection
    (ids + columns; packed geometry columns sum their buffers), or any
    value that sizes itself via an ``nbytes`` attribute (ndarrays)."""
    from geomesa_tpu_torch.filter.predicates import PointColumn

    nb = getattr(fc, "nbytes", None)
    if nb is not None:
        return int(nb)
    total = int(np.asarray(fc.ids).nbytes)
    for col in fc.columns.values():
        if isinstance(col, PointColumn):
            total += int(col.x.nbytes) + int(col.y.nbytes)
        elif hasattr(col, "coords"):  # PackedGeometryColumn
            for name in ("coords", "ring_offsets", "part_ring_offsets",
                         "geom_part_offsets", "types", "bboxes"):
                total += int(np.asarray(getattr(col, name)).nbytes)
        else:
            a = np.asarray(col)
            # object columns (python strings): rough per-slot estimate
            total += int(a.nbytes) if a.dtype.kind != "O" else 64 * len(a)
    return total


@dataclass
class _Entry:
    value: object
    nbytes: int
    tick: int
    type_name: str
    key_range: KeyRange
    expires_at: Optional[float]
    pinned: bool = False


class _Flight:
    """One in-flight computation other callers can wait on."""

    __slots__ = ("event", "tick", "value", "cost_s", "error")

    def __init__(self, tick: int):
        self.event = threading.Event()
        self.tick = tick
        self.value = None
        self.cost_s = 0.0
        self.error: Optional[BaseException] = None


@dataclass
class ResultCacheConf:
    max_bytes: int = 256 << 20
    ttl_s: Optional[float] = None
    min_cost_s: float = 0.0
    #: deterministic per-key TTL spread, as a fraction of ttl_s (0..1):
    #: a burst of entries admitted together would otherwise all expire
    #: at the same instant and stampede the store re-filling — the
    #: synchronized-expiry half of the thundering-herd problem that
    #: single-flight alone does not fix (geomesa.cache.ttl.jitter)
    ttl_jitter: float = 0.0


class ResultCache:
    """Thread-safe LRU result cache with generation validation."""

    def __init__(
        self,
        conf: ResultCacheConf,
        generations: GenerationTracker,
        metrics=None,
    ):
        from geomesa_tpu_torch.metrics import resolve

        from geomesa_tpu_torch.lockwitness import witness

        self.conf = conf
        self.generations = generations
        self.metrics = resolve(metrics)
        self._lock = witness(threading.RLock(), "ResultCache._lock")
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()  # guarded-by: _lock
        self._inflight: dict[str, _Flight] = {}  # guarded-by: _lock
        self._bytes = 0                          # guarded-by: _lock

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_resident(self) -> int:
        return self._bytes

    @property
    def enabled(self) -> bool:
        return self.conf.max_bytes > 0

    # -- internals -------------------------------------------------------
    def _drop_locked(self, key: str, counter: str) -> None:
        e = self._entries.pop(key, None)
        if e is not None:
            self._bytes -= e.nbytes
            self.metrics.counter(counter)
            self._gauges_locked()

    def _gauges_locked(self) -> None:
        self.metrics.gauge("geomesa.cache.bytes", self._bytes)
        self.metrics.gauge("geomesa.cache.entries", len(self._entries))

    def _probe_locked(self, key: str):
        """The valid entry for ``key``, or None (expired/stale entries are
        dropped here, with their counters)."""
        e = self._entries.get(key)
        if e is None:
            return None
        if e.expires_at is not None and time.monotonic() >= e.expires_at:
            self._drop_locked(key, "geomesa.cache.expired")
            return None
        if self.generations.stale(e.type_name, e.key_range, e.tick):
            self._drop_locked(key, "geomesa.cache.invalidation")
            return None
        self._entries.move_to_end(key)
        return e

    def _admit(
        self, key: str, type_name: str, key_range: KeyRange,
        value, cost_s: float, tick: int, pinned: bool,
    ) -> None:
        if not pinned and cost_s < self.conf.min_cost_s:
            self.metrics.counter("geomesa.cache.reject")
            return
        if self.generations.stale(type_name, key_range, tick):
            # a mutation landed mid-compute: the result is already stale
            self.metrics.counter("geomesa.cache.reject")
            return
        nbytes = collection_nbytes(value) + 512  # entry overhead
        if nbytes > self.conf.max_bytes:
            self.metrics.counter("geomesa.cache.reject")
            return
        ttl = self.conf.ttl_s
        if ttl is not None and self.conf.ttl_jitter > 0:
            # deterministic per-key spread (Python's hash() is salted
            # per process — useless for a reproducible schedule): the
            # key's crc32 picks a stable fraction of jitter * ttl
            frac = zlib.crc32(key.encode()) / 2.0 ** 32
            ttl = ttl * (1.0 + self.conf.ttl_jitter * frac)
        expires = time.monotonic() + ttl if ttl is not None else None
        with self._lock:
            self._drop_locked(key, "geomesa.cache.replaced")
            self._entries[key] = _Entry(
                value=value, nbytes=nbytes, tick=tick, type_name=type_name,
                key_range=key_range, expires_at=expires, pinned=pinned,
            )
            self._bytes += nbytes
            # LRU eviction down to budget; pinned entries are skipped
            for k in list(self._entries):
                if self._bytes <= self.conf.max_bytes:
                    break
                if k == key or self._entries[k].pinned:
                    continue
                self._drop_locked(k, "geomesa.cache.eviction")
            self._gauges_locked()

    # -- API -------------------------------------------------------------
    def get_or_compute(
        self,
        key: str,
        type_name: str,
        key_range: KeyRange,
        compute: Callable[[], tuple],
        pinned: bool = False,
    ):
        """Serve ``key`` from cache, or run ``compute()`` (-> (value,
        cost_seconds)) exactly once across concurrent identical callers.
        Returns (value, status, probe_s) with status in hit | miss |
        coalesced; probe_s is cache machinery time EXCLUDING the scan."""
        t0 = time.perf_counter()
        with self._lock:
            e = self._probe_locked(key)
            if e is not None:
                self.metrics.counter("geomesa.cache.hit")
                return e.value, "hit", time.perf_counter() - t0
            flight = self._inflight.get(key)
            leader = flight is None
            if leader:
                flight = _Flight(self.generations.tick())
                self._inflight[key] = flight
        probe_s = time.perf_counter() - t0

        if not leader:
            flight.event.wait()
            if flight.error is None and not self.generations.stale(
                type_name, key_range, flight.tick
            ):
                self.metrics.counter("geomesa.cache.stampede.coalesced")
                return flight.value, "coalesced", probe_s
            # leader failed, or a write landed mid-flight: compute alone
            tick = self.generations.tick()
            value, cost_s = compute()
            self.metrics.counter("geomesa.cache.miss")
            self._admit(key, type_name, key_range, value, cost_s, tick, pinned)
            return value, "miss", probe_s

        try:
            value, cost_s = compute()
            flight.value, flight.cost_s = value, cost_s
        except BaseException as exc:
            flight.error = exc
            raise
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            flight.event.set()
        self.metrics.counter("geomesa.cache.miss")
        self._admit(
            key, type_name, key_range, value, cost_s, flight.tick, pinned
        )
        return value, "miss", probe_s

    def peek(self, key: str):
        """Counter-free lookup: the valid cached value for ``key`` or
        None. Read-only: it touches no hit/miss counter and drops no
        entry (the counted paths clean up stale entries)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            if e.expires_at is not None and time.monotonic() >= e.expires_at:
                return None
            if self.generations.stale(e.type_name, e.key_range, e.tick):
                return None
            return e.value

    def admit(
        self, key: str, type_name: str, key_range: KeyRange,
        value, cost_s: float, tick: int, pinned: bool = False,
    ) -> None:
        """Populate one externally computed result (a scan run outside
        :meth:`get_or_compute`). The normal
        admission policy applies: cost threshold, byte budget, and a
        staleness re-check against ``tick`` (the generation tick captured
        BEFORE the scan read store state) — a mutation landing mid-scan
        rejects the entry. Does not touch hit/miss counters; those
        belong to the probing paths."""
        if not self.enabled:
            return
        self._admit(key, type_name, key_range, value, cost_s, tick, pinned)

    def probe(self, key: str):
        """Non-computing lookup (tests/tools): the value or None."""
        with self._lock:
            e = self._probe_locked(key)
            if e is not None:
                self.metrics.counter("geomesa.cache.hit")
                return e.value
            self.metrics.counter("geomesa.cache.miss")
            return None

    def sweep(self, type_name: Optional[str] = None) -> int:
        """Eagerly drop entries that are stale/expired (lazy validation
        already guarantees they can never be SERVED; sweeping reclaims
        their bytes now). Returns entries dropped."""
        dropped = 0
        with self._lock:
            for key in list(self._entries):
                e = self._entries[key]
                if type_name is not None and e.type_name != type_name:
                    continue
                if e.expires_at is not None and time.monotonic() >= e.expires_at:
                    self._drop_locked(key, "geomesa.cache.expired")
                    dropped += 1
                elif self.generations.stale(e.type_name, e.key_range, e.tick):
                    self._drop_locked(key, "geomesa.cache.invalidation")
                    dropped += 1
        return dropped

    def invalidate_type(self, type_name: str) -> int:
        """Drop every entry for one feature type (schema dropped)."""
        n = 0
        with self._lock:
            for key in list(self._entries):
                if self._entries[key].type_name == type_name:
                    self._drop_locked(key, "geomesa.cache.invalidation")
                    n += 1
        return n

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._gauges_locked()
