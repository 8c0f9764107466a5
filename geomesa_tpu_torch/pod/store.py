"""PodStore: the streaming tier sharded per host.

The port of geomesa_tpu/pod/store.py. One streaming.LambdaStore runtime
per host, each with its own cold DataStore (by default on that host's
shard mesh), its own hot tier, its own WAL directory
(``<root>/host-<h>/_wal``) and its own standing-subscription shard. Rows
route by the crc32 of their feature id (mod H), so:

- acknowledgements are host-local: ``write`` returns when each owning
  host's WAL has made its slice durable to its sync policy
  (``pod.wal.route`` marks each hop);
- failure is per host: killing host h loses nothing acknowledged, and
  ``rejoin`` (``LambdaStore.recover``; the ``pod.wal.replay`` fault
  point) rebuilds the rows and registrations that host owned while the
  other hosts keep serving (undrained alerts are at-most-once and die
  with their host, as in a one-process crash);
- ingest is host-local: ``bulk_load`` partitions a collection by owner
  and drives one pipelined BulkLoader per host against its cold store;
- standing shards compose: a subscription registers on every host's
  engine, each batch matches only on its owning host, so the union of
  the hosts' alert queues equals one LambdaStore's alert set.

The only pod-global state is the auto-id counter (``_route_lock``): an
id's owner must be known before the row is logged anywhere.
"""

from __future__ import annotations

import os
import threading
import zlib
from typing import Mapping, Optional, Sequence

import numpy as np

from geomesa_tpu_torch.fault import fault_point
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import INCLUDE
from geomesa_tpu_torch.pod.hostgroup import HostGroup


class PodStore:
    """H host-local streaming runtimes behind one routed facade."""

    def __init__(
        self,
        sft,
        group: HostGroup,
        root: "str | None" = None,
        expiry_ms: Optional[int] = None,
        config=None,
        wal_config=None,
        cold_factory=None,
    ):
        """``cold_factory(h)``: host h's empty cold DataStore (default: a
        DataStore on the host's shard mesh)."""
        from geomesa_tpu_torch.lockwitness import witness

        self.group = group
        self.hosts = group.hosts
        self.type_name = sft.name
        self._sft_spec = (sft.name, sft.to_spec())
        self.root = root
        self._expiry_ms = expiry_ms
        self._config = config
        self._wal_config = wal_config
        self._cold_factory = cold_factory
        self._route_lock = witness(threading.Lock(), "PodStore._route_lock")
        self._next_id = 0  # guarded-by: _route_lock
        self.stores: list = [self._open_host(h) for h in range(self.hosts)]
        if self.root is not None:
            # seed every host's checkpoint root, so a host killed before its
            # first scheduled checkpoint still recovers
            self.checkpoint()

    # -- host runtimes ---------------------------------------------------
    def host_root(self, h: int) -> "str | None":
        return None if self.root is None else os.path.join(self.root, f"host-{h}")

    def host_wal_dir(self, h: int) -> "str | None":
        r = self.host_root(h)
        return None if r is None else os.path.join(r, "_wal")

    def _host_store_kwargs(self, h: int) -> dict:
        """DataStore arguments of host h's default cold store: its shard
        mesh, on the mesh's device type."""
        mesh = self.group.mesh(h)
        return {"device": mesh.device_type, "mesh": mesh}

    def _make_cold(self, h: int):
        from geomesa_tpu_torch.sft import FeatureType

        if self._cold_factory is not None:
            cold = self._cold_factory(h)
        else:
            from geomesa_tpu_torch.datastore import DataStore

            cold = DataStore(**self._host_store_kwargs(h))
        cold.create_schema(FeatureType.from_spec(*self._sft_spec))
        return cold

    def _open_host(self, h: int):
        from geomesa_tpu_torch.streaming.store import LambdaStore

        wal_dir = self.host_wal_dir(h)
        if wal_dir is not None:
            os.makedirs(wal_dir, exist_ok=True)
        return LambdaStore(
            self._make_cold(h), self.type_name, expiry_ms=self._expiry_ms,
            config=self._config, wal_dir=wal_dir, wal_config=self._wal_config,
        )

    def _require(self, h: int):
        st = self.stores[h]
        if st is None:
            raise RuntimeError(f"pod host {h} is down (rejoin() it first)")
        return st

    # -- ownership -------------------------------------------------------
    def owner(self, fid) -> int:
        """Stable id -> owning host (crc32 mod H): decided at the
        coordinator, the same across restarts and drivers."""
        return zlib.crc32(str(fid).encode()) % self.hosts

    def _route(self, ids: Sequence[str]):
        per: dict[int, list] = {}
        for i, fid in enumerate(ids):
            per.setdefault(self.owner(fid), []).append(i)
        return sorted(per.items())

    # -- mutations (host-local acks) -------------------------------------
    def write(self, rows: Sequence[Mapping], ids: "Sequence[str] | None" = None) -> int:
        """Route a batch to its owning hosts' hot tiers. Each host's WAL
        acknowledges its own slice; a fault between hosts leaves earlier
        hosts' slices acknowledged and later ones not, the per-host ack
        contract replay preserves."""
        rows = list(rows)
        if ids is None:
            with self._route_lock:
                base = self._next_id
                self._next_id += len(rows)
            ids = [f"pod-{base + i}" for i in range(len(rows))]
        else:
            ids = [str(i) for i in ids]
        total = 0
        for h, idxs in self._route(ids):
            fault_point("pod.wal.route")
            total += self._require(h).write([rows[i] for i in idxs], [ids[i] for i in idxs])
        return total

    def delete(self, ids: Sequence[str]) -> int:
        total = 0
        for h, idxs in self._route([str(i) for i in ids]):
            fault_point("pod.wal.route")
            total += self._require(h).delete([str(ids[i]) for i in idxs])
        return total

    def expire(self, now_ms: Optional[int] = None) -> int:
        return sum(self._require(h).expire(now_ms=now_ms) for h in range(self.hosts))

    def bulk_load(self, fc: FeatureCollection, config=None) -> list:
        """Host-local pipelined ingest: partition by owner, one BulkLoader
        per owning host against that host's cold store (each host sorts
        and uploads only its own rows). Returns the per-host
        IngestResults (None for a host that owns no row)."""
        from concurrent.futures import ThreadPoolExecutor

        from geomesa_tpu_torch.ingest.pipeline import BulkLoader

        owners = np.array([self.owner(f) for f in fc.ids], np.int64)

        def run(h: int):
            idx = np.flatnonzero(owners == h)
            if not len(idx):
                return None
            fault_point("pod.dispatch")
            loader = BulkLoader(self._require(h).cold, self.type_name, config=config)
            try:
                loader.put(fc.take(idx))
            except BaseException:
                loader.abort()
                raise
            return loader.close()

        with ThreadPoolExecutor(max_workers=self.hosts) as ex:
            return list(ex.map(run, range(self.hosts)))

    # -- standing subscriptions (per-host shards) ------------------------
    def subscribe(self, sub) -> None:
        """Register on every host's engine (each batch matches only on its
        owning host, so the union of the shards' alerts equals one
        matcher's). Each host logs its own copy in its WAL."""
        from geomesa_tpu_torch.streaming.standing import Subscription

        sub.validate()
        rec = sub.to_record()
        for h in range(self.hosts):
            self._require(h).subscribe(Subscription.from_record(rec))

    def unsubscribe(self, sub_id: str) -> bool:
        ok = False
        for h in range(self.hosts):
            ok = self._require(h).unsubscribe(sub_id) or ok
        return ok

    def drain_alerts(self) -> list:
        """Union of the per-host alert queues, host-major (delivery order
        across hosts is not part of the contract: compare as sets)."""
        out: list = []
        for st in self.stores:
            if st is not None and st._standing is not None:
                out.extend(st.standing().alerts.drain())
        return out

    # -- reads (fan out, disjoint merge) ---------------------------------
    def query(self, f=INCLUDE, **kw) -> FeatureCollection:
        parts = [self._require(h).query(f, **kw) for h in range(self.hosts)]
        fault_point("pod.join")
        return FeatureCollection.concat([p for p in parts if len(p)] or parts[:1])

    def count(self, f=INCLUDE) -> int:
        # owners partition the ids, so per-host counts add exactly
        total = sum(self._require(h).count(f) for h in range(self.hosts))
        fault_point("pod.join")
        return total

    # -- persistence and failure -----------------------------------------
    def flush(self, incremental: "bool | None" = None, full: bool = False) -> int:
        return sum(self._require(h).flush(incremental=incremental, full=full)
                   for h in range(self.hosts))

    def checkpoint(self) -> int:
        if self.root is None:
            raise ValueError("PodStore needs a root to checkpoint")
        return sum(self._require(h).checkpoint(self.host_root(h)) for h in range(self.hosts))

    def kill(self, h: int) -> None:
        """Simulate a host crash: abandon the runtime without flushing or
        closing. Unsynced WAL bytes and the whole hot tier vanish
        (``wal.crash()``); on-disk WAL segments and checkpoints stay,
        which is what ``rejoin`` recovers from."""
        st = self._require(h)
        if st.wal is not None:
            st.wal.crash()
        self.stores[h] = None

    def rejoin(self, h: int, on_progress=None):
        """Re-open a killed host from its own checkpoint and WAL replay
        (``LambdaStore.recover``, onto the host's shard mesh unless a
        ``cold_factory`` built its stores): acknowledged rows, standing
        registrations and fold progress return; the other hosts are
        untouched throughout."""
        from geomesa_tpu_torch.streaming.store import LambdaStore

        if self.stores[h] is not None:
            raise RuntimeError(f"pod host {h} is not down")
        fault_point("pod.wal.replay")
        kw = self._host_store_kwargs(h)
        if self._cold_factory is not None:
            kw.pop("mesh")
        st = LambdaStore.recover(
            self.host_root(h), type_name=self.type_name, wal_dir=self.host_wal_dir(h),
            expiry_ms=self._expiry_ms, config=self._config, wal_config=self._wal_config,
            on_progress=on_progress, **kw,
        )
        self.stores[h] = st
        return st

    def close(self) -> None:
        """Close every live host's runtime and its cold store's services."""
        for st in self.stores:
            if st is not None:
                st.close()
                st.cold.close()
