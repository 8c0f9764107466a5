"""IndexAdapter: the pluggable backend seam.

The port's copy of geomesa_tpu/storage/adapter.py (reference
IndexAdapter.scala:27-86). An adapter turns (keyspace, write keys) into
a *scan surface*, any object with the IndexTable interface (scan_submit,
scan_submit_many, count, density_submit, bounds_stats, candidate_spans,
nbytes_device), and owns its lifecycle. Every table build of a DataStore
goes through its adapter: the first write's build, compaction, the
incremental fold and delete_schema's release.

- :class:`InProcessAdapter` (the default) builds the port's IndexTable on
  the store's device; compactions of a table holding exactly the
  compacted prefix take the partition-preserving merge
  (storage.table.merged_table), and the fold takes folded_table. Given a
  ``mesh`` it builds a parallel.DistributedIndexTable over it, or over a
  pod.HostGroup a pod.PodIndexTable; those tables rebuild on every
  compaction and never fold.
- :class:`HostAdapter` builds :class:`HostTable` surfaces: sorted host
  keys and numpy predicate masks, no device at all. Only a caller who
  passes it gets it; nothing selects it.

With a cache tier attached (``DataStore.attach_cache`` sets the
adapter's ``generations``), every ``create_table`` of the in-process
adapter bumps the owning type's generation: a compaction is a mutation
path of the cache's invalidation contract.
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np

from geomesa_tpu_torch.fault import fault_point, with_retries
from geomesa_tpu_torch.index.api import IndexKeySpace, WriteKeys
from geomesa_tpu_torch.timing import NULL_CLOCK


@runtime_checkable
class IndexAdapter(Protocol):
    """Backend seam (reference IndexAdapter.createTable/deleteTables)."""

    def create_table(
        self,
        keyspace: IndexKeySpace,
        keys: WriteKeys,
        old=None,
        main_rows: int = 0,
        sorted_state=None,
    ):
        """Build (or update from ``old``) the scan surface of one index.
        ``old`` is this adapter's previous table for the index (or None);
        ``main_rows`` is the row count ``old`` was built from: rows past
        it in ``keys`` are the freshly compacted delta. ``sorted_state``:
        an optional stable (bin, z) argsort of ``keys`` (the pipelined
        ingest's merged runs) an adapter may build from instead of
        sorting; ignoring it is always correct. DataStore passes it only
        to adapters whose signature takes it."""
        ...

    def delete_table(self, table) -> None:
        """Release a table's resources (reference deleteTables)."""
        ...


def merge_applies(old, main_rows: int, n_rows: int) -> bool:
    """Whether a compaction of ``n_rows`` key rows may merge its delta
    into ``old`` (storage.table.merged_table): ``old`` is a one-device
    table built from exactly the ``main_rows`` compacted prefix, and a
    delta exists. Otherwise the table rebuilds outright (mesh and pod
    tables, whose layout is their own, always do)."""
    from geomesa_tpu_torch.storage.table import IndexTable

    return (
        isinstance(old, IndexTable)
        and type(old)._place_cols is IndexTable._place_cols
        and old.n == main_rows
        and 0 < main_rows < n_rows
    )


def _bump_generations(adapter, keyspace) -> None:
    """Generation hook for table rebuilds: a DataStore with a cache tier
    sets ``adapter.generations`` (cache.GenerationTracker) and every
    create_table bumps the owning type, scoped to the whole type since
    the adapter sees sort keys, not filters."""
    generations = getattr(adapter, "generations", None)
    sft = getattr(keyspace, "sft", None)
    if generations is not None and sft is not None:
        generations.bump(sft.name)


class InProcessAdapter:
    """The built-in backend: sorted columnar tables whose predicate
    columns live on one device, or are sharded over a ``mesh``
    (parallel.Mesh, or a pod.HostGroup). ``device`` None takes the device
    of the DataStore the adapter is given to."""

    def __init__(self, tile: Optional[int] = None, device=None, mesh=None):
        self.tile = tile
        self.device = device
        self.mesh = mesh
        self.generations = None  # set by DataStore.attach_cache

    def create_table(self, keyspace, keys, old=None, main_rows: int = 0, sorted_state=None):
        from geomesa_tpu_torch.datastore import _slice_keys
        from geomesa_tpu_torch.storage.table import IndexTable, merged_table

        # a table build is a pure function of (keyspace, keys), so a
        # transient IO fault (an OSError) is safely retried; device errors
        # are not retried
        def attempt():
            fault_point("adapter.create_table")
            if self.mesh is not None:
                from geomesa_tpu_torch.parallel import DistributedIndexTable
                from geomesa_tpu_torch.pod.hostgroup import HostGroup

                if isinstance(self.mesh, HostGroup):
                    from geomesa_tpu_torch.pod.table import PodIndexTable

                    # a host group rides the mesh seam: per-host
                    # contiguous shards instead of one flat deal
                    return PodIndexTable(keyspace, keys, self.mesh, tile=self.tile)
                # mesh tables sort anew (their deal derives from the sort
                # anyway): ignoring sorted_state is correct
                return DistributedIndexTable(keyspace, keys, self.mesh, tile=self.tile)
            if sorted_state is not None and len(sorted_state) == len(keys.zs) > 0:
                # the pipelined ingest already merged the stable (bin, z)
                # order: build straight from it, no sort
                return IndexTable(
                    keyspace, keys, tile=self.tile, device=self.device, sorted_state=sorted_state,
                )
            if merge_applies(old, main_rows, len(keys.zs)):
                return merged_table(old, keys, _slice_keys(keys, main_rows), tile=self.tile)
            return IndexTable(keyspace, keys, tile=self.tile, device=self.device)

        table = with_retries(attempt)
        _bump_generations(self, keyspace)
        return table

    def fold_table(
        self,
        keyspace,
        old,
        merged_keys,
        keep_ordinal=None,
        ordinal_map=None,
        delta_keys=None,
        delta_perm=None,
    ):
        """Incremental replace-merge (storage.table.folded_table): fold a
        delete and an insert batch into ``old`` without a whole-table
        sort, bit-identical to a full build. Returns None when the table
        cannot fold (a mesh or pod table, secondary sort words, another
        table class): the caller then builds it through
        :meth:`create_table`."""
        from geomesa_tpu_torch.storage.table import IndexTable, folded_table

        if self.mesh is not None or merged_keys.sub is not None or type(old) is not IndexTable:
            return None

        def attempt():
            fault_point("adapter.create_table")
            return folded_table(
                old, merged_keys, keep_ordinal, ordinal_map, delta_keys,
                delta_perm=delta_perm, tile=self.tile,
            )

        return with_retries(attempt)

    def delete_table(self, table) -> None:
        pass  # device memory frees with the last reference


class HostTable:
    """Host-only scan surface: the IndexTable contract over sorted keys
    and numpy predicate masks, no device anywhere (the reference's
    in-memory backend tier). The second IndexAdapter implementation: the
    DataStore and planner code run unchanged against it."""

    def __init__(self, keyspace, keys: WriteKeys, tile=None, sorted_state=None):
        from geomesa_tpu_torch.storage.table import SortedKeys

        self._sk = SortedKeys(keyspace, keys, tile or 0, sorted_state=sorted_state)
        self.keyspace = keyspace
        # sorted host copies of the predicate columns
        self._cols = {k: v[self._sk.perm] for k, v in keys.device_cols.items()}
        self.nbytes_device = 0  # nothing lives on a device

    @property
    def n(self):
        return self._sk.n

    def candidate_spans(self, config):
        return self._sk.candidate_spans(config)

    # -- scan surface ----------------------------------------------------
    def _wide_rows(self, config) -> np.ndarray:
        """Sorted-table rows passing the WIDE predicate within the
        candidate spans (numpy; bit-compatible with the kernels' wide
        plane through delta_wide_mask)."""
        from geomesa_tpu_torch.storage.delta import delta_wide_mask
        from geomesa_tpu_torch.storage.table import _span_rows

        rows = _span_rows(self.candidate_spans(config))
        if len(rows) == 0:
            return rows
        sub = WriteKeys(
            bins=self._sk.bins[rows],
            zs=self._sk.zs[rows],
            device_cols={k: v[rows] for k, v in self._cols.items()},
        )
        m = delta_wide_mask(
            config, sub, packed_shift=getattr(self.keyspace, "packed_time", None),
        )
        return rows[m]

    def scan_submit(self, config, clock=NULL_CLOCK, deadline=None):
        if config.disjoint or self.n == 0:
            return lambda: (np.zeros(0, np.int64), np.zeros(0, bool))
        rows = self._wide_rows(config)
        out = (
            self._sk.perm[rows].astype(np.int64),
            np.zeros(len(rows), bool),  # wide only: every row refines
        )
        return lambda: out

    def scan_submit_many(self, configs, clock=NULL_CLOCK, deadline=None):
        """IndexTable.scan_submit_many's contract (one finish per config);
        a host table has no launch to share, so this loops."""
        return [self.scan_submit(c, clock=clock, deadline=deadline) for c in configs]

    def count(self, config, clock=NULL_CLOCK) -> int:
        return int(len(self._wide_rows(config)))

    # -- aggregation surface (wide semantics, like the device kernels;
    # the representative-xy and grid-scatter rules are the delta tier's)
    def density_submit(self, config, envelope, width, height, clock=NULL_CLOCK):
        from geomesa_tpu_torch.storage.delta import rep_xy, scatter_density

        rows = self._wide_rows(config)
        x, y = rep_xy(self._cols, rows)
        grid = scatter_density(x, y, envelope, width, height)
        return lambda: grid

    def bounds_stats(self, config, clock=NULL_CLOCK):
        from geomesa_tpu_torch.storage.delta import rep_xy

        rows = self._wide_rows(config)
        if len(rows) == 0:
            return 0, None
        x, y = rep_xy(self._cols, rows)
        return len(rows), (float(x.min()), float(y.min()), float(x.max()), float(y.max()))

    def warmup(self) -> int:
        return 0  # nothing to compile


class HostAdapter:
    """IndexAdapter producing HostTable scan surfaces (no device): the
    backend for callers who want no accelerator in the path, or tiny
    reference stores in tests. Compactions sort outright (no merge fast
    path)."""

    def __init__(self, tile=None):
        self.tile = tile

    def create_table(self, keyspace, keys, old=None, main_rows: int = 0, sorted_state=None):
        def attempt():
            fault_point("adapter.create_table")
            if sorted_state is not None and len(sorted_state) != len(keys.zs):
                return HostTable(keyspace, keys, tile=self.tile)
            return HostTable(keyspace, keys, tile=self.tile, sorted_state=sorted_state)

        return with_retries(attempt)

    def delete_table(self, table) -> None:
        pass
