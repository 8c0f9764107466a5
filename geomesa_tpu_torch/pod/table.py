"""PodIndexTable: one index sharded host-major over a host group.

The port of geomesa_tpu/pod/table.py. The mesh table (parallel.dtable)
deals blocks round-robin over one flat device axis, so every query fans
out over every device: right inside one host, wrong across hosts, where
every host would touch every query and hold keys for the whole table.
The pod table instead cuts the globally sorted block sequence into H
contiguous runs (the reference's tablet split points): host h owns global
blocks ``[h * bph, (h + 1) * bph)`` and builds one per-host
DistributedIndexTable over its own device slice from its piece of the
already-sorted columns (``sorted_state`` identity: no re-sort; per-host
device memory ~1/H of the table). A selective query's candidate blocks
then land on few hosts, and non-owning hosts launch nothing.

The coordinator keeps the global sorted keys (ranges, spans, ``perm``),
so planning is the single-device table's, and the device hooks route
each candidate run to its owning host's shard: every owning host is
launched before any is finished, then the parts merge. Shard rows plus
the host's row base are global sorted rows, and since the cuts are
contiguous and ascending the per-host parts concatenate in order. The
fused path rides the shards' ``_fused_raw_finishes``: one K2 launch per
shard and one pull per host per chunk, decoded at the coordinator, then
the global ``_post_decode``; results equal the flat mesh table's bit for
bit. ``pod.dispatch`` marks each host's launch and ``pod.join`` each
merge (fault points).
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.fault import fault_point
from geomesa_tpu_torch.index.api import IndexKeySpace, ScanConfig, WriteKeys
from geomesa_tpu_torch.parallel.dtable import DistributedIndexTable
from geomesa_tpu_torch.pod.hostgroup import HostGroup
from geomesa_tpu_torch.storage.table import IndexTable
from geomesa_tpu_torch.timing import NULL_CLOCK

# key values of the rows padding a short host cut (the cut slices
# sentinel-padded device columns, so only the host arrays need explicit
# pads; the values keep the (bin, z) order non-decreasing)
_PAD_BIN = np.int32(np.iinfo(np.int32).max)
_PAD_Z = np.uint64(0xFFFFFFFFFFFFFFFF)


class PodIndexTable(IndexTable):
    """Sorted columnar index cut into per-host contiguous shards, each a
    DistributedIndexTable on its host's own shard mesh."""

    def __init__(
        self,
        keyspace: IndexKeySpace,
        keys: WriteKeys,
        group: HostGroup,
        tile: int | None = None,
        sorted_state: "np.ndarray | None" = None,
    ):
        self.group = group
        self.hosts = group.hosts
        super().__init__(keyspace, keys, tile=tile, device=group.devices[0],
                         sorted_state=sorted_state)

    # -- layout hooks ----------------------------------------------------
    def _round_blocks(self, n_blocks: int) -> int:
        # a multiple of H * dph: the cut is H equal contiguous runs, each a
        # whole number of rounds on its shard mesh, so every global block
        # (full scans included) maps to a real shard block; the flat mesh
        # over the same devices rounds to the same H * dph, which keeps
        # the candidate sets identical
        unit = self.hosts * self.group.devices_per_host
        return -(-n_blocks // unit) * unit

    def _place_cols(self, cols: dict, device=None) -> None:
        """Cut the padded sorted columns into H contiguous host runs and
        build one shard table from each: the pod table places nothing on a
        device itself."""
        self.rows_uploaded = self.n_pad
        H = self.hosts
        self.blocks_per_host = self.n_blocks // H
        rows_ph = self.blocks_per_host * self.block
        self.rows_per_host = rows_ph
        self.cols3 = {}  # the shards own the device tensors
        self.shards: list[DistributedIndexTable] = []
        for h in range(H):
            r0 = h * rows_ph
            n_h = max(0, min(self.n - r0, rows_ph))  # real rows in the cut
            bins = np.full(rows_ph, _PAD_BIN, np.int32)
            zs = np.full(rows_ph, _PAD_Z, np.uint64)
            bins[:n_h] = self.bins[r0 : r0 + n_h]
            zs[:n_h] = self.zs[r0 : r0 + n_h]
            sub = None
            if self.subkeys is not None:
                sub = np.zeros((rows_ph, self.subkeys.shape[1]), self.subkeys.dtype)
                sub[:n_h] = self.subkeys[r0 : r0 + n_h]
            shard_keys = WriteKeys(
                bins=bins, zs=zs,
                # the pod-level pad already wrote never-matching sentinels
                # past row n, so a short cut's tail rows are sentinels
                device_cols={k: v[r0 : r0 + rows_ph] for k, v in cols.items()},
                sub=sub,
            )
            shard = DistributedIndexTable(
                self.keyspace, shard_keys, self.group.mesh(h), tile=self.block,
                # the cut slices the globally sorted columns: identity order
                sorted_state=np.arange(rows_ph, dtype=np.int64),
            )
            cap = self.group.slot_cap(h)
            if cap is not None:
                shard._slot_cap = cap  # the host's own probed link
            self.shards.append(shard)

    @property
    def nbytes_device(self) -> int:
        return sum(sh.nbytes_device for sh in self.shards)

    def warmup(self) -> int:
        """Per-shard warm-up: every shape the pod table can launch is a
        shard shape on that host's mesh."""
        return sum(sh.warmup() for sh in self.shards)

    # -- ownership routing -----------------------------------------------
    def _host_blocks(self, blocks: np.ndarray):
        """Ascending global candidate blocks -> [(h, local blocks)] over
        owning hosts only (the contiguous cut makes this two searchsorted
        calls per host; non-owning hosts never appear)."""
        bph = self.blocks_per_host
        out = []
        for h in range(self.hosts):
            s = int(np.searchsorted(blocks, h * bph))
            e = int(np.searchsorted(blocks, (h + 1) * bph))
            if e > s:
                out.append((h, blocks[s:e] - h * bph))
        return out

    def _merge_host_rows(self, parts):
        """[(h, shard rows, certain)] in ascending host order -> global
        (rows, certain): shard rows plus the host's row base are global
        sorted rows, and ascending contiguous cuts concatenate sorted."""
        fault_point("pod.join")
        parts = [(h, r, c) for h, r, c in parts if len(r)]
        if not parts:
            return np.zeros(0, np.int64), np.zeros(0, bool)
        rows = np.concatenate([r.astype(np.int64) + h * self.rows_per_host for h, r, _ in parts])
        cert = np.concatenate([c for _, _, c in parts])
        return rows, cert

    # -- device hooks ----------------------------------------------------
    def _device_scan_submit(self, blocks: np.ndarray, config: ScanConfig, clock=NULL_CLOCK):
        pending = []
        for h, loc in self._host_blocks(blocks):
            fault_point("pod.dispatch")
            # launch every owning host before finishing any
            pending.append((h, self.shards[h]._device_scan_submit(loc, config, clock)))

        def finish():
            return self._merge_host_rows([(h, *fin()) for h, fin in pending])

        return finish

    def _device_pops(self, blocks: np.ndarray, config: ScanConfig, clock=NULL_CLOCK):
        pops_parts, gbid_parts = [], []
        for h, loc in self._host_blocks(blocks):
            fault_point("pod.dispatch")
            pops, gbids = self.shards[h]._device_pops(loc, config, clock)
            pops_parts.append(pops)
            gbid_parts.append(gbids + h * self.blocks_per_host)
        fault_point("pod.join")
        if not pops_parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        # each shard's result is block-sorted; ascending cuts keep the
        # concatenation sorted
        return np.concatenate(pops_parts), np.concatenate(gbid_parts)

    def _device_density_submit(self, blocks, config, grid_bounds, width: int, height: int,
                               clock=NULL_CLOCK):
        finishes = []
        for h, loc in self._host_blocks(blocks):
            fault_point("pod.dispatch")
            finishes.append(self.shards[h]._device_density_submit(
                loc, config, grid_bounds, width, height, clock))

        def finish():
            fault_point("pod.join")
            grid = np.zeros((height, width), np.float32)
            for fin in finishes:
                grid = grid + fin()
            return grid

        return finish

    def _device_bounds(self, blocks, config, clock=NULL_CLOCK):
        total, env = 0, None
        for h, loc in self._host_blocks(blocks):
            fault_point("pod.dispatch")
            cnt, e = self.shards[h]._device_bounds(loc, config, clock)
            total += cnt
            if e is not None:
                env = e if env is None else (
                    min(env[0], e[0]), min(env[1], e[1]), max(env[2], e[2]), max(env[3], e[3]),
                )
        fault_point("pod.join")
        return total, env

    # -- fused multi-query scan (the cross-host leg) ---------------------
    @property
    def fused_slots(self) -> int:
        return min(sh.fused_slots for sh in self.shards)

    @property
    def fused_pack_capacity(self) -> int:
        return sum(sh.fused_pack_capacity for sh in self.shards)

    def _submit_fused_chunk(self, members, names, has_boxes, has_windows, finishes,
                            clock=NULL_CLOCK, deadline=None) -> None:
        """Cross-host fused dispatch: route each member's candidate blocks
        to their owning hosts, check every host's per-shard slot budget
        first (a skewed chunk splits before any host launches), then drive
        each owning host's ``_fused_raw_finishes``: one K2 launch per
        shard and one pull per host per chunk. Members decode per host at
        the coordinator and ``_post_decode`` runs once per member, so the
        results equal the flat mesh's fused path bit for bit."""
        if self._fused_route_single(members, finishes, clock, deadline):
            return
        host_members: dict[int, list] = {}
        for k, m in enumerate(members):
            for h, loc in self._host_blocks(m[2]):
                host_members.setdefault(h, []).append((k, loc))
        for h, mem in host_members.items():
            sh = self.shards[h]
            counts = np.zeros(sh.n_devices, np.int64)
            for _, loc in mem:
                counts += np.bincount(loc % sh.n_devices, minlength=sh.n_devices)
            if counts.max() > sh.fused_slots:
                # candidate skew overflows a shard's slots: split the chunk
                # in half before any host launches (the mesh table's
                # policy), down to the per-query route
                half = len(members) // 2
                for part in (members[:half], members[half:]):
                    self._submit_fused_chunk(part, names, has_boxes, has_windows, finishes,
                                             clock, deadline)
                return
        host_raw: list = []
        for h in sorted(host_members):
            fault_point("pod.dispatch")
            mem = host_members[h]
            sub_members = [(i, members[k][1], loc, (), ()) for i, (k, loc) in enumerate(mem)]
            raw = self.shards[h]._fused_raw_finishes(
                sub_members, names, has_boxes, has_windows, clock, deadline
            )
            # the pre-check above is the shard's own test, so raw is never None
            host_raw.append((h, {k: raw[i] for i, (k, _) in enumerate(mem)}))

        def member_finish(k: int):
            _, config, _, overlap, contained = members[k]
            parts = [(h, *raws[k]()) for h, raws in host_raw if k in raws]
            rows, certain = self._merge_host_rows(parts)
            with clock.host("decode"):
                return self._post_decode(rows, certain, config, overlap, contained)

        for k, m in enumerate(members):
            finishes[m[0]] = lambda k=k: member_finish(k)
