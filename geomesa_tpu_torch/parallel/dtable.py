"""DistributedIndexTable: one index sharded over a device mesh.

The port of geomesa_tpu/parallel/dtable.py. Layout: the sorted table's
scan blocks are dealt round-robin across the mesh (global block g ->
shard ``g % D``, local slot ``g // D``), so consecutive z-runs interleave
across shards and any query's candidate ranges fan out over the whole
mesh instead of hot-spotting one device (the reference's ShardStrategy).

Execution is the single-device table's engine (storage.table.IndexTable):
this class overrides only the layout and device hooks. Where the JAX
package runs one ``shard_map`` over the mesh, each shard here launches
the port's kernel wrapper on its own device with its own ``[M]`` local
block ids (K1 ``scan_planes``, K2 ``scan_planes_multi``, K1p
``block_pops``, K3 ``block_density``, K4 ``block_bounds``): a CUDA shard
launches its kernel or raises, a CPU shard takes the plain version. Every
shard's bucket is the mesh-wide static one, so the shards' planes stack;
they come to the host in one copy per device (the shards on one device
stacked), and the host decodes each shard's slots back to global blocks.
The JAX package's ``psum`` of the density grids is the sum of the shards'
grids in shard order (integer counts in f32, exact). A shard with no
candidate block launches nothing.

A mesh table always re-deals its whole column set (``rows_uploaded =
n_pad``): it never reuses an old table's prefix or takes the device fold,
and the adapter never folds into it.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.index.api import IndexKeySpace, ScanConfig, WriteKeys
from geomesa_tpu_torch.parallel.mesh import Mesh
from geomesa_tpu_torch.planning.errors import check_deadline
from geomesa_tpu_torch.scan import aggregations
from geomesa_tpu_torch.scan import block_kernels as bk
from geomesa_tpu_torch.storage.table import IndexTable, _host_planes
from geomesa_tpu_torch.timing import NULL_CLOCK


def pull_shards(planes: dict, clock=NULL_CLOCK) -> dict:
    """Host copies of per-shard device tensors of one shape (shard ->
    tensor): one device->host copy per device, the shards that share a
    device stacked into it."""
    by_dev: dict = {}
    for d, t in planes.items():
        by_dev.setdefault(t.device, []).append(d)
    out = {}
    for dev, shards in by_dev.items():
        with clock.device("d2h", dev):
            stacked = torch.stack([planes[d] for d in shards]) if len(shards) > 1 \
                else planes[shards[0]][None]
            host = stacked.cpu().numpy()
        for i, d in enumerate(shards):
            out[d] = host[i]
    return out


class DistributedIndexTable(IndexTable):
    """Sorted columnar index table sharded over a 1-D mesh. Shares the
    whole scan engine with IndexTable; only the layout and device hooks
    differ."""

    def __init__(
        self,
        keyspace: IndexKeySpace,
        keys: WriteKeys,
        mesh: Mesh,
        tile: int | None = None,
        sorted_state: "np.ndarray | None" = None,
    ):
        self.mesh = mesh
        self.n_devices = mesh.size
        super().__init__(keyspace, keys, tile=tile, device=mesh.devices[0],
                         sorted_state=sorted_state)

    # -- layout hooks ----------------------------------------------------
    def _round_blocks(self, n_blocks: int) -> int:
        D = self.n_devices
        return -(-n_blocks // D) * D

    def _place_cols(self, cols: dict, device=None) -> None:
        """Deal the padded columns: ``cols3[name][d]`` is shard d's
        contiguous [n_blocks / D, SUB, 128] tensor on its device, local
        slot j holding global block ``j * D + d``. The shards on one
        device upload in one copy."""
        self.rows_uploaded = self.n_pad  # mesh tables always re-deal
        D = self.n_devices
        nb = self.n_blocks
        self.blocks_local = nb // D
        # deal[d, j] = global block j*D + d
        deal = np.arange(nb).reshape(self.blocks_local, D).T
        by_dev: dict = {}
        for d, dev in enumerate(self.mesh.devices):
            by_dev.setdefault(dev, []).append(d)
        self.cols3 = {}
        for k, v in cols.items():
            v4 = v.reshape(nb, self.sub, bk.LANES)[deal]  # [D, nb/D, SUB, L]
            shards: list = [None] * D
            for dev, ds in by_dev.items():
                t = torch.from_numpy(np.ascontiguousarray(v4[ds])).to(dev)
                for i, d in enumerate(ds):
                    shards[d] = t[i]
            self.cols3[k] = shards
            del v4

    def _shard_cols(self, d: int, names: tuple) -> tuple:
        return tuple(self.cols3[k][d] for k in names)

    @property
    def nbytes_device(self) -> int:
        return sum(int(t.numel() * t.element_size()) for v in self.cols3.values() for t in v)

    # -- candidate split -------------------------------------------------
    def _split_blocks(self, blocks: np.ndarray, pad: int = 0):
        """Global candidate blocks -> ([D, M] i32 local block ids padded to
        one mesh-wide static bucket, per-shard real counts [D]). Past the
        largest bucket every shard scans all its local blocks."""
        D = self.n_devices
        per = [blocks[blocks % D == d] // D for d in range(D)]
        mx = max(len(p) for p in per)
        if mx > bk.M_BUCKETS[-1]:
            per = [np.arange(self.blocks_local, dtype=np.int64)] * D
            mx = self.blocks_local
        m = bk.m_bucket_of(mx)  # the single-query ladder: the link floor applies
        bids2 = np.full((D, m), pad, np.int32)
        n_real = np.zeros(D, np.int64)
        for d, p in enumerate(per):
            bids2[d, : len(p)] = p
            n_real[d] = len(p)
        return bids2, n_real

    def _merge_device_rows(self, parts):
        """[(rows, certain)] per shard (each ascending) -> globally
        ascending (rows, certain)."""
        parts = [(r, c) for r, c in parts if len(r)]
        if not parts:
            return np.zeros(0, np.int64), np.zeros(0, bool)
        rows = np.concatenate([r for r, _ in parts])
        cert = np.concatenate([c for _, c in parts])
        order = np.argsort(rows, kind="stable")
        return rows[order], cert[order]

    # -- fused multi-query scan ------------------------------------------
    @property
    def fused_slots(self) -> int:
        """Per-shard slot bucket of the fused shape: the single-device
        clamp applied to the local block count (each shard scans its own
        round-robin share, so a fused chunk is D slot lists of this size).
        ``_slot_cap`` is a per-table cap (a pod host's shard)."""
        return min(
            bk.fused_slot_cap(self._slot_cap), bk.bucket_of(max(1, self.blocks_local))
        )

    @property
    def fused_pack_capacity(self) -> int:
        """Chunk-packer capacity: candidates split round-robin across the
        mesh, so a chunk holds D x the per-shard slot bucket."""
        return self.fused_slots * self.n_devices

    def _submit_fused_chunk(self, members, names, has_boxes, has_windows, finishes,
                            clock=NULL_CLOCK, deadline=None) -> None:
        """Mesh fused dispatch: one K2 launch per shard over every member's
        local candidate blocks (member k's blocks on shard d form one
        contiguous slot segment) and one pull per device; members decode
        per (member, shard) segment and merge like per-query mesh scans,
        so fused results equal the per-query ones bit for bit. A chunk
        whose candidates overflow one shard's slot bucket (members
        clustered on one residue class) splits in half and recurses,
        down to the per-query route."""
        if self._fused_route_single(members, finishes, clock, deadline):
            return
        raw = self._fused_raw_finishes(members, names, has_boxes, has_windows, clock, deadline)
        if raw is None:
            half = len(members) // 2
            for part in (members[:half], members[half:]):
                self._submit_fused_chunk(part, names, has_boxes, has_windows, finishes,
                                         clock, deadline)
            return

        def member_finish(k: int):
            _, config, _, overlap, contained = members[k]
            rows, certain = raw[k]()
            with clock.host("decode"):
                return self._post_decode(rows, certain, config, overlap, contained)

        for k, m in enumerate(members):
            finishes[m[0]] = lambda k=k: member_finish(k)

    def _fused_raw_finishes(self, members, names, has_boxes, has_windows,
                            clock=NULL_CLOCK, deadline=None):
        """The launch half of a fused chunk: one K2 launch per shard with
        candidates, and one raw finish per member yielding this table's
        (rows, certain) in sorted-row coordinates, before ``_post_decode``.
        Returns None (nothing launched) when candidate skew overflows a
        shard's slot bucket. The pod table drives this seam per host
        shard and applies the global ``_post_decode`` itself."""
        D = self.n_devices
        slots = self.fused_slots
        # member-major per-shard split: global block g -> shard g % D,
        # local slot g // D (the round-robin deal, _place_cols)
        per = [[m[2][m[2] % D == d] // D for m in members] for d in range(D)]
        counts = [sum(len(p) for p in row) for row in per]
        if max(counts) > slots:
            return None
        check_deadline(deadline, "device scan dispatch")
        boxes, wins = self._fused_param_stacks(members)
        chunk_e, edges, pip = self._chunk_edge_stack(members)
        chunk_r, rasts, has_rast = self._chunk_raster_stack(members)
        poly_slot = pip | has_rast
        bids2 = np.zeros((D, slots), np.int32)
        qids2 = np.zeros((D, slots), np.int32)
        spip2 = np.zeros((D, slots), np.int32)
        segs: list[list] = [[(0, 0)] * D for _ in members]
        for d in range(D):
            pos = 0
            for q, loc in enumerate(per[d]):
                nb = len(loc)
                bids2[d, pos : pos + nb] = loc
                qids2[d, pos : pos + nb] = q
                if poly_slot[q]:
                    spip2[d, pos : pos + nb] = 1
                segs[q][d] = (pos, pos + nb)
                pos += nb
        planes = {
            d: bk.scan_planes_multi(
                self._shard_cols(d, names), bids2[d], qids2[d], boxes, wins, col_names=names,
                has_boxes=has_boxes, has_windows=has_windows, extent=self.extent,
                edges=edges, spip=spip2[d], n_edges=chunk_e, rasts=rasts, n_rints=chunk_r,
                clock=clock,
            )
            for d in range(D) if counts[d]
        }
        if clock.armed:
            self._note_launches(clock, "n.launch.fused", len(planes), sum(counts))
        pulled: list = []

        def raw_finish(k: int):
            if not pulled:
                pulled.append(pull_shards(planes, clock))
            host = pulled[0]
            check_deadline(deadline, "bitmask decode")
            parts = []
            with clock.host("decode"):
                for d in range(D):
                    s, e = segs[k][d]
                    if e <= s:
                        continue
                    gb = bids2[d, s:e].astype(np.int64) * D + d
                    parts.append(bk.decode_bits_pair(*_host_planes(host[d], slice(s, e)), gb, e - s))
                return self._merge_device_rows(parts)

        return [lambda k=k: raw_finish(k) for k in range(len(members))]

    # -- device hooks ----------------------------------------------------
    def _device_scan_submit(self, blocks: np.ndarray, config: ScanConfig, clock=NULL_CLOCK):
        D = self.n_devices
        bids2, n_real = self._split_blocks(blocks)
        boxes, wins = self._params(config)
        names = self._scan_cols(config)
        kw = self._scan_kernel_kwargs(config, names)
        planes = {
            d: bk.scan_planes(self._shard_cols(d, names), bids2[d], boxes, wins, clock=clock, **kw)
            for d in range(D) if n_real[d]
        }
        if clock.armed:
            self._note_launches(clock, "n.launch.single", len(planes), sum(n_real))

        def finish():
            host = pull_shards(planes, clock)
            with clock.host("decode"):
                parts = [
                    bk.decode_bits_pair(*_host_planes(host[d]),
                                        bids2[d].astype(np.int64) * D + d, int(n_real[d]))
                    for d in sorted(host)
                ]
                return self._merge_device_rows(parts)

        return finish

    def _device_pops(self, blocks: np.ndarray, config: ScanConfig, clock=NULL_CLOCK):
        D = self.n_devices
        bids2, n_real = self._split_blocks(blocks, pad=-1)
        boxes, wins = self._params(config)
        names = self._scan_cols(config)
        kw = self._kernel_kwargs(config, names)
        host = pull_shards({
            d: aggregations.block_pops(self._shard_cols(d, names), bids2[d], boxes, wins,
                                       clock=clock, **kw)
            for d in range(D) if n_real[d]
        }, clock)
        pops = np.concatenate([host[d][: n_real[d]].astype(np.int64) for d in sorted(host)])
        gbids = np.concatenate([bids2[d, : n_real[d]].astype(np.int64) * D + d
                                for d in sorted(host)])
        order = np.argsort(gbids)
        return pops[order], gbids[order]

    def _device_density_submit(self, blocks, config, grid_bounds, width: int, height: int,
                               clock=NULL_CLOCK):
        bids2, n_real = self._split_blocks(blocks, pad=-1)
        boxes, wins = self._params(config)
        names = self._agg_cols(config)
        kw = self._kernel_kwargs(config, names)
        grids = {
            d: aggregations.block_density(
                self._shard_cols(d, names), bids2[d], boxes, wins, grid_bounds,
                width=width, height=height, clock=clock, **kw,
            )
            for d in range(self.n_devices) if n_real[d]
        }

        def finish() -> np.ndarray:
            host = pull_shards(grids, clock)
            grid = np.zeros((height, width), np.float32)
            for d in sorted(host):  # the JAX package's psum, in shard order
                grid += host[d]
            return grid

        return finish

    def _device_bounds(self, blocks, config, clock=NULL_CLOCK):
        bids2, n_real = self._split_blocks(blocks, pad=-1)
        boxes, wins = self._params(config)
        names = self._agg_cols(config)
        kw = self._kernel_kwargs(config, names)
        host = pull_shards({
            d: aggregations.block_bounds(self._shard_cols(d, names), bids2[d], boxes, wins,
                                         clock=clock, **kw)
            for d in range(self.n_devices) if n_real[d]
        }, clock)
        # fold only each shard's real slots
        parts = [host[d][: n_real[d]] for d in sorted(host)]
        return aggregations.reduce_bounds(np.concatenate(parts), None)
