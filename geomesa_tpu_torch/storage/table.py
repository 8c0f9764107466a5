"""IndexTable: one index's sorted, device-resident columnar table.

The port of the single-device scan engine of geomesa_tpu/storage/table.py.
Host side: the (bin, z) lexicographic sort, the permutation back to
feature ordinals and per-bin segment offsets, used for range -> row-span
-> block pruning. Device side: the predicate columns as
[n_blocks, SUB, 128] tensors, pad rows carrying never-matching sentinels.

A query is one kernel launch plus one device->host copy of its bit
planes: contained ranges' rows are taken from the spans directly, the
remaining candidate blocks go through the scan kernel, and host
refinement touches only the uncertain ``wide & ~inner`` rows. A polygon
query's scan runs the kernel's point-in-polygon and raster legs
(``_scan_kernel_kwargs``). Many queries pack into fused chunks, one launch
and one device->host copy per chunk (``scan_submit_many``); polygon
members fuse through per-query edge and raster stacks.

An extent (XZ) table holds the four f32 bbox columns (gxmin, gymin, gxmax,
gymax) instead of x and y. Its box leg is bbox-intersects, which never
certifies a geometry: an extent box scan writes and pulls the wide plane
alone, every hit refines on the host, and the polygon legs never run
(extent members fuse with empty edge and raster stacks).

The delta tier (storage.delta) wraps a table between compactions. A
compaction sorts only the delta and merges it into the old sort order
(``merged_table``), and a replace batch folds in without any whole-table
sort (``folded_table``); both keep every device block before the first
changed row. A fold on a CUDA table computes its columns on the card
from the old table's blocks and the batch's rows (``_fold_cols_device``),
so only the batch crosses PCIe.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch import conf, native
from geomesa_tpu_torch.index.api import IndexKeySpace, ScanConfig, WriteKeys
from geomesa_tpu_torch.planning.errors import check_deadline
from geomesa_tpu_torch.scan import aggregations
from geomesa_tpu_torch.scan import block_kernels as bk
from geomesa_tpu_torch.timing import NULL_CLOCK

_SENTINELS = {
    "x": np.float32(np.inf),
    "y": np.float32(np.inf),
    "tbin": np.int32(-1),
    "toff": np.int32(0),
    "tw": np.int32(-1),  # packed-time: bin -1 never matches
    # extent pads: an empty bbox (min = +inf, max = -inf) intersects nothing
    "gxmin": np.float32(np.inf),
    "gymin": np.float32(np.inf),
    "gxmax": np.float32(-np.inf),
    "gymax": np.float32(-np.inf),
}

# host state a table is rebuilt from (state.load_table_state)
STATE_KEYS = ("perm", "bins", "zs", "ubins", "bin_starts", "block")

# Fused-chunk shape (scan_submit_many), the JAX package's constants: a
# chunk's slot list pads to the table's ``fused_slots`` (this cap clamped
# down to the table's own block-count bucket, so a small table never scans
# a multiple of its size in pad slots) and its param stacks to
# FUSED_CHUNK_Q queries. Members wider than half a chunk take the
# single-query kernel. The routing thresholds are the JAX package's, tuned
# for a TPU's per-dispatch cost; they are not yet measured on the card.
FUSED_CHUNK_SLOTS = 2048
FUSED_CHUNK_Q = 128


def _block_rows(tile: "int | None") -> int:
    """Rows per device scan block for a ``tile`` request (multiples of
    4096, so SUB is a multiple of 32); shared by IndexTable and the fold
    plan's eligibility check so they cannot drift."""
    return bk.BLOCK if tile is None else max(4096, -(-int(tile) // 4096) * 4096)


def _device_fold_enabled(device: torch.device) -> bool:
    """Whether folded_table builds its columns through the device-side
    fold plan (``geomesa.stream.fold.device``): 'on' forces it; 'auto'
    (the default) takes it on a CUDA table, where the PCIe upload of the
    changed suffix is the cost it saves, and keeps the host gather on a
    CPU table, where every "upload" is a copy; 'off' never. The two
    builds are bit-identical."""
    mode = str(conf.STREAM_FOLD_DEVICE.get()).lower()
    if mode in ("on", "1", "true"):
        return True
    return mode == "auto" and device.type == "cuda"


class SortedKeys:
    """Host-side sorted key structure: the (bin, z) sort, the permutation
    back to feature ordinals, and searchsorted range -> row-span pruning."""

    def __init__(self, keyspace: IndexKeySpace, keys: WriteKeys, tile: int,
                 sorted_state: "np.ndarray | None" = None):
        self.keyspace = keyspace
        self.tile = tile
        self.n = len(keys.bins)
        if sorted_state is not None:
            # the caller already knows the sort order (merged_table,
            # folded_table): no sort at all
            perm = sorted_state
            self.rows_sorted = 0
        elif keys.sub is not None:
            # secondary sort words (string attribute indexes): the full
            # (bin, z, sub[0], ..., sub[W-1]) order, so z-tie runs stay
            # value-sorted and candidate_spans_split can narrow boundary
            # runs (np.lexsort: LAST key is most significant)
            sub_keys = tuple(keys.sub[:, j] for j in range(keys.sub.shape[1] - 1, -1, -1))
            perm = np.lexsort(sub_keys + (keys.zs, keys.bins))
            self.rows_sorted = self.n
        else:
            # stable (bin, z) sort: the native radix sort (equal to
            # np.lexsort((zs, bins))), numpy under native.disabled()
            perm = native.sort_bins_z(keys.bins, keys.zs)
            if perm is None:
                perm = np.lexsort((keys.zs, keys.bins))
            self.rows_sorted = self.n
        self.perm = perm  # table row -> feature ordinal (u32 or i64)
        self.bins = bins = _take(keys.bins, perm)
        self.zs = _take(keys.zs, perm)
        self.subkeys = keys.sub[perm] if keys.sub is not None else None  # [n, W]
        n = self.n
        # per-bin segments for searchsorted pruning: bins are sorted, so
        # segment boundaries come from one linear diff pass
        if n:
            starts = np.concatenate([[0], np.flatnonzero(bins[1:] != bins[:-1]) + 1])
            self.ubins = bins[starts]
        else:
            starts = np.zeros(0, np.int64)
            self.ubins = bins[:0]
        self.bin_starts = np.append(starts, n).astype(np.int64)

    def _narrow_lo(self, a: int, ae: int, words: np.ndarray) -> int:
        """First row >= the bound within the primary tie-run [a, ae):
        descend word by word: rows below the word are dropped, the
        word-tie run recurses, and final-level ties stay included."""
        for j in range(self.subkeys.shape[1]):
            if ae <= a:
                return a
            col = self.subkeys[a:ae, j]
            w = words[j] if j < len(words) else 0
            left = a + int(np.searchsorted(col, w, side="left"))
            right = a + int(np.searchsorted(col, w, side="right"))
            if right <= left:
                return left  # no exact ties at this word: done
            a, ae = left, right
        return a

    def _narrow_hi(self, hs: int, z: int, words: np.ndarray) -> int:
        """One past the last row <= the bound within the primary tie-run
        [hs, z): rows below the word are kept whole, the word-tie run
        recurses, rows above are dropped."""
        U64 = np.uint64(0xFFFFFFFFFFFFFFFF)
        for j in range(self.subkeys.shape[1]):
            if z <= hs:
                return z
            col = self.subkeys[hs:z, j]
            w = words[j] if j < len(words) else U64
            left = hs + int(np.searchsorted(col, w, side="left"))
            right = hs + int(np.searchsorted(col, w, side="right"))
            if right <= left:
                return left  # everything below the word is included
            hs, z = left, right
        return z

    def pad_cols(self, keys: WriteKeys, n_pad: int) -> dict:
        """The sorted device columns, each padded to ``n_pad`` rows with
        never-matching sentinels."""
        cols = {}
        for name, col in keys.device_cols.items():
            out = np.full(n_pad, _SENTINELS[name], dtype=col.dtype)
            out[: self.n] = _take(col, self.perm)
            cols[name] = out
        return cols

    # -- pruning ---------------------------------------------------------
    def candidate_spans(self, config: ScanConfig) -> list[tuple[int, int]]:
        """Merged, sorted row spans [lo, hi) covering ALL scan ranges
        (contained + overlapping) — the cost estimator's input."""
        overlap, contained = self.candidate_spans_split(config)
        return _merge_spans(overlap + contained)

    def candidate_spans_split(self, config: ScanConfig):
        """(overlap_spans, contained_spans): row spans [lo, hi) of the
        non-contained vs contained scan ranges. Contained ranges' rows are
        certain hits when ``config.contained_exact``."""
        cont_flags = config.range_contained
        use_contained = config.contained_exact and cont_flags is not None
        overlap: list[tuple[int, int]] = []
        contained: list[tuple[int, int]] = []
        for b in np.unique(config.range_bins):
            i = int(np.searchsorted(self.ubins, b))
            if i >= len(self.ubins) or self.ubins[i] != b:
                continue
            s, e = int(self.bin_starts[i]), int(self.bin_starts[i + 1])
            sel = config.range_bins == b
            seg = self.zs[s:e]
            lo = np.searchsorted(seg, config.range_lo[sel], side="left") + s
            hi = np.searchsorted(seg, config.range_hi[sel], side="right") + s
            if self.subkeys is not None and config.range_lo2 is not None:
                # narrow each range's boundary tie-runs by the secondary
                # sort words: rows sharing the lo (hi) primary code are
                # value-sorted by the word columns, so long-string bounds
                # prune exactly past the 8-byte prefix (ties at every word
                # stay included: a superset, refined exactly on the host)
                lo_end = np.searchsorted(seg, config.range_lo[sel], side="right") + s
                hi_start = np.searchsorted(seg, config.range_hi[sel], side="left") + s
                lo2 = config.range_lo2[sel]
                hi2 = config.range_hi2[sel]
                for k in range(len(lo)):
                    lo[k] = self._narrow_lo(int(lo[k]), int(lo_end[k]), lo2[k])
                    hi[k] = self._narrow_hi(int(hi_start[k]), int(hi[k]), hi2[k])
            if use_contained:
                cf = cont_flags[sel]
            else:
                cf = np.zeros(int(sel.sum()), dtype=bool)
            for a, z, c in zip(lo.tolist(), hi.tolist(), cf.tolist()):
                if z > a:
                    (contained if c else overlap).append((a, z))
        return _merge_spans(overlap), _merge_spans(contained)


def _take(col: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """col[perm]: the native gather for a u32 permutation, numpy otherwise."""
    if perm.dtype == np.uint32:
        out = native.take(col, perm)
        if out is not None:
            return out
    return col[perm]


def _merge_spans(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    if not spans:
        return []
    spans = sorted(spans)
    merged = [spans[0]]
    for a, z in spans[1:]:
        if a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], z))
        else:
            merged.append((a, z))
    return merged


def _span_rows(spans: list[tuple[int, int]]) -> np.ndarray:
    if not spans:
        return np.zeros(0, np.int64)
    return np.concatenate([np.arange(a, z, dtype=np.int64) for a, z in spans])


def _merge_sorted_rows(cont_rows: np.ndarray, kr: np.ndarray, kc: np.ndarray):
    """Merge two ascending row runs — contained rows (all certain) and
    kernel rows with their certainty — in O(n) by positional merge."""
    nm, nd = len(cont_rows), len(kr)
    if nd == 0:
        return cont_rows, np.ones(nm, bool)
    if nm == 0:
        return kr, kc
    pos = np.searchsorted(cont_rows, kr)
    kr_dest = pos + np.arange(nd, dtype=np.int64)
    cont_dest = np.arange(nm, dtype=np.int64) + np.searchsorted(
        pos, np.arange(nm, dtype=np.int64), side="right"
    )
    rows = np.empty(nm + nd, np.int64)
    certain = np.empty(nm + nd, bool)
    rows[cont_dest] = cont_rows
    certain[cont_dest] = True
    rows[kr_dest] = kr
    certain[kr_dest] = kc
    return rows, certain


def _spans_intersect(rng: tuple[int, int], spans: list[tuple[int, int]]) -> bool:
    """True when [rng.lo, rng.hi) intersects any [lo, hi) span."""
    lo, hi = rng
    for a, z in spans:
        if a < hi and z > lo:
            return True
    return False


def _rows_in_spans(rows: np.ndarray, spans: list[tuple[int, int]]) -> np.ndarray:
    """Boolean mask: which sorted ``rows`` fall inside any [lo, hi) span."""
    if not spans or len(rows) == 0:
        return np.zeros(len(rows), dtype=bool)
    los = np.array([s[0] for s in spans], dtype=np.int64)
    his = np.array([s[1] for s in spans], dtype=np.int64)
    idx = np.searchsorted(los, rows, side="right") - 1
    ok = idx >= 0
    return ok & (rows < his[np.clip(idx, 0, len(his) - 1)])


def _host_planes(host: np.ndarray, slots=slice(None)):
    """(wide, inner | None) of pulled planes [n_planes, M, SUB/32, 128] over
    ``slots``: inner is None where the kernel wrote the wide plane alone."""
    wide = np.ascontiguousarray(host[0, slots])
    return wide, np.ascontiguousarray(host[1, slots]) if len(host) == 2 else None


class IndexTable(SortedKeys):
    """Sorted columnar table for one (feature type, index) pair, its
    predicate columns on ``device``."""

    def __init__(
        self,
        keyspace: IndexKeySpace,
        keys: WriteKeys,
        tile: int | None = None,
        device="cuda",
        sorted_state: "np.ndarray | None" = None,
        reuse: "tuple[IndexTable, int] | None" = None,
        fold_plan: "tuple | None" = None,
    ):
        """``sorted_state``: the table's sort order (row -> feature
        ordinal), or None for the stable (bin, z) sort of ``keys``.
        ``reuse``: (old table, first changed sorted row): every device
        block before that row is taken from the old table and only the
        suffix uploads. ``fold_plan``: folded_table's description of a
        fold, from which the columns are computed on the device."""
        block = _block_rows(tile)
        super().__init__(keyspace, keys, block, sorted_state)
        self._set_layout(block, keys.device_cols, torch.device(device))
        self._reuse = reuse
        if type(self)._place_cols is not IndexTable._place_cols:
            # subclasses (the mesh and pod tables) own their layout through
            # the whole padded column set: they never reuse a prefix or
            # take the device fold, both of which assume one contiguous
            # device table
            self._place_cols(self.pad_cols(keys, self.n_pad), self.device)
        elif fold_plan is not None:
            self._fold_cols_device(fold_plan)
        else:
            self._stream_cols(keys)

    @classmethod
    def from_state(cls, keyspace: IndexKeySpace, state: dict, device) -> "IndexTable":
        """A table over host sort state and [n_blocks, SUB, 128] column
        arrays taken from another table (state.load_table_state)."""
        self = cls.__new__(cls)
        self.keyspace = keyspace
        self.n = len(state["perm"])
        self.perm = np.asarray(state["perm"])
        self.bins = np.asarray(state["bins"])
        self.zs = np.asarray(state["zs"])
        sub = state.get("subkeys")
        self.subkeys = None if sub is None else np.asarray(sub)
        self.ubins = np.asarray(state["ubins"])
        self.bin_starts = np.asarray(state["bin_starts"], np.int64)
        block = int(state["block"])
        self.tile = block
        cols = state["cols3"]
        self._set_layout(block, cols, torch.device(device))
        # copies: the table never aliases the caller's arrays
        self._place_cols({k: np.array(cols[k]) for k in self.col_names}, self.device)
        return self

    def _set_layout(self, block: int, cols: dict, device: torch.device) -> None:
        self.block = block
        self.sub = block // bk.LANES
        self.n_blocks = self._round_blocks(max(1, -(-self.n // block)))
        self.n_pad = self.n_blocks * block
        self.col_names = tuple(sorted(cols))
        self.extent = "gxmin" in cols
        self.device = device

    def _upload(self, col: np.ndarray) -> torch.Tensor:
        v3 = np.ascontiguousarray(col).reshape(-1, self.sub, bk.LANES)
        return torch.from_numpy(v3).to(self.device)

    # -- layout hooks ----------------------------------------------------
    # The mesh and pod tables (parallel.dtable, pod.table) override these
    # and the device hooks below (_device_scan_submit, _device_pops,
    # _device_density_submit, _device_bounds, _submit_fused_chunk); the
    # pruning, exactness tier and decode stay this class's.

    def _round_blocks(self, n_blocks: int) -> int:
        """Block-count rounding hook (a mesh table rounds up to a multiple
        of its shard count)."""
        return n_blocks

    # a per-table fused slot cap: a pod host group stamps one per host
    # shard (None = the process-wide link constants)
    _slot_cap: "int | None" = None

    def _place_cols(self, cols: dict, device: torch.device) -> None:
        """Layout hook: put padded sorted columns (``n_pad`` rows each) on
        ``device`` in the [n_blocks, SUB, 128] scan layout. A table built
        from keys streams its columns instead (``_stream_cols``)."""
        self.rows_uploaded = self.n_pad
        self.cols3 = {k: self._upload(v) for k, v in cols.items()}

    def _reuse_prefix(self, col_names) -> tuple:
        """(old table, first reusable block count) from ``self._reuse``,
        or (None, 0) when nothing can be reused."""
        if self._reuse is not None:
            cand, first_row = self._reuse
            if cand.block == self.block and set(cand.col_names) == set(col_names):
                return cand, min(first_row // self.block, cand.n_blocks, self.n_blocks)
        return None, 0

    def _stream_cols(self, keys: WriteKeys) -> None:
        """Build and upload the sorted padded columns one at a time,
        gathering each through block-aligned spans of
        ``geomesa.tpu.compact.span.rows`` rows, and release the host copy
        before the next column (host peak: one padded column). With
        ``self._reuse`` set, only rows past the first changed block are
        gathered and uploaded; the prefix blocks stay the old table's."""
        old, first_block = self._reuse_prefix(set(keys.device_cols))
        self.rows_uploaded = (self.n_blocks - first_block) * self.block
        lo = first_block * self.block  # first sorted row to (re)build
        span = max(self.block, (conf.COMPACT_SPAN_ROWS.get() // self.block) * self.block)
        self.cols3 = {}
        for k in self.col_names:
            col = keys.device_cols[k]
            out = np.empty(self.n_pad - lo, dtype=col.dtype)
            for s in range(lo, self.n, span):
                e = min(s + span, self.n)
                out[s - lo : e - lo] = _take(col, self.perm[s:e])
            out[self.n - lo :] = _SENTINELS[k]  # pad rows never match
            suffix = self._upload(out)
            if old is not None and first_block > 0:
                self.cols3[k] = torch.cat([old.cols3[k][:first_block], suffix])
            else:
                self.cols3[k] = suffix
            del out, suffix

    def _fold_cols_device(self, plan) -> None:
        """The device-side fold plan: the new sorted columns are a
        permutation of the old table's device rows plus the batch's, so
        only the fold's description (removed sorted positions, insert
        destinations, the batch's sorted rows) goes to the device, and
        the device computes each new row's source:

        - a non-insert destination ``i`` holds survivor rank
          ``r = i - #inserts<=i``; its old sorted position solves
          ``p = r + #removed<=p``, one searchsorted over
          ``removed - arange`` (a non-decreasing key);
        - an insert destination takes the batch's sorted row;
        - pad rows past ``self.n`` take the never-matching sentinels.

        PyTorch ops on the table's device, one gather per column.
        Bit-identical to the host build: every value is a copy of an old
        table or batch value. ``rows_uploaded`` records the rows that
        crossed to the device: the batch's."""
        old, removed, delta_dest, delta_sorted_cols = plan
        nr, nd = len(removed), len(delta_dest)
        dev = self.device
        # i32 position math: folded_table gates the plan to < 2**31 rows
        i = torch.arange(self.n_pad, dtype=torch.int32, device=dev)
        is_ins = ins_idx = None
        if nd:
            dd = torch.from_numpy(np.asarray(delta_dest, np.int32)).to(dev)
            k_ins = torch.searchsorted(dd, i, right=True, out_int32=True)
            ins_idx = torch.clamp(k_ins - 1, 0, nd - 1)
            is_ins = (k_ins > 0) & (dd[ins_idx] == i)
            r = i - k_ins
        else:
            r = i
        if nr:
            rem_adj = np.asarray(removed, np.int64) - np.arange(nr, dtype=np.int64)
            rem_adj = torch.from_numpy(rem_adj.astype(np.int32)).to(dev)
            src = r + torch.searchsorted(rem_adj, r, right=True, out_int32=True)
        else:
            src = r
        # PyTorch raises on an index past the end where the JAX take clamps
        src = torch.clamp(src, 0, max(old.n_pad - 1, 0))
        valid = i < self.n
        self.rows_uploaded = nd  # only the batch's rows cross to the device
        self.cols3 = {}
        for k in self.col_names:
            vals = old.cols3[k].reshape(-1)[src]
            if is_ins is not None:
                dvals = torch.from_numpy(np.ascontiguousarray(delta_sorted_cols[k])).to(dev)
                vals = torch.where(is_ins, dvals[ins_idx], vals)
            pad = torch.tensor(_SENTINELS[k], dtype=vals.dtype, device=dev)
            vals = torch.where(valid, vals, pad)
            self.cols3[k] = vals.reshape(self.n_blocks, self.sub, bk.LANES)

    # -- scanning --------------------------------------------------------
    def candidate_blocks(self, spans: list[tuple[int, int]]) -> np.ndarray:
        if not spans:
            return np.zeros(0, np.int64)
        ids = [
            np.arange(a // self.block, (z - 1) // self.block + 1, dtype=np.int64)
            for a, z in spans
        ]
        return np.unique(np.concatenate(ids))

    def scan(self, config: ScanConfig, deadline=None) -> tuple[np.ndarray, np.ndarray]:
        """One-call device scan -> (ordinals, certain): feature ordinals of
        all candidate hits, ascending in table order, and per row whether
        it is a certain f64-exact hit (inner plane or contained range).

        ``deadline``: an optional Deadline (or monotonic cutoff); the scan
        checks it at stage boundaries (range pruning, before the launch,
        after the copy that ends it) and raises QueryTimeout when overdue
        (reference ThreadManagement scan timeouts)."""
        return self.scan_submit(config, deadline=deadline)()

    def scan_submit(self, config: ScanConfig, clock=NULL_CLOCK, deadline=None):
        """Launch the device work now; return ``finish()`` -> (ordinals,
        certain)."""
        if config.disjoint or self.n == 0:
            return lambda: (np.zeros(0, np.int64), np.zeros(0, bool))
        check_deadline(deadline, "range pruning")
        overlap, contained = self.candidate_spans_split(config)
        if config.boxes is None and config.windows is None:
            # a pure range scan (an attribute index's value ranges): the
            # spans are row-exact and no kernel runs
            cont_rows = _span_rows(contained)
            rows = np.union1d(_span_rows(overlap), cont_rows) if overlap else cont_rows
            out = (self.perm[rows].astype(np.int64), np.ones(len(rows), bool))
            return lambda: out
        blocks = self.candidate_blocks(overlap)
        if len(blocks) == 0:
            return self._contained_only(contained)
        check_deadline(deadline, "device scan dispatch")
        return self._make_finish(
            self._device_scan_submit(blocks, config, clock), config, overlap, contained, clock,
            deadline,
        )

    def _contained_only(self, contained):
        """finish() of a scan with no candidate block: the contained
        spans' rows, all certain."""
        cont_rows = _span_rows(contained)
        out = (self.perm[cont_rows].astype(np.int64), np.ones(len(cont_rows), bool))
        return lambda: out

    def _make_finish(self, finish_device, config, overlap, contained, clock=NULL_CLOCK,
                     deadline=None):
        """finish() over a launched device scan: decode + _post_decode.
        Shared by scan_submit and the fused path's single-query members.
        The deadline check follows the copy that ends the scan."""

        def finish() -> tuple[np.ndarray, np.ndarray]:
            rows, certain = finish_device()
            check_deadline(deadline, "bitmask decode")
            with clock.host("decode"):
                return self._post_decode(rows, certain, config, overlap, contained)

        return finish

    def _post_decode(self, rows, certain, config, overlap, contained):
        """Decoded kernel rows -> (feature ordinals, certain): clipped
        back to the spans where they are row-exact (``clip_rows``: kernel
        hits are block granular), united with the contained spans' rows
        (all certain; the native two-pointer merge), then the permutation
        to feature ordinals. Shared by the per-query and fused paths."""
        if config.clip_rows:
            keep = _rows_in_spans(rows, _merge_spans(overlap + contained))
            rows, certain = rows[keep], certain[keep]
        if contained:
            merged = native.merge_rows_spans(contained, rows, certain)
            if merged is not None:
                rows, certain = merged
            else:
                dup = _rows_in_spans(rows, contained)
                rows, certain = _merge_sorted_rows(
                    _span_rows(contained), rows[~dup], certain[~dup]
                )
        return self.perm[rows].astype(np.int64), certain

    # -- fused multi-query scans -----------------------------------------
    @property
    def fused_slots(self) -> int:
        """Slot count of this table's fused-chunk shape: the slot cap in
        force (bk.fused_slot_cap: the compiled FUSED_CHUNK_SLOTS unless a
        link profile or the geomesa.scan.fused.slots knob sets another)
        clamped down to the table's block-count bucket (2048 at 100M rows
        of 16384-row blocks). ``_slot_cap`` is a per-table cap (a pod
        host's shard)."""
        return min(bk.fused_slot_cap(self._slot_cap), bk.bucket_of(self.n_blocks))

    @property
    def fused_pack_capacity(self) -> int:
        """Candidate blocks the chunk packer fills per fused chunk (the
        slot count, on a one-device table)."""
        return self.fused_slots

    def scan_submit_many(self, configs: list, clock=NULL_CLOCK, deadline=None) -> list:
        """Fused form of :meth:`scan_submit` for many queries: configs
        group by kernel variant (projected columns, boxes, windows, and
        the fused edge and interval buckets of polygon members), pack
        greedily in input order into chunks of at most
        ``fused_pack_capacity`` candidate blocks and FUSED_CHUNK_Q queries,
        and each chunk is one fused kernel launch. Returns one
        ``finish() -> (ordinals, certain)`` per config, in input order; a
        chunk's planes come to the host once, on its first member's
        finish, and each member decodes its own slot segment."""
        finishes: list = [None] * len(configs)
        groups: dict[tuple, list] = {}
        for j, config in enumerate(configs):
            if config.disjoint or self.n == 0:
                out = (np.zeros(0, np.int64), np.zeros(0, bool))
                finishes[j] = lambda out=out: out
                continue
            check_deadline(deadline, "range pruning")
            if config.boxes is None and config.windows is None:
                # pure range scans (row-exact spans, no kernel) keep the
                # per-query path
                finishes[j] = self.scan_submit(config, clock, deadline=deadline)
                continue
            overlap, contained = self.candidate_spans_split(config)
            blocks = self.candidate_blocks(overlap)
            if len(blocks) == 0:
                finishes[j] = self._contained_only(contained)
                continue
            blocks = self._full_or(blocks)
            names = self._scan_cols(config)
            # the E and R buckets are part of the variant key (the JAX
            # package's): box queries group at E = R = 0, polygons per
            # fused bucket pair. The key also keeps raster-only, PIP-only
            # and both-leg members apart: a raster-only member in an E > 0
            # chunk would compute full | (part & (0 | 0)) and drop its
            # partial rows
            key = (
                names, config.boxes is not None, config.windows is not None,
                0 if self.extent else bk.fused_e_bucket(bk.n_edges_of(config.poly)),
                0 if self.extent else bk.fused_r_bucket(bk.n_rints_of(config.rast)),
            )
            groups.setdefault(key, []).append((j, config, blocks, overlap, contained))

        slots = self.fused_pack_capacity
        for (names, has_boxes, has_windows, _e, _r), members in groups.items():
            # members broader than half a chunk (e.g. _full_or expansions)
            # go alone on the single-query kernel; the rest pack greedily
            chunks: list[list] = []
            cur: list = []
            cur_blocks = 0
            for m in members:
                nb = len(m[2])
                if nb > slots // 2:
                    chunks.append([m])
                    continue
                if cur and (cur_blocks + nb > slots or len(cur) == FUSED_CHUNK_Q):
                    chunks.append(cur)
                    cur, cur_blocks = [], 0
                cur.append(m)
                cur_blocks += nb
            if cur:
                chunks.append(cur)
            for chunk in chunks:
                self._submit_fused_chunk(
                    chunk, names, has_boxes, has_windows, finishes, clock, deadline,
                )
        return finishes

    def _fused_route_single(self, members, finishes, clock=NULL_CLOCK, deadline=None) -> bool:
        """Send a one-member or near-empty chunk to the single-query kernel
        (the fixed fused shape would spend most of its work on pad slots);
        returns True when routed."""
        if len(members) == 1 or (
            len(members) <= 8
            and sum(len(m[2]) for m in members) < self.fused_pack_capacity // 8
        ):
            for j, config, blocks, overlap, contained in members:
                finishes[j] = self._make_finish(
                    self._device_scan_submit(blocks, config, clock), config, overlap,
                    contained, clock, deadline,
                )
            return True
        return False

    def _fused_param_stacks(self, members):
        """(boxes, wins) [FUSED_CHUNK_Q, 8, 128] per-query param stacks of
        one fused chunk; rows past the members stay zero (no slot reads
        them)."""
        boxes = np.zeros((FUSED_CHUNK_Q, 8, bk.LANES), np.float32)
        wins = np.zeros((FUSED_CHUNK_Q, 8, bk.LANES), np.int32)
        for q, m in enumerate(members):
            boxes[q], wins[q] = self._params(m[1])
        return boxes, wins

    def _chunk_edge_stack(self, members):
        """(chunk_E, edges [FUSED_CHUNK_Q, chunk_E, 128] | None, pip [n]
        bool) of one fused chunk: the per-query edge stack, sized to the
        chunk's largest member polygon and zero-padded per query (pad rows
        never cross and are never near). Extent chunks ride E = 0: their
        device test is bbox-intersects."""
        pip = np.zeros(len(members), bool)
        if self.extent:
            return 0, None, pip
        chunk_e = bk.fused_e_bucket(max(bk.n_edges_of(m[1].poly) for m in members))
        if chunk_e == 0:
            return 0, None, pip
        edges = np.zeros((FUSED_CHUNK_Q, chunk_e, bk.LANES), np.float32)
        for q, m in enumerate(members):
            poly = m[1].poly
            if poly is not None:
                edges[q, : poly.shape[0]] = poly
                pip[q] = True
        return chunk_e, edges, pip

    def _chunk_raster_stack(self, members):
        """(chunk_R, rasts [FUSED_CHUNK_Q, 1 + chunk_R, 128] | None, rast [n]
        bool) of one fused chunk: the per-query raster stack (pack_block
        header + intervals), sized to the chunk's largest member raster
        and zero-padded per query (pad interval rows never classify; an
        all-zero header puts every row outside the grid, and such slots
        never select the polygon legs). Extent chunks ride R = 0."""
        has = np.zeros(len(members), bool)
        if self.extent:
            return 0, None, has
        chunk_r = bk.fused_r_bucket(max(bk.n_rints_of(m[1].rast) for m in members))
        if chunk_r == 0:
            return 0, None, has
        rasts = np.zeros((FUSED_CHUNK_Q, 1 + chunk_r, bk.LANES), np.float32)
        for q, m in enumerate(members):
            rast = m[1].rast
            if rast is not None:
                rasts[q, : rast.shape[0]] = rast
                has[q] = True
        return chunk_r, rasts, has

    def _fused_pull(self, planes, clock=NULL_CLOCK):
        """``pull() -> host planes [n_planes, M, SUB/32, 128]``, memoized: the
        chunk's planes come to the host in one copy, on the first member's
        finish, for every member."""
        pulled: list = []

        def pull() -> np.ndarray:
            if not pulled:
                with clock.device("d2h", self.device):
                    pulled.append(planes.cpu().numpy())
            return pulled[0]

        return pull

    def _submit_fused_chunk(self, members, names, has_boxes, has_windows, finishes,
                            clock=NULL_CLOCK, deadline=None) -> None:
        """Launch one fused chunk: slot segments per member, pad slots
        (bid 0, qid 0, spip 0) after them up to ``fused_slots``; with
        polygon members, the edge and raster stacks and a per-slot
        selector ``spip`` (1 where the slot's query takes the polygon
        legs)."""
        if self._fused_route_single(members, finishes, clock, deadline):
            return
        check_deadline(deadline, "device scan dispatch")
        boxes, wins = self._fused_param_stacks(members)
        chunk_e, edges, pip = self._chunk_edge_stack(members)
        chunk_r, rasts, has_rast = self._chunk_raster_stack(members)
        segs: list[tuple[int, int]] = []
        pos = 0
        for m in members:
            segs.append((pos, pos + len(m[2])))
            pos += len(m[2])
        bids, n_real = bk.pad_bids(
            np.concatenate([m[2] for m in members]), self.n_blocks, bucket=self.fused_slots
        )
        qids = np.zeros(len(bids), np.int32)
        qids[:n_real] = np.repeat(np.arange(len(members), dtype=np.int32),
                                  [len(m[2]) for m in members])
        spip = None
        if chunk_e or chunk_r:
            spip = (pip | has_rast)[qids].astype(np.int32)
            spip[n_real:] = 0  # pad slots keep the box leg
        planes = bk.scan_planes_multi(
            self._cols_args(names), bids, qids, boxes, wins, col_names=names,
            has_boxes=has_boxes, has_windows=has_windows, extent=self.extent, edges=edges,
            spip=spip, n_edges=chunk_e, rasts=rasts, n_rints=chunk_r, clock=clock,
        )
        pull = self._fused_pull(planes, clock)

        def member_finish(k: int):
            _, config, blocks, overlap, contained = members[k]
            s, e = segs[k]
            host = pull()
            check_deadline(deadline, "bitmask decode")
            with clock.host("decode"):
                rows, certain = bk.decode_bits_pair(
                    *_host_planes(host, slice(s, e)), blocks, e - s,
                )
                return self._post_decode(rows, certain, config, overlap, contained)

        for k, m in enumerate(members):
            finishes[m[0]] = lambda k=k: member_finish(k)

    # -- device hooks ----------------------------------------------------
    def _params(self, config: ScanConfig):
        """(boxes, windows) packed [8, 128] kernel param blocks (wide +
        inner planes). Packed-time tables convert window offsets to device
        ticks first — floor-wide / shrink-inner, so tick-boundary rows
        refine on host like f32 box edges."""
        boxes = bk.pack_boxes(config.boxes, config.boxes_inner)
        shift = getattr(self.keyspace, "packed_time", None)
        if shift is not None and config.windows is not None:
            from geomesa_tpu_torch.index.z3 import windows_to_ticks

            wide = bk.merge_window_slots(
                windows_to_ticks(config.windows, shift, inner=False),
                overflow="widen",
            )
            wi = config.windows_inner
            if wi is not None:
                wi = np.asarray(windows_to_ticks(wi, shift, inner=True))
                wi = wi[wi[:, 1] <= wi[:, 2]] if len(wi) else wi
            inner = (
                bk.merge_window_slots(wi, overflow="drop")
                if wi is not None and len(wi) else None
            )
            return boxes, bk.pack_windows(wide, inner)
        wins = bk.pack_windows(
            bk.merge_window_slots_wide(config), bk.merge_window_slots_inner(config)
        )
        return boxes, wins

    def _full_or(self, blocks: np.ndarray) -> np.ndarray:
        """Past the largest static M bucket, scan every block — one static
        shape per table instead of an unbounded bucket ladder."""
        if len(blocks) > bk.M_BUCKETS[-1]:
            return np.arange(self.n_blocks, dtype=np.int64)
        return blocks

    def _coord_cols(self) -> set:
        want = set(bk.EXTENT_COLS) if self.extent else {"x", "y"}
        return want & set(self.col_names)

    def _scan_cols(self, config: ScanConfig) -> tuple:
        """Device columns this scan's predicate actually reads."""
        names: set = set()
        if config.boxes is not None:
            names |= self._coord_cols()
        if config.windows is not None:
            names |= {"tbin", "toff", "tw"} & set(self.col_names)
        if not names:
            # no predicate: one validity column (sentinel test in the legs)
            for v in ("x", "gxmin", "tw", "tbin"):
                if v in self.col_names:
                    names = {v}
                    break
        return tuple(sorted(names))

    def _agg_cols(self, config: ScanConfig) -> tuple:
        """Aggregations additionally read the representative coordinates."""
        return tuple(sorted(set(self._scan_cols(config)) | self._coord_cols()))

    def _kernel_kwargs(self, config: ScanConfig, names: tuple) -> dict:
        return dict(
            col_names=names,
            has_boxes=config.boxes is not None,
            has_windows=config.windows is not None,
            extent=self.extent,
        )

    def _scan_kernel_kwargs(self, config: ScanConfig, names: tuple) -> dict:
        """Kernel kwargs of the scan path: the box legs plus the
        point-in-polygon and raster legs. The aggregation kernels keep
        ``_kernel_kwargs`` (the box test); polygon configs take the host
        aggregation path (mask_decides_filter's for_aggregation). Extent
        tables never take the polygon legs: their device test is the
        bbox-intersects box leg."""
        kw = self._kernel_kwargs(config, names)
        if config.poly is not None and not self.extent:
            kw["edges"] = config.poly
            kw["n_edges"] = bk.n_edges_of(config.poly)
        if config.rast is not None and not self.extent:
            kw["rast"] = config.rast
            kw["n_rints"] = bk.n_rints_of(config.rast)
        return kw

    def _cols_args(self, names: tuple) -> tuple:
        return tuple(self.cols3[k] for k in names)

    def _device_scan_submit(self, blocks: np.ndarray, config: ScanConfig, clock=NULL_CLOCK):
        """Launch the scan kernel now; return finish() -> (rows, certain).
        The planes come back in one device->host copy (the wide plane
        alone on an extent box scan)."""
        blocks = self._full_or(blocks)
        bids, n_real = bk.pad_bids(blocks, self.n_blocks)
        boxes, wins = self._params(config)
        names = self._scan_cols(config)
        planes = bk.scan_planes(
            self._cols_args(names), bids, boxes, wins,
            clock=clock, **self._scan_kernel_kwargs(config, names),
        )

        def finish():
            with clock.device("d2h", self.device):
                host = planes.cpu().numpy()
            with clock.host("decode"):
                return bk.decode_bits_pair(*_host_planes(host), bids, n_real)

        return finish

    def _device_pops(self, blocks: np.ndarray, config: ScanConfig, clock=NULL_CLOCK):
        """Per-candidate-block wide-hit counts -> (pops [n] i64, block ids
        [n] i64). Pulls M ints, never bit planes."""
        blocks = self._full_or(blocks)
        bids, n_real = bk.pad_bids(blocks, self.n_blocks)
        boxes, wins = self._params(config)
        names = self._scan_cols(config)
        pops = aggregations.block_pops(
            self._cols_args(names), bids, boxes, wins,
            clock=clock, **self._kernel_kwargs(config, names),
        )
        with clock.device("d2h", self.device):
            pops = pops.cpu().numpy()
        return pops[:n_real].astype(np.int64), bids[:n_real].astype(np.int64)

    # -- counting --------------------------------------------------------
    def count(self, config: ScanConfig, clock=NULL_CLOCK) -> int:
        """Wide-predicate hit count (a superset of the exact count where
        boundary rows would refine away) without materializing row ids:
        contained spans count by length, the other candidate blocks by the
        device popcount of their wide plane; only blocks straddling a
        contained span (whose rows the spans already counted) decode."""
        if config.disjoint or self.n == 0:
            return 0
        overlap, contained = self.candidate_spans_split(config)
        cont_total = sum(z - a for a, z in contained)
        if config.boxes is None and config.windows is None:
            return cont_total + sum(z - a for a, z in overlap)
        if config.clip_rows:  # span-exact clipping needs the rows
            rows, _ = self.scan_submit(config, clock)()
            return len(rows)
        blocks = self.candidate_blocks(overlap)
        if len(blocks) == 0:
            return cont_total
        pops, gbids = self._device_pops(blocks, config, clock)
        if not contained:
            return int(pops.sum())
        straddle = np.array(
            [_spans_intersect((b * self.block, (b + 1) * self.block), contained) for b in gbids]
        )
        total = int(pops[~straddle].sum()) + cont_total
        if straddle.any():
            rows, _ = self._device_scan_submit(gbids[straddle], config, clock)()
            total += int((~_rows_in_spans(rows, contained)).sum())
        return total

    # -- aggregation push-down -------------------------------------------
    def _agg_blocks(self, config: ScanConfig) -> np.ndarray:
        """Candidate blocks over ALL scan ranges (contained rows pass the
        wide predicate, so aggregations just run the kernel over them)."""
        overlap, contained = self.candidate_spans_split(config)
        return self.candidate_blocks(_merge_spans(overlap + contained))

    def _agg_candidates(self, config: ScanConfig) -> "np.ndarray | None":
        """Candidate blocks of an aggregation, or None when there is
        nothing to scan."""
        if config.disjoint or self.n == 0:
            return None
        blocks = self._agg_blocks(config)
        return blocks if len(blocks) else None

    def _agg_args(self, blocks: np.ndarray, config: ScanConfig):
        """(cols3, padded bids (-1 pads), n_real, boxes, wins, kwargs) of an
        aggregation kernel over candidate ``blocks``."""
        blocks = self._full_or(blocks)
        bids, n_real = bk.pad_bids(blocks, self.n_blocks, pad=-1)
        boxes, wins = self._params(config)
        names = self._agg_cols(config)
        return (
            self._cols_args(names), bids, n_real, boxes, wins,
            self._kernel_kwargs(config, names),
        )

    def agg_launch_args(self, config: ScanConfig):
        """(cols3, padded bids (-1 pads), n_real, boxes, wins, kwargs) of an
        aggregation kernel over this config's candidate blocks, or None
        when there is nothing to scan."""
        blocks = self._agg_candidates(config)
        return None if blocks is None else self._agg_args(blocks, config)

    def bounds_stats(self, config: ScanConfig, clock=NULL_CLOCK):
        """(count, (xmin, ymin, xmax, ymax)) of wide-predicate hits on
        device (the StatsScan Count/MinMax(geom) fast path; loose f32
        semantics)."""
        blocks = self._agg_candidates(config)
        if blocks is None:
            return 0, None
        return self._device_bounds(blocks, config, clock)

    def _device_bounds(self, blocks: np.ndarray, config: ScanConfig, clock=NULL_CLOCK):
        """Device hook of :meth:`bounds_stats`: the bounds kernel over
        candidate ``blocks``, folded on the host."""
        cols3, bids, n_real, boxes, wins, kw = self._agg_args(blocks, config)
        stats = aggregations.block_bounds(cols3, bids, boxes, wins, clock=clock, **kw)
        with clock.device("d2h", self.device):
            host = stats.cpu().numpy()
        return aggregations.reduce_bounds(host, n_real)

    def density(self, config: ScanConfig, bounds, width: int, height: int,
                clock=NULL_CLOCK) -> np.ndarray:
        """[height, width] density grid over ``bounds``, computed on the
        device (the DensityScan push-down tier)."""
        return self.density_submit(config, bounds, width, height, clock)()

    def density_submit(self, config: ScanConfig, bounds, width: int, height: int,
                       clock=NULL_CLOCK):
        """Launch the density kernel now (the DensityScan push-down tier:
        a [height, width] grid over ``bounds``); return finish() -> grid.
        A batch of map tiles launches every tile's kernel before pulling
        any grid (DataStore.density_many)."""
        blocks = self._agg_candidates(config)
        if blocks is None:
            return lambda: np.zeros((height, width), dtype=np.float32)
        gb = np.asarray(bounds, dtype=np.float32).reshape(4)
        return self._device_density_submit(blocks, config, gb, width, height, clock)

    def _device_density_submit(self, blocks: np.ndarray, config: ScanConfig, grid_bounds,
                               width: int, height: int, clock=NULL_CLOCK):
        """Launch the density kernel over candidate ``blocks``; return
        finish() -> grid (one device->host copy). The device hook beside
        ``_device_scan_submit`` and ``_device_pops``."""
        cols3, bids, _, boxes, wins, kw = self._agg_args(blocks, config)
        grid = aggregations.block_density(
            cols3, bids, boxes, wins, grid_bounds, width=width, height=height,
            clock=clock, **kw,
        )

        def finish() -> np.ndarray:
            with clock.device("d2h", self.device):
                return grid.cpu().numpy()

        return finish

    # -- warm-up ---------------------------------------------------------
    def warmup(self) -> int:
        """Launch every scan-kernel shape this table can hit once: each M
        bucket up to the table's size (and the full-table shape past the
        ladder) for the table's natural predicate flags, then the fused
        chunk shape per flag combination, with the edge and interval
        buckets on a point table. On the card the first launch loads each
        kernel library. Returns the number of kernel calls issued (the
        JAX package's count for the same table)."""
        if self.n == 0:
            return 0
        sizes = sorted({
            *(m for m in bk.M_BUCKETS if m <= self.n_blocks),
            min(bk.bucket_of(self.n_blocks), max(self.n_blocks, bk.M_BUCKETS[0])),
        })
        if self.n_blocks > bk.M_BUCKETS[-1]:
            sizes.append(bk.M_BUCKETS[-1] + 1)  # the full-scan shape
        has_windows = bool({"tbin", "tw"} & set(self.col_names))
        # (False, False) is the no-predicate (validity column) variant
        flag_combos = [(True, False), (False, False)]
        if has_windows:
            flag_combos = [(True, True), (True, False), (False, True), (False, False)]

        def make_cfg(has_boxes: bool, has_w: bool) -> ScanConfig:
            return ScanConfig(
                index="warmup",
                range_bins=np.zeros(1, np.int32),
                range_lo=np.zeros(1, np.uint64),
                range_hi=np.zeros(1, np.uint64),
                boxes=np.array([[0.0, 0.0, 1e-6, 1e-6]], np.float32) if has_boxes else None,
                windows=np.array([[0, 0, 0]], np.int32) if has_w else None,
            )

        calls = 0
        for m in sizes:
            blocks = np.arange(min(m, self.n_blocks), dtype=np.int64)
            for has_boxes, has_w in flag_combos:
                self._device_scan_submit(blocks, make_cfg(has_boxes, has_w))()
                calls += 1
        # the fused chunk shape: E = R = 0 for box members; point tables
        # also take the edge and interval buckets (polygon members always
        # carry a box)
        pip_ok = not self.extent and {"x", "y"} <= set(self.col_names)
        for has_boxes, has_w in flag_combos:
            if not (has_boxes or has_w):
                continue  # the fused path needs a predicate
            ladder = [(0, 0)] + (
                [(e, 0) for e in bk.FUSED_E_BUCKETS] + [(0, r) for r in bk.FUSED_R_BUCKETS]
                if (pip_ok and has_boxes) else []
            )
            for n_e, n_r in ladder:
                cfg = make_cfg(has_boxes, has_w)
                if n_e:
                    cfg.poly = np.zeros((n_e, bk.LANES), np.float32)
                if n_r:
                    cfg.rast = np.zeros((1 + n_r, bk.LANES), np.float32)
                    cfg.rast[1:, 0] = 1.0  # pad intervals never match
                names = self._scan_cols(cfg)
                # half a chunk of blocks over two members: past the
                # small-batch routing threshold, so the fused kernel runs
                blk = (np.arange(max(self.fused_pack_capacity // 4, 1))
                       % self.n_blocks).astype(np.int64)
                fins: list = [None, None]
                self._submit_fused_chunk(
                    [(0, cfg, blk, [], []), (1, cfg, blk, [], [])], names, has_boxes, has_w, fins,
                )
                for f in fins:
                    f()
                calls += 1
        return calls

    @property
    def nbytes_device(self) -> int:
        return sum(int(v.numel() * v.element_size()) for v in self.cols3.values())


def _sort_bins_z(keys: WriteKeys) -> np.ndarray:
    """i64 stable (bin, z) sort order of ``keys``: the native radix sort,
    np.lexsort under native.disabled()."""
    perm = native.sort_bins_z(keys.bins, keys.zs)
    if perm is None:
        perm = np.lexsort((keys.zs, keys.bins))
    return np.asarray(perm, dtype=np.int64)


def folded_table(
    old: IndexTable,
    merged_keys: WriteKeys,
    keep_ordinal: "np.ndarray | None",
    ordinal_map: "np.ndarray | None",
    delta_keys: WriteKeys,
    delta_perm: "np.ndarray | None" = None,
    tile: int | None = None,
) -> IndexTable:
    """Incremental replace-merge: fold a delete + insert batch into a
    sorted table without a whole-table sort (the streaming hot -> cold
    merge, ``DataStore.fold_upsert``):

    - survivors keep their relative sorted order;
    - the batch sorts alone (or arrives sorted as ``delta_perm``) and
      two-run merges into the survivors with ``side='right'`` ties: new
      rows land after equal-key survivors, where the stable whole-table
      sort of ``concat(survivors, batch)`` puts them, so the result is
      bit-identical to a full rebuild;
    - device blocks before the first touched sorted row are reused;
      with the device fold plan (``geomesa.stream.fold.device``) the
      columns are computed on the device and only the batch uploads.

    ``merged_keys`` must be ``concat(masked old keys, delta_keys)`` in
    ordinal order; ``keep_ordinal`` is the survivor mask over old feature
    ordinals (None = nothing deleted) and ``ordinal_map`` maps old
    ordinals to post-delete ordinals. The table stays on ``old``'s
    device. Tables with a secondary sort word rebuild outright, like
    :func:`merged_table`."""
    nd = len(delta_keys.zs)
    if old.n == 0 or merged_keys.sub is not None:
        return IndexTable(old.keyspace, merged_keys, tile=tile, device=old.device)
    if keep_ordinal is None:
        keep_sorted = None
        nm = old.n
        sbins, szs = old.bins, old.zs
        sperm = np.asarray(old.perm, dtype=np.int64)
        first_del = old.n
    else:
        # survivor mask in sorted order: a sorted row survives when its
        # feature ordinal does
        keep_sorted = keep_ordinal[np.asarray(old.perm, dtype=np.int64)]
        nm = int(keep_sorted.sum())
        if nm == 0:
            return IndexTable(old.keyspace, merged_keys, tile=tile, device=old.device)
        sbins = old.bins[keep_sorted]
        szs = old.zs[keep_sorted]
        sperm = ordinal_map[np.asarray(old.perm, dtype=np.int64)[keep_sorted]]
        first_del = int(np.argmax(~keep_sorted)) if not keep_sorted.all() else old.n

    if nd == 0:
        perm = sperm
        first_change = first_del
    else:
        if delta_perm is not None and len(delta_perm) == nd:
            dperm = np.asarray(delta_perm, dtype=np.int64)
        else:
            dperm = _sort_bins_z(delta_keys)
        db = delta_keys.bins[dperm]
        dz = delta_keys.zs[dperm]
        # per-bin survivor segments for the insertion searchsorted
        subins, sstarts = np.unique(sbins, return_index=True)
        sstarts = np.append(sstarts, nm).astype(np.int64)
        pos = np.empty(nd, np.int64)
        for b in np.unique(db):
            i = int(np.searchsorted(subins, b))
            if i < len(subins) and subins[i] == b:
                s, e = int(sstarts[i]), int(sstarts[i + 1])
            else:
                s = e = int(sstarts[i]) if i < len(sstarts) else nm
            sel = db == b
            # side='right': batch rows land after equal-key survivors
            pos[sel] = np.searchsorted(szs[s:e], dz[sel], side="right") + s
        main_dest = np.arange(nm, dtype=np.int64) + np.searchsorted(
            pos, np.arange(nm, dtype=np.int64), side="right"
        )
        delta_dest = pos + np.arange(nd, dtype=np.int64)
        perm = np.empty(nm + nd, dtype=np.int64)
        perm[main_dest] = sperm
        perm[delta_dest] = nm + dperm
        first_change = min(first_del, int(pos.min()))
    if len(perm) < 2**32:
        perm = perm.astype(np.uint32)

    fold_plan = None
    if (
        _device_fold_enabled(old.device)
        and old.block == _block_rows(tile)
        and set(old.col_names) == set(merged_keys.device_cols)
        and max(old.n_pad, nm + nd) < 2**31  # i32 position math
    ):
        removed = (
            np.flatnonzero(~keep_sorted) if keep_sorted is not None
            else np.zeros(0, np.int64)
        )
        delta_sorted_cols = (
            {k: v[dperm] for k, v in delta_keys.device_cols.items()} if nd else {}
        )
        dest = delta_dest if nd else np.zeros(0, np.int64)
        fold_plan = (old, removed, dest, delta_sorted_cols)

    table = IndexTable(
        old.keyspace, merged_keys, tile=tile, device=old.device,
        sorted_state=perm, reuse=(old, first_change), fold_plan=fold_plan,
    )
    table.rows_sorted = nd
    return table


def merged_table(
    old: IndexTable, merged_keys: WriteKeys, delta_keys: WriteKeys, tile: int | None = None
) -> IndexTable:
    """Merge compaction: the table is sorted by (bin, z), so folding a
    delta in needs no global sort, only a sort of the delta and a
    positional merge (``side='left'``: delta rows land before equal-key
    old rows), and every device block before the first insertion point
    is reused. ``merged_keys`` must be ``concat(old keys, delta_keys)``
    in ordinal order. The table stays on ``old``'s device."""
    nm, nd = old.n, len(delta_keys.zs)
    if nm == 0 or nd == 0 or merged_keys.sub is not None:
        # tables with a secondary sort word (string attribute indexes)
        # rebuild outright: the positional merge below compares (bin, z)
        # only, which would interleave z-tie runs out of sub order and
        # break the boundary-run narrowing of candidate_spans_split
        return IndexTable(old.keyspace, merged_keys, tile=tile, device=old.device)
    dperm = _sort_bins_z(delta_keys)
    db = delta_keys.bins[dperm]
    dz = delta_keys.zs[dperm]
    # insertion position in the old sorted order for every delta row,
    # resolved per bin segment (lexicographic (bin, z) searchsorted)
    pos = np.empty(nd, np.int64)
    for b in np.unique(db):
        i = int(np.searchsorted(old.ubins, b))
        if i < len(old.ubins) and old.ubins[i] == b:
            s, e = int(old.bin_starts[i]), int(old.bin_starts[i + 1])
        else:
            # bin absent from the old table: insert at the segment boundary
            s = e = int(old.bin_starts[i]) if i < len(old.bin_starts) else nm
        sel = db == b
        pos[sel] = np.searchsorted(old.zs[s:e], dz[sel], side="left") + s
    # stable two-run merge by destination index
    main_dest = np.arange(nm, dtype=np.int64) + np.searchsorted(
        pos, np.arange(nm, dtype=np.int64), side="right"
    )
    delta_dest = pos + np.arange(nd, dtype=np.int64)
    perm = np.empty(nm + nd, dtype=np.int64)
    perm[main_dest] = np.asarray(old.perm, dtype=np.int64)
    perm[delta_dest] = nm + np.asarray(dperm, dtype=np.int64)
    if nm + nd < 2**32:
        perm = perm.astype(np.uint32)
    table = IndexTable(
        old.keyspace, merged_keys, tile=tile, device=old.device,
        sorted_state=perm, reuse=(old, int(pos.min())),
    )
    table.rows_sorted = nd
    return table
