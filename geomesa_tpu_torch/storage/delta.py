"""The delta tier: recent writes stay on the host until a compaction.

The port of geomesa_tpu/storage/delta.py. A write after the first keeps
its rows in a small host-resident, unsorted delta per index, scanned
exactly with vectorised numpy, while the sorted device table (the main
table) is rebuilt only when the delta outgrows its threshold
(``DataStore.write``): a write costs time in proportion to its batch, not
to the table.

Delta hits follow the main table's hits, in write order, and are always
uncertain (the planner refines them): the host predicate here is the
kernels' *wide* semantics (f32 boxes and windows, bbox-intersects for
extents), so counts, bounds and density grids over a tiered table equal
the kernels' over the same rows.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.index.api import ScanConfig, WriteKeys
from geomesa_tpu_torch.timing import NULL_CLOCK


def concat_keys(parts: list[WriteKeys], consume: bool = False) -> WriteKeys:
    """Concatenate per-batch write keys in write (ordinal) order, the
    secondary sort words of string attribute indexes included.
    ``consume=True`` releases each part's arrays as their column finishes
    concatenating, so the transient peak is one column set plus one
    column. Only for parts the caller owns alone (the stream flusher's
    staged chunks): parts published in a store may be shared with
    concurrent readers and must never be consumed."""
    if len(parts) == 1:
        return parts[0]
    names = tuple(parts[0].device_cols)
    sub = _concat_sub(parts)
    if consume:
        for p in parts:
            p.sub = None
    device_cols = {}
    for name in names:
        device_cols[name] = np.concatenate(
            [p.device_cols.pop(name) if consume else p.device_cols[name] for p in parts]
        )
    bins = np.concatenate([p.bins for p in parts])
    zs = np.concatenate([p.zs for p in parts])
    if consume:
        for p in parts:
            p.bins = p.bins[:0]
            p.zs = p.zs[:0]
    return WriteKeys(bins=bins, zs=zs, device_cols=device_cols, sub=sub)


def _concat_sub(parts: list[WriteKeys]) -> "np.ndarray | None":
    """Concatenate variable-width secondary sort words, zero-padding
    narrower batches to the widest word count (0 is the right pad: a
    shorter string sorts before any extension)."""
    subs = [p.sub for p in parts]
    if all(s is None for s in subs):
        return None
    w = max(s.shape[1] for s in subs if s is not None)
    out = []
    for p, s in zip(parts, subs):
        if s is None:
            s = np.zeros((len(p.bins), w), dtype=np.uint64)
        elif s.shape[1] < w:
            s = np.pad(s, ((0, 0), (0, w - s.shape[1])))
        out.append(s)
    return np.concatenate(out)


def delta_wide_mask(
    config: ScanConfig, keys: WriteKeys, packed_shift: "int | None" = None
) -> np.ndarray:
    """Wide-predicate mask over delta rows, bit-compatible with the
    kernels' wide plane: f32 widened boxes, per-bin windows, bbox-intersects
    for extents, and the value ranges of an attribute scan (a pure range
    scan, or ``clip_rows`` beside a predicate). ``packed_shift``: the keyspace's packed-time tick shift
    (tw column)."""
    cols = keys.device_cols
    n = len(keys.zs)
    m = np.ones(n, dtype=bool)
    if config.boxes is not None:
        hit = np.zeros(n, dtype=bool)
        if "gxmin" in cols:
            for x0, y0, x1, y1 in np.asarray(config.boxes, np.float32):
                hit |= (
                    (cols["gxmin"] <= x1)
                    & (cols["gxmax"] >= x0)
                    & (cols["gymin"] <= y1)
                    & (cols["gymax"] >= y0)
                )
        else:
            x, y = cols["x"], cols["y"]
            for x0, y0, x1, y1 in np.asarray(config.boxes, np.float32):
                hit |= (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        m &= hit
    if config.windows is not None:
        if "tw" in cols:
            # packed-time rows: wide tick semantics (floor), as the kernel;
            # refinement stays exact (delta hits are always uncertain)
            from geomesa_tpu_torch.index.z3 import unpack_tw, windows_to_ticks

            tb, to = unpack_tw(cols["tw"])
            wins = windows_to_ticks(config.windows, packed_shift, inner=False)
        else:
            tb, to = cols["tbin"], cols["toff"]
            wins = config.windows
        hit = np.zeros(n, dtype=bool)
        for b, lo, hi in np.asarray(wins, np.int64):
            hit |= (tb == b) & (to >= lo) & (to <= hi)
        m &= hit
    if (config.boxes is None and config.windows is None) or config.clip_rows:
        # a pure range scan (attribute primary), or an attribute scan
        # with a secondary predicate: rows must be in a value range
        hit = np.zeros(n, dtype=bool)
        for b, lo, hi in zip(
            config.range_bins.tolist(), config.range_lo.tolist(), config.range_hi.tolist()
        ):
            hit |= (keys.bins == b) & (keys.zs >= lo) & (keys.zs <= hi)
        m &= hit
    return m


def rep_xy(cols: dict, rows) -> tuple:
    """Representative coordinate per row: the point itself, or the bbox
    midpoint of an extent, added then halved in f32 as the kernels do."""
    if "x" in cols:
        return cols["x"][rows], cols["y"][rows]
    x = (cols["gxmin"][rows] + cols["gxmax"][rows]) * 0.5
    y = (cols["gymin"][rows] + cols["gymax"][rows]) * 0.5
    return x, y


def scatter_density(x, y, envelope, width: int, height: int, grid=None):
    """Clip and scatter-add points into a [height, width] f32 grid (the
    wide density semantics of the delta tier)."""
    x0, y0, x1, y1 = (float(v) for v in envelope)
    inb = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    px = np.clip(((x - x0) / max(x1 - x0, 1e-12) * width).astype(np.int64), 0, width - 1)
    py = np.clip(((y - y0) / max(y1 - y0, 1e-12) * height).astype(np.int64), 0, height - 1)
    if grid is None:
        grid = np.zeros((height, width), np.float32)
    flat = grid.reshape(-1)
    np.add.at(flat, (py * width + px)[inb], np.float32(1))
    return flat.reshape(height, width)


class TieredTable:
    """The main device table and the host delta behind the IndexTable
    scan surface. Delta hits come after the main table's and are
    uncertain (always refined)."""

    def __init__(self, main, delta_keys: WriteKeys, base_ordinal: int):
        self.main = main
        self.delta = delta_keys
        self.base = base_ordinal
        self.keyspace = main.keyspace

    @property
    def n(self) -> int:
        return self.main.n + len(self.delta.zs)

    def _delta_hits(self, config: ScanConfig) -> np.ndarray:
        if config.disjoint or len(self.delta.zs) == 0:
            return np.zeros(0, np.int64)
        return self.base + np.flatnonzero(
            delta_wide_mask(
                config, self.delta, packed_shift=getattr(self.keyspace, "packed_time", None)
            )
        )

    def scan(self, config: ScanConfig, deadline=None):
        return self.scan_submit(config, deadline=deadline)()

    def scan_submit(self, config: ScanConfig, clock=NULL_CLOCK, deadline=None):
        """Launch the main table's scan now; finish() appends the delta
        hits, scanned on the host."""
        finish_main = self.main.scan_submit(config, clock=clock, deadline=deadline)
        return self._with_delta(config, finish_main, clock)

    def scan_submit_many(self, configs, clock=NULL_CLOCK, deadline=None):
        """The main table's fused multi-query scan (one launch per chunk,
        IndexTable.scan_submit_many), each query's delta hits appended at
        its finish as in scan_submit. One finish() per config."""
        fins = self.main.scan_submit_many(configs, clock=clock, deadline=deadline)
        return [self._with_delta(c, f, clock) for c, f in zip(configs, fins)]

    def _with_delta(self, config, finish_main, clock):
        def finish():
            ordinals, certain = finish_main()
            with clock.host("delta"):
                d = self._delta_hits(config)
            if len(d) == 0:
                return ordinals, certain
            return (
                np.concatenate([ordinals, d]),
                np.concatenate([certain, np.zeros(len(d), bool)]),
            )

        return finish

    def count(self, config: ScanConfig, clock=NULL_CLOCK) -> int:
        return self.main.count(config, clock=clock) + len(self._delta_hits(config))

    def candidate_spans(self, config: ScanConfig):
        """The cost estimator's view: the main table's spans and the whole
        delta as one span (the delta is scanned linearly)."""
        spans = list(self.main.candidate_spans(config))
        if len(self.delta.zs):
            spans.append((self.main.n, self.main.n + len(self.delta.zs)))
        return spans

    def bounds_stats(self, config: ScanConfig, clock=NULL_CLOCK):
        cnt, env = self.main.bounds_stats(config, clock=clock)
        d = self._delta_hits(config)
        if len(d) == 0:
            return cnt, env
        x, y = rep_xy(self.delta.device_cols, d - self.base)
        denv = (float(x.min()), float(y.min()), float(x.max()), float(y.max()))
        if env is None:
            return cnt + len(d), denv
        return cnt + len(d), (
            min(env[0], denv[0]), min(env[1], denv[1]),
            max(env[2], denv[2]), max(env[3], denv[3]),
        )

    def density(self, config: ScanConfig, bounds, width: int, height: int,
                clock=NULL_CLOCK) -> np.ndarray:
        return self.density_submit(config, bounds, width, height, clock)()

    def density_submit(self, config: ScanConfig, bounds, width: int, height: int,
                       clock=NULL_CLOCK):
        """Launch the main table's density kernel now; finish() pulls its
        grid and scatters the delta's hits on top."""
        finish_main = self.main.density_submit(config, bounds, width, height, clock)

        def finish() -> np.ndarray:
            grid = finish_main()
            d = self._delta_hits(config)
            if len(d):
                x, y = rep_xy(self.delta.device_cols, d - self.base)
                grid = scatter_density(x, y, bounds, width, height, grid=grid)
            return grid

        return finish

    @property
    def nbytes_device(self) -> int:
        return self.main.nbytes_device
