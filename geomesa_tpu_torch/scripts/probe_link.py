"""Profile the card's link: dispatch RTT, host/device copy rates and the
rate of a full-table count scan.

The port of the JAX package's scripts/probe_link.py, which sizes the
query path (how many round trips a query can afford; whether a full
linear scan beats a gather). It measures, on the card:

1. ``rtt_ms``: a trivial launch (``x + 1`` on 8 floats) and a
   ``torch.cuda.synchronize`` (the reference's jitted ``x + 1`` and
   ``block_until_ready``);
2. ``d2h``: device-to-host copies of 4 B, 4 KB, 4 MB and 64 MB, each
   into pageable memory (``.cpu()``, the reference's ``np.asarray`` of a
   device array) and into a pinned buffer (``copy_(non_blocking=True)``
   and a sync);
3. ``h2d``: host-to-device copies of 4 KB, 4 MB and 64 MB, from pageable
   and from pinned memory;
4. ``count_scan``: the mask and count of 8 box slots and 8 window slots
   over a 128M-row table of four columns (x, y f32; tbin, toff i32;
   2.1 GB on the card);
5. ``scan_compact``: the same scan plus a fixed-size compaction of the
   hits' row ids to 1M slots (padded with -1; a cumulative sum and a
   scatter, so nothing waits on the host);
6. ``end_to_end``: 5 then the count pulled to the host and 64K row ids
   copied back;
7. ``gather_scan``: the count over 1/8 of the table, gathered as every
   8th tile of 2048 rows.

The reference's scans (4-7) are plain jitted array code, not Pallas, so
their counterparts here are plain PyTorch operations on the same table
(``route`` says so); the port's hand-written K1 is measured by
chip_smoke.py beside its plain version and is not run here. Each scan's
count (and the compaction's first ids) is checked against numpy on the
same columns; a mismatch raises. Times are host wall-clock medians
around calls that end in a sync (``timing``-style warm-up); off the card
nothing is timed (``None``). Run on the card (the reference's table is
128M rows):

    python -m geomesa_tpu_torch.scripts.probe_link [--rows N] [--device cuda]

It prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

N_REFERENCE = 128 * 1024 * 1024
CAP = 1 << 20
TILE = 2048
D2H_BYTES = (4, 4 << 10, 4 << 20, 64 << 20)
H2D_BYTES = (4 << 10, 4 << 20, 64 << 20)
BOXES = np.array([[-10, -10, 10, 10]] * 8, np.float32)
WINDOWS = np.array([[0, 0, 1 << 19]] * 8, np.int32)
ROUTE = "plain PyTorch (the reference's jitted XLA array code; no Pallas kernel)"


def _timer(device):
    """``t(fn, n, warm)``: median host seconds of ``fn()`` on a card (each
    call ends in a sync); on the CPU one call and ``None``."""
    def t(fn, n=10, warm=2):
        if device.type != "cuda":
            fn()
            return None
        for _ in range(warm):
            fn()
        times = []
        for _ in range(n):
            s = time.perf_counter()
            fn()
            times.append(time.perf_counter() - s)
        return statistics.median(times)
    return t


def _ms(s):
    return None if s is None else s * 1e3


def _rate(nbytes, s):
    return None if not s else nbytes / s / 1e9


def make_table(n: int, device) -> dict:
    """The reference's table: uniform x, y (seeds 0, 1), tbin 0, toff
    uniform in [0, 2^20) (seed 2)."""
    host = {
        "x": np.random.default_rng(0).uniform(-180, 180, n).astype(np.float32),
        "y": np.random.default_rng(1).uniform(-90, 90, n).astype(np.float32),
        "tbin": np.zeros(n, np.int32),
        "toff": np.random.default_rng(2).integers(0, 1 << 20, n).astype(np.int32),
    }
    return host, {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def scan_mask(cols, boxes, windows):
    """Any box slot and any window slot, over every row (the probe's
    unrolled slots)."""
    x, y, tb, to = cols["x"], cols["y"], cols["tbin"], cols["toff"]
    m = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for i in range(boxes.shape[0]):
        m |= (x >= boxes[i, 0]) & (x <= boxes[i, 2]) & (y >= boxes[i, 1]) & (y <= boxes[i, 3])
    mw = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for i in range(windows.shape[0]):
        mw |= (tb == windows[i, 0]) & (to >= windows[i, 1]) & (to <= windows[i, 2])
    return m & mw


def count_scan(cols, boxes, windows):
    return scan_mask(cols, boxes, windows).sum(dtype=torch.int32)


def scan_compact(cols, boxes, windows, cap: int = CAP):
    """(count, the first ``cap`` hit rows padded with -1), fixed-size:
    each hit's slot from a cumulative sum, scattered into ``cap + 1``
    slots whose last one takes every overflow and is dropped."""
    m = scan_mask(cols, boxes, windows)
    pos = torch.cumsum(m, 0, dtype=torch.int64) - 1
    slot = torch.where(m & (pos < cap), pos, torch.full_like(pos, cap))
    out = torch.full((cap + 1,), -1, dtype=torch.int64, device=m.device)
    out.scatter_(0, slot, torch.arange(m.numel(), dtype=torch.int64, device=m.device))
    return m.sum(dtype=torch.int32), out[:cap]


def gather_scan(cols, tiles, boxes, windows):
    base = tiles[:, None] * TILE + torch.arange(TILE, dtype=torch.int64, device=tiles.device)
    g = {k: v[base] for k, v in cols.items()}
    return count_scan(g, boxes, windows)


def numpy_mask(host, boxes, windows) -> np.ndarray:
    x, y, tb, to = host["x"], host["y"], host["tbin"], host["toff"]
    m = np.zeros(len(x), bool)
    for b in boxes:
        m |= (x >= b[0]) & (x <= b[2]) & (y >= b[1]) & (y <= b[3])
    mw = np.zeros(len(x), bool)
    for w in windows:
        mw |= (tb == w[0]) & (to >= w[1]) & (to <= w[2])
    return m & mw


def run(n: int = N_REFERENCE, device="cuda") -> dict:
    """Every measurement; returns the record. Raises where a scan's
    answer differs from numpy's."""
    from geomesa_tpu_torch.datastore import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    t = _timer(device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rec: dict = {"driver": "probe_link", "device": torch.cuda.get_device_name(device)
                 if cuda else "cpu", "rows": n, "route": ROUTE}

    one = torch.ones(8, dtype=torch.float32, device=device)
    rec["rtt_ms"] = _ms(t(lambda: ((one + 1), sync()), n=20))

    rec["d2h"] = []
    for nbytes in D2H_BYTES:
        a = torch.zeros(nbytes // 4, dtype=torch.int32, device=device)
        pinned = torch.empty(a.shape, dtype=a.dtype, pin_memory=cuda)
        assert int(a.cpu().sum()) == 0
        s_page = t(lambda: a.cpu(), n=5)
        s_pin = t(lambda: (pinned.copy_(a, non_blocking=True), sync()), n=5)
        rec["d2h"].append({"bytes": nbytes, "pageable_ms": _ms(s_page),
                           "pageable_gb_s": _rate(nbytes, s_page), "pinned_ms": _ms(s_pin),
                           "pinned_gb_s": _rate(nbytes, s_pin)})
    rec["h2d"] = []
    for nbytes in H2D_BYTES:
        h = torch.zeros(nbytes // 4, dtype=torch.int32)
        hp = h.pin_memory() if cuda else h
        dst = torch.empty(h.shape, dtype=h.dtype, device=device)
        s_page = t(lambda: (h.to(device), sync()), n=5)
        s_pin = t(lambda: (dst.copy_(hp, non_blocking=True), sync()), n=5)
        rec["h2d"].append({"bytes": nbytes, "pageable_ms": _ms(s_page),
                           "pageable_gb_s": _rate(nbytes, s_page), "pinned_ms": _ms(s_pin),
                           "pinned_gb_s": _rate(nbytes, s_pin)})

    host, cols = make_table(n, device)
    nbytes = sum(int(v.numel() * v.element_size()) for v in cols.values())
    rec["table_gb"] = nbytes / 1e9
    boxes = torch.from_numpy(BOXES).to(device)
    windows = torch.from_numpy(WINDOWS).to(device)
    want = numpy_mask(host, BOXES, WINDOWS)
    want_n = int(want.sum())

    got = int(count_scan(cols, boxes, windows))
    assert got == want_n, ("count_scan", got, want_n)
    s = t(lambda: (count_scan(cols, boxes, windows), sync()))
    rec["count_scan"] = {"ms": _ms(s), "gb_s": _rate(nbytes, s), "count": got}

    c, idx = scan_compact(cols, boxes, windows)
    want_idx = np.full(CAP, -1, np.int64)
    hits = np.flatnonzero(want)[:CAP]
    want_idx[: len(hits)] = hits
    assert int(c) == want_n and np.array_equal(idx.cpu().numpy(), want_idx), "scan_compact"
    s = t(lambda: (scan_compact(cols, boxes, windows), sync()))
    rec["scan_compact"] = {"ms": _ms(s), "gb_s": _rate(nbytes, s), "cap": CAP}

    def full_query():
        c, idx = scan_compact(cols, boxes, windows)
        return int(c), idx[: 64 * 1024].cpu().numpy()

    s = t(full_query)
    rec["end_to_end"] = {"ms": _ms(s), "rows_pulled": 64 * 1024}

    n_tiles = n // TILE // 8
    tiles = torch.arange(n_tiles, dtype=torch.int64, device=device) * 8
    rows = (np.arange(n_tiles)[:, None] * 8 * TILE + np.arange(TILE)).ravel()
    want_g = int(want[rows].sum())
    got_g = int(gather_scan(cols, tiles, boxes, windows))
    assert got_g == want_g, ("gather_scan", got_g, want_g)
    s = t(lambda: (gather_scan(cols, tiles, boxes, windows), sync()))
    rec["gather_scan"] = {"ms": _ms(s), "gb_s": _rate(nbytes / 8, s), "tiles": n_tiles,
                          "count": got_g}
    rec["reduced"] = [] if n >= N_REFERENCE else [f"rows {n:,} of the reference's "
                                                  f"{N_REFERENCE:,}"]
    del cols
    if cuda:
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=N_REFERENCE, help="table rows (default 128M)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        rec = run(args.rows, args.device)
    except AssertionError as e:
        print(f"probe_link: FAIL {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
