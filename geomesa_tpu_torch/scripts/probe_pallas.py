"""Probe P1: the candidate-block scan kernel end to end, on the card.

The port of the JAX package's scripts/probe_pallas.py. Design under test:

- columns stored [n_blocks, SUB, 128] (BLOCK = SUB * 128 rows a block);
- one CTA per candidate slot, block ids staged with the params;
- params: one wide and one inner box and window, the other 7 slots of
  each padded, all 8 evaluated every time (no slot counts);
- outputs: wide and inner packed bit planes [M, SUB/32, 128] int32;
- one pull of the wide plane, host decode to row ids.

For each M it reports the kernel's time and GB/s (bytes = M * 16384 *
16), the wrapper's, the plain version's, the end-to-end query (kernel,
D2H copy of the wide plane, decode) and the port's K1 (csrc/block_scan.cu)
on the same columns, the yardstick of what K1's generality costs: once
on the probe's params, where K1 loops over the one real slot of each leg
and P1 still evaluates all 8, and once on the same predicate split into
8 real box and 8 real window slots (:func:`split_params`), where both do
the same slot work. Every kernel output is held against the plain
version and K1's planes, and at ``check_m`` the decoded rows against
numpy; a mismatch raises. Times are medians of
``geomesa_tpu_torch.timing.TIMED_RUNS`` runs. Run on a CUDA card:

    python -m geomesa_tpu_torch.scripts.probe_pallas
"""

from __future__ import annotations

import json

import numpy as np
import torch

from geomesa_tpu_torch.scan import block_kernels as bk
from geomesa_tpu_torch.scan import probe_kernels as pk
from geomesa_tpu_torch.timing import event_ms, max_abs_err, wall_ms

BLOCK = pk.BLOCK
SUB = pk.SUB
PACK = pk.PACK
N_ROWS = 64 * 1024 * 1024  # the JAX probe's table: 1.07 GB of columns
MS = (128, 1024)
CHECK_M = 128
SEED = 0  # the JAX probe's generator
# the probe's one wide and inner box (lon/lat) and window (week bins
# 3-5, every second of the week)
BOX = (-10.0, -10.0, 10.0, 10.0)
WINDOW = (3, 5, 0, 604799)
# operations a row: per plane and slot 8 box and 8 window compares and
# logic ops, over 2 planes and 8 slots; per plane the AND of the legs and
# the shift and OR that pack the bit
OPS_PER_ROW = 2 * 8 * 16 + 2 * 3


def make_columns(n_rows: int = N_ROWS, seed: int = SEED):
    """(x, y, tbin, toff) numpy columns [n_blocks, SUB, 128]: uniform
    lon/lat, week bins in [0, 18) and offsets in [0, 604800) seconds, drawn
    as the JAX probe draws them."""
    if n_rows % BLOCK:
        raise ValueError(f"n_rows must be a multiple of {BLOCK}")
    n_blocks = n_rows // BLOCK
    rng = np.random.default_rng(seed)
    xh = rng.uniform(-180, 180, n_rows).astype(np.float32)
    yh = rng.uniform(-90, 90, n_rows).astype(np.float32)
    tbh = rng.integers(0, 18, n_rows).astype(np.int32)
    toh = rng.integers(0, 604800, n_rows).astype(np.int32)
    return tuple(a.reshape(n_blocks, SUB, pk.LANES) for a in (xh, yh, tbh, toh))


def pack_params(bw, bi, ww, wi):
    """([8, 128] f32 boxes, [8, 128] i32 windows): wide slots in lanes 0-3,
    inner in 4-7; pad boxes +inf/-inf, pad windows bin_lo 1 > bin_hi 0."""
    boxes = np.zeros((8, 128), np.float32)
    boxes[:, 0] = np.inf
    boxes[:, 2] = -np.inf
    boxes[:, 4] = np.inf
    boxes[:, 6] = -np.inf
    boxes[: len(bw), 0:4] = bw
    boxes[: len(bi), 4:8] = bi
    wins = np.zeros((8, 128), np.int32)
    wins[:, 0] = 1
    wins[:, 1] = 0
    wins[:, 4] = 1
    wins[:, 5] = 0
    wins[: len(ww), 0:4] = ww
    wins[: len(wi), 4:8] = wi
    return boxes, wins


def split_params():
    """The probe's predicate with every slot real: its box cut into 8
    strips along x and its window's seconds into 8 eighths of the week,
    wide and inner alike. The closed strips and eighths cover exactly the
    probe's box and window, so the planes are the probe's; K1 then loops
    over 8 box and 8 window slots, the work P1 does on any params."""
    x = np.linspace(BOX[0], BOX[2], 9, dtype=np.float32)
    boxes = np.stack([x[:-1], np.full(8, BOX[1], np.float32), x[1:],
                      np.full(8, BOX[3], np.float32)], axis=1)
    t = np.linspace(WINDOW[2], WINDOW[3] + 1, 9).astype(np.int32)
    wins = np.stack([np.full(8, WINDOW[0]), np.full(8, WINDOW[1]), t[:-1], t[1:] - 1],
                    axis=1).astype(np.int32)
    return pack_params(boxes, boxes, wins, wins)


def sample_bids(n_blocks: int, m: int):
    """(bids [m], real): every (n_blocks // m)-th block, pads repeat block 0."""
    bids = np.zeros(m, np.int32)
    real = np.arange(0, n_blocks, max(1, n_blocks // m), dtype=np.int32)[:m]
    bids[: len(real)] = real
    return bids, real


def truth_rows(host, real, box=BOX, window=WINDOW) -> np.ndarray:
    """Global row ids of the wide predicate over blocks ``real`` in numpy."""
    x, y, tb, to = (a[real].reshape(len(real), -1) for a in host)
    m = (
        (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & (y <= box[3])
        & (tb >= window[0]) & (tb <= window[1]) & (to >= window[2]) & (to <= window[3])
    )
    blk, local = np.nonzero(m)
    return real[blk].astype(np.int64) * BLOCK + local


def _require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"probe_pallas: {msg}")


def _err_to_plain(cols3, bids, boxes, wins, dev):
    """(wide, inner, max |kernel - plain| over both planes' words)."""
    got = pk.probe_scan(cols3, bids, boxes, wins)
    ref = pk.probe_scan_plain(*cols3, dev(bids, torch.int32), dev(boxes, torch.float32),
                              dev(wins, torch.int32))
    return (*got, max(max_abs_err(g, r) for g, r in zip(got, ref)))


def run(device="cuda", n_rows: int = N_ROWS, ms=MS, check_m: int = CHECK_M) -> dict:
    """P1 at ``n_rows`` rows for each M in ``ms``; returns {"records":
    [one per M], "check": numpy check at ``check_m``, ...}. On a CUDA
    device the times are CUDA-event medians (the query's by the host
    clock); on the CPU nothing is timed (None)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_pallas: no CUDA device")
    timed = device.type == "cuda"
    host = make_columns(n_rows)
    n_blocks = host[0].shape[0]
    cols3 = tuple(torch.from_numpy(a).to(device) for a in host)
    names = pk.P1_COLS
    boxes, wins = pack_params(np.array([BOX], np.float32), np.array([BOX], np.float32),
                              np.array([WINDOW], np.int32), np.array([WINDOW], np.int32))
    boxes8, wins8 = split_params()

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    def t(fn):
        return event_ms(fn) if timed else None

    records, check = [], None
    for m in ms:
        bids, real = sample_bids(n_blocks, m)
        n_real = len(real)
        wide, inner, err = _err_to_plain(cols3, bids, boxes, wins, dev)
        _require(err == 0.0, f"kernel planes differ from the plain version at M={m}")
        # K1 on the same columns and params computes the same two planes
        k1_kw = dict(col_names=names, has_boxes=True, has_windows=True)
        kw, ki = bk.block_scan(cols3, bids, boxes, wins, **k1_kw)
        k1_equal = torch.equal(kw, wide) and torch.equal(ki, inner)
        _require(k1_equal, f"K1's planes differ from the probe's at M={m}")
        # the same predicate over 8 real slots of each leg: P1 and K1 both
        # give the probe's planes
        w8, i8, err8 = _err_to_plain(cols3, bids, boxes8, wins8, dev)
        kw8, ki8 = bk.block_scan(cols3, bids, boxes8, wins8, **k1_kw)
        split_equal = all(torch.equal(a, b) for a, b in ((w8, wide), (i8, inner), (kw8, wide),
                                                          (ki8, inner)))
        _require(err8 == 0.0 and split_equal,
                 f"the 8-slot split of the params changes the planes at M={m}")
        rows = pk.decode_rows(wide.cpu().numpy(), bids, n_real)
        # pads (the last quarter of the slots repeating block 0) too
        padded = bids.copy()
        padded[n_real - n_real // 4:] = 0
        pads_err = _err_to_plain(cols3, padded, boxes, wins, dev)[2]
        _require(pads_err == 0.0,
                 f"kernel planes differ from the plain version with pads at M={m}")
        if m == check_m:
            expect = truth_rows(host, real)
            got = np.sort(rows)
            ok = len(got) == len(expect) and bool(np.array_equal(got, expect))
            check = {"M": m, "rows": len(got), "expect": len(expect), "ok": ok}
            _require(ok, f"rows differ from numpy at M={m} ({len(got)} vs {len(expect)})")
        rec = {
            "M": m, "n_real": n_real, "rows": len(rows),
            "max_abs_err": max(err, pads_err, err8), "k1_equal": k1_equal,
            "split_equal": split_equal,
            "bytes": m * BLOCK * 16 + 2 * m * PACK * pk.LANES * 4
            + bk.stage_params(bids, boxes, wins).nbytes,
            "ops": m * BLOCK * OPS_PER_ROW,
            "kernel_ms": None, "gb_per_s": None, "wrapper_ms": None, "plain_ms": None,
            "query_ms": None, "k1_ms": None, "k1_wrapper_ms": None,
            "split_kernel_ms": None, "split_k1_ms": None,
        }
        if timed:
            _, launch = pk.probe_scan_launcher(cols3, bids, boxes, wins)
            _, k1_launch = bk.scan_launcher(dict(zip(names, cols3)), bids, boxes, wins,
                                            has_boxes=True, has_windows=True)
            _, split_launch = pk.probe_scan_launcher(cols3, bids, boxes8, wins8)
            _, split_k1_launch = bk.scan_launcher(dict(zip(names, cols3)), bids, boxes8, wins8,
                                                  has_boxes=True, has_windows=True)
            pargs = (*cols3, dev(bids, torch.int32), dev(boxes, torch.float32),
                     dev(wins, torch.int32))

            def query():
                w, _ = pk.probe_scan(cols3, bids, boxes, wins)
                return pk.decode_rows(w.cpu().numpy(), bids, n_real)

            rec["kernel_ms"] = t(launch)
            rec["gb_per_s"] = m * BLOCK * 16 / (rec["kernel_ms"] * 1e-3) / 1e9
            rec["wrapper_ms"] = t(lambda: pk.probe_scan(cols3, bids, boxes, wins))
            rec["plain_ms"] = t(lambda: pk.probe_scan_plain(*pargs))
            rec["query_ms"] = wall_ms(query)
            rec["k1_ms"] = t(k1_launch)
            rec["k1_wrapper_ms"] = t(lambda: bk.block_scan(cols3, bids, boxes, wins, **k1_kw))
            rec["split_kernel_ms"] = t(split_launch)
            rec["split_k1_ms"] = t(split_k1_launch)
        records.append(rec)
    _require(check is not None or check_m not in ms, "no numpy check ran")
    del cols3
    return {
        "probe": "probe_pallas", "device": str(device), "n_rows": n_rows, "n_blocks": n_blocks,
        "col_gb": 4 * n_rows * 4 / 1e9, "records": records, "check": check,
        "equal": all(r["max_abs_err"] == 0.0 for r in records),
    }


def main() -> int:
    out = run()
    for rec in out["records"]:
        print(json.dumps(rec), flush=True)
    print(json.dumps({k: v for k, v in out.items() if k != "records"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
