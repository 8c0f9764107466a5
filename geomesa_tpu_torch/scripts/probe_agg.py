"""Probe P2: the aggregation-kernel candidates, on the card.

The port of the JAX package's scripts/probe_agg.py. Per candidate-block
count M over a [n_blocks, SUB, 128] point table it measures:

- ``k1``: the port's K1 scan (csrc/block_scan.cu, box leg only), the
  reference point;
- ``plain_density`` / ``plain_bounds``: the plain PyTorch versions on the
  card (block gather, masked reduce, bincount), the counterparts of the
  probe's ``xla_density`` / ``xla_bounds``;
- ``bounds``: the bounds probe kernel (csrc/probe_bounds.cu), per-slot
  [M, 128] out;
- ``density.reshape`` / ``density.fori``: the one-hot density probe
  kernel (csrc/probe_density.cu) on the tensor cores, over chunks of 32
  sublanes or one, with the tensor-core rate it reaches;
- as yardsticks, the port's K3 (csrc/density.cu, global atomics) and one
  ``torch.bincount`` over the hits' pixels on the same inputs.

Each probe kernel is held against its plain version word for word at
every M, with and without pad slots, and K3's grid against the probe's;
a mismatch raises. Times are medians of
``geomesa_tpu_torch.timing.TIMED_RUNS`` runs. Run on a CUDA card:

    python -m geomesa_tpu_torch.scripts.probe_agg
"""

from __future__ import annotations

import json

import numpy as np
import torch

from geomesa_tpu_torch.scan import aggregations as agg
from geomesa_tpu_torch.scan import block_kernels as bk
from geomesa_tpu_torch.scan import probe_kernels as pk
from geomesa_tpu_torch.timing import event_ms, max_abs_err

BLOCK = pk.BLOCK
SUB = pk.SUB
N_BLOCKS = 4096  # the JAX probe's table: 64 Mi rows, 0.54 GB of x and y
MS = (256, 1024)
H = W = 256
SEED = 0  # the JAX probe's generator
BOX = (-40.0, -30.0, 60.0, 40.0)  # the query box, and the grid's envelope
TC_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
# operations of the functions (as K3's bound counts them): per row and
# box slot 4 compares, 3 ANDs and an OR; per row the closed envelope (4
# compares, 4 ANDs); per density hit two pixels (subtract, divide,
# multiply, truncate, 2 clips) and the flat index (multiply, add); per
# bounds hit a count and four min/max
BOX_OPS_PER_ROW = 8 * 8
ENVELOPE_OPS_PER_ROW = 8
DENSITY_OPS_PER_HIT = 15
BOUNDS_OPS_PER_HIT = 5


def make_columns(n_blocks: int = N_BLOCKS):
    """(rng, x, y): uniform lon/lat numpy columns [n_blocks, SUB, 128],
    drawn as the JAX probe draws them; the generator goes on to draw the
    block ids."""
    rng = np.random.default_rng(SEED)
    shape = (n_blocks, SUB, pk.LANES)
    xs = rng.uniform(-180, 180, n_blocks * BLOCK).astype(np.float32).reshape(shape)
    ys = rng.uniform(-90, 90, n_blocks * BLOCK).astype(np.float32).reshape(shape)
    return rng, xs, ys


def sample_bids(rng, n_blocks: int, m: int) -> np.ndarray:
    """m distinct sorted block ids (the bucket is m, so no pads)."""
    bids, _ = bk.pad_bids(np.sort(rng.choice(n_blocks, m, replace=False)), n_blocks, pad=-1,
                          bucket=m)
    return bids


def grid_bounds() -> np.ndarray:
    """The probe's [1, 128] f32 envelope row: lanes 0-3 = x0, y0, x1, y1."""
    gb = np.zeros((1, pk.LANES), np.float32)
    gb[0, :4] = BOX
    return gb


def _require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"probe_agg: {msg}")


def run(device="cuda", n_blocks: int = N_BLOCKS, ms=MS) -> dict:
    """P2 over ``n_blocks`` blocks for each M in ``ms``, on an H x W
    grid; returns {"records": [one per M], ...}. On a CUDA device every
    time is a CUDA-event median; on the CPU nothing is timed (None)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_agg: no CUDA device")
    timed = device.type == "cuda"
    rng, xh, yh = make_columns(n_blocks)
    cols = (torch.from_numpy(xh).to(device), torch.from_numpy(yh).to(device))
    del xh, yh
    boxes = bk.pack_boxes(np.array([BOX]), None)
    no_wins = bk.pack_windows(None, None)
    gb = grid_bounds()
    gb4 = gb[0, :4]
    names = pk.P2_COLS
    k1_kw = dict(col_names=names, has_boxes=True, has_windows=False)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    def t(fn):
        return event_ms(fn) if timed else None

    def kernel_errs(bids) -> dict:
        """max |kernel - plain| of each probe kernel on ``bids``."""
        pargs = (*cols, dev(bids, torch.int32), dev(boxes, torch.float32))
        out = {"bounds": max_abs_err(pk.probe_bounds(cols, bids, boxes),
                                     pk.probe_bounds_plain(*pargs))}
        ref = pk.probe_density_plain(*pargs, dev(gb4, torch.float32), H, W)
        for v in pk.DENSITY_CHUNKS:
            got = pk.probe_density(cols, bids, boxes, gb, variant=v, height=H, width=W)
            out[v] = max_abs_err(got, ref)
        return out

    records = []
    for m in ms:
        bids = sample_bids(rng, n_blocks, m)
        n_real = int((bids >= 0).sum())
        pargs = (*cols, dev(bids, torch.int32), dev(boxes, torch.float32))
        gb_t = dev(gb4, torch.float32)
        err = kernel_errs(bids)
        _require(not any(err.values()),
                 f"a probe kernel differs from its plain version at M={m}: {err}")
        # pads: the last quarter of the slots -1
        padded = bids.copy()
        padded[m - m // 4:] = -1
        pads_err = kernel_errs(padded)
        _require(not any(pads_err.values()),
                 f"a probe kernel differs from its plain version with pads at M={m}: {pads_err}")
        # K3 computes the same grid as the density probe
        ref_grid = pk.probe_density_plain(*pargs, gb_t, H, W)
        k3_grid = agg.block_density(cols, bids, boxes, no_wins, gb4, width=W, height=H,
                                    **k1_kw)
        k3_equal = torch.equal(k3_grid, ref_grid)
        _require(k3_equal, f"K3's grid differs from the density probe's at M={m}")
        stats = pk.probe_bounds_plain(*pargs)
        flat = pk.density_pixels(*pargs, gb_t, H, W)
        rows = m * BLOCK
        real_rows = n_real * BLOCK
        bounds_hits = int(stats[:, 0].sum())
        density_hits = int(flat.numel())
        density_params = bk.stage_params(bids, boxes, no_wins, gb4).nbytes
        rec = {
            "M": m, "n_real": n_real, "k3_equal": k3_equal,
            "max_abs_err": {k: max(err[k], pads_err[k]) for k in err},
            "bounds": {
                "hits": bounds_hits,
                "bytes": rows * 8 + m * pk.OUT_LANES * 4
                + bk.stage_params(bids, boxes, no_wins).nbytes,
                "ops": rows * BOX_OPS_PER_ROW + bounds_hits * BOUNDS_OPS_PER_HIT,
                "kernel_ms": None, "wrapper_ms": None,
            },
            "density": {
                "hits": density_hits, "grid": [H, W],
                "bytes": real_rows * 8 + H * W * 4 + density_params,
                "ops": real_rows * (BOX_OPS_PER_ROW + ENVELOPE_OPS_PER_ROW)
                + density_hits * DENSITY_OPS_PER_HIT,
                "tc_flops": 2 * H * W * real_rows,
                **{v: {"kernel_ms": None, "wrapper_ms": None, "tc_tflops": None,
                       "tc_share": None} for v in pk.DENSITY_CHUNKS},
            },
            "k1_ms": None, "plain_density_ms": None, "plain_bounds_ms": None,
            "k3_ms": None, "k3_wrapper_ms": None, "bincount_ms": None,
        }
        if timed:
            _, k1_launch = bk.scan_launcher(dict(zip(names, cols)), np.maximum(bids, 0), boxes,
                                            no_wins, has_boxes=True, has_windows=False)
            rec["k1_ms"] = t(k1_launch)
            rec["plain_density_ms"] = t(lambda: pk.probe_density_plain(*pargs, gb_t, H, W))
            rec["plain_bounds_ms"] = t(lambda: pk.probe_bounds_plain(*pargs))
            _, b_launch = pk.probe_bounds_launcher(cols, bids, boxes)
            rec["bounds"]["kernel_ms"] = t(b_launch)
            rec["bounds"]["wrapper_ms"] = t(lambda: pk.probe_bounds(cols, bids, boxes))
            for v in pk.DENSITY_CHUNKS:
                _, d_launch = pk.probe_density_launcher(cols, bids, boxes, gb, variant=v,
                                                        height=H, width=W)
                d = rec["density"][v]
                d["kernel_ms"] = t(d_launch)
                d["wrapper_ms"] = t(lambda v=v: pk.probe_density(
                    cols, bids, boxes, gb, variant=v, height=H, width=W))
                d["tc_tflops"] = rec["density"]["tc_flops"] / (d["kernel_ms"] * 1e-3) / 1e12
                d["tc_share"] = d["tc_tflops"] * 1e12 / TC_FLOPS_PER_S
            _, k3_launch = agg.density_launcher(dict(zip(names, cols)), bids, boxes, no_wins,
                                                gb4, has_boxes=True, has_windows=False,
                                                width=W, height=H)
            rec["k3_ms"] = t(k3_launch)
            rec["k3_wrapper_ms"] = t(lambda: agg.block_density(
                cols, bids, boxes, no_wins, gb4, width=W, height=H, **k1_kw))
            rec["bincount_ms"] = t(lambda: torch.bincount(flat, minlength=H * W))
        records.append(rec)
        del flat, stats, ref_grid, k3_grid
    del cols
    return {
        "probe": "probe_agg", "device": str(device), "n_blocks": n_blocks,
        "col_gb": 2 * n_blocks * BLOCK * 4 / 1e9, "records": records,
        "equal": all(not any(r["max_abs_err"].values()) for r in records),
    }


def main() -> int:
    out = run()
    for rec in out["records"]:
        print(json.dumps(rec), flush=True)
    print(json.dumps({k: v for k, v in out.items() if k != "records"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
