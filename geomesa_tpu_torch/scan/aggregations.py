"""Aggregation push-down over the block layout: counts, density, bounds.

The port of geomesa_tpu/scan/aggregations.py (reference DensityScan and
StatsScan iterators). Same candidate-block contract as the scan: the host
prunes the sorted table to candidate blocks and pads the id list (-1 for
density and bounds; counts clamp pads to block 0 and the host reads
[:n_real]); the device evaluates the shared wide predicate over whole
blocks. The representative point of a row is the point itself, or on an
extent (XZ) table the bbox centre ``(gxmin + gxmax) * 0.5`` in f32.

Each function has a plain PyTorch version beside the wrapper of its CUDA
kernel (csrc/block_pops.cu, csrc/density.cu, csrc/bounds.cu): a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or the
call raises.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.scan import block_kernels as bk
from geomesa_tpu_torch.timing import NULL_CLOCK

# per-slot bounds stats lane layout: [count, xmin, xmax, ymin, ymax, 0...]
STAT_LANES = 8


def _gather(cols: dict, bids: torch.Tensor) -> dict:
    """Candidate blocks of every column; pad slots (-1) read block 0."""
    b = bids.to(torch.int64).clamp(min=0)
    return {k: v[b] for k, v in cols.items()}


def _rep_xy(cols: dict, extent: bool):
    """Representative coordinates per row (the JAX package's ``_rep_xy``):
    the point, or the bbox centre of an extent geometry, added then halved
    in f32."""
    if extent:
        return (cols["gxmin"] + cols["gxmax"]) * 0.5, (cols["gymin"] + cols["gymax"]) * 0.5
    return cols["x"], cols["y"]


# ------------------------------------------------------------------ pops


def popcount_slots_plain(plane: torch.Tensor) -> torch.Tensor:
    """[M, PACK, 128] int32 bit plane -> [M] int32 set-bit counts (each
    word read as unsigned)."""
    v = plane.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & 0xFFFFFFFF) >> 24
    return v.sum(dim=(1, 2)).to(torch.int32)


def block_pops_plain(cols: dict, bids, boxes, wins, *, has_boxes, has_windows,
                     extent=False) -> torch.Tensor:
    """[M] int32 wide-predicate hit count per slot: the plain scan's wide
    plane over ``max(bids, 0)``, popcounted per slot (pads count block 0;
    the host reads [:n_real]). Tensors on the columns' device."""
    wide, _ = bk.block_scan_plain(
        cols, bids.clamp(min=0), boxes, wins, has_boxes=has_boxes, has_windows=has_windows,
        extent=extent,
    )
    return popcount_slots_plain(wide)


def block_pops(
    cols3, bids, boxes, wins, *, col_names, has_boxes, has_windows,
    extent=False, clock=NULL_CLOCK,
) -> torch.Tensor:
    """[M] int32 wide-predicate hit count per candidate block slot on the
    columns' device, pads included: a count-only query pulls M ints, not
    M bit planes."""
    cols = dict(zip(col_names, cols3))
    device = bk.device_of(cols3)
    bids = np.asarray(bids, np.int32)
    if device.type == "cpu":
        with clock.device("kernel", device):
            return block_pops_plain(
                cols, torch.from_numpy(bids),
                torch.as_tensor(np.asarray(boxes, np.float32)),
                torch.as_tensor(np.asarray(wins, np.int32)),
                has_boxes=has_boxes, has_windows=has_windows, extent=extent,
            )
    out, launch = pops_launcher(
        cols, bids, boxes, wins, has_boxes=has_boxes, has_windows=has_windows, extent=extent,
        clock=clock,
    )
    with clock.device("kernel", device):
        launch()
    return out


def pops_launcher(cols: dict, bids, boxes, wins, *, has_boxes, has_windows, extent=False,
                  clock=NULL_CLOCK):
    """Stage one CUDA count: check, copy the params to the card, allocate
    the [M] counts. Returns (counts, launch): each launch() writes
    ``counts`` on the current stream."""
    device = bk.device_of(tuple(cols.values()))
    if device.type != "cuda":
        raise ValueError(f"no count kernel for device {device}")
    from geomesa_tpu_torch.kernels import BLOCK_POPS

    ptrs, flags, sub, n_blocks = bk.kernel_columns(cols, has_boxes, has_windows, extent=extent)
    bids = np.asarray(bids, np.int32)
    bk.check_bids(bids, n_blocks, allow_pad=True)
    m = len(bids)
    with torch.cuda.device(device):
        params = bk.upload_params(bk.stage_params(bids, boxes, wins), device, clock)
        out = torch.empty(m, dtype=torch.int32, device=device)

    def launch() -> None:
        BLOCK_POPS.launch(
            *ptrs, params.data_ptr(), m, sub, flags, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream, leg=bk.leg_name(flags),
        )

    return out, launch


# --------------------------------------------------------------- density


def density_plain(cols: dict, bids, boxes, wins, grid_bounds, *, has_boxes,
                  has_windows, width, height, extent=False) -> torch.Tensor:
    """[height, width] f32 grid: a row counts when it passes the wide
    predicate, its representative point lies in the closed envelope and it
    sits in a real slot (bid >= 0). Pixel = clip(int((x - x0) / (x1 - x0)
    * W), 0, W - 1) in f32, likewise for y. All arguments are tensors on
    the columns' device."""
    g = _gather(cols, bids)
    w, _ = bk.masks_plain(g, boxes, wins, has_boxes, has_windows, extent=extent)
    x, y = _rep_xy(g, extent)
    x0, y0, x1, y1 = grid_bounds[0], grid_bounds[1], grid_bounds[2], grid_bounds[3]
    m = (
        w
        & (bids >= 0)[:, None, None]
        & (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    )
    xs, ys = x[m], y[m]
    px = ((xs - x0) / (x1 - x0) * width).to(torch.int32).clamp(0, width - 1)
    py = ((ys - y0) / (y1 - y0) * height).to(torch.int32).clamp(0, height - 1)
    flat = py.to(torch.int64) * width + px.to(torch.int64)
    counts = torch.bincount(flat, minlength=height * width)
    return counts.to(torch.float32).reshape(height, width)


def block_density(
    cols3, bids, boxes, wins, grid_bounds, *, col_names, has_boxes,
    has_windows, width, height, extent=False, clock=NULL_CLOCK,
) -> torch.Tensor:
    """[height, width] f32 density grid over ``grid_bounds`` (x0, y0, x1,
    y1) on the columns' device. ``bids``: numpy i32 [M], -1 = pad slot."""
    cols = dict(zip(col_names, cols3))
    device = bk.device_of(cols3)
    bids = np.asarray(bids, np.int32)
    gb = np.asarray(grid_bounds, np.float32).reshape(4)
    if device.type == "cpu":
        with clock.device("kernel", device):
            return density_plain(
                cols, torch.from_numpy(bids),
                torch.as_tensor(np.asarray(boxes, np.float32)),
                torch.as_tensor(np.asarray(wins, np.int32)),
                torch.from_numpy(gb), has_boxes=has_boxes,
                has_windows=has_windows, width=width, height=height, extent=extent,
            )
    grid, launch = density_launcher(
        cols, bids, boxes, wins, gb, has_boxes=has_boxes, has_windows=has_windows,
        width=width, height=height, extent=extent, clock=clock,
    )
    with clock.device("kernel", device):
        launch()
    return grid.to(torch.float32)


def density_launcher(cols: dict, bids, boxes, wins, grid_bounds, *, has_boxes,
                     has_windows, width, height, extent=False, clock=NULL_CLOCK):
    """Stage one CUDA density: check, copy the params to the card, zero an
    int32 [height, width] grid. Returns (grid, launch): each launch() adds
    the hits' counts into ``grid`` on the current stream."""
    device = bk.device_of(tuple(cols.values()))
    if device.type != "cuda":
        raise ValueError(f"no density kernel for device {device}")
    from geomesa_tpu_torch.kernels import DENSITY

    ptrs, flags, sub, n_blocks = bk.kernel_columns(
        cols, has_boxes, has_windows, need_xy=True, extent=extent
    )
    bids = np.asarray(bids, np.int32)
    bk.check_bids(bids, n_blocks, allow_pad=True)
    if width < 1 or height < 1:
        raise ValueError(f"density grid must be at least 1 x 1: {height} x {width}")
    gb = np.asarray(grid_bounds, np.float32).reshape(4)
    m = len(bids)
    with torch.cuda.device(device):
        params = bk.upload_params(bk.stage_params(bids, boxes, wins, gb), device, clock)
        grid = torch.zeros((height, width), dtype=torch.int32, device=device)

    def launch() -> None:
        DENSITY.launch(
            *ptrs, params.data_ptr(), m, sub, flags, width, height,
            grid.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
            leg=bk.leg_name(flags),
        )

    return grid, launch


# ---------------------------------------------------------------- bounds


def bounds_plain(cols: dict, bids, boxes, wins, *, has_boxes, has_windows,
                 extent=False) -> torch.Tensor:
    """[M, 8] f32 per-slot stats (count, xmin, xmax, ymin, ymax, 0, 0, 0)
    of the wide-predicate hits' representative points; pad slots (-1)
    read block 0, as in the reference, and the host reads [:n_real]."""
    g = _gather(cols, bids)
    w, _ = bk.masks_plain(g, boxes, wins, has_boxes, has_windows, extent=extent)
    x, y = _rep_xy(g, extent)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    cnt = w.sum(dim=(1, 2)).to(torch.float32)
    xmin = torch.where(w, x, inf).amin(dim=(1, 2))
    xmax = torch.where(w, x, -inf).amax(dim=(1, 2))
    ymin = torch.where(w, y, inf).amin(dim=(1, 2))
    ymax = torch.where(w, y, -inf).amax(dim=(1, 2))
    zero = torch.zeros_like(cnt)
    return torch.stack([cnt, xmin, xmax, ymin, ymax, zero, zero, zero], dim=1)


def block_bounds(
    cols3, bids, boxes, wins, *, col_names, has_boxes, has_windows,
    extent=False, clock=NULL_CLOCK,
) -> torch.Tensor:
    """[M, STAT_LANES] f32 per-slot stats on the columns' device."""
    cols = dict(zip(col_names, cols3))
    device = bk.device_of(cols3)
    bids = np.asarray(bids, np.int32)
    if device.type == "cpu":
        with clock.device("kernel", device):
            return bounds_plain(
                cols, torch.from_numpy(bids),
                torch.as_tensor(np.asarray(boxes, np.float32)),
                torch.as_tensor(np.asarray(wins, np.int32)),
                has_boxes=has_boxes, has_windows=has_windows, extent=extent,
            )
    out, launch = bounds_launcher(
        cols, bids, boxes, wins, has_boxes=has_boxes, has_windows=has_windows, extent=extent,
        clock=clock,
    )
    with clock.device("kernel", device):
        launch()
    return out


def bounds_launcher(cols: dict, bids, boxes, wins, *, has_boxes, has_windows, extent=False,
                    clock=NULL_CLOCK):
    """Stage one CUDA bounds: check, copy the params to the card, allocate
    the [M, STAT_LANES] stats. Returns (stats, launch): each launch()
    writes ``stats`` on the current stream."""
    device = bk.device_of(tuple(cols.values()))
    if device.type != "cuda":
        raise ValueError(f"no bounds kernel for device {device}")
    from geomesa_tpu_torch.kernels import BOUNDS

    ptrs, flags, sub, n_blocks = bk.kernel_columns(
        cols, has_boxes, has_windows, need_xy=True, extent=extent
    )
    bids = np.asarray(bids, np.int32)
    bk.check_bids(bids, n_blocks, allow_pad=True)
    m = len(bids)
    with torch.cuda.device(device):
        params = bk.upload_params(bk.stage_params(bids, boxes, wins), device, clock)
        out = torch.empty((m, STAT_LANES), dtype=torch.float32, device=device)

    def launch() -> None:
        BOUNDS.launch(
            *ptrs, params.data_ptr(), m, sub, flags, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream, leg=bk.leg_name(flags),
        )

    return out, launch


def reduce_bounds(stats, n_real: int):
    """Host-side fold of [M, STAT_LANES] per-slot stats -> (count,
    (xmin, ymin, xmax, ymax) | None)."""
    s = np.asarray(stats)[:n_real] if n_real is not None else np.asarray(stats)
    if len(s) == 0:
        return 0, None
    cnt = int(s[:, 0].sum())
    if cnt == 0:
        return 0, None
    return cnt, (
        float(s[:, 1].min()), float(s[:, 3].min()),
        float(s[:, 2].max()), float(s[:, 4].max()),
    )


# ---------------------------------------------------- tile-pyramid partials
# Host-side exact aggregation for the map-tile tier (tiles.pyramid), as in
# the JAX package: counts are integers in f64 (exact to 2^53), and the
# bincount/block-sum pair keeps a zoom-z pixel bit-identical to a
# from-scratch aggregation of the same rows however the pyramid associates
# its partial sums.


def tile_partial(col, row, w: int, h: int):
    """Windowed density partial of one tile: per-pixel counts of rows
    already binned to LOCAL pixel indices (``0 <= col < w``,
    ``0 <= row < h``, row 0 = north). One ``bincount``: no scatter
    races, deterministic."""
    flat = np.asarray(row, np.int64) * w + np.asarray(col, np.int64)
    return np.bincount(flat, minlength=h * w).reshape(h, w).astype(np.float64)


def block_sum(grid, k: int):
    """Exact ``k x k`` block-sum downsample of a 2-D f64 grid: the
    pyramid's parent recompose (4 children fold with k=2). Integer
    counts in f64 sum exactly in any association order."""
    g = np.asarray(grid, np.float64)
    hh, ww = g.shape
    return g.reshape(hh // k, k, ww // k, k).sum(axis=(1, 3))
