"""The chip-side probes' kernels: P1's scan, P2's bounds and density.

The port of the Pallas kernels of the JAX package's design probes
(scripts/probe_pallas.py ``block_scan``; scripts/probe_agg.py
``make_pallas`` over ``_bounds_kernel``, ``_density_kernel_reshape`` and
``_density_kernel_fori``), which the probe scripts of this package drive
(geomesa_tpu_torch/scripts/). Same layout as the scan path: f32 ``x``,
``y`` and i32 ``tbin``, ``toff`` columns [n_blocks, SUB, 128] with SUB =
128 (BLOCK = 16384 rows), M candidate slots, [8, 128] box and window
param blocks. Unlike the system's kernels the probes take no flags and no
slot counts: every slot evaluates all 8 box (and window) slots.

- P1 (:func:`probe_scan`): two int32 planes [M, SUB/32, 128], wide =
  any box (lanes 0-3) & any window (lanes 0-3), inner = the same over
  lanes 4-7; bit b of word [j, lane] is local row (j*32 + b)*128 + lane.
  Pad slots repeat block 0 (bids >= 0).
- P2 bounds (:func:`probe_bounds`): [M, 128] f32, lanes 0-4 = count,
  xmin, xmax, ymin, ymax of the rows in any box (lanes 0-3), the rest 0.
  Pad slots (bid -1) read block 0 and report its stats unmasked, as the
  probe does.
- P2 density (:func:`probe_density`): [H, W] f32 grid of the rows in any
  box, in the closed envelope ``gb`` and in a real slot (bid >= 0), on the
  tensor cores as one-hot products over chunks of 32 sublanes
  (``variant="reshape"``) or one (``"fori"``).

Each has a plain PyTorch version beside the wrapper of its CUDA kernel
(csrc/probe_scan.cu, csrc/probe_bounds.cu, csrc/probe_density.cu): a CPU
tensor takes the plain version, a CUDA tensor launches the kernel, any
other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.scan import block_kernels as bk

LANES = bk.LANES
SUB = 128  # fixed by both probes
PACK = SUB // 32
BLOCK = SUB * LANES
OUT_LANES = 128  # P2 bounds: one [1, 128] row per slot
# P2 density's two bodies: sublanes per one-hot chunk
DENSITY_CHUNKS = {"reshape": 32, "fori": 1}

P1_COLS = ("x", "y", "tbin", "toff")
P2_COLS = ("x", "y")


# ------------------------------------------------------------------ checks


def check_columns(cols3, names) -> tuple[torch.device, int]:
    """(device, n_blocks) of the probe columns: contiguous [n_blocks, SUB,
    128] tensors on one device, f32 coordinates and i32 time columns."""
    if len(cols3) != len(names):
        raise ValueError(f"the probe reads columns {', '.join(names)}")
    device = bk.device_of(cols3)
    shape = tuple(cols3[0].shape)
    if len(shape) != 3 or shape[1:] != (SUB, LANES):
        raise ValueError(f"probe columns are [n_blocks, {SUB}, {LANES}]: {shape}")
    for name, c in zip(names, cols3):
        want = torch.float32 if name in ("x", "y") else torch.int32
        if c.dtype != want or tuple(c.shape) != shape or not c.is_contiguous():
            raise ValueError(f"column {name!r} must be contiguous {want} {shape}")
    return device, shape[0]


def _param_block(a, dtype) -> np.ndarray:
    p = np.asarray(a, dtype)
    if p.shape != (8, LANES):
        raise ValueError(f"param blocks are [8, {LANES}]: {p.shape}")
    return p


def _grid_bounds(gb) -> np.ndarray:
    """(x0, y0, x1, y1) f32 from a [1, 128] probe row or 4 values."""
    g = np.asarray(gb, np.float32).reshape(-1)
    if g.size < 4:
        raise ValueError("gb holds x0, y0, x1, y1")
    return g[:4].copy()


def _route(device: torch.device, what: str) -> bool:
    """True for the plain version (CPU), False for the kernel (CUDA); any
    other device has no kernel and raises."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {device}")
    return False


def _staged(device, bids, boxes, wins, gb=None) -> torch.Tensor:
    """The probe's params in one host->device copy, in the one-query layout
    of csrc/masks.cuh (its slot counts are not read by the probes)."""
    with torch.cuda.device(device):
        return bk.upload_params(bk.stage_params(bids, boxes, wins, gb), device)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _any_box(x, y, boxes, o: int) -> torch.Tensor:
    """Rows in any of the 8 closed boxes of lanes o..o+3 (pad slots never
    match)."""
    hit = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for k in range(8):
        hit |= (
            (x >= boxes[k, 0 + o]) & (x <= boxes[k, 2 + o])
            & (y >= boxes[k, 1 + o]) & (y <= boxes[k, 3 + o])
        )
    return hit


def _any_window(tb, to, wins, o: int) -> torch.Tensor:
    hit = torch.zeros(tb.shape, dtype=torch.bool, device=tb.device)
    for k in range(8):
        hit |= (
            (tb >= wins[k, 0 + o]) & (tb <= wins[k, 1 + o])
            & (to >= wins[k, 2 + o]) & (to <= wins[k, 3 + o])
        )
    return hit


# ---------------------------------------------------------------- P1 scan


def probe_scan_plain(x, y, tb, to, bids, boxes, wins):
    """P1's planes in plain PyTorch: (wide, inner) int32 [M, SUB/32, 128].
    All arguments are tensors on the columns' device."""
    b = bids.to(torch.int64)
    xs, ys, tbs, tos = x[b], y[b], tb[b], to[b]
    wide = _any_box(xs, ys, boxes, 0) & _any_window(tbs, tos, wins, 0)
    inner = _any_box(xs, ys, boxes, 4) & _any_window(tbs, tos, wins, 4)
    return bk.pack_bits_plain(wide), bk.pack_bits_plain(inner)


def probe_scan_launcher(cols3, bids, boxes, wins):
    """Stage one P1 launch: check, copy the params to the card, allocate
    the planes [2, M, SUB/32, 128]. Returns (planes, launch): each launch()
    writes ``planes`` on the current stream."""
    device, n_blocks = check_columns(cols3, P1_COLS)
    if device.type != "cuda":
        raise ValueError(f"no probe scan kernel for device {device}")
    from geomesa_tpu_torch.kernels import PROBE_SCAN

    bids = np.asarray(bids, np.int32)
    bk.check_bids(bids, n_blocks, allow_pad=False)
    m = len(bids)
    params = _staged(device, bids, _param_block(boxes, np.float32),
                     _param_block(wins, np.int32))
    with torch.cuda.device(device):
        planes = torch.empty((2, m, PACK, LANES), dtype=torch.int32, device=device)
    ptrs = [c.data_ptr() for c in cols3]

    def launch() -> None:
        PROBE_SCAN.launch(*ptrs, params.data_ptr(), m, SUB, planes[0].data_ptr(),
                          planes[1].data_ptr(), _stream(device))

    return planes, launch


def probe_scan(cols3, bids, boxes, wins):
    """P1: (wide, inner) int32 [M, SUB/32, 128] planes of ``cols3`` = (x,
    y, tbin, toff) over block ids ``bids`` (numpy i32 [M], pads repeat
    block 0) with the [8, 128] ``boxes`` and ``wins``, on the columns'
    device."""
    device, n_blocks = check_columns(cols3, P1_COLS)
    if _route(device, "probe scan"):
        bids = np.asarray(bids, np.int32)
        bk.check_bids(bids, n_blocks, allow_pad=False)
        return probe_scan_plain(
            *cols3, torch.from_numpy(bids), torch.from_numpy(_param_block(boxes, np.float32)),
            torch.from_numpy(_param_block(wins, np.int32)),
        )
    planes, launch = probe_scan_launcher(cols3, bids, boxes, wins)
    launch()
    return planes[0], planes[1]


def decode_rows(packed, bids, n_real) -> np.ndarray:
    """[M, PACK, 128] plane -> global row ids of its first ``n_real`` slots,
    slot by slot, each in local-row order (the probe's decode_rows)."""
    blk, local = np.nonzero(bk.unpack_plane(np.asarray(packed), n_real))
    return np.asarray(bids)[:n_real][blk].astype(np.int64) * BLOCK + local


# -------------------------------------------------------------- P2 bounds


def probe_bounds_plain(x, y, bids, boxes) -> torch.Tensor:
    """P2's bounds in plain PyTorch: [M, 128] f32, lanes 0-4 = count,
    xmin, xmax, ymin, ymax of the rows in any box; pad slots (-1) read
    block 0, unmasked. Tensors on the columns' device."""
    b = bids.to(torch.int64).clamp(min=0)
    xs, ys = x[b], y[b]
    w = _any_box(xs, ys, boxes, 0)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    out = torch.zeros((len(b), OUT_LANES), dtype=torch.float32, device=x.device)
    out[:, 0] = w.sum(dim=(1, 2)).to(torch.float32)
    out[:, 1] = torch.where(w, xs, inf).amin(dim=(1, 2))
    out[:, 2] = torch.where(w, xs, -inf).amax(dim=(1, 2))
    out[:, 3] = torch.where(w, ys, inf).amin(dim=(1, 2))
    out[:, 4] = torch.where(w, ys, -inf).amax(dim=(1, 2))
    return out


def probe_bounds_launcher(cols3, bids, boxes):
    """Stage one P2 bounds launch. Returns (out [M, 128], launch)."""
    device, n_blocks = check_columns(cols3, P2_COLS)
    if device.type != "cuda":
        raise ValueError(f"no probe bounds kernel for device {device}")
    from geomesa_tpu_torch.kernels import PROBE_BOUNDS

    bids = np.asarray(bids, np.int32)
    bk.check_bids(bids, n_blocks, allow_pad=True)
    m = len(bids)
    params = _staged(device, bids, _param_block(boxes, np.float32), bk.pack_windows(None, None))
    with torch.cuda.device(device):
        out = torch.empty((m, OUT_LANES), dtype=torch.float32, device=device)
    ptrs = [c.data_ptr() for c in cols3]

    def launch() -> None:
        PROBE_BOUNDS.launch(*ptrs, params.data_ptr(), m, SUB, out.data_ptr(), _stream(device))

    return out, launch


def probe_bounds(cols3, bids, boxes) -> torch.Tensor:
    """P2 bounds: [M, 128] f32 per-slot stats of ``cols3`` = (x, y) over
    ``bids`` (numpy i32 [M], -1 = pad) with the [8, 128] ``boxes``, on the
    columns' device."""
    device, n_blocks = check_columns(cols3, P2_COLS)
    if _route(device, "probe bounds"):
        bids = np.asarray(bids, np.int32)
        bk.check_bids(bids, n_blocks, allow_pad=True)
        return probe_bounds_plain(*cols3, torch.from_numpy(bids),
                                  torch.from_numpy(_param_block(boxes, np.float32)))
    out, launch = probe_bounds_launcher(cols3, bids, boxes)
    launch()
    return out


# ------------------------------------------------------------- P2 density


def density_pixels(x, y, bids, boxes, gb, height: int, width: int) -> torch.Tensor:
    """Flat pixel ids py * width + px (int64) of the rows P2's density
    counts: in any box, in the closed envelope ``gb`` (x0, y0, x1, y1) and
    in a real slot; the pixel in f32 as the probe computes it, clipped."""
    b = bids.to(torch.int64)
    xs, ys = x[b.clamp(min=0)], y[b.clamp(min=0)]
    x0, y0, x1, y1 = gb[0], gb[1], gb[2], gb[3]
    m = (
        _any_box(xs, ys, boxes, 0)
        & (b >= 0)[:, None, None]
        & (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    )
    xs, ys = xs[m], ys[m]
    px = ((xs - x0) / (x1 - x0) * width).to(torch.int32).clamp(0, width - 1)
    py = ((ys - y0) / (y1 - y0) * height).to(torch.int32).clamp(0, height - 1)
    return py.to(torch.int64) * width + px.to(torch.int64)


def probe_density_plain(x, y, bids, boxes, gb, height: int, width: int) -> torch.Tensor:
    """P2's density grid in plain PyTorch: [height, width] f32 counts.
    Tensors on the columns' device."""
    flat = density_pixels(x, y, bids, boxes, gb, height, width)
    return torch.bincount(flat, minlength=height * width).to(torch.float32).reshape(
        height, width
    )


def _variant_chunk(variant: str) -> int:
    if variant not in DENSITY_CHUNKS:
        raise ValueError(f"density variant is one of {sorted(DENSITY_CHUNKS)}: {variant!r}")
    return DENSITY_CHUNKS[variant]


def probe_density_launcher(cols3, bids, boxes, gb, *, variant: str, height: int, width: int):
    """Stage one P2 density launch: check, copy the params to the card,
    zero an f32 [height, width] grid. Returns (grid, launch): each
    launch() adds the counts into ``grid`` on the current stream."""
    chunk = _variant_chunk(variant)
    device, n_blocks = check_columns(cols3, P2_COLS)
    if device.type != "cuda":
        raise ValueError(f"no probe density kernel for device {device}")
    if height % 128 or width % 128 or not 0 < height < 2**15 or not 0 < width < 2**16:
        raise ValueError(f"the density kernel takes grids of 128-multiples: {height}x{width}")
    from geomesa_tpu_torch.kernels import PROBE_DENSITY

    bids = np.asarray(bids, np.int32)
    bk.check_bids(bids, n_blocks, allow_pad=True)
    m = len(bids)
    params = _staged(device, bids, _param_block(boxes, np.float32), bk.pack_windows(None, None),
                     _grid_bounds(gb))
    with torch.cuda.device(device):
        grid = torch.zeros((height, width), dtype=torch.float32, device=device)
    ptrs = [c.data_ptr() for c in cols3]

    def launch() -> None:
        PROBE_DENSITY.launch(*ptrs, params.data_ptr(), m, SUB, chunk, height, width,
                             grid.data_ptr(), _stream(device), leg=variant)

    return grid, launch


def probe_density(cols3, bids, boxes, gb, *, variant: str = "reshape", height: int = 256,
                  width: int = 256) -> torch.Tensor:
    """P2 density: [height, width] f32 grid of ``cols3`` = (x, y) over
    ``bids`` (numpy i32 [M], -1 = pad) with the [8, 128] ``boxes`` and the
    envelope ``gb`` (x0, y0, x1, y1, or the probe's [1, 128] row), on the
    columns' device; ``variant`` names the TPU body ("reshape", "fori")."""
    _variant_chunk(variant)
    device, n_blocks = check_columns(cols3, P2_COLS)
    if _route(device, "probe density"):
        bids = np.asarray(bids, np.int32)
        bk.check_bids(bids, n_blocks, allow_pad=True)
        return probe_density_plain(
            *cols3, torch.from_numpy(bids), torch.from_numpy(_param_block(boxes, np.float32)),
            torch.from_numpy(_grid_bounds(gb)), height, width,
        )
    grid, launch = probe_density_launcher(cols3, bids, boxes, gb, variant=variant,
                                          height=height, width=width)
    launch()
    return grid
