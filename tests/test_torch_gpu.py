"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no interpret mode, so these tests need a CUDA device
and skip without one. They import only torch, numpy and the port, so
they run where jax is not installed (``--noconftest`` skips the suite's
jax setup):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q

Tolerance is exact equality: planes are bit patterns, grids integer
counts, bounds copies of stored f32 values.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu_torch.scan import aggregations as tagg
from geomesa_tpu_torch.scan import block_kernels as tbk

pytestmark = pytest.mark.gpu

SUB = 128
NB = 40


@pytest.fixture(scope="module")
def cuda_cols():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    n = NB * SUB * tbk.LANES
    x = rng.uniform(-180, 180, n).astype(np.float32)
    y = rng.uniform(-90, 90, n).astype(np.float32)
    tb = rng.integers(2800, 2820, n).astype(np.int32)
    to = rng.integers(0, 604_800, n).astype(np.int32)
    tw = ((tb.astype(np.int64) << 16) | (to >> 5)).astype(np.int32)
    for c, s in ((x, np.inf), (y, np.inf), (tb, -1), (tw, -1)):
        c[-3000:] = s
    shape = (NB, SUB, tbk.LANES)
    return {k: torch.from_numpy(v.reshape(shape)).cuda() for k, v in
            {"x": x, "y": y, "tbin": tb, "toff": to, "tw": tw}.items()}


BOXES = tbk.pack_boxes(np.array([[-60, -30, 40, 50], [100, -80, 170, -10]], np.float32),
                       np.array([[-59, -29, 39, 49]], np.float32))
WINS = tbk.pack_windows(np.array([[2801, 2805, 0, 604_799], [2810, 2810, 1000, 90_000]]),
                        np.array([[2801, 2805, 1, 604_798]]))
WINS_TW = tbk.pack_windows(np.array([[2801, 2805, 0, 18_899], [2810, 2810, 31, 2812]]),
                           np.array([[2801, 2805, 1, 18_898]]))
CASES = [
    (("tbin", "toff", "x", "y"), True, True, WINS),
    (("tw", "x", "y"), True, True, WINS_TW),
    (("x", "y"), True, False, WINS),
    (("tbin", "toff"), False, True, WINS),
    (("x",), False, False, WINS),
    (("tw",), False, False, WINS),
]


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a)).to(dtype=dtype).cuda()


@pytest.mark.parametrize("case", CASES)
def test_block_scan_kernel_equals_plain(cuda_cols, case):
    names, hb, hw, wins = case
    bids, _ = tbk.pad_bids(np.array([7, 0, 39, 12, 13, 2]), NB)
    cols = tuple(cuda_cols[k] for k in names)
    w, i = tbk.block_scan(cols, bids, BOXES, wins, col_names=names, has_boxes=hb, has_windows=hw)
    pw, pi = tbk.block_scan_plain(
        dict(zip(names, cols)), _t(bids, torch.int32), _t(BOXES, torch.float32),
        _t(wins, torch.int32), has_boxes=hb, has_windows=hw,
    )
    torch.cuda.synchronize()
    assert torch.equal(w, pw) and torch.equal(i, pi)


@pytest.mark.parametrize("grid", [(256, 256), (33, 17)])
@pytest.mark.parametrize("case", [c for c in CASES if c[1] or c[2]])
def test_density_and_bounds_kernels_equal_plain(cuda_cols, case, grid):
    names, hb, hw, wins = case
    names = tuple(sorted(set(names) | {"x", "y"}))
    width, height = grid
    bids, n_real = tbk.pad_bids(np.array([3, 5, 8, 21, 39]), NB, pad=-1)
    cols = tuple(cuda_cols[k] for k in names)
    gb = np.array([-100, -60, 120, 70], np.float32)
    kw = dict(col_names=names, has_boxes=hb, has_windows=hw)
    got = tagg.block_density(cols, bids, BOXES, wins, gb, width=width, height=height, **kw)
    ref = tagg.density_plain(
        dict(zip(names, cols)), _t(bids, torch.int32), _t(BOXES, torch.float32),
        _t(wins, torch.int32), _t(gb, torch.float32), has_boxes=hb, has_windows=hw,
        width=width, height=height,
    )
    assert torch.equal(got, ref) and got.sum() > 0
    st = tagg.block_bounds(cols, bids, BOXES, wins, **kw)
    sp = tagg.bounds_plain(
        dict(zip(names, cols)), _t(bids, torch.int32), _t(BOXES, torch.float32),
        _t(wins, torch.int32), has_boxes=hb, has_windows=hw,
    )
    assert np.array_equal(st[:n_real].cpu().numpy(), sp[:n_real].cpu().numpy())


def _stacks(n_q: int, tw: bool, seed: int = 9):
    """[bucket_q(n_q), 8, 128] stacks; query q uses 1 + q % 8 box slots and
    1 + (3q + 1) % 8 window slots (seconds, or 32 s ticks for tw)."""
    rng = np.random.default_rng(seed)
    q_pad = tbk.bucket_q(n_q)
    boxes = np.zeros((q_pad, 8, tbk.LANES), np.float32)
    wins = np.zeros((q_pad, 8, tbk.LANES), np.int32)
    top = 18_899 if tw else 604_799
    for q in range(n_q):
        nb, nw = 1 + q % 8, 1 + (3 * q + 1) % 8
        lo = rng.uniform(-170, 100, (nb, 2)).astype(np.float32)
        wide = np.concatenate([lo, lo + rng.uniform(5, 60, (nb, 2)).astype(np.float32)], axis=1)
        boxes[q] = tbk.pack_boxes(wide, wide[:1] + np.array([1, 1, -1, -1], np.float32))
        b = rng.integers(2800, 2820, nw)
        o = np.sort(rng.integers(0, top, (nw, 2)), axis=1)
        ws = np.stack([b, b + rng.integers(0, 3, nw), o[:, 0], o[:, 1]], axis=1)
        wins[q] = tbk.pack_windows(ws, ws[:1] + np.array([0, 0, 1, -1]))
    return boxes, wins


@pytest.mark.parametrize("case", CASES)
def test_block_scan_multi_kernel_equals_plain(cuda_cols, case):
    names, hb, hw, _ = case
    boxes, wins = _stacks(41, tw="tw" in names)
    rng = np.random.default_rng(3)
    blocks = rng.integers(0, NB, 60)
    qids = np.zeros(64, np.int32)
    qids[:60] = rng.permutation(np.arange(60) % 41)  # interleaved queries
    bids, _ = tbk.pad_bids(blocks, NB, bucket=64)   # pads: bid 0, qid 0
    cols = tuple(cuda_cols[k] for k in names)
    w, i = tbk.block_scan_multi(cols, bids, qids, boxes, wins, col_names=names,
                                has_boxes=hb, has_windows=hw)
    pw, pi = tbk.block_scan_multi_plain(
        dict(zip(names, cols)), _t(bids, torch.int32), _t(qids, torch.int32),
        _t(boxes, torch.float32), _t(wins, torch.int32), has_boxes=hb, has_windows=hw,
    )
    torch.cuda.synchronize()
    assert torch.equal(w, pw) and torch.equal(i, pi) and bool(w.any())


@pytest.mark.parametrize("case", CASES)
def test_block_pops_kernel_equals_plain(cuda_cols, case):
    names, hb, hw, wins = case
    bids, n_real = tbk.pad_bids(np.array([7, 0, 39, 12, 13, 2]), NB, pad=-1)
    cols = tuple(cuda_cols[k] for k in names)
    got = tagg.block_pops(cols, bids, BOXES, wins, col_names=names, has_boxes=hb, has_windows=hw)
    ref = tagg.block_pops_plain(
        dict(zip(names, cols)), _t(bids, torch.int32), _t(BOXES, torch.float32),
        _t(wins, torch.int32), has_boxes=hb, has_windows=hw,
    )
    assert torch.equal(got, ref) and int(got[:n_real].sum()) > 0
