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
from geomesa_tpu_torch.scan import probe_kernels as tpk

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


def _star(cx, cy, arms, r_in, r_out, hole=False):
    """A star polygon of 2 * arms edges (with a reversed inner hole ring)."""
    from geomesa_tpu_torch import geometry as geo

    a = np.linspace(0, 2 * np.pi, 2 * arms, endpoint=False)
    r = np.where(np.arange(2 * arms) % 2 == 0, r_out, r_in)
    shell = np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1)
    holes = []
    if hole:
        h = 0.3 * r_in
        holes.append(np.stack([cx + h * np.cos(a[::-1]), cy + h * np.sin(a[::-1])], axis=1))
    return geo.Polygon(shell, holes)


# (polygon, leg): E buckets 16, 64 (with a hole) and 256; rasters at R 16,
# 64 and 256; both legs at R 16
POLY_CASES = [
    ((-10, 5, 7, 30, 90), "pip", 0),
    ((20, -10, 30, 25, 70, True), "pip", 0),
    ((0, 0, 120, 40, 80), "pip", 0),
    ((-10, 5, 7, 30, 90), "raster", 16),
    ((20, -10, 30, 25, 70, True), "raster", 64),
    ((0, 0, 120, 40, 80), "raster", 256),
    ((20, -10, 30, 25, 70, True), "pip+raster", 16),
]


@pytest.mark.parametrize("case", [c for c in CASES if c[1]])
@pytest.mark.parametrize("poly", POLY_CASES, ids=[f"{c[1]}-R{c[2]}-{k}"
                                                  for k, c in enumerate(POLY_CASES)])
def test_block_scan_polygon_legs_equal_plain(cuda_cols, case, poly):
    from geomesa_tpu_torch.filter import raster as tfr

    names, hb, hw, wins = case
    spec, leg, r_bucket = poly
    p = _star(*spec)
    edges = tbk.pack_edges(p) if "pip" in leg else None
    rast = tfr.build_raster(p).pack_block(r_bucket) if "raster" in leg else None
    bids, _ = tbk.pad_bids(np.array([7, 0, 39, 12, 13, 2, 20, 21]), NB)
    cols = tuple(cuda_cols[k] for k in names)
    w, i = tbk.block_scan(cols, bids, BOXES, wins, col_names=names, has_boxes=hb,
                          has_windows=hw, edges=edges, n_edges=tbk.n_edges_of(edges),
                          rast=rast, n_rints=tbk.n_rints_of(rast))
    pw, pi = tbk.block_scan_plain(
        dict(zip(names, cols)), _t(bids, torch.int32), _t(BOXES, torch.float32),
        _t(wins, torch.int32), has_boxes=hb, has_windows=hw,
        edges=None if edges is None else _t(edges, torch.float32),
        rast=None if rast is None else _t(rast, torch.float32),
    )
    torch.cuda.synchronize()
    assert torch.equal(w, pw) and torch.equal(i, pi) and bool(w.any())


@pytest.mark.parametrize("leg", ["pip", "raster", "pip+raster"])
@pytest.mark.parametrize("case", [c for c in CASES if c[1]])
def test_block_scan_multi_polygon_stacks_equal_plain(cuda_cols, case, leg):
    """Polygon queries of differing edge and interval counts beside box
    queries in one chunk (E bucket 64, R bucket 16); spip 0 on box slots
    and pads."""
    from geomesa_tpu_torch.filter import raster as tfr

    names, hb, hw, _ = case
    n_q = 24
    boxes, wins = _stacks(n_q, tw="tw" in names)
    rng = np.random.default_rng(11)
    q_pad = boxes.shape[0]
    edges = np.zeros((q_pad, 64, tbk.LANES), np.float32) if "pip" in leg else None
    rasts = np.zeros((q_pad, 17, tbk.LANES), np.float32) if "raster" in leg else None
    poly = np.zeros(q_pad, bool)
    for q in range(0, n_q, 3):
        p = _star(rng.uniform(-120, 120), rng.uniform(-50, 50), 3 + q // 2, 10 + q, 60, q % 2 == 0)
        if edges is not None:
            e = tbk.pack_edges(p)
            edges[q, : len(e)] = e
        if rasts is not None:
            r = tfr.build_raster(p).pack_block(16)
            rasts[q, : len(r)] = r
        poly[q] = True
    blocks = rng.integers(0, NB, 60)
    qids = np.zeros(64, np.int32)
    qids[:60] = rng.permutation(np.arange(60) % n_q)
    bids, n_real = tbk.pad_bids(blocks, NB, bucket=64)
    spip = poly[qids].astype(np.int32)
    spip[n_real:] = 0
    cols = tuple(cuda_cols[k] for k in names)
    n_edges, n_rints = (0 if edges is None else 64), (0 if rasts is None else 16)
    w, i = tbk.block_scan_multi(cols, bids, qids, boxes, wins, col_names=names, has_boxes=hb,
                                has_windows=hw, edges=edges, spip=spip, n_edges=n_edges,
                                rasts=rasts, n_rints=n_rints)
    pw, pi = tbk.block_scan_multi_plain(
        dict(zip(names, cols)), _t(bids, torch.int32), _t(qids, torch.int32),
        _t(boxes, torch.float32), _t(wins, torch.int32), has_boxes=hb, has_windows=hw,
        edges=None if edges is None else _t(edges, torch.float32),
        rasts=None if rasts is None else _t(rasts, torch.float32), spip=_t(spip, torch.int32),
    )
    torch.cuda.synchronize()
    assert torch.equal(w, pw) and torch.equal(i, pi) and bool(w.any())


# ------------------------------------------------------------ extent legs

EXT = ("gxmax", "gxmin", "gymax", "gymin")
# (projected columns, has_boxes, has_windows): XZ2 box, XZ3 box + window,
# XZ3 window alone, validity on gxmin
EXT_CASES = [
    (EXT, True, False),
    (tuple(sorted(EXT + ("tbin", "toff"))), True, True),
    (("tbin", "toff"), False, True),
    (("gxmin",), False, False),
]
EXT_BOXES = tbk.pack_boxes(np.array([[-60, -30, 40, 50], [100, -80, 170, -10]], np.float32), None)


@pytest.fixture(scope="module")
def cuda_ext_cols(cuda_cols):
    """Extent columns beside the point table's time columns: boxes up to a
    few degrees wide, one f32 ulp widened, boxes touching the first query
    box's edges exactly, pad rows (+inf, -inf) at the tail."""
    rng = np.random.default_rng(8)
    n = NB * SUB * tbk.LANES
    x0 = rng.uniform(-180, 178, n)
    y0 = rng.uniform(-90, 88, n)
    w, h = rng.exponential(0.5, n), rng.exponential(0.5, n)
    gx0 = np.nextafter(x0.astype(np.float32), -np.inf)
    gy0 = np.nextafter(y0.astype(np.float32), -np.inf)
    gx1 = np.nextafter((x0 + w).astype(np.float32), np.inf)
    gy1 = np.nextafter((y0 + h).astype(np.float32), np.inf)
    # stored extents touching an edge of EXT_BOXES[0] = (-60, -30, 40, 50)
    # from outside, 64 rows per edge: (gxmin, gymin, gxmax, gymax)
    for k, ext in enumerate(((40, 0, 41, 1), (-61, 0, -60, 1), (0, 50, 1, 51), (0, -31, 1, -30))):
        for col, v in zip((gx0, gy0, gx1, gy1), ext):
            col[64 * k:64 * (k + 1)] = v
    gx0[-3000:] = gy0[-3000:] = np.inf
    gx1[-3000:] = gy1[-3000:] = -np.inf
    shape = (NB, SUB, tbk.LANES)
    out = {k: torch.from_numpy(v.reshape(shape)).cuda() for k, v in
           {"gxmin": gx0, "gymin": gy0, "gxmax": gx1, "gymax": gy1}.items()}
    return {**out, "tbin": cuda_cols["tbin"], "toff": cuda_cols["toff"]}


@pytest.mark.parametrize("case", EXT_CASES)
def test_extent_scan_and_pops_kernels_equal_plain(cuda_ext_cols, case):
    names, hb, hw = case
    bids, n_real = tbk.pad_bids(np.array([7, 0, 39, 12, 13, 2]), NB)
    cols = tuple(cuda_ext_cols[k] for k in names)
    kw = dict(col_names=names, has_boxes=hb, has_windows=hw, extent=True)
    plain = dict(has_boxes=hb, has_windows=hw, extent=True)
    w, i = tbk.block_scan(cols, bids, EXT_BOXES, WINS, **kw)
    args = (dict(zip(names, cols)), _t(bids, torch.int32), _t(EXT_BOXES, torch.float32),
            _t(WINS, torch.int32))
    pw, pi = tbk.block_scan_plain(*args, **plain)
    torch.cuda.synchronize()
    assert torch.equal(w, pw) and bool(w.any())
    assert (i is None) == (pi is None) == hb  # an extent box scan has one plane
    assert i is None or torch.equal(i, pi)
    got = tagg.block_pops(cols, bids, EXT_BOXES, WINS, **kw)
    assert torch.equal(got, tagg.block_pops_plain(*args, **plain))


@pytest.mark.parametrize("case", EXT_CASES)
def test_extent_block_scan_multi_kernel_equals_plain(cuda_ext_cols, case):
    names, hb, hw = case
    boxes, wins = _stacks(41, tw=False)
    rng = np.random.default_rng(4)
    qids = np.zeros(64, np.int32)
    qids[:60] = rng.permutation(np.arange(60) % 41)
    bids, _ = tbk.pad_bids(rng.integers(0, NB, 60), NB, bucket=64)
    cols = tuple(cuda_ext_cols[k] for k in names)
    w, i = tbk.block_scan_multi(cols, bids, qids, boxes, wins, col_names=names,
                                has_boxes=hb, has_windows=hw, extent=True)
    pw, pi = tbk.block_scan_multi_plain(
        dict(zip(names, cols)), _t(bids, torch.int32), _t(qids, torch.int32),
        _t(boxes, torch.float32), _t(wins, torch.int32), has_boxes=hb, has_windows=hw,
        extent=True,
    )
    torch.cuda.synchronize()
    assert torch.equal(w, pw) and bool(w.any())
    assert (i is None) == (pi is None) == hb
    assert i is None or torch.equal(i, pi)


@pytest.mark.parametrize("grid", [(256, 256), (33, 17)])
@pytest.mark.parametrize("case", [c for c in EXT_CASES if c[1] or c[2]])
def test_extent_density_and_bounds_kernels_equal_plain(cuda_ext_cols, case, grid):
    """The bbox centre as the representative point; pad rows' NaN centres
    never reach a pixel."""
    names, hb, hw = case
    names = tuple(sorted(set(names) | set(EXT)))
    width, height = grid
    bids, n_real = tbk.pad_bids(np.array([3, 5, 8, 21, 39]), NB, pad=-1)
    cols = tuple(cuda_ext_cols[k] for k in names)
    gb = np.array([-100, -60, 120, 70], np.float32)
    kw = dict(col_names=names, has_boxes=hb, has_windows=hw, extent=True)
    plain = dict(has_boxes=hb, has_windows=hw, extent=True)
    args = (dict(zip(names, cols)), _t(bids, torch.int32), _t(EXT_BOXES, torch.float32),
            _t(WINS, torch.int32))
    got = tagg.block_density(cols, bids, EXT_BOXES, WINS, gb, width=width, height=height, **kw)
    ref = tagg.density_plain(*args, _t(gb, torch.float32), width=width, height=height, **plain)
    assert torch.equal(got, ref) and got.sum() > 0
    st = tagg.block_bounds(cols, bids, EXT_BOXES, WINS, **kw)
    sp = tagg.bounds_plain(*args, **plain)
    assert np.array_equal(st[:n_real].cpu().numpy(), sp[:n_real].cpu().numpy())


# -- K3 as redesigned: warp-compacted hits, grouped device atomics --------

HOT = (10.0, 20.0)  # every row of the hot blocks lies on this point


@pytest.fixture(scope="module")
def hot_cols(cuda_cols):
    """cuda_cols with blocks 8-15 (131,072 rows) moved onto one point and
    blocks 16-23 into 4 gaussian clusters of sigma 0.5 degrees."""
    rng = np.random.default_rng(6)
    x = cuda_cols["x"].clone()
    y = cuda_cols["y"].clone()
    x[8:16] = HOT[0]
    y[8:16] = HOT[1]
    shape = tuple(x[16:24].shape)
    which = rng.integers(0, 4, shape)
    x[16:24] = torch.from_numpy((rng.uniform(-50, 30, 4)[which]
                                 + rng.normal(0, 0.5, shape)).astype(np.float32)).cuda()
    y[16:24] = torch.from_numpy((rng.uniform(-25, 45, 4)[which]
                                 + rng.normal(0, 0.5, shape)).astype(np.float32)).cuda()
    return {**cuda_cols, "x": x, "y": y}


def _density_pair(cols_by_name, names, bids, boxes, wins, gb, width, height, hb=True, hw=True):
    cols = tuple(cols_by_name[k] for k in names)
    got = tagg.block_density(cols, bids, boxes, wins, gb, width=width, height=height,
                             col_names=names, has_boxes=hb, has_windows=hw)
    ref = tagg.density_plain(
        dict(zip(names, cols)), _t(bids, torch.int32), _t(boxes, torch.float32),
        _t(wins, torch.int32), _t(gb, torch.float32), has_boxes=hb, has_windows=hw,
        width=width, height=height,
    )
    torch.cuda.synchronize()
    return got, ref


# the test grid, the polygon path's and the main path's
K3_GRIDS = [(33, 17), (128, 128), (256, 256)]


@pytest.mark.parametrize("grid", K3_GRIDS)
def test_density_kernel_hot_pixel_past_16_bits(hot_cols, grid):
    """One pixel gets 131,072 hits from 8 blocks, split over several CTAs
    (at most 16,384 rows each), clusters make other hot pixels: the
    grouped atomics of every CTA must add up exactly past 16 bits."""
    width, height = grid
    names = ("tbin", "toff", "x", "y")
    bids, _ = tbk.pad_bids(np.arange(0, 30), NB, pad=-1)
    boxes = tbk.pack_boxes(np.array([[-60, -30, 40, 50]], np.float32), None)
    wins = tbk.pack_windows(np.array([[2800, 2819, 0, 604_799]]), None)
    gb = np.array([-100, -60, 120, 70], np.float32)
    # the hot blocks' time columns match the window: tbin, toff as drawn
    got, ref = _density_pair(hot_cols, names, bids, boxes, wins, gb, width, height)
    assert torch.equal(got, ref) and float(ref.max()) > 65_535


@pytest.mark.parametrize("grid", K3_GRIDS)
def test_density_kernel_all_pads_and_empty_predicate(cuda_cols, grid):
    width, height = grid
    names = ("tbin", "toff", "x", "y")
    gb = np.array([-100, -60, 120, 70], np.float32)
    pads = np.full(32, -1, np.int32)
    got, ref = _density_pair(cuda_cols, names, pads, BOXES, WINS, gb, width, height)
    assert torch.equal(got, ref) and float(got.sum()) == 0
    empty = tbk.pack_boxes(np.array([[200, 100, 210, 110]], np.float32), None)
    bids, _ = tbk.pad_bids(np.arange(NB), NB, pad=-1)
    got, ref = _density_pair(cuda_cols, names, bids, empty, WINS, gb, width, height)
    assert torch.equal(got, ref) and float(got.sum()) == 0


@pytest.mark.parametrize("grid", K3_GRIDS)
def test_density_kernel_every_block_box_and_validity(hot_cols, grid):
    """Every block of the table (pads past the bucket), the box leg alone
    and the validity leg (no predicate: every finite row)."""
    width, height = grid
    bids, _ = tbk.pad_bids(np.arange(NB), NB, pad=-1)
    gb = np.array([-100, -60, 120, 70], np.float32)
    for names, hb, hw in ((("x", "y"), True, False), (("x", "y"), False, False)):
        got, ref = _density_pair(hot_cols, names, bids, BOXES, WINS, gb, width, height, hb, hw)
        assert torch.equal(got, ref) and float(got.sum()) > 0


# -- K1 and K2 as redesigned: the row-batched body's edges ------------------

EDGE_NB = 6
EDGE_SUBS = [32, 96, 256]  # SUB/32 = 1, 3, 8 word groups a slot


@pytest.fixture(scope="module")
def sub_cols():
    """Point, extent and time columns of EDGE_NB blocks at each SUB of
    EDGE_SUBS, pad rows (+inf, -1; empty extents) at the last block's
    tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = {}
    for sub in EDGE_SUBS:
        rng = np.random.default_rng(sub)
        n = EDGE_NB * sub * tbk.LANES
        x = rng.uniform(-180, 180, n).astype(np.float32)
        y = rng.uniform(-90, 90, n).astype(np.float32)
        tb = rng.integers(2800, 2820, n).astype(np.int32)
        to = rng.integers(0, 604_800, n).astype(np.int32)
        tw = ((tb.astype(np.int64) << 16) | (to >> 5)).astype(np.int32)
        x0, y0 = rng.uniform(-180, 178, n), rng.uniform(-90, 88, n)
        w, h = rng.exponential(2.0, n), rng.exponential(2.0, n)
        gx0 = np.nextafter(x0.astype(np.float32), -np.inf)
        gy0 = np.nextafter(y0.astype(np.float32), -np.inf)
        gx1 = np.nextafter((x0 + w).astype(np.float32), np.inf)
        gy1 = np.nextafter((y0 + h).astype(np.float32), np.inf)
        tail = slice(n - sub * tbk.LANES // 3, n)
        for c, v in ((x, np.inf), (y, np.inf), (tb, -1), (tw, -1), (gx0, np.inf),
                     (gy0, np.inf), (gx1, -np.inf), (gy1, -np.inf)):
            c[tail] = v
        shape = (EDGE_NB, sub, tbk.LANES)
        out[sub] = {k: torch.from_numpy(v.reshape(shape)).cuda() for k, v in dict(
            x=x, y=y, tbin=tb, toff=to, tw=tw, gxmin=gx0, gymin=gy0, gxmax=gx1,
            gymax=gy1).items()}
    return out


def _k1_pair(cols_by_name, names, bids, boxes, wins, hb, hw, extent=False, edges=None,
             rast=None):
    cols = tuple(cols_by_name[k] for k in names)
    w, i = tbk.block_scan(cols, bids, boxes, wins, col_names=names, has_boxes=hb,
                          has_windows=hw, extent=extent, edges=edges,
                          n_edges=tbk.n_edges_of(edges), rast=rast, n_rints=tbk.n_rints_of(rast))
    pw, pi = tbk.block_scan_plain(
        dict(zip(names, cols)), _t(bids, torch.int32), _t(boxes, torch.float32),
        _t(wins, torch.int32), has_boxes=hb, has_windows=hw, extent=extent,
        edges=None if edges is None else _t(edges, torch.float32),
        rast=None if rast is None else _t(rast, torch.float32),
    )
    torch.cuda.synchronize()
    return (w, i), (pw, pi)


def _k2_pair(cols_by_name, names, bids, qids, boxes, wins, hb, hw, extent=False, edges=None,
             rasts=None, spip=None):
    cols = tuple(cols_by_name[k] for k in names)
    n_edges = 0 if edges is None else edges.shape[1]
    n_rints = 0 if rasts is None else rasts.shape[1] - 1
    w, i = tbk.block_scan_multi(cols, bids, qids, boxes, wins, col_names=names, has_boxes=hb,
                                has_windows=hw, extent=extent, edges=edges, spip=spip,
                                n_edges=n_edges, rasts=rasts, n_rints=n_rints)
    pw, pi = tbk.block_scan_multi_plain(
        dict(zip(names, cols)), _t(bids, torch.int32), _t(qids, torch.int32),
        _t(boxes, torch.float32), _t(wins, torch.int32), has_boxes=hb, has_windows=hw,
        extent=extent, edges=None if edges is None else _t(edges, torch.float32),
        rasts=None if rasts is None else _t(rasts, torch.float32),
        spip=None if spip is None else _t(spip, torch.int32),
    )
    torch.cuda.synchronize()
    return (w, i), (pw, pi)


def _same_planes(got, ref) -> bool:
    (w, i), (pw, pi) = got, ref
    return torch.equal(w, pw) and (i is None) == (pi is None) and (i is None or torch.equal(i, pi))


# M = 1 on the table's last block; three slots ending on it, block 0 between
EDGE_BIDS = {"M1-last": [EDGE_NB - 1], "M3-last": [2, 0, EDGE_NB - 1]}


@pytest.mark.parametrize("bids", list(EDGE_BIDS), ids=list(EDGE_BIDS))
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sub", EDGE_SUBS)
def test_block_scan_sub_and_small_m_equal_plain(sub_cols, sub, case, bids):
    """K1 at SUB/32 = 1, 3 and 8 word groups, M = 1 and M = 3, the last
    block of the table (pad rows at its tail) among the slots."""
    names, hb, hw, wins = case
    got, ref = _k1_pair(sub_cols[sub], names, np.array(EDGE_BIDS[bids], np.int32), BOXES, wins,
                        hb, hw)
    assert _same_planes(got, ref) and bool(ref[0].any())


@pytest.mark.parametrize("leg", ["pip", "raster", "pip+raster"])
@pytest.mark.parametrize("sub", EDGE_SUBS)
def test_block_scan_polygon_legs_at_each_sub_equal_plain(sub_cols, sub, leg):
    from geomesa_tpu_torch.filter import raster as tfr

    p = _star(20, -10, 30, 25, 70, True)
    edges = tbk.pack_edges(p) if "pip" in leg else None
    rast = tfr.build_raster(p).pack_block(16) if "raster" in leg else None
    names = ("tbin", "toff", "x", "y")
    got, ref = _k1_pair(sub_cols[sub], names, np.array([2, 0, EDGE_NB - 1], np.int32), BOXES,
                        WINS, True, True, edges=edges, rast=rast)
    assert _same_planes(got, ref) and bool(ref[0].any())


def _one_and_eight_slots(tw: bool):
    """Query 0 with 1 box slot and 1 window slot, query 1 with 8 of each
    (the inner plane with fewer), in a stack of 2."""
    rng = np.random.default_rng(21)
    top = 18_899 if tw else 604_799
    boxes = np.zeros((2, 8, tbk.LANES), np.float32)
    wins = np.zeros((2, 8, tbk.LANES), np.int32)
    for q, n in ((0, 1), (1, 8)):
        lo = rng.uniform(-170, 100, (n, 2)).astype(np.float32)
        wide = np.concatenate([lo, lo + rng.uniform(10, 70, (n, 2)).astype(np.float32)], axis=1)
        boxes[q] = tbk.pack_boxes(wide, wide[: max(1, n // 2)] + np.array([1, 1, -1, -1],
                                                                          np.float32))
        b = rng.integers(2800, 2820, n)
        o = np.sort(rng.integers(0, top, (n, 2)), axis=1)
        ws = np.stack([b, b + rng.integers(0, 4, n), o[:, 0], o[:, 1]], axis=1)
        wins[q] = tbk.pack_windows(ws, ws[: max(1, n // 2)] + np.array([0, 0, 1, -1]))
    return boxes, wins


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sub", EDGE_SUBS)
def test_block_scan_multi_one_then_eight_slots_equal_plain(sub_cols, sub, case):
    """A chunk whose queries alternate slot by slot between 1 and 8 box and
    window slots (each warp restages its query's words on every change),
    the last block among the slots, and M = 1."""
    names, hb, hw, _ = case
    boxes, wins = _one_and_eight_slots(tw="tw" in names)
    bids = np.array([EDGE_NB - 1, 0, 3, EDGE_NB - 1, 1, 2, 4, 5], np.int32)
    qids = (np.arange(len(bids)) % 2).astype(np.int32)
    got, ref = _k2_pair(sub_cols[sub], names, bids, qids, boxes, wins, hb, hw)
    assert _same_planes(got, ref) and bool(ref[0].any())
    got, ref = _k2_pair(sub_cols[sub], names, bids[:1], qids[1:2], boxes, wins, hb, hw)
    assert _same_planes(got, ref)


@pytest.mark.parametrize("leg", ["pip", "raster", "pip+raster"])
@pytest.mark.parametrize("sub", EDGE_SUBS)
def test_block_scan_multi_box_slots_between_polygon_slots_equal_plain(sub_cols, sub, leg):
    """A chunk carrying stacks where polygon slots (spip 1) and box slots
    (spip 0) of other queries alternate; the box queries' polygon blocks
    are zero and past the staged blocks."""
    from geomesa_tpu_torch.filter import raster as tfr

    boxes, wins = _one_and_eight_slots(tw=False)
    boxes = np.concatenate([boxes, boxes])
    wins = np.concatenate([wins, wins])
    edges = np.zeros((4, 64, tbk.LANES), np.float32) if "pip" in leg else None
    rasts = np.zeros((4, 17, tbk.LANES), np.float32) if "raster" in leg else None
    for q, spec in ((0, (-40, 10, 9, 25, 70, True)), (1, (60, -20, 14, 20, 60))):
        p = _star(*spec)
        if edges is not None:
            e = tbk.pack_edges(p)
            edges[q, : len(e)] = e
        if rasts is not None:
            r = tfr.build_raster(p).pack_block(16)
            rasts[q, : len(r)] = r
    qids = np.array([0, 2, 1, 3, 0, 3, 1, 2], np.int32)  # queries 2, 3 take the box leg
    spip = (qids < 2).astype(np.int32)
    bids = np.array([EDGE_NB - 1, 0, 3, EDGE_NB - 1, 1, 2, 4, 5], np.int32)
    names = ("tbin", "toff", "x", "y")
    got, ref = _k2_pair(sub_cols[sub], names, bids, qids, boxes, wins, True, True, edges=edges,
                        rasts=rasts, spip=spip)
    assert _same_planes(got, ref) and bool(ref[0].any())


@pytest.mark.parametrize("case", EXT_CASES)
def test_extent_scans_at_sub_96_equal_plain(sub_cols, case):
    """The extent leg on three word groups a slot: K1 with M = 1 and 3 on
    the last block, K2 with 1- and 8-slot queries alternating."""
    names, hb, hw = case
    cols = sub_cols[96]
    for bids in EDGE_BIDS.values():
        got, ref = _k1_pair(cols, names, np.array(bids, np.int32), EXT_BOXES, WINS, hb, hw,
                            extent=True)
        assert _same_planes(got, ref) and bool(ref[0].any())
    boxes, wins = _one_and_eight_slots(tw=False)
    bids = np.array([EDGE_NB - 1, 0, 3, EDGE_NB - 1, 1, 2, 4, 5], np.int32)
    qids = (np.arange(len(bids)) % 2).astype(np.int32)
    got, ref = _k2_pair(cols, names, bids, qids, boxes, wins, hb, hw, extent=True)
    assert _same_planes(got, ref) and bool(ref[0].any())


def test_scan_wrappers_refuse_unaligned_columns(sub_cols):
    """The scans read 16 bytes at a time from each block's base: a column
    view that starts off a 16-byte boundary raises before any launch."""
    n = EDGE_NB - 1
    x = sub_cols[32]["x"].flatten()[1:1 + n * 32 * tbk.LANES].reshape(n, 32, tbk.LANES)
    y = sub_cols[32]["y"][:n].contiguous()
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        tbk.block_scan((x, y), np.array([0], np.int32), BOXES, WINS, col_names=("x", "y"),
                       has_boxes=True, has_windows=False)


# -- the chip-side probes' kernels (P1 scan, P2 bounds and density) ---------

PROBE_NB = 24


@pytest.fixture(scope="module")
def probe_cols():
    """The probes' [PROBE_NB, 128, 128] columns on the card (x, y, tbin,
    toff), drawn as the probes draw them, with rows exactly on the edges
    of the P2 box / envelope (-40, -30, 60, 40) and of the P1 box."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from geomesa_tpu_torch.scripts import probe_pallas as pp

    x, y, tb, to = (a.copy() for a in pp.make_columns(PROBE_NB * tpk.BLOCK, seed=3))
    xb, yb = x.reshape(PROBE_NB, -1), y.reshape(PROBE_NB, -1)
    for k, (ex, ey) in enumerate(((60, 0), (0, 40), (60, 40), (-40, -30), (10, 10),
                                  (-10, 5), (60.00001, 0))):
        xb[:, k * 97:(k + 1) * 97] = ex  # in every block
        yb[:, k * 97:(k + 1) * 97] = ey
    return tuple(torch.from_numpy(a).cuda() for a in (x, y, tb, to))


def _probe_p1_params(n_slots):
    from geomesa_tpu_torch.scripts import probe_pallas as pp

    r = np.random.default_rng(n_slots)
    lo = r.uniform(-170, 100, (n_slots, 2)).astype(np.float32)
    bw = np.concatenate([lo, lo + r.uniform(5, 60, (n_slots, 2)).astype(np.float32)], axis=1)
    bw[0] = (-10, -10, 10, 10)
    b = r.integers(0, 18, n_slots)
    ww = np.stack([b, b + r.integers(0, 4, n_slots), np.zeros(n_slots, int),
                   np.full(n_slots, 604_799)], axis=1)
    ww[-1, 2:] = (1000, 90_000)
    return pp.pack_params(bw, bw[:1] + np.float32([1, 1, -1, -1]), ww, ww[:1])


@pytest.mark.parametrize("m", [8, 32])
@pytest.mark.parametrize("n_slots", [1, 3, 8])
def test_probe_scan_kernel_equals_plain(probe_cols, m, n_slots):
    """P1's planes word for word, pad slots (the tail repeating block 0)
    included."""
    r = np.random.default_rng(m)
    bids = np.zeros(m, np.int32)
    bids[: m - m // 4] = np.sort(r.choice(PROBE_NB, m - m // 4, replace=m > PROBE_NB))
    boxes, wins = _probe_p1_params(n_slots)
    w, i = tpk.probe_scan(probe_cols, bids, boxes, wins)
    pw, pi = tpk.probe_scan_plain(*probe_cols, _t(bids, torch.int32),
                                  _t(boxes, torch.float32), _t(wins, torch.int32))
    torch.cuda.synchronize()
    assert torch.equal(w, pw) and torch.equal(i, pi) and bool(w.any())


def _probe_p2_bids(m):
    r = np.random.default_rng(m + 1)
    bids = np.full(m, -1, np.int32)
    bids[: m - m // 4] = np.sort(r.choice(PROBE_NB, m - m // 4, replace=m > PROBE_NB))
    return bids


P2_BOXES = tbk.pack_boxes(np.array([[-40.0, -30.0, 60.0, 40.0], [100, -80, 170, -10]]), None)


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("m", [8, 32])
def test_probe_bounds_kernel_equals_plain(probe_cols, m, empty):
    """P2 bounds: pad slots (-1) report block 0's stats, unmasked; a box
    that matches nothing gives count 0 and +-inf extrema."""
    boxes = tbk.pack_boxes(np.array([[500.0, 500, 501, 501]]), None) if empty else P2_BOXES
    bids = _probe_p2_bids(m)
    got = tpk.probe_bounds(probe_cols[:2], bids, boxes)
    ref = tpk.probe_bounds_plain(*probe_cols[:2], _t(bids, torch.int32),
                                 _t(boxes, torch.float32))
    block0 = tpk.probe_bounds_plain(*probe_cols[:2], _t(np.zeros(1, np.int32), torch.int32),
                                    _t(boxes, torch.float32))[0]
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got[-1], block0)
    assert (float(got[:, 0].sum()) == 0) == empty


@pytest.mark.parametrize("grid", [(256, 256), (128, 384), (33, 17), (1000, 3)])
@pytest.mark.parametrize("variant", ["reshape", "fori"])
@pytest.mark.parametrize("m", [8, 32])
def test_probe_density_kernel_equals_plain(probe_cols, m, variant, grid):
    """P2 density, both variants (one kernel), on grids of any size: rows
    on x1 / y1 clip to the last pixel, pad slots count nothing; and K3's
    grid is the same."""
    height, width = grid
    bids = _probe_p2_bids(m)
    gb = np.array([-40, -30, 60, 40], np.float32)
    from geomesa_tpu_torch.kernels import PROBE_DENSITY

    before = PROBE_DENSITY.leg_launches[variant]
    got = tpk.probe_density(probe_cols[:2], bids, P2_BOXES, gb, variant=variant,
                            height=height, width=width)
    assert PROBE_DENSITY.leg_launches[variant] == before + 1
    ref = tpk.probe_density_plain(*probe_cols[:2], _t(bids, torch.int32),
                                  _t(P2_BOXES, torch.float32), _t(gb, torch.float32),
                                  height, width)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and got.sum() > 0 and got[-1, -1] > 0
    k3 = tagg.block_density(probe_cols[:2], bids, P2_BOXES, WINS, gb, width=width,
                            height=height, col_names=("x", "y"), has_boxes=True,
                            has_windows=False)
    assert torch.equal(k3, ref)


# the probes over M, on the probe's params and on the 8-slot split, and on
# the live-slot staging edge cases (scripts/probe_pallas.staging_cases)

PROBE_MS = [1, 3, 128, 257, 1024]


def _probe_p1_bids(m):
    """P1's bids: the last quarter pad slots repeating block 0."""
    r = np.random.default_rng(m + 2)
    bids = np.zeros(m, np.int32)
    n = m - m // 4
    bids[:n] = np.sort(r.choice(PROBE_NB, n, replace=n > PROBE_NB))
    return bids


def _probe_kernels_equal_plain(cols, bids1, bids2, boxes, wins, boxes2) -> dict:
    """Each probe kernel on the card against its plain version: P1 on
    ``bids1`` (pads repeat block 0) with ``boxes``, ``wins``; P2 bounds and
    both density variants on ``bids2`` (pads -1) with ``boxes2``. Returns
    the outputs by name."""
    gb = np.array([-40, -30, 60, 40], np.float32)
    w, i = tpk.probe_scan(cols, bids1, boxes, wins)
    pw, pi = tpk.probe_scan_plain(*cols, _t(bids1, torch.int32), _t(boxes, torch.float32),
                                  _t(wins, torch.int32))
    b2 = (*cols[:2], _t(bids2, torch.int32), _t(boxes2, torch.float32))
    bounds = tpk.probe_bounds(cols[:2], bids2, boxes2)
    ref_grid = tpk.probe_density_plain(*b2, _t(gb, torch.float32), 256, 256)
    grids = {v: tpk.probe_density(cols[:2], bids2, boxes2, gb, variant=v)
             for v in tpk.DENSITY_VARIANTS}
    torch.cuda.synchronize()
    assert torch.equal(w, pw) and torch.equal(i, pi)
    assert torch.equal(bounds, tpk.probe_bounds_plain(*b2))
    for g in grids.values():
        assert torch.equal(g, ref_grid)
    return {"wide": w, "inner": i, "bounds": bounds, "grid": ref_grid}


@pytest.mark.parametrize("m", PROBE_MS)
def test_probe_kernels_over_m_and_the_split(probe_cols, m):
    """P1, P2 bounds and P2 density at M = 1 to 1024, each with its pad
    rule (P1's pads repeat block 0; P2 bounds' pads read block 0 unmasked;
    density's count nothing), on the probe's params and on the 8-slot
    split, which gives the same outputs."""
    from geomesa_tpu_torch.scripts import probe_agg as pa
    from geomesa_tpu_torch.scripts import probe_pallas as pp

    bids1, bids2 = _probe_p1_bids(m), _probe_p2_bids(m)
    boxes, wins = pp.pack_params(*(np.array([pp.BOX], np.float32),) * 2,
                                 *(np.array([pp.WINDOW], np.int32),) * 2)
    p2_boxes = tbk.pack_boxes(np.array([pa.BOX]), None)
    one = _probe_kernels_equal_plain(probe_cols, bids1, bids2, boxes, wins, p2_boxes)
    split = _probe_kernels_equal_plain(probe_cols, bids1, bids2, *pp.split_params(),
                                       pa.split_boxes())
    for k in one:
        assert torch.equal(one[k], split[k])
    assert bool(one["wide"].any()) and float(one["grid"].sum()) > 0
    if m // 4:  # the tail is pads: bounds report block 0, unmasked
        assert bids2[-1] == -1 and torch.equal(one["bounds"][-1], tpk.probe_bounds(
            probe_cols[:2], np.zeros(1, np.int32), p2_boxes)[0])


@pytest.mark.parametrize("m", [3, 257])
@pytest.mark.parametrize("case", ["pads", "inverted", "nan", "inf", "one_plane", "all8",
                                  "no_box", "no_window"])
def test_probe_kernels_on_staging_cases(probe_cols, case, m):
    """Every probe kernel equals its plain version (all 8 slots) where the
    launch loops over the live slots only: live slots between pads,
    inverted, NaN and infinite slots, one plane live, all 8 live, and a leg
    with no live slot (a zero plane; count 0 with +-inf extrema; an empty
    grid)."""
    from geomesa_tpu_torch.scripts import probe_pallas as pp

    boxes, wins = pp.staging_cases()[case]
    out = _probe_kernels_equal_plain(probe_cols, _probe_p1_bids(m), _probe_p2_bids(m), boxes,
                                     wins, boxes)
    if case in ("no_box", "no_window"):
        assert not out["wide"].any() and not out["inner"].any()
    if case == "no_box":
        b = out["bounds"]
        assert float(b[:, 0].sum()) == 0 and float(out["grid"].sum()) == 0
        assert bool((b[:, [1, 3]] == float("inf")).all() and (b[:, [2, 4]] == -float("inf")).all())


# -- the mutation surface and the incremental fold on the card -------------

T0_MS = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY_MS = 86_400_000


def _mutation_rows(seed, n, id0, t_lo=0, t_hi=28):
    rng = np.random.default_rng(seed)
    return (np.arange(id0, id0 + n), rng.uniform(-180, 180, n), rng.uniform(-85, 85, n),
            T0_MS + rng.integers(t_lo * DAY_MS, t_hi * DAY_MS, n))


def _mutation_fc(sft, rows):
    from geomesa_tpu_torch import FeatureCollection

    ids, x, y, t = rows
    return FeatureCollection.from_columns(sft, ids, {"dtg": t, "geom": (x, y)})


def _mutation_tables(device, rows_old, rows_new, keep):
    """Per index: (old table on ``device``, merged keys, the batch's keys)
    over the same seeded rows."""
    from geomesa_tpu_torch import FeatureType
    from geomesa_tpu_torch.index import Z2Index, Z3Index
    from geomesa_tpu_torch.storage.delta import concat_keys
    from geomesa_tpu_torch.storage.table import IndexTable
    from geomesa_tpu_torch.index.api import WriteKeys

    sft = FeatureType.from_spec("t", "dtg:Date,*geom:Point:srid=4326")
    out = {}
    for idx in (Z3Index(sft), Z2Index(sft)):
        ok = idx.write_keys(_mutation_fc(sft, rows_old))
        dk = idx.write_keys(_mutation_fc(sft, rows_new))
        old = IndexTable(idx, ok, tile=4096, device=device)
        if keep is not None:
            ok = WriteKeys(bins=ok.bins[keep], zs=ok.zs[keep],
                           device_cols={k: v[keep] for k, v in ok.device_cols.items()})
        out[idx.name] = (old, concat_keys([ok, dk]), dk)
    return out


@pytest.fixture
def fold_knob():
    from geomesa_tpu_torch import conf

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield conf.STREAM_FOLD_DEVICE
    conf.STREAM_FOLD_DEVICE.clear()


def test_fold_cols_device_equals_the_host_fold(fold_knob):
    """folded_table on a CUDA table: the device fold plan (the default
    'auto' there) gives the host path's columns bit for bit and uploads
    only the batch's rows."""
    from geomesa_tpu_torch.storage.table import folded_table

    rows_old = _mutation_rows(1, 60_000, 0)
    rows_new = _mutation_rows(2, 7_000, 60_000, t_lo=20)
    keep = np.ones(60_000, bool)
    keep[np.random.default_rng(3).choice(60_000, 5_000, replace=False)] = False
    ordinal_map = np.cumsum(keep, dtype=np.int64) - 1
    for name, (old, merged, dk) in _mutation_tables("cuda", rows_old, rows_new, keep).items():
        dev = folded_table(old, merged, keep, ordinal_map, dk, tile=4096)
        fold_knob.set("off")
        host = folded_table(old, merged, keep, ordinal_map, dk, tile=4096)
        fold_knob.clear()
        assert dev.rows_uploaded == 7_000 and host.rows_uploaded == host.n_pad
        assert np.array_equal(dev.perm, host.perm)
        for k in host.cols3:
            assert dev.cols3[k].is_cuda and torch.equal(dev.cols3[k], host.cols3[k]), (name, k)


def test_merged_table_keeps_the_prefix_and_uploads_the_suffix():
    """merged_table on a CUDA table: blocks before the first insertion
    keep the old table's values, only the suffix uploads, and the whole
    equals a full build."""
    from geomesa_tpu_torch.storage.table import IndexTable, merged_table

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows_old = _mutation_rows(4, 60_000, 0)
    rows_new = _mutation_rows(5, 5_000, 60_000, t_lo=26)  # the last two days
    tables = _mutation_tables("cuda", rows_old, rows_new, None)
    old, merged, dk = tables["z3"]
    table = merged_table(old, merged, dk, tile=4096)
    first = (table.n_pad - table.rows_uploaded) // table.block
    assert 0 < first < table.n_blocks
    full = IndexTable(old.keyspace, merged, tile=4096, device="cuda")
    for k in table.cols3:
        assert torch.equal(table.cols3[k][:first], old.cols3[k][:first])
        assert torch.equal(table.cols3[k], full.cols3[k])


def test_mutated_store_queries_equal_a_cpu_store():
    """The same write, fold (monolithic and sliced), upsert, modify,
    delete and age-off sequence on a CUDA store and a CPU store: the same
    rows, the same table columns and the same query ids in order."""
    from geomesa_tpu_torch import DataStore, FeatureType

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    queries = [
        "bbox(geom, -40, -30, 30, 40) AND dtg DURING 2024-01-03T00:00:00Z/2024-01-10T00:00:00Z",
        "bbox(geom, 60, -45, 120, 10)",
        "IN ('5', '17', '40', '2000', '65001')",
    ]
    stores = []
    for device in ("cuda", "cpu"):
        sft = FeatureType.from_spec("t", "dtg:Date,*geom:Point:srid=4326")
        ds = DataStore(device=device, tile=4096)
        ds.create_schema(sft)
        ds.write("t", _mutation_fc(sft, _mutation_rows(6, 60_000, 0)))
        ids, x, y, t = _mutation_rows(7, 8_000, 0, t_lo=20)
        ids = np.concatenate([np.arange(0, 60_000, 10)[:4_000], 65_000 + np.arange(4_000)])
        ds.fold_upsert("t", _mutation_fc(sft, (ids, x, y, t)), slice_rows=0)
        ds.fold_upsert("t", _mutation_fc(sft, (ids + 1, x, y, t)), slice_rows=1_500)
        ds.upsert("t", _mutation_fc(sft, _mutation_rows(8, 500, 100)))
        ds.modify_features("t", {"dtg": T0_MS + 2 * DAY_MS}, "bbox(geom, 0, 0, 40, 40)")
        ds.delete_features("t", "bbox(geom, -100, -40, -60, 0)")
        ds.age_off("t", ttl_ms=25 * DAY_MS, now_ms=T0_MS + 28 * DAY_MS)
        stores.append(ds)
    gpu, cpu = stores
    assert np.array_equal(gpu.features("t").ids, cpu.features("t").ids)
    for iname in ("z3", "z2"):
        a, b = gpu.table("t", iname), cpu.table("t", iname)
        assert np.array_equal(a.perm, b.perm)
        for k in a.cols3:
            assert torch.equal(a.cols3[k].cpu(), b.cols3[k])
    for q in queries:
        got = np.asarray(gpu.query("t", q).ids)
        assert len(got) and np.array_equal(got, np.asarray(cpu.query("t", q).ids)), q
    assert gpu.warmup("t") == cpu.warmup("t") > 0


def test_native_helpers_load_on_the_card_host_and_plan_z3():
    """On the card's host the port's g++ library builds and loads, and a
    Z3 store's plan decomposes its ranges natively; the query ids equal a
    CPU store's (both native)."""
    from geomesa_tpu_torch import DataStore, FeatureType, native

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    native.library()
    assert native.loaded()
    q = "bbox(geom, -40, -30, 30, 40) AND dtg DURING 2024-01-03T00:00:00Z/2024-01-10T00:00:00Z"
    got = []
    for device in ("cuda", "cpu"):
        sft = FeatureType.from_spec("t", "dtg:Date,*geom:Point:srid=4326")
        ds = DataStore(device=device, tile=4096)
        ds.create_schema(sft)
        ds.write("t", _mutation_fc(sft, _mutation_rows(9, 50_000, 0)))
        before = native.calls["zranges"]
        plan = ds.planner.plan("t", q)
        assert plan.index == "z3" and native.calls["zranges"] > before
        got.append(np.asarray(ds.query("t", q).ids))
    assert len(got[0]) and np.array_equal(got[0], got[1])


def _hint_store(device, n=60_000):
    """A GDELT-shaped point store (a string attribute, ids 0..n-1) on
    ``device``, from a fixed seed."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    rng = np.random.default_rng(31)
    sft = FeatureType.from_spec("t", "code:String,dtg:Date,*geom:Point:srid=4326")
    ds = DataStore(device=device, tile=4096)
    ds.create_schema(sft)
    t0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
    cols = {"geom": (rng.uniform(-60, 60, n), rng.uniform(-40, 40, n)),
            "dtg": t0 + rng.integers(0, 20 * 86_400_000, n),
            "code": np.array(["01", "04", "14", "19"])[rng.integers(0, 4, n)]}
    ds.write("t", FeatureCollection.from_columns(sft, np.arange(n), cols))
    return ds


HINT_QUERIES = [
    "bbox(geom, -30, -25, 10, 15) AND dtg DURING 2024-01-03T00:00:00Z/2024-01-13T00:00:00Z",
    "INTERSECTS(geom, POLYGON ((0 -10, 30 -10, 25 20, 5 15, 0 -10)))",
    "IN ('7', '70') OR (bbox(geom, -5, -5, 5, 5) AND dtg DURING "
    "2024-01-02T00:00:00Z/2024-01-05T00:00:00Z)",
]


def test_query_controls_on_the_card_equal_the_cpu_store():
    """Hints, ``query_many`` hints, timeouts and tracing on a CUDA store
    give the CPU store's results (the kernels are exact, so the ids, the
    loose wide plane and every column agree)."""
    from geomesa_tpu_torch import conf
    from geomesa_tpu_torch.obs import trace as otrace
    from geomesa_tpu_torch.planning.errors import QueryTimeout
    from geomesa_tpu_torch.planning.hints import QueryHints

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gpu, cpu = _hint_store("cuda"), _hint_store("cpu")
    kinds = [{}, {"sort_by": "-dtg", "offset": 5}, {"sample": 0.2, "sample_by": "code"},
             {"loose": True}, {"transforms": ["code", "lon=st_x(geom)"]},
             {"reproject": "EPSG:3857"}]
    for q in HINT_QUERIES:
        for kw in kinds:
            a = gpu.query("t", q, limit=50 if "offset" in kw else None, hints=QueryHints(**kw))
            b = cpu.query("t", q, limit=50 if "offset" in kw else None, hints=QueryHints(**kw))
            assert np.array_equal(np.asarray(a.ids), np.asarray(b.ids)), (q, kw)
            for name in a.columns:
                ca, cb = a.columns[name], b.columns[name]
                if hasattr(ca, "x"):
                    assert np.array_equal(ca.x, cb.x) and np.array_equal(ca.y, cb.y), (q, kw)
                else:
                    assert np.array_equal(np.asarray(ca), np.asarray(cb)), (q, kw)
    hs = [QueryHints(sort_by="dtg"), QueryHints(loose=True), QueryHints(sample=0.5)]
    for a, b in zip(gpu.query_many("t", HINT_QUERIES, hints=hs),
                    cpu.query_many("t", HINT_QUERIES, hints=hs)):
        assert np.array_equal(np.asarray(a.ids), np.asarray(b.ids))
    with pytest.raises(QueryTimeout):
        gpu.query("t", HINT_QUERIES[0], hints=QueryHints(timeout=1e-6))
    with pytest.raises(QueryTimeout):
        gpu.query_many("t", HINT_QUERIES, hints=QueryHints(timeout=1e-6))
    # a timed-out query leaves nothing behind: the next one is exact
    assert np.array_equal(np.asarray(gpu.query("t", HINT_QUERIES[0]).ids),
                          np.asarray(cpu.query("t", HINT_QUERIES[0]).ids))
    conf.OBS_TRACE_SAMPLE.set(1)
    old = otrace.tracer()
    tr = otrace.install(otrace.Tracer())
    try:
        gpu.query("t", HINT_QUERIES[0])
        names = [s["name"] for s in tr.traces()[0].to_dict()["spans"]]
    finally:
        conf.OBS_TRACE_SAMPLE.clear()
        otrace.install(old)
    assert {"query", "plan", "dispatch", "scan", "decode"} <= set(names)


def test_save_and_load_round_trip_on_the_card(tmp_path):
    """persist.save of a CUDA store and persist.load(device="cuda"): the
    loaded store builds every table on the card, and its queries launch
    K1 (its density K3, its bounds estimate K4) and answer with the saved
    store's ids in order; a CPU load of the same directory agrees."""
    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.storage import persist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src = _hint_store("cuda")
    persist.save(src, tmp_path / "s")
    back = persist.load(tmp_path / "s", device="cuda")
    cpu = persist.load(tmp_path / "s", device="cpu")
    assert back.store_health.status == "ok"
    assert all(t.device.type == "cuda" for t in back._tables.values())
    q = HINT_QUERIES[0]
    for k in kernels.KERNELS:
        k.reset_counts()
    ids = np.asarray(back.query("t", q).ids)
    grid = back.density("t", q, width=64, height=32)
    env = back.bounds("t", q)
    assert kernels.BLOCK_SCAN.launches > 0
    assert kernels.DENSITY.launches > 0 and kernels.BOUNDS.launches > 0
    src_ids = np.asarray(src.query("t", q).ids)
    # the load orders rows by partition: compare the rows, then the order
    # against the CPU load of the same directory
    assert len(ids) and sorted(ids.tolist()) == sorted(src_ids.tolist())
    assert np.array_equal(ids, np.asarray(cpu.query("t", q).ids))
    assert np.array_equal(grid, cpu.density("t", q, width=64, height=32))
    assert env == cpu.bounds("t", q)
    for hq in HINT_QUERIES[1:]:
        assert np.array_equal(np.asarray(back.query("t", hq).ids),
                              np.asarray(cpu.query("t", hq).ids)), hq


def _vis_store(device, auths, n=60_000, cache=None):
    """A GDELT-shaped point store with a ``vis`` label column (the
    chip_smoke secure path's mix) and ``code`` declared ``vis=secret``."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    rng = np.random.default_rng(41)
    sft = FeatureType.from_spec(
        "t", "code:String:vis=secret,vis:String,dtg:Date,*geom:Point:srid=4326")
    sft.user_data["geomesa.vis.field"] = "vis"
    ds = DataStore(device=device, tile=4096, auths=auths, cache=cache)
    ds.create_schema(sft)
    t0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
    labels = np.array(["", "analyst", "analyst&secret", "secret|ops", "ops"])
    cols = {"geom": (rng.uniform(-60, 60, n), rng.uniform(-40, 40, n)),
            "dtg": t0 + rng.integers(0, 20 * 86_400_000, n),
            "code": np.array(["01", "04", "14", "19"])[rng.integers(0, 4, n)],
            "vis": labels[rng.choice(5, n, p=[0.5, 0.2, 0.15, 0.1, 0.05])]}
    ds.write("t", FeatureCollection.from_columns(sft, np.arange(n), cols))
    return ds


def _aggregate(ds, q):
    return (ds.count("t", q), ds.stats_query("t", "Count()", q, estimate=True)[0].count,
            ds.density("t", q, width=64, height=32).tolist(), ds.bounds("t", q, estimate=True),
            ds.bounds("t", q, estimate=False), np.asarray(ds.query("t", q).ids).tolist())


def test_visibility_gates_launch_no_aggregation_kernel_on_the_card():
    """With visibility active the count estimate, density and bounds step
    aside: K1p, K3 and K4 launch 0 times while K1 scans the rows, and the
    answers equal a CPU store's; with auths None the same calls launch
    K1p, K3 and K4."""
    from geomesa_tpu_torch import kernels

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = HINT_QUERIES[0]
    for auths in (("analyst",), None):
        gpu, cpu = _vis_store("cuda", auths), _vis_store("cpu", auths)
        for k in kernels.KERNELS:
            k.reset_counts()
        got = _aggregate(gpu, q)
        aggs = [kernels.BLOCK_POPS.launches, kernels.DENSITY.launches, kernels.BOUNDS.launches]
        assert kernels.BLOCK_SCAN.launches > 0
        if auths is None:
            assert all(a > 0 for a in aggs), aggs
        else:
            assert aggs == [0, 0, 0]
        assert got == _aggregate(cpu, q)


def test_warm_cache_launches_no_scan_on_the_card():
    """A cached store on the card: the cold pass launches K1, the warm
    pass serves every query from the result cache (K1 launches 0) with
    identical ids, equal to a CPU store's."""
    from geomesa_tpu_torch import kernels

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gpu, cpu = _hint_store("cuda"), _hint_store("cpu")
    from geomesa_tpu_torch.cache import QueryCache

    gpu.attach_cache(QueryCache())
    for k in kernels.KERNELS:
        k.reset_counts()
    cold = [np.asarray(gpu.query("t", q).ids).tolist() for q in HINT_QUERIES]
    assert kernels.BLOCK_SCAN.launches > 0
    kernels.BLOCK_SCAN.reset_counts()
    warm = [np.asarray(gpu.query("t", q).ids).tolist() for q in HINT_QUERIES]
    assert kernels.BLOCK_SCAN.launches == 0 and warm == cold
    assert warm == [np.asarray(cpu.query("t", q).ids).tolist() for q in HINT_QUERIES]


def _analytics_store(device):
    """A cached 200k-point store with the Z2 index (the analytics path's
    shape, cut down) on ``device``."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch.cache import CacheConfig

    rng = np.random.default_rng(41)
    n = 200_000
    sft = FeatureType.from_spec("p", "*geom:Point:srid=4326")
    sft.user_data["geomesa.indices.enabled"] = "z2"
    ds = DataStore(device=device, cache=CacheConfig(max_bytes=1 << 26))
    ds.create_schema(sft)
    ds.write("p", FeatureCollection.from_columns(
        sft, np.arange(n), {"geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))}),
        check_ids=False)
    ds.compact("p")
    return ds


def _stars(n_poly=16, seed=3):
    from geomesa_tpu_torch import FeatureCollection, FeatureType, geometry

    rng = np.random.default_rng(seed)
    polys = []
    for k in range(n_poly):
        arms = int(rng.integers(8, 128))
        a = np.linspace(0, 2 * np.pi, 2 * arms + 1)[:-1]
        rad = np.where(np.arange(2 * arms) % 2 == 0, 1.0, rng.uniform(0.3, 0.7, 2 * arms))
        r, cx, cy = rng.uniform(2, 15), rng.uniform(-150, 150), rng.uniform(-60, 60)
        polys.append(geometry.Polygon([(cx + r * q * np.cos(t), cy + r * q * np.sin(t))
                                       for t, q in zip(a, rad)]))
    return FeatureCollection.from_columns(
        FeatureType.from_spec("adm", "*geom:Polygon:srid=4326"), np.arange(n_poly),
        {"geom": geometry.PackedGeometryColumn.from_geometries(polys)})


def test_analytics_on_the_card_equal_the_cpu_store():
    """kNN (one point through K1, a batch through K2's fused windows),
    the indexed join (K2, rasters off and on) and every tile of a small
    pyramid (K1 leaf scans) on the card: ids in order, pairs and grids
    equal to a CPU store's."""
    from geomesa_tpu_torch import conf, kernels
    from geomesa_tpu_torch.filter import raster
    from geomesa_tpu_torch.process import knn_many, knn_search
    from geomesa_tpu_torch.sql import spatial_join_indexed
    from geomesa_tpu_torch.tiles import TilePyramid, TilesConfig

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gpu, cpu = _analytics_store("cuda"), _analytics_store("cpu")
    pts = [(float(x), float(y)) for x, y in np.random.default_rng(8).uniform(-60, 60, (16, 2))]
    for k in kernels.KERNELS:
        k.reset_counts()
    one = [np.asarray(knn_search(gpu, "p", x, y, k=10).ids).tolist() for x, y in pts[:4]]
    assert kernels.BLOCK_SCAN.launches > 0
    many = [np.asarray(fc.ids).tolist() for fc in knn_many(gpu, "p", pts, k=10)]
    assert kernels.BLOCK_SCAN_MULTI.launches > 0
    assert one == many[:4]
    assert many == [np.asarray(fc.ids).tolist() for fc in knn_many(cpu, "p", pts, k=10)]
    left = _stars()
    try:
        for on in (False, True):
            conf.RASTER_ENABLED.set(on)
            raster.clear_cache()
            for ds in (gpu, cpu):
                ds.planner.invalidate_config_memo()
            kernels.BLOCK_SCAN_MULTI.reset_counts()
            got = [a.tolist() for a in spatial_join_indexed(gpu, "p", left, "contains")]
            assert kernels.BLOCK_SCAN_MULTI.launches > 0
            assert got == [a.tolist() for a in spatial_join_indexed(cpu, "p", left, "contains")]
    finally:
        conf.RASTER_ENABLED.clear()
        raster.clear_cache()
    cfg = TilesConfig(leaf_zoom=2, px=64)
    pg, pc = TilePyramid(gpu, cfg), TilePyramid(cpu, cfg)
    kernels.BLOCK_SCAN.reset_counts()
    for z in range(3):
        nx, ny = pg.lattice.n_tiles(z)
        for x in range(nx):
            for y in range(ny):
                g = pg.fetch("p", z, x, y).grid
                assert np.array_equal(g, pc.fetch("p", z, x, y).grid)
                assert np.array_equal(g, pg.fresh("p", z, x, y).grid)
    assert kernels.BLOCK_SCAN.launches > 0


def _s2_store(device, n=60_000):
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    sft = FeatureType.from_spec("s", "name:String,dtg:Date,*geom:Point:srid=4326")
    sft.user_data["geomesa.indices.enabled"] = "s3,s2"
    ds = DataStore(device=device)
    ds.create_schema(sft)
    rng = np.random.default_rng(31)
    t0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
    ds.write("s", FeatureCollection.from_columns(
        sft, [f"s{i}" for i in range(n)],
        {"name": np.array([f"n{i % 9}" for i in range(n)]),
         "dtg": t0 + rng.integers(0, 20 * 86_400_000, n),
         "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))}))
    return ds


def test_s2_and_s3_stores_on_the_card_equal_the_cpu_store():
    """S3 (bbox + during) and S2 (bbox) plans on the card: ids in order and
    under ``limit`` equal to a CPU store's, through K1; density and bounds
    through K3 and K4; keys on every face (bit 63 set on faces 4 and 5)."""
    from geomesa_tpu_torch import kernels

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gpu, cpu = _s2_store("cuda"), _s2_store("cpu")
    zs = gpu.table("s", "s2").zs
    assert zs.dtype == np.uint64 and ((zs >> np.uint64(63)) == 1).any()
    queries = [
        "bbox(geom, -30, 20, 40, 60) AND dtg DURING 2024-01-03T00:00:00Z/2024-01-12T00:00:00Z",
        "bbox(geom, 120, -90, 180, -30) AND dtg DURING 2024-01-01T00:00:00Z/2024-01-05T00:00:00Z",
        "bbox(geom, -30, 20, 40, 60)", "bbox(geom, -180, -90, 180, -40)",
    ]
    for k in kernels.KERNELS:
        k.reset_counts()
    for q in queries:
        assert gpu.explain("s", q).splitlines()[-1] == cpu.explain("s", q).splitlines()[-1]
        assert gpu.query("s", q).ids.tolist() == cpu.query("s", q).ids.tolist(), q
        assert gpu.query("s", q, limit=9).ids.tolist() == cpu.query("s", q, limit=9).ids.tolist()
        g = gpu.density("s", q, envelope=(-180, -90, 180, 90), width=64, height=32)
        c = cpu.density("s", q, envelope=(-180, -90, 180, 90), width=64, height=32)
        assert np.array_equal(np.asarray(g), np.asarray(c))
        assert gpu.bounds("s", q) == cpu.bounds("s", q)
    assert kernels.BLOCK_SCAN.launches > 0
    assert kernels.DENSITY.launches > 0 and kernels.BOUNDS.launches > 0


def test_data_plane_on_the_card_equals_a_cpu_server():
    """One store on the card and one on the CPU behind ``serve(port=0)``:
    GeoJSON bodies byte for byte, rows headers and statuses equal, and
    the card's queries go through K1 or K2; an ingest acks on both."""
    from urllib.parse import quote

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.serving import DataClient

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gpu, cpu = _s2_store("cuda", n=40_000), _s2_store("cpu", n=40_000)
    try:
        gc, cc = DataClient(gpu.serve(port=0).url), DataClient(cpu.serve(port=0).url)
        for k in kernels.KERNELS:
            k.reset_counts()
        for q, limit in (("bbox(geom, -30, 20, 40, 60)", None), ("bbox(geom, 0, 0, 90, 45)", 100),
                         ("name = 'n3' AND bbox(geom, -90, -45, 90, 45)", 50),
                         ("bbox(geom, 170, 80, 171, 81)", None)):
            path = f"/query/s?cql={quote(q)}" + (f"&limit={limit}" if limit else "")
            (gs, gh, gb), (cs, ch, cb) = gc.request("GET", path), cc.request("GET", path)
            assert (gs, gh.get("X-Geomesa-Rows"), gb) == (cs, ch.get("X-Geomesa-Rows"), cb), q
        assert kernels.BLOCK_SCAN.launches + kernels.BLOCK_SCAN_MULTI.launches > 0
        feat = {"type": "FeatureCollection", "features": [
            {"type": "Feature", "id": "new-1", "geometry": {"type": "Point", "coordinates": [1, 2]},
             "properties": {"name": "zz", "dtg": 1704067200000}}]}
        assert gc.ingest("s", feat) == cc.ingest("s", feat) == {
            "acked": 1, "durable": False, "type": "s"}
        assert gc.query("s", cql="name = 'zz'") == cc.query("s", cql="name = 'zz'")
        for path in ("/query/nope", "/tiles/s/density/0/0/0", "/tenants"):
            assert gc.request("GET", path)[0] == cc.request("GET", path)[0]
    finally:
        gpu.close()
        cpu.close()


def _mesh_store(device, mesh=None, n=200_000):
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    sft = FeatureType.from_spec("m", "dtg:Date,*geom:Point:srid=4326")
    ds = DataStore(device=device, mesh=mesh)
    ds.create_schema(sft)
    rng = np.random.default_rng(37)
    t0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
    ds.write("m", FeatureCollection.from_columns(
        sft, np.arange(n), {"dtg": t0 + rng.integers(0, 20 * 86_400_000, n),
                            "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))}))
    return ds


def test_virtual_cuda_mesh_planes_and_answers_equal_the_one_device_store():
    """A virtual mesh of 4 shards on cuda:0: each shard's K1 planes over
    its local blocks equal the one-device table's planes over the same
    global blocks (j * 4 + d), word for word; ids, counts, count
    estimates, grids, bounds and a fused batch equal the one-device
    store's, and K1, K2, K1p, K3 and K4 launch on the shards."""
    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    D = 4
    one = _mesh_store("cuda")
    mesh = _mesh_store("cuda", make_mesh(devices=["cuda:0"] * D))
    q = "bbox(geom, -60, -30, 40, 50) AND dtg DURING 2024-01-03T00:00:00Z/2024-01-12T00:00:00Z"
    plan = one.planner.plan("m", q)
    t1, tm = one.table("m", plan.index), mesh.table("m", plan.index)
    boxes, wins = t1._params(plan.config)
    names = t1._scan_cols(plan.config)
    kw = t1._scan_kernel_kwargs(plan.config, names)
    for d in range(D):
        local = np.arange(tm.blocks_local, dtype=np.int64)
        glob = local * D + d
        keep = glob < t1.n_blocks
        lb, _ = tbk.pad_bids(local[keep], tm.blocks_local)
        gb, _ = tbk.pad_bids(glob[keep], t1.n_blocks)
        a = tbk.scan_planes(tm._shard_cols(d, names), lb, boxes, wins, **kw)
        b = tbk.scan_planes(t1._cols_args(names), gb, boxes, wins, **kw)
        n_real = int(keep.sum())
        assert torch.equal(a[:, :n_real], b[:, :n_real]), d
    queries = [q, "bbox(geom, 100, -80, 170, -10)", "bbox(geom, -10, -10, 10, 10)"]
    batch = [f"bbox(geom, {x:.2f}, {y:.2f}, {x + 12:.2f}, {y + 9:.2f})"
             for x, y in zip(np.linspace(-170, 150, 24), np.linspace(-80, 70, 24))]

    def answers(ds):
        out = []
        for qq in queries:
            out += [ds.query("m", qq).ids.tolist(), ds.count("m", qq),
                    ds.stats_query("m", "Count()", qq, estimate=True)[0].count,
                    ds.density("m", qq, envelope=(-180, -90, 180, 90), width=64,
                               height=32).tolist(),
                    ds.bounds("m", qq, estimate=True)]
        return out + [[r.ids.tolist() for r in ds.query_many("m", batch)]]

    for k in kernels.KERNELS:
        k.reset_counts()
    got = answers(mesh)
    launched = {k.name: k.launches for k in kernels.KERNELS}
    assert got == answers(one)
    assert all(launched.values()), launched
