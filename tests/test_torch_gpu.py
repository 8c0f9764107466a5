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


@pytest.mark.parametrize("grid", [(256, 256), (128, 384)])
@pytest.mark.parametrize("variant", ["reshape", "fori"])
@pytest.mark.parametrize("m", [8, 32])
def test_probe_density_kernel_equals_plain(probe_cols, m, variant, grid):
    """P2 density on the tensor cores, both chunk variants: rows on x1 / y1
    clip to the last pixel, pad slots count nothing; and K3's grid is the
    same."""
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
