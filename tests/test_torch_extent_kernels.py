"""The extent legs of the port's kernel modules against the JAX package,
on the CPU, and the XZ curves against the JAX package's numpy paths.

An extent (XZ) table holds four f32 bbox columns (gxmin, gymin, gxmax,
gymax), plus tbin and toff on XZ3. Each plain PyTorch version of the scan
(K1), the fused scan (K2), the popcount (K1p), the density (K3) and the
bounds (K4) is held against the JAX function it replaces, run both
through Pallas interpret mode and through the XLA version, on the same
numpy inputs made from a seed: box only, box + window, window only and
no predicate. The reference's XZ3 keeps tbin/toff (no packed time), so
there is no packed-time case. Tolerance everywhere is exact equality.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from geomesa_tpu.curve import xz2sfc as jxz2
from geomesa_tpu.curve import xz3sfc as jxz3
from geomesa_tpu.scan import aggregations as jagg
from geomesa_tpu.scan import block_kernels as jbk
from geomesa_tpu_torch.curve import xz2sfc as txz2
from geomesa_tpu_torch.curve import xz3sfc as txz3
from geomesa_tpu_torch.curve import xzsfc as txz
from geomesa_tpu_torch.scan import aggregations as tagg
from geomesa_tpu_torch.scan import block_kernels as tbk
from geomesa_tpu_torch import native as tnative

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

SUB = 32  # 4096-row blocks
NB = 8
N = NB * SUB * tbk.LANES
SHAPE = (NB, SUB, tbk.LANES)
EXT = ("gxmax", "gxmin", "gymax", "gymin")  # sorted, as a table projects them


@pytest.fixture(scope="module")
def columns():
    """numpy [NB, SUB, 128] extent columns, pad rows at the tail like a
    real table (gxmin = gymin = +inf, gxmax = gymax = -inf, tbin = -1):
    boxes from a point up to a few degrees wide, and boxes whose stored
    extent touches the first query box's edge exactly (the closed
    compares decide them)."""
    rng = np.random.default_rng(29)
    x0 = rng.uniform(-50, 50, N)
    y0 = rng.uniform(-50, 50, N)
    w = np.where(rng.random(N) < 0.1, 0.0, rng.exponential(1.5, N))
    h = np.where(rng.random(N) < 0.1, 0.0, rng.exponential(1.5, N))
    gx0 = np.nextafter(x0.astype(np.float32), -np.inf)
    gy0 = np.nextafter(y0.astype(np.float32), -np.inf)
    gx1 = np.nextafter((x0 + w).astype(np.float32), np.inf)
    gy1 = np.nextafter((y0 + h).astype(np.float32), np.inf)
    # stored extents touching an edge of BOXES[0] = (-20, -15, 25, 30)
    # from outside, 64 rows per edge: (gxmin, gymin, gxmax, gymax)
    for k, ext in enumerate(((25, 0, 26, 1), (-21, 0, -20, 1), (0, 30, 1, 31), (0, -16, 1, -15))):
        for col, v in zip((gx0, gy0, gx1, gy1), ext):
            col[64 * k:64 * (k + 1)] = v
    tb = rng.integers(100, 104, N).astype(np.int32)
    to = rng.integers(0, 604_800, N).astype(np.int32)
    gx0[-700:] = gy0[-700:] = np.inf
    gx1[-700:] = gy1[-700:] = -np.inf
    tb[-700:] = -1
    to[-700:] = 0
    cols = {"gxmin": gx0, "gymin": gy0, "gxmax": gx1, "gymax": gy1, "tbin": tb, "toff": to}
    return {k: v.reshape(SHAPE) for k, v in cols.items()}


BOXES = tbk.pack_boxes(
    np.array([[-20.0, -15.0, 25.0, 30.0], [30.0, -45.0, 49.5, -20.0]], np.float32), None
)
WINS = tbk.pack_windows(
    np.array([[100, 100, 200_000, 604_799], [101, 102, 0, 604_799], [103, 103, 0, 300_000]]),
    np.array([[101, 102, 1, 604_798]]),
)

# (case, projected columns, has_boxes, has_windows): an XZ2 box scan, an
# XZ3 box + window scan, an XZ3 DURING-only scan (the window leg alone
# decides; both planes) and the validity leg on gxmin
CASES = [
    ("box", EXT, True, False),
    ("box+window", tuple(sorted(EXT + ("tbin", "toff"))), True, True),
    ("window", ("tbin", "toff"), False, True),
    ("valid:gxmin", ("gxmin",), False, False),
]
IDS = [c[0] for c in CASES]


def _agg_names(names):
    return tuple(sorted(set(names) | set(EXT)))  # aggregations read the extents


def _jax_cols(columns, names):
    return tuple(jnp.asarray(columns[k]) for k in names)


def _torch_cols(columns, names):
    return tuple(torch.from_numpy(columns[k]) for k in names)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_extent_block_scan_plain_equals_pallas_and_xla(columns, case):
    _, names, has_boxes, has_windows = case
    bids, _ = tbk.pad_bids(np.array([5, 0, 2, 7, 3]), NB)
    kw = dict(col_names=names, has_boxes=has_boxes, has_windows=has_windows, extent=True)
    jc = _jax_cols(columns, names)
    pw, pi = jbk._pallas_block_scan(jc, bids, BOXES, WINS, interpret=True, **kw)
    xw, xi = jbk._xla_block_scan(jc, bids, BOXES, WINS, **kw)
    tw, ti = tbk.block_scan(_torch_cols(columns, names), bids, BOXES, WINS, **kw)
    assert tw.dtype == torch.int32 and tw.shape == (len(bids), SUB // 32, tbk.LANES)
    # an extent box scan has one plane; the others both
    one_plane = tbk.skip_inner_plane(has_boxes, True)
    assert one_plane == jbk.skip_inner_plane(has_boxes, True) == has_boxes
    for ref_w, ref_i in ((pw, pi), (xw, xi)):
        assert np.array_equal(tw.numpy(), np.asarray(ref_w))
        if one_plane:
            assert ti is None and ref_i is None
        else:
            assert np.array_equal(ti.numpy(), np.asarray(ref_i))
    assert tw.numpy().any()  # the predicates do select rows
    planes = tbk.scan_planes(_torch_cols(columns, names), bids, BOXES, WINS, **kw)
    assert planes.shape[0] == (1 if one_plane else 2)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_extent_block_pops_plain_equals_pallas_and_xla(columns, case):
    _, names, has_boxes, has_windows = case
    bids, n_real = tbk.pad_bids(np.array([6, 1, 4, 7, 0]), NB, pad=-1)
    kw = dict(col_names=names, has_boxes=has_boxes, has_windows=has_windows, extent=True)
    jc = _jax_cols(columns, names)
    pal = np.asarray(jagg._pops_pallas(jc, bids, BOXES, WINS, interpret=True, **kw))
    xla = np.asarray(jagg._pops_xla(jc, bids, BOXES, WINS, **kw))
    got = tagg.block_pops(_torch_cols(columns, names), bids, BOXES, WINS, **kw)
    assert got.dtype == torch.int32 and got.shape == (len(bids),)
    assert np.array_equal(got.numpy(), pal) and np.array_equal(got.numpy(), xla)
    assert got.numpy()[:n_real].sum() > 0


GRIDS = [(96, 48), (33, 17)]  # lane-aligned width, and a ragged grid


@pytest.mark.parametrize("width,height", GRIDS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_extent_density_plain_equals_pallas_and_xla(columns, case, width, height):
    _, names, has_boxes, has_windows = case
    names = _agg_names(names)
    bids, _ = tbk.pad_bids(np.array([0, 2, 3, 5, 7]), NB, pad=-1)
    gb = np.array([-30, -30, 40, 40], np.float32)
    kw = dict(col_names=names, has_boxes=has_boxes, has_windows=has_windows,
              extent=True, width=width, height=height)
    jc = _jax_cols(columns, names)
    pal = np.asarray(jagg._pallas_density(jc, bids, BOXES, WINS, gb,
                                          interpret=True, chunk=SUB, **kw))
    xla = np.asarray(jagg._xla_density(jc, bids, BOXES, WINS, gb, **kw))
    got = tagg.block_density(_torch_cols(columns, names), bids, BOXES, WINS, gb, **kw)
    assert got.dtype == torch.float32 and got.shape == (height, width)
    assert np.array_equal(got.numpy(), pal)
    assert np.array_equal(got.numpy(), xla)
    assert got.numpy().sum() > 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_extent_bounds_plain_equals_pallas_and_xla(columns, case):
    _, names, has_boxes, has_windows = case
    names = _agg_names(names)
    bids, n_real = tbk.pad_bids(np.array([1, 4, 6, 7]), NB, pad=-1)
    kw = dict(col_names=names, has_boxes=has_boxes, has_windows=has_windows, extent=True)
    jc = _jax_cols(columns, names)
    pal = np.asarray(jagg._pallas_bounds(jc, bids, BOXES, WINS, interpret=True, **kw))
    xla = np.asarray(jagg._xla_bounds(jc, bids, BOXES, WINS, **kw))
    got = tagg.block_bounds(_torch_cols(columns, names), bids, BOXES, WINS, **kw).numpy()
    assert got.shape == (len(bids), tagg.STAT_LANES)
    assert np.array_equal(got[:n_real], pal[:n_real])
    assert np.array_equal(got[:n_real], xla[:n_real])
    assert np.isfinite(got[:n_real, 1:5]).all()  # no pad row's NaN centre leaks in
    assert tagg.reduce_bounds(got, n_real) == jagg.reduce_bounds(xla, n_real)


def test_extent_rep_xy_is_the_f32_bbox_centre(columns):
    """The representative point adds then halves in f32, as the JAX
    package's _rep_xy; a pad row's centre is NaN."""
    g = {k: torch.from_numpy(v) for k, v in columns.items()}
    x, y = tagg._rep_xy(g, True)
    jx, jy = jagg._rep_xy({k: jnp.asarray(v) for k, v in columns.items()}, True)
    assert x.dtype == torch.float32
    assert np.array_equal(x.numpy(), np.asarray(jx), equal_nan=True)
    assert np.array_equal(y.numpy(), np.asarray(jy), equal_nan=True)
    assert np.isnan(x.numpy().reshape(-1)[-1])


# ------------------------------------------------ fused multi-query scan


def _query_stack(n_q=5, seed=31):
    """[Q, 8, 128] box and window stacks of n_q extent queries (Q =
    bucket_q), each with its own number of box and window slots (1..8)."""
    rng = np.random.default_rng(seed)
    q_pad = tbk.bucket_q(n_q)
    boxes = np.zeros((q_pad, 8, tbk.LANES), np.float32)
    wins = np.zeros((q_pad, 8, tbk.LANES), np.int32)
    for q in range(n_q):
        nb, nw = 1 + (q * 3) % 8, 1 + (q * 5 + 2) % 8
        lo = rng.uniform(-50, 30, (nb, 2)).astype(np.float32)
        wide = np.concatenate([lo, lo + rng.uniform(2, 15, (nb, 2)).astype(np.float32)], axis=1)
        boxes[q] = tbk.pack_boxes(wide, None)
        bins = rng.integers(100, 104, nw)
        offs = np.sort(rng.integers(0, 604_799, (nw, 2)), axis=1)
        ws = np.stack([bins, bins, offs[:, 0], offs[:, 1]], axis=1)
        wins[q] = tbk.pack_windows(ws, ws[:1] + np.array([0, 0, 1, -1]))
    return boxes, wins


def _multi_ids():
    """Interleaved qids over real slots, then pad slots (bid 0, qid 0)."""
    blocks = np.array([5, 0, 2, 7, 3, 3, 6, 1, 4, 7, 0, 2, 5])
    qids = np.array([0, 3, 1, 4, 2, 0, 3, 1, 2, 4, 4, 0, 1], np.int32)
    bids, n_real = tbk.pad_bids(blocks, NB, bucket=16)
    q = np.zeros(len(bids), np.int32)
    q[:n_real] = qids
    return bids, q


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_extent_block_scan_multi_plain_equals_pallas_and_xla(columns, case):
    _, names, has_boxes, has_windows = case
    boxes, wins = _query_stack()
    bids, qids = _multi_ids()
    kw = dict(col_names=names, has_boxes=has_boxes, has_windows=has_windows, extent=True)
    jc = _jax_cols(columns, names)
    pw, pi = jbk._pallas_block_scan_multi(jc, bids, qids, boxes, wins, interpret=True, **kw)
    xw, xi = jbk._xla_block_scan_multi(jc, bids, qids, boxes, wins, **kw)
    tw, ti = tbk.block_scan_multi(_torch_cols(columns, names), bids, qids, boxes, wins, **kw)
    assert tw.dtype == torch.int32 and tw.shape == (len(bids), SUB // 32, tbk.LANES)
    for ref_w, ref_i in ((pw, pi), (xw, xi)):
        assert np.array_equal(tw.numpy(), np.asarray(ref_w))
        if has_boxes:
            assert ti is None and ref_i is None
        else:
            assert np.array_equal(ti.numpy(), np.asarray(ref_i))
    assert tw.numpy().any()
    # each slot equals the single-query scan of its own query
    for q in np.unique(qids):
        sel = qids == q
        sw, si = tbk.block_scan(_torch_cols(columns, names), bids[sel], boxes[q], wins[q], **kw)
        assert torch.equal(tw[torch.from_numpy(sel)], sw)
        assert (si is None) == (ti is None)
        if si is not None:
            assert torch.equal(ti[torch.from_numpy(sel)], si)


def test_extent_scan_refuses_the_polygon_legs(columns):
    """The polygon legs read points: an extent scan takes the box leg."""
    bids, _ = tbk.pad_bids(np.array([0, 1]), NB)
    with pytest.raises(ValueError, match="extent tables take the box leg"):
        tbk.block_scan(_torch_cols(columns, EXT), bids, BOXES, WINS, col_names=EXT,
                       has_boxes=True, has_windows=False, extent=True,
                       edges=np.zeros((8, 128), np.float32), n_edges=8)


def test_decode_one_plane_equals_jax(columns, monkeypatch):
    """decode_bits_pair with no inner plane: every row uncertain, the
    rows those of the JAX package's numpy decode."""
    from geomesa_tpu import native

    monkeypatch.setattr(native, "_lib", False)  # the numpy decode path
    with tnative.disabled():
        for blocks in (np.array([0, 2, 3, 5, 7]), np.array([5, 0, 2, 7, 3])):
            bids, n_real = tbk.pad_bids(blocks, NB)
            w, i = tbk.block_scan(_torch_cols(columns, EXT), bids, BOXES, WINS, col_names=EXT,
                                  has_boxes=True, has_windows=False, extent=True)
            assert i is None
            rows, cert = tbk.decode_bits_pair(w.numpy(), None, bids, n_real)
            jrows, jcert = jbk.decode_bits_pair(w.numpy(), None, bids, n_real)
            assert np.array_equal(rows, jrows) and np.array_equal(cert, jcert)
            assert len(rows) and not cert.any()


# ----------------------------------------------------------------- curves


def _boxes(rng, n, span=180.0):
    x0 = rng.uniform(-span, span - 5, n)
    y0 = rng.uniform(-85, 80, n)
    w = np.where(rng.random(n) < 0.3, rng.uniform(0, 1e-3, n), rng.exponential(2.0, n))
    h = rng.exponential(1.0, n)
    return x0, y0, np.minimum(x0 + w, 180.0), np.minimum(y0 + h, 90.0)


@pytest.mark.parametrize("g", [12, 6])
def test_xz2_index_and_ranges_equal_jax_numpy(g, monkeypatch):
    from geomesa_tpu import native

    monkeypatch.setattr(native, "_lib", False)
    with tnative.disabled():
        # several index chunks, one of them ragged
        monkeypatch.setattr(txz, "INDEX_CHUNK", 1000)
        rng = np.random.default_rng(g)
        x0, y0, x1, y1 = _boxes(rng, 3500)
        t, j = txz2.XZ2SFC.for_precision(g), jxz2.XZ2SFC.for_precision(g)
        got = t.index(x0, y0, x1, y1)
        assert got.dtype == np.int64 and np.array_equal(got, j.index(x0, y0, x1, y1))
        for bounds in ([(-30.0, -25.0, 10.0, -5.0)], [(0.5, 0.5, 2.5, 1.0), (100, -10, 120, 5)]):
            for max_ranges in (None, 64):
                tr, jr = t.ranges(bounds, max_ranges), j.ranges(bounds, max_ranges)
                assert [(r.lower, r.upper, r.contained) for r in tr] == \
                    [(r.lower, r.upper, r.contained) for r in jr]
                assert tr


@pytest.mark.parametrize("period", ["week", "day"])
def test_xz3_index_and_ranges_equal_jax_numpy(period, monkeypatch):
    from geomesa_tpu import native

    monkeypatch.setattr(native, "_lib", False)
    with tnative.disabled():
        monkeypatch.setattr(txz, "INDEX_CHUNK", 1000)
        rng = np.random.default_rng(3)
        x0, y0, x1, y1 = _boxes(rng, 2500)
        t, j = txz3.XZ3SFC.for_period(period, 12), jxz3.XZ3SFC.for_period(period, 12)
        top = t.tmax
        t0 = rng.uniform(0, top, len(x0))
        got = t.index(x0, y0, t0, x1, y1, t0)
        assert np.array_equal(got, j.index(x0, y0, t0, x1, y1, t0))
        bounds = [(-30.0, -25.0, 0.1 * top, 10.0, -5.0, 0.4 * top), (5, 5, 0.0, 6, 6, top)]
        tr, jr = t.ranges(bounds), j.ranges(bounds)
        assert tr and [(r.lower, r.upper, r.contained) for r in tr] == \
            [(r.lower, r.upper, r.contained) for r in jr]
