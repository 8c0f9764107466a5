"""The port's kernel modules against the JAX package, on the CPU.

Each plain PyTorch version (the path a CPU tensor takes through the
kernel wrappers) is held against the JAX function it replaces, run both
through Pallas interpret mode and through the XLA version, on the same
numpy inputs made from a seed. Tolerance everywhere is exact equality:
the planes are bit patterns, the density grids integer counts, and the
bounds stats copies of stored f32 values (compared with np.array_equal,
so -0.0 equals 0.0).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from geomesa_tpu.scan import aggregations as jagg
from geomesa_tpu.scan import block_kernels as jbk
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


@pytest.fixture(scope="module")
def columns():
    """numpy [NB, SUB, 128] columns, sentinel-padded at the tail like a
    real table (x = y = +inf, tbin = tw = -1)."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-50, 50, N).astype(np.float32)
    y = rng.uniform(-50, 50, N).astype(np.float32)
    tb = rng.integers(100, 104, N).astype(np.int32)
    to = rng.integers(0, 604_800, N).astype(np.int32)
    tw = ((tb.astype(np.int64) << 16) | (to >> 5)).astype(np.int32)
    x[-700:] = np.inf
    y[-700:] = np.inf
    tb[-700:] = -1
    to[-700:] = 0
    tw[-700:] = -1
    return {k: v.reshape(SHAPE) for k, v in
            {"x": x, "y": y, "tbin": tb, "toff": to, "tw": tw}.items()}


BOXES = tbk.pack_boxes(
    np.array([[-20.0, -15.0, 25.0, 30.0], [30.0, -45.0, 49.5, -20.0]], np.float32),
    np.array([[-19.0, -14.0, 24.0, 29.0]], np.float32),
)
WINS = tbk.pack_windows(
    np.array([[100, 100, 200_000, 604_799], [101, 102, 0, 604_799], [103, 103, 0, 300_000]]),
    np.array([[101, 102, 1, 604_798]]),
)
# packed-time windows: the same slots in 32 s ticks
WINS_TW = tbk.pack_windows(
    np.array([[100, 100, 6250, 18_899], [101, 102, 0, 18_899], [103, 103, 0, 9375]]),
    np.array([[101, 102, 1, 18_898]]),
)

# (case, projected columns, has_boxes, has_windows, window block)
CASES = [
    ("box+window", ("tbin", "toff", "x", "y"), True, True, WINS),
    ("box+window:tw", ("tw", "x", "y"), True, True, WINS_TW),
    ("box", ("x", "y"), True, False, WINS),
    ("window", ("tbin", "toff"), False, True, WINS),
    ("window:tw", ("tw",), False, True, WINS_TW),
    ("valid:x", ("x",), False, False, WINS),
    ("valid:tw", ("tw",), False, False, WINS),
    ("valid:tbin", ("tbin",), False, False, WINS),
]
AGG_CASES = [c for c in CASES if c[2] or c[3]]


def _jax_cols(columns, names):
    return tuple(jnp.asarray(columns[k]) for k in names)


def _torch_cols(columns, names):
    return tuple(torch.from_numpy(columns[k]) for k in names)


def _scan_bids():
    # unsorted candidates; pads repeat block 0
    bids, n_real = tbk.pad_bids(np.array([5, 0, 2, 7, 3]), NB)
    return bids, n_real


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_block_scan_plain_equals_pallas_and_xla(columns, case):
    _, names, has_boxes, has_windows, wins = case
    bids, _ = _scan_bids()
    kw = dict(col_names=names, has_boxes=has_boxes, has_windows=has_windows, extent=False)
    jc = _jax_cols(columns, names)
    pw, pi = jbk._pallas_block_scan(jc, bids, BOXES, wins, interpret=True, **kw)
    xw, xi = jbk._xla_block_scan(jc, bids, BOXES, wins, **kw)
    tw, ti = tbk.block_scan(_torch_cols(columns, names), bids, BOXES, wins, **kw)
    assert tw.dtype == torch.int32 and tw.shape == (len(bids), SUB // 32, tbk.LANES)
    for ref_w, ref_i in ((pw, pi), (xw, xi)):
        assert np.array_equal(tw.numpy(), np.asarray(ref_w))
        assert np.array_equal(ti.numpy(), np.asarray(ref_i))
    assert tw.numpy().any()  # the predicates do select rows


GRIDS = [(96, 48), (33, 17)]  # lane-aligned width, and a ragged grid


@pytest.mark.parametrize("width,height", GRIDS)
@pytest.mark.parametrize("case", AGG_CASES, ids=[c[0] for c in AGG_CASES])
def test_density_plain_equals_pallas_and_xla(columns, case, width, height):
    _, names, has_boxes, has_windows, wins = case
    names = tuple(sorted(set(names) | {"x", "y"}))  # aggregations read coords
    bids, _ = tbk.pad_bids(np.array([0, 2, 3, 5, 7]), NB, pad=-1)
    gb = np.array([-30, -30, 40, 40], np.float32)
    kw = dict(col_names=names, has_boxes=has_boxes, has_windows=has_windows,
              extent=False, width=width, height=height)
    jc = _jax_cols(columns, names)
    pal = np.asarray(jagg._pallas_density(jc, bids, BOXES, wins, gb,
                                          interpret=True, chunk=SUB, **kw))
    xla = np.asarray(jagg._xla_density(jc, bids, BOXES, wins, gb, **kw))
    got = tagg.block_density(_torch_cols(columns, names), bids, BOXES, wins, gb, **kw)
    assert got.dtype == torch.float32 and got.shape == (height, width)
    assert np.array_equal(got.numpy(), pal)
    assert np.array_equal(got.numpy(), xla)
    assert got.numpy().sum() > 0


@pytest.mark.parametrize("case", AGG_CASES, ids=[c[0] for c in AGG_CASES])
def test_bounds_plain_equals_pallas_and_xla(columns, case):
    _, names, has_boxes, has_windows, wins = case
    names = tuple(sorted(set(names) | {"x", "y"}))
    bids, n_real = tbk.pad_bids(np.array([1, 4, 6, 7]), NB, pad=-1)
    kw = dict(col_names=names, has_boxes=has_boxes, has_windows=has_windows, extent=False)
    jc = _jax_cols(columns, names)
    pal = np.asarray(jagg._pallas_bounds(jc, bids, BOXES, wins, interpret=True, **kw))
    xla = np.asarray(jagg._xla_bounds(jc, bids, BOXES, wins, **kw))
    got = tagg.block_bounds(_torch_cols(columns, names), bids, BOXES, wins, **kw).numpy()
    assert got.shape == (len(bids), tagg.STAT_LANES)
    assert np.array_equal(got[:n_real], pal[:n_real])
    assert np.array_equal(got[:n_real], xla[:n_real])
    assert tagg.reduce_bounds(got, n_real) == jagg.reduce_bounds(xla, n_real)


def test_decode_equals_jax(columns, monkeypatch):
    """decode_bits_pair over the same planes, sorted and unsorted block
    lists, against the JAX package's numpy decode."""
    from geomesa_tpu import native

    monkeypatch.setattr(native, "_lib", False)  # the numpy decode path
    with tnative.disabled():
        names = ("tbin", "toff", "x", "y")
        for blocks in (np.array([0, 2, 3, 5, 7]), np.array([5, 0, 2, 7, 3])):
            bids, n_real = tbk.pad_bids(blocks, NB)
            w, i = tbk.block_scan(
                _torch_cols(columns, names), bids, BOXES, WINS,
                col_names=names, has_boxes=True, has_windows=True,
            )
            w, i = w.numpy(), i.numpy()
            rows, cert = tbk.decode_bits_pair(w, i, bids, n_real)
            jrows, jcert = jbk.decode_bits_pair(w, i, bids, n_real)
            assert np.array_equal(rows, jrows) and np.array_equal(cert, jcert)
            assert len(rows) and cert.any() and not cert.all()


def test_param_packers_equal_jax():
    rng = np.random.default_rng(3)
    boxes = rng.uniform(-50, 50, (11, 4)).astype(np.float32)
    boxes[:, 2:] += 60
    for wide, inner in ((boxes[:3], boxes[:2]), (boxes, boxes), (None, None)):
        assert np.array_equal(tbk.pack_boxes(wide, inner), jbk.pack_boxes(wide, inner))
    per_bin = np.array([[b, 10, 500 + (b % 3)] for b in range(100, 120)], np.int64)
    for overflow in ("widen", "drop"):
        a = tbk.merge_window_slots(per_bin, overflow=overflow)
        b = jbk.merge_window_slots(per_bin, overflow=overflow)
        assert np.array_equal(a, b)
        assert np.array_equal(tbk.pack_windows(a, a[:2]), jbk.pack_windows(b, b[:2]))
    for n in (0, 1, 31, 32, 33, 4096, 4097, 10_000):
        assert tbk.bucket_of(n) == jbk.bucket_of(n)
        blocks = np.arange(n) % 97
        for pad in (0, -1):
            a, na = tbk.pad_bids(blocks, 97, pad=pad)
            b, nb = jbk.pad_bids(blocks, 97, pad=pad)
            assert na == nb and np.array_equal(a, b)


def test_staged_params_layout():
    """One int32 buffer per query: bids | box slots | window slots |
    active slot counts | extra f32 words, as csrc/masks.cuh reads it."""
    bids = np.array([3, 1, 0, 0], np.int32)
    gb = np.array([-1.5, 2.0, 3.25, 4.0], np.float32)
    s = tbk.stage_params(bids, BOXES, WINS, gb)
    assert s.dtype == np.int32 and len(s) == 4 + 64 + 64 + 2 + 4
    assert np.array_equal(s[:4], bids)
    assert np.array_equal(s[4:68].view(np.float32).reshape(8, 8), BOXES[:, :8])
    assert np.array_equal(s[68:132].reshape(8, 8), WINS[:, :8])
    assert list(s[132:134]) == [2, 3]  # BOXES fills 2 slots, WINS 3
    assert np.array_equal(s[134:].view(np.float32), gb)
    empty = tbk.stage_params(bids, tbk.pack_boxes(None, None), tbk.pack_windows(None, None))
    assert list(empty[-2:]) == [0, 0]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_over_active_slots_equals_all_slots(columns, case):
    """The kernels loop over the slots before the trailing pad run only:
    the plain version over those slots gives the same planes as over all
    eight (a pad slot never matches), here with pads ahead of a real slot
    too, which the count keeps."""
    _, names, has_boxes, has_windows, wins = case
    boxes = BOXES.copy()
    boxes[5] = boxes[0]  # a real slot after pad slots 2-4
    bids, _ = _scan_bids()
    cols = dict(zip(names, _torch_cols(columns, names)))
    nb = tbk.active_slots(boxes[:, :8], tbk._PAD_BOX)
    nw = tbk.active_slots(wins[:, :8], tbk._PAD_WIN)
    assert nb == 6
    full = tbk.block_scan_plain(
        cols, torch.from_numpy(bids), torch.from_numpy(boxes), torch.from_numpy(wins),
        has_boxes=has_boxes, has_windows=has_windows,
    )
    cut = tbk.block_scan_plain(
        cols, torch.from_numpy(bids), torch.from_numpy(boxes[:nb]), torch.from_numpy(wins[:nw]),
        has_boxes=has_boxes, has_windows=has_windows,
    )
    assert all(torch.equal(a, b) for a, b in zip(full, cut))


# ------------------------------------------------ fused multi-query scan


def _query_stack(tw: bool, n_q: int = 5, seed: int = 17):
    """[Q, 8, 128] box and window stacks of n_q queries (Q = bucket_q),
    each with its own number of box and window slots (1..8), windows in
    seconds or, for the packed-time columns, in 32 s ticks."""
    rng = np.random.default_rng(seed)
    q_pad = tbk.bucket_q(n_q)
    boxes = np.zeros((q_pad, 8, tbk.LANES), np.float32)
    wins = np.zeros((q_pad, 8, tbk.LANES), np.int32)
    top = 18_899 if tw else 604_799
    for q in range(n_q):
        nb, nw = 1 + (q * 3) % 8, 1 + (q * 5 + 2) % 8
        lo = rng.uniform(-50, 30, (nb, 2)).astype(np.float32)
        wide = np.concatenate([lo, lo + rng.uniform(5, 20, (nb, 2)).astype(np.float32)], axis=1)
        inner = wide[:1] + np.array([1, 1, -1, -1], np.float32)
        boxes[q] = tbk.pack_boxes(wide, inner)
        bins = rng.integers(100, 104, nw)
        offs = np.sort(rng.integers(0, top, (nw, 2)), axis=1)
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
    return bids, q, n_real


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_block_scan_multi_plain_equals_pallas_and_xla(columns, case):
    _, names, has_boxes, has_windows, _ = case
    boxes, wins = _query_stack(tw="tw" in names)
    counts = tbk.stage_multi_params(np.zeros(0), np.zeros(0), boxes, wins)[-2 * len(boxes):]
    assert len(set(counts[0:10:2])) > 1 and len(set(counts[1:10:2])) > 1  # differing slots
    bids, qids, _ = _multi_ids()
    kw = dict(col_names=names, has_boxes=has_boxes, has_windows=has_windows, extent=False)
    jc = _jax_cols(columns, names)
    pw, pi = jbk._pallas_block_scan_multi(jc, bids, qids, boxes, wins, interpret=True, **kw)
    xw, xi = jbk._xla_block_scan_multi(jc, bids, qids, boxes, wins, **kw)
    tw, ti = tbk.block_scan_multi(_torch_cols(columns, names), bids, qids, boxes, wins, **kw)
    assert tw.dtype == torch.int32 and tw.shape == (len(bids), SUB // 32, tbk.LANES)
    for ref_w, ref_i in ((pw, pi), (xw, xi)):
        assert np.array_equal(tw.numpy(), np.asarray(ref_w))
        assert np.array_equal(ti.numpy(), np.asarray(ref_i))
    assert tw.numpy().any()
    # each slot equals the single-query scan of its own query
    for q in np.unique(qids):
        sel = qids == q
        sw, si = tbk.block_scan(_torch_cols(columns, names), bids[sel], boxes[q], wins[q], **kw)
        assert torch.equal(tw[torch.from_numpy(sel)], sw) and torch.equal(ti[torch.from_numpy(sel)], si)


def test_staged_multi_params_layout():
    """One int32 buffer per fused chunk: bids | qids | box slots [Q] |
    window slots [Q] | per-query active slot counts, as
    csrc/block_scan_multi.cu reads it."""
    boxes, wins = _query_stack(tw=False)
    bids, qids, _ = _multi_ids()
    s = tbk.stage_multi_params(bids, qids, boxes, wins)
    m, q = len(bids), len(boxes)
    assert s.dtype == np.int32 and len(s) == 2 * m + 2 * q * 64 + 2 * q
    assert np.array_equal(s[:m], bids) and np.array_equal(s[m:2 * m], qids)
    box = s[2 * m:2 * m + q * 64].view(np.float32).reshape(q, 8, 8)
    win = s[2 * m + q * 64:2 * m + 2 * q * 64].reshape(q, 8, 8)
    assert np.array_equal(box, boxes[:, :, :8]) and np.array_equal(win, wins[:, :, :8])
    counts = s[2 * m + 2 * q * 64:].reshape(q, 2)
    for k in range(q):
        assert list(counts[k]) == list(tbk.slot_words(boxes[k], wins[k])[2])
    assert list(counts[5]) == [8, 8]  # an all-zero pad row: no slot equals the pad
    assert tbk.bucket_q(5) == jbk.bucket_q(5) == 8 and tbk.bucket_q(40) == jbk.bucket_q(40)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_block_pops_plain_equals_pallas_and_xla(columns, case):
    _, names, has_boxes, has_windows, wins = case
    bids, n_real = tbk.pad_bids(np.array([6, 1, 4, 7, 0]), NB, pad=-1)
    kw = dict(col_names=names, has_boxes=has_boxes, has_windows=has_windows, extent=False)
    jc = _jax_cols(columns, names)
    pal = np.asarray(jagg._pops_pallas(jc, bids, BOXES, wins, interpret=True, **kw))
    xla = np.asarray(jagg._pops_xla(jc, bids, BOXES, wins, **kw))
    got = tagg.block_pops(_torch_cols(columns, names), bids, BOXES, wins, **kw)
    assert got.dtype == torch.int32 and got.shape == (len(bids),)
    assert np.array_equal(got.numpy(), pal) and np.array_equal(got.numpy(), xla)
    assert got.numpy()[:n_real].sum() > 0


def test_popcount_slots_plain_counts_unsigned_words():
    rng = np.random.default_rng(23)
    plane = rng.integers(-2**31, 2**31, (6, 2, tbk.LANES), dtype=np.int64).astype(np.int32)
    plane[0, 0, :3] = [-1, 0, np.iinfo(np.int32).min]
    want = np.unpackbits(plane.view(np.uint8), axis=None).reshape(6, -1).sum(axis=1)
    got = tagg.popcount_slots_plain(torch.from_numpy(plane))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
