"""The port's point-in-polygon and raster legs against the JAX package, on
the CPU.

The plain PyTorch versions of the single-query scan (K1) and the fused
scan (K2) with the polygon legs on are held against the JAX kernels they
replace: Pallas in interpret mode where its unrolled kernel runs (E and
R up to 64) and the XLA version at every size, on the same numpy inputs
made from a seed. The packers (``pack_edges``, ``RasterApprox``'s
``pack_block`` and ``zranges``, ``classify_raster_cells``) must equal the
JAX package's for the same polygons, holes and MultiPolygons included.
Tolerance everywhere is exact equality: planes are bit patterns, blocks
f32 words, cell classes and z-ranges integers.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from geomesa_tpu import geometry as jgeo
from geomesa_tpu.filter import raster as jfr
from geomesa_tpu.scan import block_kernels as jbk
from geomesa_tpu_torch import geometry as tgeo
from geomesa_tpu_torch.filter import raster as tfr
from geomesa_tpu_torch.scan import block_kernels as tbk
from test_torch_kernels import BOXES, NB, SUB, WINS, WINS_TW, _jax_cols, _torch_cols, columns  # noqa: F401

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)


def star_rings(cx, cy, arms, r_in, r_out, hole=0.0):
    """Shell (and a reversed inner hole ring of radius ``hole`` * r_in) of
    a star with ``arms`` points: 2 * arms edges per ring."""
    a = np.linspace(0, 2 * np.pi, 2 * arms, endpoint=False)
    r = np.where(np.arange(2 * arms) % 2 == 0, r_out, r_in)
    shell = np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1)
    holes = []
    if hole:
        h = hole * r_in
        holes.append(np.stack([cx + h * np.cos(a[::-1]), cy + h * np.sin(a[::-1])], axis=1))
    return shell, holes


def both(shell, holes=()):
    """The same polygon in the JAX package and in the port."""
    return jgeo.Polygon(shell, list(holes)), tgeo.Polygon(shell, list(holes))


# (id, polygon in both packages): the edge buckets 16, 64 (with a hole),
# 256 and 32 (a MultiPolygon with a hole), each overlapping [-50, 50]^2
POLYGONS = {
    "e16": both(*star_rings(3, -2, 5, 12, 40)),
    "e64-hole": both(*star_rings(-4, 5, 14, 15, 44, hole=0.5)),
    "e256": both(*star_rings(2, 1, 100, 22, 46)),
}
_s1, _ = star_rings(-25, -20, 4, 6, 20)
_s2, _h2 = star_rings(20, 22, 5, 8, 24, hole=0.6)
POLYGONS["multi"] = (
    jgeo.MultiPolygon([jgeo.Polygon(_s1), jgeo.Polygon(_s2, [_h2[0]])]),
    tgeo.MultiPolygon([tgeo.Polygon(_s1), tgeo.Polygon(_s2, [_h2[0]])]),
)
PIDS = list(POLYGONS)


@pytest.mark.parametrize("pid", PIDS)
def test_packers_equal_jax(pid):
    jp, tp = POLYGONS[pid]
    je, te = jbk.pack_edges(jp), tbk.pack_edges(tp)
    assert te is not None and te.dtype == np.float32 and np.array_equal(te, je)
    assert tbk.n_edges_of(te) == jbk.n_edges_of(je)
    x_edges = np.linspace(-50, 50, 37)
    y_edges = np.linspace(-50, 50, 29)
    for margin in (0.0, 3e-4, 0.7):
        jc = jgeo.classify_raster_cells(jp, x_edges, y_edges, margin)
        tc = tgeo.classify_raster_cells(tp, x_edges, y_edges, margin)
        assert tc.dtype == np.int8 and np.array_equal(tc, jc)
        assert {tgeo.RASTER_FULL, tgeo.RASTER_PARTIAL, tgeo.RASTER_OUT} <= set(np.unique(tc))
    ja, ta = jfr.build_raster(jp), tfr.build_raster(tp)
    assert ta is not None and ta.level == ja.level and np.array_equal(ta.classes, ja.classes)
    for bucket in (16, 64, 256):
        assert np.array_equal(ta.pack_block(bucket), ja.pack_block(bucket))
    for cap in (None, 50, 7):
        for a, b in zip(ta.zranges(max_ranges=cap), ja.zranges(max_ranges=cap)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(ta.classify_points([0.0, 3.0, 70.0], [0.0, -2.0, 0.0]),
                          ja.classify_points([0.0, 3.0, 70.0], [0.0, -2.0, 0.0]))


def test_ladders_equal_jax():
    for n in (0, 1, 15, 16, 17, 63, 64, 65, 200, 256, 300):
        assert tbk.fused_e_bucket(min(n, 256)) == jbk.fused_e_bucket(min(n, 256))
        assert tbk.fused_r_bucket(min(n, 256)) == jbk.fused_r_bucket(min(n, 256))
        assert tbk.r_bucket_of(n) == jbk.r_bucket_of(n)
    assert tbk.E_BUCKETS == jbk.E_BUCKETS and tbk.FUSED_E_BUCKETS == jbk.FUSED_E_BUCKETS
    assert tbk.R_BUCKETS == jbk.R_BUCKETS and tbk.FUSED_R_BUCKETS == jbk.FUSED_R_BUCKETS
    segs = np.array([[0, 0, 1, 2], [1, 2, 3, 2], [3, 2, 0, 0]], np.float64)
    assert np.array_equal(tbk.pack_edge_segments(segs), jbk.pack_edge_segments(segs))
    assert tbk.pack_edge_segments(np.zeros((257, 4))) is None
    assert tbk.n_rints_of(None) == jbk.n_rints_of(None) == 0


def _legs(pid, leg, r_bucket):
    """(edges, rast) numpy blocks of one polygon for a leg combination."""
    jp, _ = POLYGONS[pid]
    edges = jbk.pack_edges(jp) if "pip" in leg else None
    rast = jfr.build_raster(jp).pack_block(r_bucket) if "raster" in leg else None
    return edges, rast


# (projected columns, has_windows, window block): no window, the window
# on (tbin, toff) and on the packed tw column
WINDOWED = [
    (("x", "y"), False, WINS),
    (("tbin", "toff", "x", "y"), True, WINS),
    (("tw", "x", "y"), True, WINS_TW),
]
LEG_CASES = [
    (pid, leg, r)
    for pid in PIDS
    for leg, r in (("pip", 0), ("raster", 16), ("raster", 64), ("pip+raster", 16),
                   ("raster", 256))
]


@pytest.mark.parametrize("win", WINDOWED, ids=["nowin", "win", "win:tw"])
@pytest.mark.parametrize("pid,leg,r_bucket", LEG_CASES,
                         ids=[f"{p}-{leg}-R{r}" for p, leg, r in LEG_CASES])
def test_block_scan_polygon_legs_equal_pallas_and_xla(columns, pid, leg, r_bucket, win):
    names, has_windows, wins = win
    edges, rast = _legs(pid, leg, r_bucket)
    n_edges, n_rints = jbk.n_edges_of(edges), jbk.n_rints_of(rast)
    bids, _ = tbk.pad_bids(np.array([5, 0, 2, 7, 3, 6]), NB)
    kw = dict(col_names=names, has_boxes=True, has_windows=has_windows, extent=False,
              n_edges=n_edges, n_rints=n_rints)
    jc = _jax_cols(columns, names)
    refs = [jbk._xla_block_scan(jc, bids, BOXES, wins, edges, rast, **kw)]
    if n_edges <= jbk.PALLAS_MAX_EDGES and n_rints <= jbk.PALLAS_MAX_RINTS:
        refs.append(jbk._pallas_block_scan(jc, bids, BOXES, wins, edges, rast,
                                           interpret=True, **kw))
    tw, ti = tbk.block_scan(_torch_cols(columns, names), bids, BOXES, wins, edges=edges,
                            rast=rast, **kw)
    assert tw.dtype == torch.int32 and tw.shape == (len(bids), SUB // 32, tbk.LANES)
    for ref_w, ref_i in refs:
        assert np.array_equal(tw.numpy(), np.asarray(ref_w))
        assert np.array_equal(ti.numpy(), np.asarray(ref_i))
    assert tw.numpy().any()
    if "pip" in leg:  # certain rows (a coarse raster alone may certify none)
        assert ti.numpy().any()
    # the polygon legs replace the box leg: not the box's planes
    bw, _ = tbk.block_scan(_torch_cols(columns, names), bids, BOXES, wins,
                           **{k: v for k, v in kw.items() if k not in ("n_edges", "n_rints")})
    assert not torch.equal(tw, bw)


def test_real_counts_skip_only_pad_rows(columns):
    """The kernels loop over the real edges and intervals only: the plain
    version over those rows gives the planes of the whole padded block."""
    names = ("x", "y")
    cols = dict(zip(names, _torch_cols(columns, names)))
    bids, _ = tbk.pad_bids(np.array([5, 0, 2, 7]), NB)
    for pid in PIDS:
        edges, rast = _legs(pid, "pip+raster", 64)
        n_e = int(tbk.active_edges_many(edges[None])[0])
        n_r = int(tbk.active_rints_many(rast[None])[0])
        assert 0 < n_e <= len(edges) and 0 < n_r <= len(rast) - 1
        assert not edges[n_e:].any() and (rast[1 + n_r:, 0] > rast[1 + n_r:, 1]).all()
        args = (cols, torch.from_numpy(bids), torch.from_numpy(BOXES), torch.from_numpy(WINS))
        full = tbk.block_scan_plain(*args, has_boxes=True, has_windows=False,
                                    edges=torch.from_numpy(edges), rast=torch.from_numpy(rast))
        cut = tbk.block_scan_plain(*args, has_boxes=True, has_windows=False,
                                   edges=torch.from_numpy(edges[:n_e]),
                                   rast=torch.from_numpy(rast[:1 + n_r]))
        assert all(torch.equal(a, b) for a, b in zip(full, cut))


def test_poly_words_layout():
    """A query's polygon block as csrc/masks.cuh reads it: real counts,
    six lanes per edge, the header, three lanes per interval; the zero
    rows of a chunk's stack count as pads."""
    edges, rast = _legs("e64-hole", "pip+raster", 64)
    stack_e = np.zeros((3, 64, tbk.LANES), np.float32)
    stack_r = np.zeros((3, 65, tbk.LANES), np.float32)
    stack_e[1] = edges
    stack_r[1] = rast
    w = tbk.poly_words(stack_e, stack_r, 64, 64)
    assert w.dtype == np.int32 and w.shape == (3, 2 + 6 * 64 + 6 + 3 * 64)
    n_e = int(tbk.active_edges_many(edges[None])[0])
    n_r = int(tbk.active_rints_many(rast[None])[0])
    assert list(w[1, :2]) == [n_e, n_r] and list(w[0, :2]) == [0, 0]
    f = w[1, 2:].view(np.float32)
    assert np.array_equal(f[: 6 * 64].reshape(64, 6), edges[:, :6])
    assert np.array_equal(f[6 * 64 : 6 * 64 + 6], rast[0, :6])
    assert np.array_equal(f[6 * 64 + 6 :].reshape(64, 3), rast[1:, :3])
    with pytest.raises(ValueError, match="caps"):
        tbk.poly_words(stack_e, None, n_e - 1, 0)
    s = tbk.stage_params(np.zeros(4, np.int32), BOXES, WINS, poly=w[1, : 2 + 6 * n_e + 6])
    assert len(s) == 4 + 128 + 2 + 2 + 6 * n_e + 6


def _fused_inputs(leg):
    """One fused chunk of 7 polygon queries (differing edge and interval
    counts) and 3 box queries, slots interleaved, then pad slots: [Q, 8,
    128] box and window stacks, the edge and raster stacks of the leg
    combination (chunk buckets E 64, R 16), and spip."""
    rng = np.random.default_rng(31)
    q_pad = tbk.bucket_q(10)
    boxes = np.zeros((q_pad, 8, tbk.LANES), np.float32)
    wins = np.zeros((q_pad, 8, tbk.LANES), np.int32)
    edges = np.zeros((q_pad, 64, tbk.LANES), np.float32) if "pip" in leg else None
    rasts = np.zeros((q_pad, 17, tbk.LANES), np.float32) if "raster" in leg else None
    poly = np.zeros(q_pad, bool)
    for q in range(10):
        cx, cy = rng.uniform(-20, 20, 2)
        shell, holes = star_rings(cx, cy, 3 + q, 6 + q, 28, hole=0.4 if q % 3 == 0 else 0.0)
        jp = jgeo.Polygon(shell, holes)
        bx = np.array([jp.bounds()], np.float32)
        boxes[q] = jbk.pack_boxes(bx, None)
        wins[q] = jbk.pack_windows(np.array([[100, 100 + q % 4, 0, 604_799]]), None)
        if q in (2, 5, 8):
            continue  # a box query
        poly[q] = True
        if edges is not None:
            e = jbk.pack_edges(jp)
            edges[q, : len(e)] = e
        if rasts is not None:
            r = jfr.build_raster(jp).pack_block(16)
            rasts[q, : len(r)] = r
    blocks = np.array([5, 0, 2, 7, 3, 3, 6, 1, 4, 7, 0, 2, 5, 6, 1, 4, 3, 0, 7, 2])
    qids = np.concatenate([np.arange(10), np.arange(10)[::-1]]).astype(np.int32)
    bids, n_real = tbk.pad_bids(blocks, NB, bucket=32)
    q = np.zeros(len(bids), np.int32)
    q[:n_real] = qids
    spip = poly[q].astype(np.int32)
    spip[n_real:] = 0
    return boxes, wins, edges, rasts, bids, q, spip


@pytest.mark.parametrize("win", WINDOWED, ids=["nowin", "win", "win:tw"])
@pytest.mark.parametrize("leg", ["pip", "raster", "pip+raster"])
def test_block_scan_multi_polygon_stacks_equal_pallas_and_xla(columns, leg, win):
    names, has_windows, _ = win
    boxes, wins, edges, rasts, bids, qids, spip = _fused_inputs(leg)
    if "tw" in names:
        wins = wins.copy()
        wins[:, :, 2:4] >>= 5  # offsets as 32 s ticks
    n_edges, n_rints = (0 if edges is None else 64), (0 if rasts is None else 16)
    kw = dict(col_names=names, has_boxes=True, has_windows=has_windows, extent=False,
              n_edges=n_edges, n_rints=n_rints)
    jc = _jax_cols(columns, names)
    pw, pi = jbk._pallas_block_scan_multi(jc, bids, qids, boxes, wins, edges, spip, rasts,
                                          interpret=True, **kw)
    xw, xi = jbk._xla_block_scan_multi(jc, bids, qids, boxes, wins, edges, spip, rasts, **kw)
    tc = _torch_cols(columns, names)
    tw, ti = tbk.block_scan_multi(tc, bids, qids, boxes, wins, edges=edges, spip=spip,
                                  rasts=rasts, **kw)
    for ref_w, ref_i in ((pw, pi), (xw, xi)):
        assert np.array_equal(tw.numpy(), np.asarray(ref_w))
        assert np.array_equal(ti.numpy(), np.asarray(ref_i))
    assert tw.numpy().any()
    # each slot equals the single-query scan of its own query's legs
    sk = {k: v for k, v in kw.items() if k not in ("n_edges", "n_rints")}
    for q in np.unique(qids[spip > 0]):
        sel = (qids == q) & (spip > 0)
        e = None if edges is None else edges[q]
        r = None if rasts is None else rasts[q]
        sw, si = tbk.block_scan(tc, bids[sel], boxes[q], wins[q], edges=e, rast=r,
                                n_edges=n_edges, n_rints=n_rints, **sk)
        m = torch.from_numpy(sel)
        assert torch.equal(tw[m], sw) and torch.equal(ti[m], si)
    # a slot whose spip is 0 takes the box leg, stacks or not
    box_w, box_i = tbk.block_scan_multi(tc, bids, qids, boxes, wins, **sk)
    m = torch.from_numpy(spip == 0)
    assert torch.equal(tw[m], box_w[m]) and torch.equal(ti[m], box_i[m])
