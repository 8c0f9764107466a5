"""The chip-side probes' kernels against the JAX probes, on the CPU.

The port's plain versions of P1 (``probe_kernels.probe_scan_plain``) and
P2 (``probe_bounds_plain``, ``probe_density_plain``) are held against
the JAX probes' own functions, loaded from scripts/ by path and run with
Pallas in TPU interpret mode (``block_scan``; ``make_pallas`` over
``_bounds_kernel``, ``_density_kernel_reshape``, ``_density_kernel_fori``)
and against the probes' XLA versions (``xla_bounds``, ``xla_density``),
on the same numpy columns made from a seed: 4 blocks of 16384 rows
(SUB = 128, fixed by both probes), M = 6. Tolerance everywhere is exact
equality: planes are bits, counts integers, and min/max select stored
f32 values. Then the rules: each probe wrapper takes the plain version
on a CPU tensor and launches nothing, raises on a device without a
kernel, and both probes' ``run(device="cpu")`` complete at a tiny size.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from geomesa_tpu_torch.scan import block_kernels as tbk
from geomesa_tpu_torch.scan import probe_kernels as tpk
from geomesa_tpu_torch.scripts import probe_agg as tpa
from geomesa_tpu_torch.scripts import probe_pallas as tpp

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NB = 4
M = 6
P2_BOX = (-40.0, -30.0, 60.0, 40.0)


def _load_probe(name):
    """The JAX probe module scripts/<name>.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jprobes():
    return _load_probe("probe_pallas"), _load_probe("probe_agg")


@pytest.fixture(scope="module")
def columns():
    """numpy (x, y, tbin, toff) [NB, 128, 128], drawn as P1 draws them,
    with rows in every block exactly on the edges the cases use: P1's box
    (+-10) and the window's offsets (1000, 90000), P2's box / envelope
    corner (60, 40), one f32 ulp past it, and a point inside the box but
    outside the narrow envelope."""
    x, y, tb, to = (a.copy() for a in tpp.make_columns(NB * tpk.BLOCK, seed=11))
    xb, yb, ob = x.reshape(NB, -1), y.reshape(NB, -1), to.reshape(NB, -1)
    edges = ((10, 10), (-10, -10), (10, -10), (60, 40), (60, 0), (0, 40),
             (np.nextafter(np.float32(60), np.float32(np.inf)), 0), (50, 35), (-40, -30))
    for k, (ex, ey) in enumerate(edges):
        xb[:, k * 64:(k + 1) * 64] = ex
        yb[:, k * 64:(k + 1) * 64] = ey
    ob[:, 0:300] = 1000
    ob[:, 300:600] = 90_000
    return x, y, tb, to


def _t(cols):
    return tuple(torch.from_numpy(c) for c in cols)


def _p1_params(n_slots, win_lo=0, win_hi=604_799, bins=(3, 5)):
    """P1 params with ``n_slots`` wide box and window slots (the first box
    P1's own), one inner slot each, the rest padded."""
    r = np.random.default_rng(n_slots)
    lo = r.uniform(-170, 100, (n_slots, 2)).astype(np.float32)
    bw = np.concatenate([lo, lo + r.uniform(5, 60, (n_slots, 2)).astype(np.float32)], axis=1)
    bw[0] = tpp.BOX
    b = r.integers(0, 18, n_slots)
    ww = np.stack([b, b + r.integers(0, 4, n_slots), np.full(n_slots, win_lo),
                   np.full(n_slots, win_hi)], axis=1)
    ww[0] = (*bins, win_lo, win_hi)
    inner_box = np.array([[-9.0, -9.0, 10.0, 10.0]], np.float32)
    inner_win = np.array([[bins[0], bins[1], win_lo + 1, win_hi]], np.int32)
    return tpp.pack_params(bw, inner_box, ww, inner_win)


# the P1 bids: pad slots repeat block 0, as the probe pads them
P1_BIDS = np.array([1, 3, 0, 2, 0, 0], np.int32)


def _jax_p1(jpp, cols, bids, boxes, wins):
    with pltpu.force_tpu_interpret_mode():
        w, i = jpp.block_scan(*cols, bids, boxes, wins, M=len(bids))
        return np.asarray(w), np.asarray(i)


@pytest.mark.parametrize("case", [
    dict(n_slots=1), dict(n_slots=3), dict(n_slots=8),
    dict(n_slots=2, win_lo=1000, win_hi=90_000),  # rows on the offset edges
    dict(n_slots=1, bins=(20, 25)),  # a window that matches nothing
])
def test_probe_scan_plain_equals_jax_probe(jprobes, columns, case):
    """P1's planes word for word: 1, 3 and 8 slots (the rest padded),
    rows on box and window edges, a window that matches nothing, bids
    that repeat block 0."""
    boxes, wins = _p1_params(**case)
    jw, ji = _jax_p1(jprobes[0], columns, P1_BIDS, boxes, wins)
    w, i = tpk.probe_scan(_t(columns), P1_BIDS, boxes, wins)
    assert w.dtype == torch.int32 and w.shape == (M, tpk.PACK, tpk.LANES)
    assert np.array_equal(w.numpy(), jw) and np.array_equal(i.numpy(), ji)
    assert bool(w.any()) == ("bins" not in case)


def test_split_params_are_the_probe_predicate_in_eight_slots(jprobes, columns):
    """``split_params`` (the yardstick on which K1 loops over as many
    slots as P1 evaluates) has all 8 box and window slots real and gives
    the probe's own planes, in the JAX probe and in the port's P1 and K1,
    rows on the box edges included."""
    boxes, wins = tpp.pack_params(*(np.array([v], np.float32) for v in (tpp.BOX, tpp.BOX)),
                                  *(np.array([v], np.int32) for v in (tpp.WINDOW, tpp.WINDOW)))
    boxes8, wins8 = tpp.split_params()
    assert tbk.slot_words(boxes8, wins8)[2].tolist() == [8, 8]
    want = _jax_p1(jprobes[0], columns, P1_BIDS, boxes, wins)
    assert want[0].any()
    got = [_jax_p1(jprobes[0], columns, P1_BIDS, boxes8, wins8),
           tpk.probe_scan(_t(columns), P1_BIDS, boxes8, wins8),
           tbk.block_scan(_t(columns), P1_BIDS, boxes8, wins8, col_names=tpk.P1_COLS,
                          has_boxes=True, has_windows=True)]
    for w, i in got:
        assert np.array_equal(np.asarray(w), want[0]) and np.array_equal(np.asarray(i), want[1])


def test_probe_decode_equals_jax_probe(jprobes, columns):
    """The port's decode to row ids equals the JAX probe's, and numpy's
    truth over the real slots."""
    boxes, wins = _p1_params(1)
    jw, _ = _jax_p1(jprobes[0], columns, P1_BIDS, boxes, wins)
    w, _ = tpk.probe_scan(_t(columns), P1_BIDS, boxes, wins)
    n_real = 4
    rows = tpk.decode_rows(w.numpy(), P1_BIDS, n_real)
    assert np.array_equal(rows, jprobes[0].decode_rows(jw, P1_BIDS, n_real))
    real = P1_BIDS[:n_real]
    order = np.argsort(real)
    expect = tpp.truth_rows(columns, real[order])
    assert np.array_equal(np.sort(rows), expect) and len(expect) > 0


def _gb(box):
    gb = np.zeros((1, tpk.LANES), np.float32)
    gb[0, :4] = box
    return gb


# the P2 bids: pad slots -1 between and after the real ones
P2_BIDS = np.array([1, 3, -1, 0, -1, 2], np.int32)


@pytest.fixture(scope="module")
def jax_p2_fns(jprobes):
    """The JAX probe's make_pallas callables at M (built once: each is a
    fresh jit)."""
    ja = jprobes[1]
    return {
        "bounds": ja.make_pallas(ja._bounds_kernel, jax.ShapeDtypeStruct((M, 128), jnp.float32),
                                 ((1, 128), lambda i, bids: (i, 0)), M),
        **{name: ja.make_pallas(kern, jax.ShapeDtypeStruct((ja.H, ja.W), jnp.float32),
                                ((ja.H, ja.W), lambda i, bids: (0, 0)), M)
           for name, kern in (("reshape", ja._density_kernel_reshape),
                              ("fori", ja._density_kernel_fori))},
    }


@pytest.mark.parametrize("empty", [False, True])
def test_probe_bounds_plain_equals_jax_probe(jprobes, columns, jax_p2_fns, empty):
    """P2 bounds against the Pallas body in interpret mode and against
    xla_bounds: pad slots (bid -1) report block 0's stats; a box that
    matches nothing gives count 0 and +-inf extrema."""
    box = np.array([[500.0, 500.0, 501.0, 501.0]]) if empty else np.array([P2_BOX])
    boxes = tbk.pack_boxes(box, None)
    gb = _gb(P2_BOX)
    x, y = columns[:2]
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(jax_p2_fns["bounds"](P2_BIDS, boxes, gb, x, y))
    xla = np.asarray(jprobes[1].xla_bounds(P2_BIDS, boxes, gb, x, y))
    got = tpk.probe_bounds(_t((x, y)), P2_BIDS, boxes).numpy()
    assert got.shape == (M, tpk.OUT_LANES) and got.dtype == np.float32
    assert np.array_equal(got, pal)
    assert np.array_equal(got[:, :5], xla)
    for pad in np.flatnonzero(P2_BIDS < 0):
        assert np.array_equal(got[pad], got[P2_BIDS.tolist().index(0)])
    if empty:
        assert (got[:, 0] == 0).all() and (got[:, [1, 3]] == np.inf).all()
        assert (got[:, [2, 4]] == -np.inf).all()
    else:
        assert (got[:, 0] > 0).all()


@pytest.mark.parametrize("envelope", [P2_BOX, (-20.0, -25.0, 45.0, 30.0)])
@pytest.mark.parametrize("variant", ["reshape", "fori"])
def test_probe_density_plain_equals_jax_probe(jprobes, columns, jax_p2_fns, variant, envelope):
    """P2 density against each Pallas body in interpret mode and against
    xla_density: rows on x1 / y1 clip to the last pixel, rows past x1 and
    rows outside a narrower envelope count nothing, pad slots count
    nothing."""
    boxes = tbk.pack_boxes(np.array([P2_BOX]), None)
    gb = _gb(envelope)
    x, y = columns[:2]
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(jax_p2_fns[variant](P2_BIDS, boxes, gb, x, y))
    xla = np.asarray(jprobes[1].xla_density(P2_BIDS, boxes, gb, x, y))
    got = tpk.probe_density(_t((x, y)), P2_BIDS, boxes, gb, variant=variant).numpy()
    assert got.shape == (tpa.H, tpa.W) and got.dtype == np.float32
    assert np.array_equal(got, pal) and np.array_equal(got, xla)
    if envelope == P2_BOX:
        # the 4 real slots' corner rows (60, 40), and nothing of the pads
        assert got[-1, -1] >= 4 * 64
    real = (P2_BIDS >= 0).sum()
    assert got.sum() <= real * tpk.BLOCK


# -- rules -------------------------------------------------------------------


def _meta_cols(n):
    return tuple(
        torch.zeros((2, tpk.SUB, tpk.LANES), dtype=torch.float32 if k < 2 else torch.int32,
                     device="meta")
        for k in range(n)
    )


def _cpu_cols(n):
    return tuple(torch.zeros((2, tpk.SUB, tpk.LANES),
                             dtype=torch.float32 if k < 2 else torch.int32) for k in range(n))


BOXES0 = tbk.pack_boxes(np.array([[-1.0, -1.0, 1.0, 1.0]]), None)
WINS0 = tbk.pack_windows(None, None)
GB0 = np.array([-1, -1, 1, 1], np.float32)
CALLS = {
    "scan": lambda cols: tpk.probe_scan(cols(4), np.zeros(4, np.int32), BOXES0, WINS0),
    "bounds": lambda cols: tpk.probe_bounds(cols(2), np.array([0, -1], np.int32), BOXES0),
    "reshape": lambda cols: tpk.probe_density(cols(2), np.array([0, -1], np.int32), BOXES0, GB0,
                                              variant="reshape"),
    "fori": lambda cols: tpk.probe_density(cols(2), np.array([0, -1], np.int32), BOXES0, GB0,
                                           variant="fori"),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_probe_wrappers_take_plain_on_cpu_and_launch_nothing(call):
    from geomesa_tpu_torch.kernels import PROBE_KERNELS

    before = [(k.launches, dict(k.leg_launches)) for k in PROBE_KERNELS]
    out = CALLS[call](_cpu_cols)
    for t in (out if isinstance(out, tuple) else (out,)):
        assert t.device.type == "cpu"
    assert [(k.launches, dict(k.leg_launches)) for k in PROBE_KERNELS] == before


@pytest.mark.parametrize("call", sorted(CALLS))
def test_probe_wrappers_raise_without_a_kernel(call):
    """A tensor off the CPU goes to a kernel or the call raises: there is
    no fallback to the plain version."""
    with pytest.raises(ValueError, match="no probe .* kernel for device meta"):
        CALLS[call](_meta_cols)


def test_probe_wrappers_check_their_inputs():
    cols = _cpu_cols(4)
    with pytest.raises(ValueError, match="block ids"):
        tpk.probe_scan(cols, np.array([-1, 0], np.int32), BOXES0, WINS0)
    with pytest.raises(ValueError, match="must be contiguous"):
        tpk.probe_scan((cols[0], cols[1], cols[2].float(), cols[3]), np.zeros(2, np.int32),
                       BOXES0, WINS0)
    with pytest.raises(ValueError, match="probe columns are"):
        tpk.probe_bounds(tuple(c[:, :32] for c in cols[:2]), np.zeros(2, np.int32), BOXES0)
    with pytest.raises(ValueError, match="density variant"):
        tpk.probe_density(cols[:2], np.zeros(2, np.int32), BOXES0, GB0, variant="scatter")
    with pytest.raises(ValueError, match="param blocks"):
        tpk.probe_bounds(cols[:2], np.zeros(2, np.int32), BOXES0[:4])


@pytest.mark.parametrize("probe", ["probe_pallas", "probe_agg"])
def test_probe_run_on_cpu_completes_and_times_nothing(probe):
    if probe == "probe_pallas":
        out = tpp.run(device="cpu", n_rows=4 * tpk.BLOCK, ms=(4, 8), check_m=4)
        assert out["check"]["ok"] and out["check"]["rows"] > 0
    else:
        out = tpa.run(device="cpu", n_blocks=8, ms=(4, 8))
        assert all(r["k3_equal"] for r in out["records"])
    assert out["equal"] is True and out["device"] == "cpu"
    assert [r["M"] for r in out["records"]] == [4, 8]
    rec = out["records"][0]
    timed = rec["kernel_ms"] if probe == "probe_pallas" else rec["bounds"]["kernel_ms"]
    assert timed is None  # a CPU run gives no device time


def test_probe_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (tpp, tpa):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main()
