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
f32 values. The live-slot staging the CUDA launches use
(``live_slots``, ``stage_probe``: each leg's live slots first, their
counts in the words csrc/masks.cuh reads) is held against the JAX probes
on the original param blocks. Then the rules: each probe wrapper takes
the plain version on a CPU tensor and launches nothing, raises on a
device without a kernel, and both probes' ``run(device="cpu")`` complete
at a tiny size.
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


# -- live-slot staging ------------------------------------------------------

# (box, window) live slots of each staging case of probe_pallas, over both
# planes (P1) and over the wide plane's boxes alone (P2)
STAGING_COUNTS = {
    "pads": ((2, 2), 1), "inverted": ((1, 1), 1), "nan": ((1, 1), 1), "inf": ((4, 2), 2),
    "one_plane": ((2, 2), 1), "all8": ((8, 8), 8), "no_box": ((0, 2), 0),
    "no_window": ((2, 0), 1),
}
_PAD_HALF = {np.float32: (np.inf, 0, -np.inf, 0), np.int32: (1, 0, 0, 0)}


def _seeded_blocks(seed):
    """Seeded P1 blocks: each half (wide lanes 0-3, inner 4-7) of each of
    the 8 box and window slots is at random live, a pad, inverted, NaN
    (boxes) or infinite (boxes), with the expected live counts."""
    r = np.random.default_rng(seed)
    blocks, counts = [], []
    for dtype in (np.float32, np.int32):
        p = np.zeros((8, tpk.LANES), dtype)
        live = np.zeros(8, bool)
        kinds = ["live", "pad", "inverted"] + (["nan", "inf"] if dtype is np.float32 else [])
        for k in range(8):
            for o in (0, 4):
                kind = r.choice(kinds)
                if dtype is np.float32:
                    lo = r.uniform(-90, 0, 2).astype(np.float32)
                    v = np.concatenate([lo, lo + r.uniform(40, 120, 2).astype(np.float32)])
                else:
                    b0, o0 = r.integers(0, 10), r.integers(0, 300_000)
                    v = np.array([b0, b0 + r.integers(2, 9), o0, o0 + r.integers(1, 300_000)])
                if kind == "pad":
                    v = np.array(_PAD_HALF[dtype], dtype)
                elif kind == "inverted":
                    v = v[[0, 3, 2, 1]] if r.integers(2) else v[[2, 1, 0, 3]]
                    if dtype is np.int32:  # (bin_lo, bin_hi, off_lo, off_hi)
                        v = v[[1, 0, 2, 3]] if v[0] < v[1] else v
                elif kind == "nan":
                    v[r.integers(4)] = np.nan
                elif kind == "inf":
                    v[r.choice([0, 1])] = -np.inf
                    v[r.choice([2, 3])] = np.inf
                p[k, o:o + 4] = v
                live[k] |= kind in ("live", "inf")
        blocks.append(p)
        counts.append(int(live.sum()))
    return blocks[0], blocks[1], tuple(counts)


def _staging_case(case):
    """(boxes, wins, P1 counts, P2 box count) of a named or seeded case."""
    if isinstance(case, int):
        boxes, wins, counts = _seeded_blocks(case)
        wide = (boxes[:, 0] <= boxes[:, 2]) & (boxes[:, 1] <= boxes[:, 3])
        return boxes, wins, counts, int(wide.sum())
    boxes, wins = tpp.staging_cases()[case]
    return (boxes, wins, *STAGING_COUNTS[case])


def _first(block, n):
    """``block`` with its slots from ``n`` on made pads (a kernel that loops
    over the first n slots sees this)."""
    out = block.copy()
    pad = _PAD_HALF[np.float32 if block.dtype == np.float32 else np.int32]
    out[n:, 0:4] = pad
    out[n:, 4:8] = pad
    return out


@pytest.mark.parametrize("case", sorted(STAGING_COUNTS) + [1, 2, 3])
def test_live_slot_staging_equals_jax_probes(jprobes, columns, jax_p2_fns, case):
    """The probes' params with each leg's live slots first (pads, inverted,
    NaN and infinite slots, one plane live, all 8 live, a leg with none,
    and seeded mixes): (a) the plain versions on the staged blocks equal
    the JAX probes (Pallas, interpret mode) on the original blocks, for
    P1's planes, P2's bounds and both density bodies; (b) the counts are
    the live slots; (c) the plain versions over the first ``count`` slots
    alone equal them over all 8."""
    boxes, wins, counts, p2_count = _staging_case(case)
    sb, sw, got_counts = tpk.live_slots(boxes, wins)
    assert tuple(got_counts.tolist()) == counts
    jw, ji = _jax_p1(jprobes[0], columns, P1_BIDS, boxes, wins)
    for b, w in ((sb, sw), (_first(sb, counts[0]), _first(sw, counts[1]))):
        pw, pi = tpk.probe_scan_plain(*_t(columns), torch.from_numpy(P1_BIDS),
                                      torch.from_numpy(b), torch.from_numpy(w))
        assert np.array_equal(pw.numpy(), jw) and np.array_equal(pi.numpy(), ji)
    if case in ("pads", "inverted", "inf", "one_plane", "all8"):
        assert jw.any()
    # P2 reads the boxes' lanes 0-3 alone
    no_wins = tbk.pack_windows(None, None)
    b2, _, c2 = tpk.live_slots(boxes, no_wins, planes=1)
    assert c2.tolist() == [p2_count, 0]
    x, y = columns[:2]
    gb = _gb(P2_BOX)
    with pltpu.force_tpu_interpret_mode():
        want = {k: np.asarray(fn(P2_BIDS, boxes, gb, x, y)) for k, fn in jax_p2_fns.items()}
    bids_t = torch.from_numpy(P2_BIDS)
    for b in (b2, _first(b2, p2_count)):
        bt = torch.from_numpy(b)
        assert np.array_equal(tpk.probe_bounds_plain(*_t((x, y)), bids_t, bt).numpy(),
                              want["bounds"])
        grid = tpk.probe_density_plain(*_t((x, y)), bids_t, bt, torch.from_numpy(gb[0, :4]),
                                       tpa.H, tpa.W).numpy()
        assert np.array_equal(grid, want["reshape"]) and np.array_equal(grid, want["fori"])


def _masks_header_extra() -> int:
    """GM_EXTRA(0) of csrc/masks.cuh: the first word after the slot counts
    of a one-query params buffer with no bids."""
    import re

    text = open(os.path.join(ROOT, "geomesa_tpu_torch", "csrc", "masks.cuh")).read()
    slots = int(re.search(r"#define GM_SLOTS (\d+)", text).group(1))
    expr = re.search(r"#define GM_EXTRA\(m\) (.+)", text).group(1)
    return eval(expr.replace("(m)", "0").replace("GM_SLOTS", str(slots)))  # noqa: S307


@pytest.mark.parametrize("m", [1, 6, 257])
def test_stage_probe_writes_counts_where_masks_reads_them(m):
    """The staged params (what the launchers copy to the card) hold the
    bids, each leg's live slots first in lanes 0-7, the two live counts
    in words GM_EXTRA(m) - 2 and - 1 as csrc/masks.cuh reads them, then
    the density envelope."""
    boxes, wins = tpp.staging_cases()["one_plane"]
    bids = np.arange(m, dtype=np.int32) % 3
    gb = np.array([-40, -30, 60, 40], np.float32)
    extra = m + _masks_header_extra()
    for planes, counts in ((2, [2, 2]), (1, [1, 1])):
        staged = tpk.stage_probe(bids, boxes, wins, gb, planes=planes)
        sb, sw, _ = tpk.live_slots(boxes, wins, planes)
        assert staged.dtype == np.int32 and len(staged) == extra + 4
        assert np.array_equal(staged[:m], bids)
        assert np.array_equal(staged[m:m + 64].view(np.float32), sb[:, :8].ravel())
        assert np.array_equal(staged[m + 64:m + 128], sw[:, :8].ravel())
        assert staged[extra - 2:extra].tolist() == counts
        assert np.array_equal(staged[extra:].view(np.float32), gb)


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
