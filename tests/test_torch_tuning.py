"""The port's self-tuning tier (geomesa_tpu_torch.tuning) and its CLI
(geomesa_tpu_torch/cli.py) against the JAX package's, on the CPU.

Mirrors the cases of tests/test_tuning.py as parity: the shared
primitives and the three measured-cost gates (tile compose, adaptive
join, standing match) and the link ladder make the same decisions in
both packages on the same seeded inputs; a disarmed tier leaves plans,
explains (less timings) and ids as a store without it; the reweighter's
factors, the knob controllers' proposals, the manager's decision records,
the burn gate's sheds and the state file equal the JAX package's on the
same readings (the managers are driven with seeded counter and histogram
readings, never wall-clock timings); a corrupt state file means
relearning; the report's shape.

The CLI: every command of tests/test_io.py's CLI cases and
tests/test_ops.py's ``ops`` case, plus ``tune``, ``playback``, ``tile``,
``sql``, ``stats-analyze`` and ``convert``, runs under both packages'
``main`` over catalogs built the same way (the port's with ``--device
cpu``), and stdout equals the JAX CLI's (paths to each side's own
catalog normalized); ``version`` and ``env`` name the port and torch.
Without a card and without ``--device cpu`` the port's CLI raises as
``DataStore(device="cuda")`` does.

Tolerance: exact (decisions, factors rounded as the records round them,
state JSON, stdout).
"""

import json
import os
import time

import numpy as np
import pytest

from test_torch_native import ensure_jax_native
from test_torch_serving_tier import BOTH, JAX, PORT

DAY = 86_400_000
Q = "bbox(geom, -10, -10, 10, 10)"
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
_TUNED_KNOBS = ("CACHE_MIN_COST", "SCAN_FUSED_SLOTS", "STREAM_FOLD_SLICE_ROWS", "STREAM_CHUNK_ROWS")


def _mod(P, name):
    from importlib import import_module

    return import_module(f"{P.name}.{name}")


@pytest.fixture(autouse=True)
def _clean_tuned_state():
    """Armed controllers write through each package's conf: every test
    leaves the steered knobs and the link constants as it found them."""
    ensure_jax_native()
    for P in BOTH:
        P.obs.install(P.obs.Tracer())
    yield
    for P in BOTH:
        for name in _TUNED_KNOBS:
            getattr(P.conf, name).clear()
        _mod(P, "scan.block_kernels").set_link_constants(None)
        P.obs.install(P.obs.Tracer())


def _mkstore(P, metrics=None, cache=None, n=512, seed=7):
    sft = P.pkg.FeatureType.from_spec("ev", "kind:String:index=true,dtg:Date,*geom:Point:srid=4326")
    ds = P.pkg.DataStore(tile=64, metrics=metrics, cache=cache, **P.kw)
    ds.create_schema(sft)
    rng = np.random.default_rng(seed)
    ds.write("ev", P.pkg.FeatureCollection.from_columns(
        sft, [str(i) for i in range(n)],
        {"kind": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
         "dtg": T0 + rng.integers(0, 20 * DAY, n),
         "geom": (rng.uniform(-60, 60, n), rng.uniform(-45, 45, n))},
    ))
    return ds


def _reg(P):
    return P.metrics.MetricsRegistry()


# -- 1. the shared primitives and the gates --------------------------------


def test_primitives_equal():
    jp, tp = _mod(JAX, "tuning.primitives"), _mod(PORT, "tuning.primitives")
    rng = np.random.default_rng(3)
    a = b = None
    for s in rng.uniform(1e-4, 2.0, 500):
        a, b = jp.ewma_step(a, s), tp.ewma_step(b, s)
        assert a == b
    ga, gb = jp.ProbeGate(explore_min=3, reprobe_every=4), tp.ProbeGate(explore_min=3, reprobe_every=4)
    for _ in range(3):
        ga.note_trial()
        gb.note_trial()
    assert [ga.block() for _ in range(9)] == [gb.block() for _ in range(9)] == [
        False, False, False, True, False, False, False, True, False]
    ea, eb = jp.CostEwma(), tp.CostEwma()
    for secs, units in ((1.0, 0), (0.0, 10), (2.0, 4), (0.3, 7)):
        assert ea.update_cost(secs, units) == eb.update_cost(secs, units)
    for want in (0.0, 256.0, 256.0001, 1e9, 1000.0):
        assert jp.doubling_ladder(want, 256, 2048) == tp.doubling_ladder(want, 256, 2048)


def _drive_tiles_gate(P):
    gen = _mod(P, "cache.generations")
    tiles = _mod(P, "cache.tiles")
    cache = tiles.TileAggregateCache(tiles.TileCacheConf(), gen.GenerationTracker(), metrics=_reg(P))
    rng = np.random.default_rng(11)
    out = []
    for _ in range(400):
        t = ("a", "b")[rng.integers(0, 2)]
        op = rng.integers(0, 3)
        if op == 0:
            cache.note_scan(t, float(rng.uniform(0.2, 1.0)))
        elif op == 1:
            cache._note_compose(t, float(rng.uniform(0.2, 2.0)))
        else:
            out.append((t, cache.worth_composing(t)))
    return out


def _drive_join_gate(P):
    gate = _mod(P, "sql.join")._AdaptiveGate()
    rng = np.random.default_rng(13)
    out = []
    for k in range(305):
        if k >= 5 and rng.integers(0, 2):
            kind = ("pip_s", "cls_s")[rng.integers(0, 2)]
            gate.update(kind, float(rng.uniform(-0.1, 0.5)), int(rng.integers(0, 1_000_000)))
        else:
            out.append(gate.pick(int(rng.integers(1, 10_000)), int(rng.integers(3, 400)),
                                 float(rng.uniform(0.0, 1.0))))
    return out


def _drive_match_gate(P):
    gate = _mod(P, "streaming.standing")._MatchGate()
    rng = np.random.default_rng(17)
    hu = rng.integers(1, 1_000_000, 32).astype(np.float64)
    fu = rng.integers(1, 1_000_000, 32).astype(np.float64)
    out = [gate.pick(hu, fu)]
    for _ in range(200):
        kind = ("host_s", "fused_s")[rng.integers(0, 2)]
        gate.update(kind, float(rng.uniform(0.0, 0.2)), int(rng.integers(0, 5_000_000)))
        m = gate.pick(hu, fu)
        out.append(None if m is None else np.asarray(m).tolist())
    return out


@pytest.mark.parametrize("drive", [_drive_tiles_gate, _drive_join_gate, _drive_match_gate],
                         ids=["tiles", "join", "standing"])
def test_gate_decisions_equal(drive):
    a, b = drive(JAX), drive(PORT)
    assert a == b
    flat = [d[1] if isinstance(d, tuple) else d for d in a]
    assert len({json.dumps(d) for d in flat}) >= 2  # both branches exercised


def test_link_ladder_equal():
    jb, tb = _mod(JAX, "scan.block_kernels"), _mod(PORT, "scan.block_kernels")
    from geomesa_tpu_torch.storage.table import FUSED_CHUNK_SLOTS

    sweep = [1e-6, 1e-3, 0.01, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0, 10.0, 20.0, 40.0, 100.0, 1e6]
    target = 256
    while target <= FUSED_CHUNK_SLOTS:
        rtt = target * tb.DESIGN_LINK_RTT_MS / FUSED_CHUNK_SLOTS
        sweep += [rtt, rtt * (1 - 1e-9), rtt * (1 + 1e-9)]
        target *= 2
    for rtt in sweep:
        for mb in (None, 100.0, 300.0):
            assert tb.derive_link_constants(rtt, mb) == jb.derive_link_constants(rtt, mb), rtt
    # an untuned store keeps the compiled shapes; a profile moves the
    # slot cap and the single-query M floor in both packages alike
    assert tb.link_constants() == jb.link_constants()
    assert tb.fused_slot_cap() == jb.fused_slot_cap() == FUSED_CHUNK_SLOTS
    assert [tb.m_bucket_of(n) for n in (0, 1, 40, 129, 5000)] == \
        [jb.m_bucket_of(n) for n in (0, 1, 40, 129, 5000)]
    for b in (jb, tb):
        b.set_link_constants(b.derive_link_constants(0.4))
    assert tb.link_constants() == jb.link_constants()
    assert tb.fused_slot_cap() == jb.fused_slot_cap() == 256
    assert tb.fused_slot_cap(512) == jb.fused_slot_cap(512) == 512
    assert [tb.m_bucket_of(n) for n in (0, 1, 40, 129)] == [128, 128, 128, 256]
    assert tb.pad_bids(np.arange(3), 100)[0].shape == jb.pad_bids(np.arange(3), 100)[0].shape
    for P in BOTH:
        P.conf.SCAN_FUSED_SLOTS.set(1024)
    assert tb.fused_slot_cap(512) == jb.fused_slot_cap(512) == 1024


def test_table_fused_slots_follow_the_seam():
    stores = [_mkstore(P, n=3000) for P in BOTH]
    tabs = [ds.table("ev", "z2") for ds in stores]
    assert tabs[1].fused_slots == tabs[0].fused_slots
    for P in BOTH:
        P.conf.SCAN_FUSED_SLOTS.set(32)
    assert tabs[1].fused_slots == tabs[0].fused_slots == 32
    for P, ds in zip(BOTH, stores):
        ds.close()


# -- 2. disarmed == no tier --------------------------------------------------


@pytest.mark.parametrize("P", BOTH, ids=["jax", "port"])
def test_disarmed_is_bit_identical(P):
    plain = _mkstore(P, metrics=_reg(P))
    tuned = _mkstore(P, metrics=_reg(P))
    mgr = tuned.attach_tuning()
    assert mgr.enabled is False and tuned.planner.reweighter is None
    knobs = {s.knob: P.conf.REGISTRY[s.knob].get()
             for s in _mod(P, "tuning.controllers").CONTROLLER_SPECS}
    for f in (Q, "kind = 'a'", "bbox(geom, 0, 0, 50, 40) AND kind = 'b'"):
        e1, e2 = P.explain.Explainer(), P.explain.Explainer()
        r1 = plain.query("ev", f, explain=e1)
        r2 = tuned.query("ev", f, explain=e2)
        assert r1.ids.tolist() == r2.ids.tolist()
        strip = lambda exp: [ln for ln in exp.lines if "ms" not in ln]  # noqa: E731
        assert strip(e1) == strip(e2)
    assert mgr.report()["pulses"] == 0
    assert tuned.metrics.counter_value("geomesa.tuning.pulse") == 0
    assert knobs == {k: P.conf.REGISTRY[k].get() for k in knobs}
    plain.close()
    tuned.close()


def test_disarmed_port_equals_the_jax_package():
    jd, td = (_mkstore(P, metrics=_reg(P)) for P in BOTH)
    for ds in (jd, td):
        ds.attach_tuning()
    for f in (Q, "kind = 'a'", "bbox(geom, 0, 0, 50, 40) AND kind = 'b'"):
        assert td.query("ev", f).ids.tolist() == jd.query("ev", f).ids.tolist()
    assert {k: v for k, v in td.tuning_report().items() if k != "controllers"} == \
        {k: v for k, v in jd.tuning_report().items() if k != "controllers"}
    jd.close()
    td.close()


def test_rearm_and_disarm_restore_hooks():
    for P in BOTH:
        ds = _mkstore(P, metrics=_reg(P))
        sched = ds.serve()
        try:
            armed = ds.attach_tuning(enabled=True)
            assert ds.planner.reweighter is armed.reweighter
            assert sched.burn_gate is armed.burnshed
            disarmed = ds.attach_tuning(enabled=False)
            assert ds.tuning is disarmed and ds.planner.reweighter is None
            assert sched.burn_gate is None
            # an armed tier attached before serve() wires its gate onto
            # the fresh scheduler
            sched.close()
            armed = ds.attach_tuning(enabled=True)
            assert ds.serve().burn_gate is armed.burnshed
        finally:
            sched.close()
            ds.close()


# -- 3a. plan-feedback reweighting -----------------------------------------


def _reweight_trail(P):
    acc = _mod(P, "obs.accuracy").EstimateAccuracy()
    rw = _mod(P, "tuning.reweight").IndexReweighter(acc, max_adjust=4.0, deadband=2.0,
                                                    step=0.5, min_count=8)
    trail = []

    def feed(n, est, act):
        for _ in range(n):
            acc.record("ev", "z2", est, act)

    def pulses(k):
        for _ in range(k):
            trail.append(rw.pulse())
            trail.append(rw.factors())

    feed(7, 29, 9)
    pulses(1)
    feed(3, 29, 9)
    pulses(6)
    feed(150, 5, 4)
    feed(50, 7, 4)
    pulses(2)
    feed(2000, 9, 9)
    pulses(8)
    return trail, rw.snapshot()


def test_reweighter_convergence_and_hysteresis():
    a, b = _reweight_trail(JAX), _reweight_trail(PORT)
    assert a == b
    moves = [d["to"] for step in b[0][::2] for d in step]
    assert moves == [1.5, 2.25, 3.375, 4.0, 2.6667, 1.7778, 1.1852, 1.0]
    assert b[1] == []


def test_reweight_factor_shows_in_plan_explain():
    lines = []
    for P in BOTH:
        ds = _mkstore(P, metrics=_reg(P))
        try:
            mgr = ds.attach_tuning(enabled=True)
            e1 = P.explain.Explainer()
            ds.query("ev", Q, explain=e1)
            [strat] = [ln for ln in e1.lines if ln.strip().startswith("Strategy:")]
            chosen = strat.split()[1]
            assert not any("estimate-accuracy reweight" in ln for ln in e1.lines)
            mgr.reweighter.restore([["ev", chosen, 2.0]])
            e2 = P.explain.Explainer()
            ds.query("ev", Q, explain=e2)
            lines.append([ln for ln in e2.lines if "ms" not in ln])
            assert any(f"Index {chosen}: estimate-accuracy reweight x2.00" in ln for ln in e2.lines)
        finally:
            ds.close()
    assert lines[0] == lines[1]


# -- 3b. knob controllers ----------------------------------------------------


def _controller_trail(P, name, steps):
    c = _mod(P, "tuning.controllers")
    spec = next(s for s in c.CONTROLLER_SPECS if s.name == name)
    ctl = c.KnobController(spec)
    out = []
    for current, reading in steps:
        out.append(ctl.propose(current, reading))
        out.append(ctl.snapshot())
    other = c.KnobController(spec)
    other.restore(ctl.snapshot())
    other.restore({"dir": 5})
    out.append(other.snapshot())
    return out


@pytest.mark.parametrize("name,steps", [
    ("fold_slice_rows", [(65536.0, 1.0), (65536.0, 0.5), (8192.0, 0.56), (71680.0, 0.57),
                         (8192.0, 100.0), (8192.0, 10.0)]),
    ("cache_min_cost", [(0.04, 100.0), (0.04, 101.0), (0.04, 10.0), (0.0275, 12.0),
                        (0.0275, 200.0)]),
    ("flush_chunk_rows", [(65536.0, 1e5), (65536.0, 2e5), (126976.0, 1e5), (65536.0, 1e4)]),
])
def test_knob_controllers_equal(name, steps):
    assert _controller_trail(JAX, name, steps) == _controller_trail(PORT, name, steps)
    specs = [_mod(P, "tuning.controllers").CONTROLLER_SPECS for P in BOTH]
    assert [vars(s) for s in specs[0]] == [vars(s) for s in specs[1]]


def _steer_cache(P, tmp_path):
    reg = _reg(P)
    ds = _mkstore(P, metrics=reg, cache=True)
    try:
        P.conf.CACHE_MIN_COST.set(0.04)
        path = str(tmp_path / f"{P.name}.json")
        mgr = ds.attach_tuning(enabled=True, interval=1, state_path=path)
        out = []
        for hits in (100, 100, 10, 10, 60, 5):
            reg.counter("geomesa.cache.hit", hits)
            out.append(mgr.pulse())
        out.append(ds.cache.result.conf.min_cost_s)
        out.append(P.conf.CACHE_MIN_COST.get())
        out.append(reg.counter_value("geomesa.tuning.adjust"))
        out.append(reg.counter_value("geomesa.tuning.pulse"))
        rep = mgr.report()
        rep["controllers"] = [{k: v for k, v in r.items() if k != "value" or r["name"] != "fused_chunk_slots"}
                              for r in rep["controllers"]]
        out.append(rep)
    finally:
        ds.close()
    out.append(json.load(open(path)))
    return out


def test_manager_pulse_steers_cache_min_cost(tmp_path):
    a, b = _steer_cache(JAX, tmp_path), _steer_cache(PORT, tmp_path)
    assert a == b
    [d] = [d for d in b[2] if d["controller"] == "cache_min_cost"]
    assert d["from"] == pytest.approx(0.04) and d["to"] == pytest.approx(0.0275)


def _derive(P):
    bk = _mod(P, "scan.block_kernels")
    reg = _reg(P)
    ds = _mkstore(P, metrics=reg)
    out = []
    try:
        mgr = ds.attach_tuning(enabled=True)
        out.append(mgr.pulse())
        bk.set_link_constants(bk.derive_link_constants(20.0))
        out.append(mgr.pulse())
        out.append(P.conf.SCAN_FUSED_SLOTS.get())
        P.conf.SCAN_FUSED_SLOTS.set(256)
        out.append(mgr.pulse())
        out.append(P.conf.SCAN_FUSED_SLOTS.get())
        out.append(reg.gauges.get("geomesa.tuning.link.rtt"))
        out.append(ds.table("ev", "z2").fused_slots)
    finally:
        ds.close()
    return out


def test_manager_derive_controller_follows_link_rtt():
    a, b = _derive(JAX), _derive(PORT)
    assert a == b
    assert b[0] == [] and b[1] == [] and b[2] == 0
    [d] = b[3]
    assert d["controller"] == "fused_chunk_slots" and d["to"] == b[4]


# -- 3c. SLO-burn admission shedding ---------------------------------------


class _StubSlo:
    def __init__(self):
        self.burn = 0.0

    def report(self, now=None):
        return {"objectives": [{"objective": "query_p99", "burn_rate": self.burn}]}


class _StubStore:
    def __init__(self, weights):
        class _T:
            def weights(self):
                return dict(weights)

        class _S:
            tenants = _T()

        self.slo = _StubSlo()
        self.scheduler = _S()


def _burn_trail(P, weights, steps):
    store = _StubStore(weights)
    gate = _mod(P, "tuning.burnshed").BurnShed(store, threshold=2.0, release=1.0)
    out = []
    for k, (burn, tenant) in enumerate(steps):
        store.slo.burn = burn
        out.append(gate.should_shed(tenant, now=float(k)))
        out.append(gate.report())
    return out


@pytest.mark.parametrize("weights,steps", [
    ({"gold": 8.0, "bronze": 1.0},
     [(0.0, "bronze"), (3.0, "bronze"), (3.0, "gold"), (3.0, "nobody"), (3.0, None),
      (1.5, "bronze"), (0.9, "bronze"), (1.5, "bronze"), (4.0, "bronze")]),
    ({"a": 1.0, "b": 1.0}, [(50.0, "a"), (50.0, "b"), (0.5, "a")]),
], ids=["tiers", "uniform"])
def test_burn_shed_equal(weights, steps):
    a, b = _burn_trail(JAX, weights, steps), _burn_trail(PORT, weights, steps)
    assert a == b
    if "gold" in weights:
        assert b[2] is not None and "slo burn 3.00x" in b[2] and b[4] is None
    else:
        assert b[0] is None and b[1]["engaged"] is True


def test_burn_shed_engages_before_queue_full_and_releases():
    for P in BOTH:
        reg = _reg(P)
        ds = _mkstore(P, metrics=reg)
        ds.slo = _mod(P, "obs.slo").SloTracker(window_s=0.6)
        tenants = P.tenancy.TenantRegistry(metrics=reg)
        tenants.configure("gold", weight=8.0)
        tenants.configure("bronze", weight=1.0)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(queue_max=64),
                                         metrics=reg, tenants=tenants)
        ds.scheduler = sched
        try:
            mgr = ds.attach_tuning(enabled=True)
            assert sched.burn_gate is mgr.burnshed
            for _ in range(60):
                ds.slo.observe("geomesa.query.scan", 60.0)
            mgr.pulse()
            assert mgr.burnshed.report()["engaged"]
            shed = sched.submit("ev", Q, block=False, tenant="bronze")
            with pytest.raises(P.serving.ServingRejected, match="slo burn"):
                shed.result(timeout=5)
            assert reg.counter_value("geomesa.tuning.shed") == 1
            assert not sched.submit("ev", Q, block=False, tenant="gold").done()
            time.sleep(1.0)
            mgr.pulse()
            assert not mgr.burnshed.report()["engaged"]
            assert not sched.submit("ev", Q, block=False, tenant="bronze").done()
            assert reg.counter_value("geomesa.tuning.shed") == 1
        finally:
            sched.close()
            ds.close()


# -- 4. persistence ----------------------------------------------------------


def _state_round_trip(P, tmp_path):
    path = str(tmp_path / f"{P.name}_tuning.json")
    ds1 = _mkstore(P, metrics=_reg(P))
    mgr1 = ds1.attach_tuning(enabled=True, state_path=path)
    mgr1.reweighter.restore([["ev", "z2", 2.25]])
    mgr1.controllers["cache_min_cost"].restore({"last": 5.0, "best": 9.0, "dir": 1})
    P.conf.CACHE_MIN_COST.set(0.03)
    ds1.close()
    text = open(path).read()
    P.conf.CACHE_MIN_COST.clear()
    ds2 = _mkstore(P, metrics=_reg(P))
    mgr2 = ds2.attach_tuning(enabled=True, state_path=path)
    out = [text, mgr2.reweighter.factor("ev", "z2"),
           mgr2.controllers["cache_min_cost"].snapshot(), P.conf.CACHE_MIN_COST.get()]
    ds2.close()
    return out


def test_state_survives_close_and_reopen(tmp_path):
    a, b = _state_round_trip(JAX, tmp_path), _state_round_trip(PORT, tmp_path)
    assert a == b  # the state file byte for byte
    assert json.loads(b[0])["factors"] == [["ev", "z2", 2.25]]
    assert b[1:] == [2.25, {"last": 5.0, "best": 9.0, "dir": 1}, pytest.approx(0.03)]


def test_corrupt_state_file_means_relearning_not_failing(tmp_path):
    path = tmp_path / "_tuning.json"
    path.write_text("{this is not json", encoding="utf-8")
    for P in BOTH:
        ds = _mkstore(P, metrics=_reg(P))
        mgr = ds.attach_tuning(enabled=True, state_path=str(path))
        assert mgr.reweighter.factors() == {} and mgr.pulse() == []
        ds.close()


def test_tuning_report_shapes():
    reps = []
    for P in BOTH:
        ds = _mkstore(P, metrics=_reg(P))
        try:
            bare = ds.tuning_report()
            mgr = ds.attach_tuning(enabled=True)
            rep = ds.tuning_report()
            assert rep["interval"] == mgr.interval
            assert {r["name"] for r in rep["controllers"]} == \
                {s.name for s in _mod(P, "tuning.controllers").CONTROLLER_SPECS}
            for row in rep["controllers"]:
                assert row["lo"] < row["hi"] and row["knob"] in P.conf.REGISTRY
            reps.append((bare, rep))
        finally:
            ds.close()
    assert reps[0] == reps[1]
    assert reps[1][1]["burn"]["objective"] == "query_p99"


def test_debug_tuning_route_serves_the_report():
    import urllib.request

    bodies = []
    for P in BOTH:
        ds = _mkstore(P, metrics=_reg(P))
        try:
            ds.attach_tuning(enabled=True)
            srv = ds.serve_ops()
            with urllib.request.urlopen(srv.url + "/debug/tuning", timeout=10) as r:
                bodies.append(json.loads(r.read()))
        finally:
            ds.close()
    assert bodies[0] == bodies[1] and bodies[1]["enabled"] is True


# -- the CLI -------------------------------------------------------------------


def _cli(P):
    return _mod(P, "cli")


def _run(P, capsys, argv, root):
    """One CLI call; returns (rc, stdout, stderr) with the catalog root
    written as <root>."""
    extra = ["--device", "cpu"] if P is PORT else []
    rc = _cli(P).main(list(argv) + extra)
    cap = capsys.readouterr()
    return rc, cap.out.replace(str(root), "<root>"), cap.err.replace(str(root), "<root>")


def _both_cli(capsys, tmp_path, argv_of):
    """Run ``argv_of(root)`` under both CLIs, each in its own root."""
    out = []
    for P in BOTH:
        root = tmp_path / P.name
        root.mkdir(exist_ok=True)
        out.append(_run(P, capsys, argv_of(root), root))
    return out


CSV = "name,lon,lat\nalpha,1.5,2.5\nbeta,3.5,4.5\n"
CONVERTER = {
    "format": "delimited", "skip-lines": 1,
    "fields": [{"name": "name", "transform": "$1"},
               {"name": "geom", "transform": "point($2, $3)"}],
}


def _points_catalog(tmp_path, capsys, n=400):
    """A catalog per package with the same rows, saved by each package."""
    for P in BOTH:
        root = tmp_path / P.name
        ds = P.pkg.DataStore(tile=64, **P.kw)
        sft = P.pkg.FeatureType.from_spec("t", "name:String,dtg:Date,*geom:Point:srid=4326")
        ds.create_schema(sft)
        rng = np.random.default_rng(4)
        ds.write("t", P.pkg.FeatureCollection.from_columns(
            sft, [f"f{i}" for i in range(n)],
            {"name": np.array([f"n{i % 5}" for i in range(n)]),
             "dtg": T0 + rng.integers(0, 10 * DAY, n),
             "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n))}))
        _mod(P, "storage.persist").save(ds, str(root / "cat"))


@pytest.mark.parametrize("argv", [
    ["get-type-names"], ["describe-schema", "-f", "t"], ["count", "-f", "t"],
    ["count", "-f", "t", "-q", "bbox(geom,0,0,50,50)"],
    ["explain", "-f", "t", "-q", "bbox(geom,0,0,5,5)"],
    ["export", "-f", "t", "-q", "bbox(geom,0,0,30,30)", "--format", "csv"],
    ["export", "-f", "t", "-q", "bbox(geom,0,0,30,30)", "--format", "geojson", "-m", "5"],
    ["export", "-f", "t", "--format", "wkt", "-q", "name = 'n1'"],
    ["export", "-f", "t", "--format", "geojson", "--reproject", "EPSG:3857", "-m", "3"],
    ["stats", "-f", "t", "--spec", "Count()"],
    ["stats", "-f", "t", "--spec", "MinMax(dtg)", "-q", "bbox(geom,-50,-50,50,50)"],
    ["stats-analyze", "-f", "t"],
    ["sql", "SELECT name FROM t WHERE st_contains(st_makeBBOX(0,0,40,40), geom)"],
    ["playback", "-f", "t", "-q", "bbox(geom,0,0,40,40)", "--batch-size", "20"],
    ["ops", "--slow", "3"], ["ops", "--json"],
    ["tune"], ["tune", "--json"],
], ids=lambda a: "-".join(a[:2]))
def test_cli_read_commands_print_what_the_jax_cli_prints(argv, tmp_path, capsys):
    _points_catalog(tmp_path, capsys)

    def args(root):
        return [argv[0], "-c", str(root / "cat")] + argv[1:]

    (ja, jo, je), (ta, to, te) = _both_cli(capsys, tmp_path, args)
    assert ja == ta == 0, (je, te)
    if argv[0] == "playback":
        # the wall time of the replay is measured
        jo, to = (o.rsplit("playback done", 1)[0] for o in (jo, to))
    assert to == jo
    assert to.strip()


def test_cli_tile_writes_the_same_png(tmp_path, capsys):
    _points_catalog(tmp_path, capsys)
    pngs = []
    for kind, fresh in (("density", []), ("heat", ["--fresh"]), ("count", [])):
        out = _both_cli(capsys, tmp_path, lambda root: [
            "tile", "-c", str(root / "cat"), "-f", "t", "1", "1", "0", "--kind", kind,
            "-o", str(root / f"{kind}.png")] + fresh)
        assert out[0][0] == out[1][0] == 0 and out[0][1] == out[1][1]
        pngs.append([(tmp_path / P.name / f"{kind}.png").read_bytes() for P in BOTH])
    for a, b in pngs:
        assert a == b and a[:8] == b"\x89PNG\r\n\x1a\n"
    bad = _both_cli(capsys, tmp_path, lambda root: [
        "tile", "-c", str(root / "cat"), "-f", "t", "0", "0", "0", "--kind", "viridis"])
    assert bad[0] == bad[1] and bad[1][0] == 1


def test_cli_catalog_lifecycle(tmp_path, capsys):
    """tests/test_io.py's create / ingest / export / stats cases."""
    for P in BOTH:
        (tmp_path / P.name).mkdir()
        (tmp_path / P.name / "obs.csv").write_text(CSV)
        (tmp_path / P.name / "conv.json").write_text(json.dumps(CONVERTER))
    steps = [
        lambda r: ["ingest", "-c", str(r / "cat"), "-f", "obs", "--infer", "--header",
                   str(r / "obs.csv")],
        lambda r: ["get-type-names", "-c", str(r / "cat")],
        lambda r: ["describe-schema", "-c", str(r / "cat"), "-f", "obs"],
        lambda r: ["count", "-c", str(r / "cat"), "-f", "obs"],
        lambda r: ["explain", "-c", str(r / "cat"), "-f", "obs", "-q", "bbox(geom,0,0,5,5)"],
        lambda r: ["export", "-c", str(r / "cat"), "-f", "obs", "--format", "geojson",
                   "-o", str(r / "out.geojson")],
        lambda r: ["stats", "-c", str(r / "cat"), "-f", "obs", "--spec", "Count()"],
        lambda r: ["create-schema", "-c", str(r / "cat"), "-f", "s", "-s",
                   "name:String,*geom:Point:srid=4326"],
        lambda r: ["ingest", "-c", str(r / "cat"), "-f", "s", "--converter",
                   str(r / "conv.json"), str(r / "obs.csv"), str(r / "obs.csv")],
        lambda r: ["ingest", "-c", str(r / "cat"), "-f", "s", "--converter",
                   str(r / "conv.json"), "--workers", "2", str(r / "obs.csv")],
        lambda r: ["count", "-c", str(r / "cat"), "-f", "s"],
        lambda r: ["export", "-c", str(r / "cat"), "-f", "s", "--format", "csv"],
        lambda r: ["delete-schema", "-c", str(r / "cat"), "-f", "s"],
        lambda r: ["get-type-names", "-c", str(r / "cat")],
    ]
    for step in steps:
        (ja, jo, je), (ta, to, te) = _both_cli(capsys, tmp_path, step)
        assert ja == ta == 0, (step(tmp_path), je, te)
        assert to == jo, step(tmp_path)
    docs = [json.loads((tmp_path / P.name / "out.geojson").read_text()) for P in BOTH]
    assert docs[0] == docs[1] and len(docs[1]["features"]) == 2


def test_cli_convert_and_file_ingest(tmp_path, capsys):
    for P in BOTH:
        d = tmp_path / P.name
        d.mkdir()
        for stem in ("a", "b"):
            (d / f"{stem}.csv").write_text("x,1,2\ny,3,4\n")
        (d / "bad.csv").write_text("only-one-column\n")
        (d / "c.json").write_text(json.dumps({
            "format": "delimited",
            "fields": [{"name": "name", "transform": "$1"},
                       {"name": "geom", "transform": "point($2, $3)"}]}))
        for stem, vals in (("g1", [1.5, 2.5]), ("g2", [3, 4])):
            (d / f"{stem}.geojson").write_text(json.dumps({
                "type": "FeatureCollection",
                "features": [{"type": "Feature",
                              "geometry": {"type": "Point", "coordinates": [i, i]},
                              "properties": {"v": v}} for i, v in enumerate(vals)]}))
    cases = [
        (lambda r: ["convert", "-s", "name:String,*geom:Point:srid=4326", "--converter",
                    str(r / "c.json"), "--format", "geojson", str(r / "a.csv"),
                    str(r / "b.csv")], 0),
        (lambda r: ["convert", "-s", "name:String,*geom:Point:srid=4326", "--converter",
                    str(r / "c.json"), str(r / "bad.csv"), str(r / "bad.csv")], 1),
        (lambda r: ["ingest", "-c", str(r / "cat"), "-f", "mix", "--file-format", "geojson",
                    str(r / "g1.geojson"), str(r / "g2.geojson")], 0),
        (lambda r: ["export", "-c", str(r / "cat"), "-f", "mix", "--format", "csv"], 0),
    ]
    for argv_of, want in cases:
        (ja, jo, je), (ta, to, te) = _both_cli(capsys, tmp_path, argv_of)
        assert ja == ta == want, (je, te)
        assert to == jo and te == je


def test_cli_tune_reads_the_state_a_store_saved(tmp_path, capsys):
    """``close()`` writes ``_tuning.json`` beside the catalog and ``tune``
    reports from it."""
    _points_catalog(tmp_path, capsys)
    for P in BOTH:
        root = tmp_path / P.name / "cat"
        ds = _mod(P, "storage.persist").load(str(root), **P.kw)
        mgr = ds.attach_tuning(enabled=True, state_path=str(root / "_tuning.json"))
        mgr.reweighter.restore([["t", "z3", 1.5]])
        ds.close()
    for argv in (["tune"], ["tune", "--json"]):
        (ja, jo, _), (ta, to, _) = _both_cli(
            capsys, tmp_path, lambda r: [argv[0], "-c", str(r / "cat")] + argv[1:])
        assert ja == ta == 0 and to == jo
        assert "t/z3" in to


def test_cli_version_and_env_name_the_port(capsys):
    assert _cli(PORT).main(["version"]) == 0
    assert capsys.readouterr().out.strip() == "geomesa_tpu_torch 0.1.0"
    assert _cli(PORT).main(["env", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu" and out[1].startswith("torch: ")
    assert "geomesa.serve.page.rows = 4096" in "\n".join(out)
    assert "geomesa.tuning.enabled = False" in "\n".join(out)


def test_cli_defaults_to_the_card(tmp_path, capsys, monkeypatch):
    import torch

    _points_catalog(tmp_path, capsys)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _cli(PORT).build_parser().parse_args(["count", "-c", str(tmp_path / "x"), "-f", "t"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli(PORT).main(["count", "-c", str(tmp_path / PORT.name / "cat"), "-f", "t"])
    assert _cli(PORT).main(["count", "-c", str(tmp_path / PORT.name / "cat"), "-f", "t",
                            "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "400"
    assert os.path.exists(tmp_path / PORT.name / "cat")
