"""The port's serving tier against the JAX package's, on the CPU (after
tests/test_serving.py, tests/test_obs.py's thread-hop trace and
tests/test_tuning.py's burn-gate admission).

Every case runs the same staged scenario on a JAX store and a port store
built from the same seeded rows (``kind`` attribute-indexed, Z3/Z2 on the
points), mostly on unstarted schedulers so queue states are
deterministic: shed at admission and at dispatch, backpressure and a full
queue, identical-fingerprint coalescing, mixed hints in one fused
dispatch, cache hits that never queue, scheduled misses that populate the
cache, the adaptive window, knob resolution, admission-anchored deadlines
in ``submit_many``, a cancelled future, no coalescing across a mutation,
plan errors at submit, execution errors on the future, close,
queue-wait attribution, ``admission_gap``; then the span tree across the
thread hop and a burn gate of the test's own that sheds below-top-weight
tenants before the queue is full. Each package's answers equal its own
sequential ``query`` and the other package's, ids in order; the
``geomesa.serving.*`` counters are equal where the scenario makes them
deterministic. Both packages take their native host helpers. Tolerance:
exact.
"""

import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

DAY = 86_400_000
Q = "bbox(geom, -10, -10, 10, 10)"
SPEC = "kind:String:index=true,dtg:Date,*geom:Point:srid=4326"
SERVING = ("submitted", "shed", "coalesced", "batches", "batched_queries")


def _pkg(pkg, kw):
    from importlib import import_module

    name = pkg.__name__
    return SimpleNamespace(
        name=name, pkg=pkg, kw=kw,
        conf=import_module(name + ".conf"),
        metrics=import_module(name + ".metrics"),
        serving=import_module(name + ".serving"),
        errors=import_module(name + ".planning.errors"),
        explain=import_module(name + ".planning.explain"),
        hints=import_module(name + ".planning.hints"),
        obs=import_module(name + ".obs"),
        ops=import_module(name + ".obs.ops"),
        audit=import_module(name + ".audit"),
        tenancy=import_module(name + ".serving.tenancy"),
    )


JAX = _pkg(geomesa_tpu, {})
PORT = _pkg(geomesa_tpu_torch, {"device": "cpu"})
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def _native():
    ensure_jax_native()


def _store(P, metrics=True, cache=None, n=4000):
    sft = P.pkg.FeatureType.from_spec("ev", SPEC)
    reg = P.metrics.MetricsRegistry() if metrics else None
    ds = P.pkg.DataStore(tile=64, metrics=reg, cache=cache, **P.kw)
    ds.create_schema(sft)
    rng = np.random.default_rng(7)
    t0 = np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64)
    ds.write("ev", P.pkg.FeatureCollection.from_columns(
        sft, [str(i) for i in range(n)],
        {
            "kind": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
            "dtg": t0 + rng.integers(0, 20 * DAY, n),
            "geom": (rng.uniform(-60, 60, n), rng.uniform(-45, 45, n)),
        },
    ))
    return ds


def _ids(fc) -> list:
    return np.asarray(fc.ids).tolist()


def _counts(reg) -> dict:
    return {k: reg.counter_value(f"geomesa.serving.{k}") for k in SERVING}


def _both(scenario, **kw):
    """Run one scenario on both packages; returns (jax result, port result)."""
    return tuple(scenario(P, **kw) for P in BOTH)


# -- attachment and equality ---------------------------------------------------


def test_serve_attach_surface():
    def run(P):
        ds = _store(P)
        s1 = ds.serve()
        assert ds.scheduler is s1 and ds.serve() is s1  # idempotent while open
        assert s1.metrics is ds.metrics  # counts into the store's registry
        s1.close()
        s2 = ds.serve(True)  # True resolves the knobs
        assert s2 is not s1 and not s2.closed  # a closed scheduler is replaced
        assert s2.conf.queue_max == P.conf.SERVING_QUEUE_MAX.get()
        ds.close()
        assert s2.closed
        return type(s2.conf).__name__

    assert _both(run) == ("ServingConfig", "ServingConfig")


def test_scheduler_query_equals_datastore_query():
    def run(P):
        ds = _store(P)
        with P.serving.QueryScheduler(ds, P.serving.ServingConfig()) as sched:
            out = sched.query("ev", Q)
        ref = ds.query("ev", Q)
        assert _ids(out) == _ids(ref)
        return _ids(out)

    j, t = _both(run)
    assert t == j and len(t) > 0


# -- shedding and backpressure -------------------------------------------------


def test_shed_at_admission_when_timeout_inside_window():
    def run(P):
        reg = P.metrics.MetricsRegistry()
        ds = _store(P, metrics=False)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(window_ms=50.0),
                                         metrics=reg)
        sched._window_s = 0.05  # as if load grew the window to its cap
        exp = P.explain.Explainer()
        fut = sched.submit("ev", Q, hints=P.hints.QueryHints(timeout=0.001), explain=exp)
        with pytest.raises(P.errors.QueryTimeout, match="shed before dispatch") as ei:
            fut.result(1)
        assert any("shed" in w for w in exp.warnings)
        return _counts(reg), str(ei.value), exp.warnings

    j, t = _both(run)
    assert t == j and t[0]["shed"] == 1


def test_shed_at_dispatch_when_deadline_expired_queued():
    def run(P):
        reg = P.metrics.MetricsRegistry()
        ds = _store(P)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(), metrics=reg)
        fut = sched.submit("ev", Q, hints=P.hints.QueryHints(timeout=0.02))
        ok = sched.submit("ev", Q)  # no deadline: survives the stall
        time.sleep(0.08)
        sched.start()
        with pytest.raises(P.errors.QueryTimeout, match="deadline expired"):
            fut.result(5)
        out = ok.result(5)
        assert _ids(out) == _ids(ds.query("ev", Q))
        sched.close()
        return _counts(reg), _ids(out)

    j, t = _both(run)
    assert t == j and t[0]["shed"] == 1


def test_queue_full_backpressure_and_shed():
    def run(P):
        reg = P.metrics.MetricsRegistry()
        ds = _store(P)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(queue_max=1), metrics=reg)
        f1 = sched.submit("ev", Q)  # fills the queue
        f2 = sched.submit("ev", "kind = 'b'", block=False)  # full: shed
        with pytest.raises(P.serving.ServingRejected, match="admission queue full"):
            f2.result(1)
        shed = [reg.counter_value("geomesa.serving.shed")]
        # block=True and a deadline that expires waiting for space: shed
        f3 = sched.submit("ev", Q, hints=P.hints.QueryHints(timeout=0.01))
        with pytest.raises(P.errors.QueryTimeout, match="queue full"):
            f3.result(1)
        shed.append(reg.counter_value("geomesa.serving.shed"))
        # backpressure: a blocking submit parks until the dispatcher frees
        # a slot, then resolves normally
        with ThreadPoolExecutor(1) as ex:
            blocked = ex.submit(sched.submit, "ev", Q)
            time.sleep(0.05)
            sched.start()
            f4 = blocked.result(5)
            out4 = f4.result(10)
        out1 = f1.result(10)
        ref = _ids(ds.query("ev", Q))
        assert _ids(out4) == ref and _ids(out1) == ref
        sched.close()
        return shed, reg.counter_value("geomesa.serving.submitted"), ref

    j, t = _both(run)
    assert t == j and t[0] == [1, 2] and t[1] == 4


# -- coalescing and fused dispatch ---------------------------------------------


def test_identical_fingerprints_coalesce_into_one_slot():
    def run(P):
        ds = _store(P)
        reg = ds.metrics
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(), metrics=reg)
        futs = [sched.submit("ev", Q) for _ in range(3)]
        other = sched.submit("ev", "kind = 'b'")
        sched.start()
        outs = [f.result(10) for f in futs]
        assert outs[1] is outs[0] and outs[2] is outs[0]  # ONE shared result
        assert _ids(outs[0]) == _ids(ds.query("ev", Q))
        b = other.result(10)
        assert _ids(b) == _ids(ds.query("ev", "kind = 'b'"))
        sched.close()
        # the followers are audited like their own queries: 4 through the
        # scheduler, 2 oracle queries
        return _counts(reg), reg.counter_value("geomesa.query.count"), _ids(outs[0]), _ids(b)

    j, t = _both(run)
    assert t == j
    c, n_queries = t[0], t[1]
    assert (c["coalesced"], c["batches"], c["batched_queries"], n_queries) == (2, 1, 2, 6)


def test_mixed_hints_fuse_into_one_dispatch():
    """Different result-shaping hints ride ONE fused dispatch: each caller
    gets the result sequential query() gives for its own hints."""
    def run(P):
        ds = _store(P)
        reg = ds.metrics
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(), metrics=reg)
        h1 = P.hints.QueryHints(sort_by="kind")
        h2 = P.hints.QueryHints(transforms=["kind"])
        f1 = sched.submit("ev", Q, hints=h1)
        f2 = sched.submit("ev", Q, hints=h2)
        f3 = sched.submit("ev", Q, limit=5)
        sched.start()
        a, b, c = f1.result(10), f2.result(10), f3.result(10)
        counts = _counts(reg)
        assert _ids(a) == _ids(ds.query("ev", Q, hints=h1))
        ob = ds.query("ev", Q, hints=h2)
        assert list(b.columns) == list(ob.columns) == ["kind"]
        assert _ids(b) == _ids(ob)
        assert _ids(c) == _ids(ds.query("ev", Q, limit=5))
        sched.close()
        return counts, _ids(a), _ids(b), _ids(c), list(b.columns)

    j, t = _both(run)
    assert t == j and (t[0]["batches"], t[0]["batched_queries"]) == (1, 3)


# -- the cache at admission --------------------------------------------------------


def test_cache_hits_never_queue():
    def run(P):
        ds = _store(P, cache=True)
        reg = ds.metrics
        sched = ds.serve()
        first = sched.query("ev", Q)  # miss: fused dispatch, cache populate
        batches = reg.counter_value("geomesa.serving.batches")
        assert batches >= 1
        h0 = reg.counter_value("geomesa.cache.hit")
        second = sched.query("ev", Q)  # the admission peek serves it in-caller
        assert reg.counter_value("geomesa.serving.batches") == batches  # no dispatch
        assert reg.counter_value("geomesa.cache.hit") == h0 + 1
        assert _ids(first) == _ids(second)
        # bypass skips both the admission peek and the populate
        third = sched.query("ev", Q, hints=P.hints.QueryHints(cache="bypass"))
        assert reg.counter_value("geomesa.serving.batches") == batches + 1
        assert _ids(first) == _ids(third)
        ds.close()
        return _counts(reg), reg.counter_value("geomesa.cache.hit"), _ids(first)

    j, t = _both(run)
    assert t == j


def test_scheduled_miss_populates_result_cache():
    def run(P):
        ds = _store(P, cache=True)
        sched = ds.serve()
        sched.query("ev", Q)
        assert len(ds.cache.result) == 1  # admitted by the dispatch path
        # ... and a later PLAIN execute serves from it
        plan = ds.planner.plan("ev", Q)
        out = ds.planner.execute(plan)
        assert plan.cache_status == "hit"
        ref = ds.query("ev", Q, hints=P.hints.QueryHints(cache="bypass"))
        assert _ids(out) == _ids(ref)
        ds.close()
        return _ids(out)

    j, t = _both(run)
    assert t == j


def test_pin_and_bypass_hints_reach_the_dispatch_admit():
    """The ``pin`` hint reaches the dispatch path's admit: the entry is
    admitted pinned; ``bypass`` admits nothing."""
    def run(P):
        ds = _store(P, cache=True)
        sched = ds.serve()
        sched.query("ev", Q, hints=P.hints.QueryHints(cache="pin"))
        sched.query("ev", "kind = 'b'", hints=P.hints.QueryHints(cache="bypass"))
        entries = list(ds.cache.result._entries.values())
        ds.close()
        return [(e.type_name, bool(e.pinned)) for e in entries]

    j, t = _both(run)
    assert t == j == [("ev", True)]


# -- the window and the knobs ----------------------------------------------------


def test_adaptive_window_grows_and_shrinks():
    def run(P):
        ds = _store(P, n=200)
        reg = P.metrics.MetricsRegistry()
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(window_ms=4.0), metrics=reg)
        seen = [sched.window_s]  # idle start: lone queries pay nothing
        sched._adapt(8)
        seen.append(sched.window_s)  # cap/8 seed
        for _ in range(10):
            sched._adapt(8)
        seen.append(sched.window_s)  # grows to the cap
        sched._adapt(1)
        seen.append(sched.window_s)  # halves when singular
        for _ in range(10):
            sched._adapt(1)
        seen.append(sched.window_s)  # collapses back to zero
        return seen, reg.snapshot()["gauges"]["geomesa.serving.window_ms"]

    j, t = _both(run)
    assert t == j
    assert t[0] == [0.0, pytest.approx(0.0005), pytest.approx(0.004), pytest.approx(0.002), 0.0]


def test_partial_config_resolves_unset_knobs_from_properties():
    for P in BOTH:
        P.conf.SERVING_QUEUE_MAX.set(7)
        try:
            c = P.serving.ServingConfig(window_ms=5.0)
            assert (c.window_ms, c.queue_max) == (5.0, 7)
            assert c.batch_max == P.conf.SERVING_BATCH_MAX.get()
        finally:
            P.conf.SERVING_QUEUE_MAX.clear()
        assert P.serving.ServingConfig().queue_max == P.conf.SERVING_QUEUE_MAX.get()
    assert vars(JAX.serving.ServingConfig()) == vars(PORT.serving.ServingConfig())


# -- deadlines, cancels and errors ------------------------------------------------


def test_admission_anchored_deadlines_in_submit_many():
    """submit_many's ``deadlines`` anchor a scan's budget at admission: a
    budget already burned in the queue times the scan out, for fused
    simple plans and for a union's synchronous fallback alike."""
    def run(P):
        ds = _store(P)
        now = time.monotonic()
        burned = P.errors.Deadline(start=now - 1.0, budget_s=0.5, cutoff=now - 0.5)
        fresh = P.errors.Deadline(start=now, budget_s=30.0, cutoff=now + 30.0)
        out = []
        for q in (Q, f"{Q} OR kind = 'c'"):
            plan = ds.planner.plan("ev", q)
            fin = ds.planner.submit_many([plan], deadlines=[burned])[0]
            with pytest.raises(P.errors.QueryTimeout):
                fin()
            got = ds.planner.submit_many([ds.planner.plan("ev", q)], deadlines=[fresh])[0]()
            assert _ids(got) == _ids(ds.query("ev", q))
            out.append((plan.union is not None, _ids(got)))
        return out

    j, t = _both(run)
    assert t == j and [u for u, _ in t] == [False, True]


def test_cancelled_future_does_not_poison_the_batch():
    def run(P):
        ds = _store(P)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig())
        f1 = sched.submit("ev", Q)
        f2 = sched.submit("ev", Q)  # coalesces onto f1's slot
        f3 = sched.submit("ev", "kind = 'b'")
        assert f1.cancel()
        sched.start()
        a, b = f2.result(10), f3.result(10)
        assert _ids(a) == _ids(ds.query("ev", Q))
        assert _ids(b) == _ids(ds.query("ev", "kind = 'b'"))
        sched.close()
        return _ids(a), _ids(b)

    j, t = _both(run)
    assert t == j


def test_no_coalescing_across_a_mutation():
    """Identical queries admitted on either side of a committed write are
    in different mutation epochs: they do not share one result, and the
    later submitter sees its own write."""
    def run(P):
        ds = _store(P)
        reg = ds.metrics
        e0 = ds.planner.mutation_epoch
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(), metrics=reg)
        f1 = sched.submit("ev", Q)
        ds.write("ev", P.pkg.FeatureCollection.from_columns(
            ds.get_schema("ev"), ["w1", "w2"],
            {
                "kind": np.array(["a", "a"]),
                "dtg": np.full(2, np.datetime64("2024-01-02", "ms").astype(np.int64)),
                "geom": (np.array([1.0, 2.0]), np.array([1.0, 2.0])),
            },
        ))
        assert ds.planner.mutation_epoch > e0
        f2 = sched.submit("ev", Q)  # the same fingerprint, a NEW epoch
        sched.start()
        r1, r2 = f1.result(10), f2.result(10)
        assert r2 is not r1
        assert {"w1", "w2"} <= set(_ids(r2))  # read-your-writes for the later caller
        assert _ids(r2) == _ids(ds.query("ev", Q))
        sched.close()
        return _counts(reg), _ids(r1), _ids(r2)

    j, t = _both(run)
    assert t == j and t[0]["coalesced"] == 0 and t[0]["batched_queries"] == 2


def test_plan_errors_raise_at_submit():
    def run(P):
        ds = _store(P, n=200)
        reg = P.metrics.MetricsRegistry()
        with P.serving.QueryScheduler(ds, P.serving.ServingConfig(), metrics=reg) as sched:
            with pytest.raises(KeyError):
                sched.submit("nope", Q)  # unknown type: raised in the caller
            with pytest.raises(Exception):
                sched.submit("ev", "this is not ecql (")
            with pytest.raises(ValueError, match="sample"):
                # bad hints raise at submit, never failing a batch
                sched.submit("ev", Q, hints=P.hints.QueryHints(sample=5.0))
        return _counts(reg)

    j, t = _both(run)
    assert t == j and t["submitted"] == 0


def test_execution_errors_land_on_the_future(monkeypatch):
    def run(P):
        ds = _store(P)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig())
        fut = sched.submit("ev", Q)  # planned against the healthy store

        def boom(*a, **k):
            raise RuntimeError("device gone")

        monkeypatch.setattr(ds, "table", boom)  # a dispatch-time failure
        sched.start()
        with pytest.raises(RuntimeError, match="device gone"):
            fut.result(10)
        sched.close()
        return True

    assert _both(run) == (True, True)


def test_close_fails_pending_and_refuses_new():
    def run(P):
        ds = _store(P, n=200)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig())  # never started
        fut = sched.submit("ev", Q)
        sched.close()
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(1)
        with pytest.raises(RuntimeError, match="closed"):
            sched.submit("ev", Q)
        assert sched.queue_depth == 0
        sched.close()  # idempotent
        return sched.closed

    assert _both(run) == (True, True)


# -- attribution ------------------------------------------------------------------


def test_queue_wait_attribution():
    """Queue wait is attributed apart from scan time: the live histogram
    lands in the store's registry and the explain trail carries both,
    with the device scan's lines through the fused dispatch."""
    def run(P):
        ds = _store(P)
        sched = ds.serve()
        exp = P.explain.Explainer()
        out = sched.submit("ev", Q, explain=exp).result(10)
        ds.close()
        snap = ds.metrics.snapshot()
        assert snap["histograms"]["geomesa.serving.queue_wait"]["count"] >= 1
        line = next(ln for ln in exp.lines if ln.strip().startswith("serving:"))
        assert "queue wait" in line and "scan" in line and "fused batch" in line
        assert any("Device scan" in ln for ln in exp.lines)
        return _ids(out), [ln.split(":")[0] for ln in exp.lines if ":" in ln]

    j, t = _both(run)
    assert t[0] == j[0]


def test_admission_gap_drains_and_bounds():
    def run(P):
        ds = _store(P)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(window_ms=0.0))
        idle = sched.admission_gap(0.01)  # an idle queue: at once
        fut = sched.submit("ev", Q)  # queued, nothing drains it
        t0 = time.perf_counter()
        stuck = sched.admission_gap(0.05)
        assert time.perf_counter() - t0 < 2.0  # bounded
        sched.start()
        drained = sched.admission_gap(5.0)
        out = fut.result(10)
        sched.close()
        return idle, stuck, drained, _ids(out)

    j, t = _both(run)
    assert t == j and t[:3] == (True, False, True)


# -- the thread hop and the burn gate ---------------------------------------------------


def test_scheduler_thread_hop_keeps_one_tree():
    """A served query's trace: plan in the caller's thread, queue,
    dispatch, scan and decode attached from the dispatcher, all parented
    on the root; the same top-level phases in both packages."""
    def run(P):
        P.conf.OBS_TRACE_SAMPLE.set(1)
        P.conf.OBS_SLOW_MS.set(0.0)
        try:
            ds = _store(P)
            ds.query("ev", Q)  # warm outside the traced run
            P.obs.install(P.obs.Tracer())
            sched = ds.serve()
            out = sched.submit("ev", Q).result(30)
            ds.close()
            tr = next(t for t in reversed(P.obs.tracer().traces())
                      if t.root.attrs and t.root.attrs.get("serving"))
        finally:
            P.conf.OBS_TRACE_SAMPLE.clear()
            P.conf.OBS_SLOW_MS.clear()
            P.obs.install(P.obs.Tracer())
        phases = tr.phases()
        names = [s.name for s in phases]
        for want in ("plan", "admit", "queue", "dispatch", "batch.wait", "scan", "decode"):
            assert want in names, names
        assert all(s.parent_id == tr.root.span_id for s in phases)
        plan = next(s for s in phases if s.name == "plan")
        scan = next(s for s in phases if s.name == "scan")
        assert plan.tid != scan.tid  # the hop really happened
        covered = sum(s.dur_s for s in phases)
        assert tr.wall_s * 0.7 <= covered <= tr.wall_s * 1.05, (covered, tr.wall_s)
        assert ds.metrics.snapshot()["histograms"]["geomesa.serving.queue_wait"]["count"] >= 1
        return _ids(out), sorted(set(names)), tr.fingerprint

    j, t = _both(run)
    assert t == j


class _Gate:
    """The burn gate's seam, held by a gate of the test's own: while
    engaged it sheds every tenant below the top weight."""

    def __init__(self, tenants):
        self.tenants = tenants
        self.engaged = True

    def should_shed(self, tenant):
        if not self.engaged:
            return None
        weights = self.tenants.weights()
        if tenant is not None and weights.get(tenant, 1.0) < max(weights.values()):
            return f"slo burn: tenant {tenant!r} below the top weight"
        return None


def test_burn_gate_sheds_below_top_weight_before_the_queue_fills():
    def run(P):
        reg = P.metrics.MetricsRegistry()
        ds = _store(P, metrics=False)
        tenants = P.serving.TenantRegistry(metrics=reg)
        tenants.configure("gold", weight=8.0)
        tenants.configure("bronze", weight=1.0)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(queue_max=64), metrics=reg,
                                         tenants=tenants)  # unstarted
        sched.burn_gate = gate = _Gate(tenants)
        shed = sched.submit("ev", Q, block=False, tenant="bronze")
        with pytest.raises(P.serving.ServingRejected, match="slo burn"):
            shed.result(timeout=5)
        kept = sched.submit("ev", Q, block=False, tenant="gold")
        assert not kept.done()  # the top weight admits through the burn
        gate.engaged = False
        ok = sched.submit("ev", Q, block=False, tenant="bronze")
        assert not ok.done()  # admitted (queued; never started)
        depth = sched.queue_depth
        sched.start()
        outs = [_ids(kept.result(10)), _ids(ok.result(10))]
        sched.close()
        rep = tenants.report()
        for row in rep["tenants"]:
            row["queue_wait_ms_mean"] = row["queue_wait_ms_max"] = row["wall_ms_mean"] = None
            row["slo"] = None
        return (reg.counter_value("geomesa.tuning.shed"), _counts(reg), depth, outs, rep)

    j, t = _both(run)
    assert t == j and t[0] == 1 and t[2] == 2
