"""The port's stats store and estimate accountability against the JAX
package, on the CPU.

- ``StatsStore.build``, ``merge`` and every estimate over point, extent,
  ``Bytes`` and None-string columns: the same sketches, bin for bin and
  cell for cell, and the same estimates;
- ``stats_for`` after a write, a tiered write, the fold (monolithic and
  sliced), upsert, modify, delete and age-off, and after a save and
  load: the same sketches, and the same ``estimate_count`` answers;
- ``estimate_count`` (marginal product, z-prefix sketch, exact
  fallback; interceptors first) and ``analyze_stats``;
- the accountability loop (after tests/test_ops.py): plan estimates and
  matched rows, the error histogram, staleness, the auto-analyze hook
  with its single-winner claim, post-refinement and union actuals, and
  the accuracy reports equal between the packages;
- the store-level tests of tests/test_stats.py.

Both packages take their native host helpers. Tolerance: exact.
"""

import hashlib
import threading

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import conf as jconf
from geomesa_tpu_torch import conf as tconf
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
PKGS = (geomesa_tpu, geomesa_tpu_torch)
KW = {geomesa_tpu: {}, geomesa_tpu_torch: {"device": "cpu"}}
ESTIMATE_KNOBS = ("PLAN_ESTIMATE", "PLAN_ESTIMATE_STALE_P90", "PLAN_ESTIMATE_MIN_COUNT",
                  "PLAN_ESTIMATE_AUTO_ANALYZE")


@pytest.fixture(autouse=True)
def _native_and_knobs():
    ensure_jax_native()
    yield
    for c in (jconf, tconf):
        for k in ESTIMATE_KNOBS:
            getattr(c, k).clear()


def _set(name, value):
    for c in (jconf, tconf):
        getattr(c, name).set(value)


def sketch_state(st):
    """Everything a sketch bundle holds, comparable across packages."""
    if st is None:
        return None
    return {
        "json": st.to_json(),
        "hist": {k: (h.n_bins, h.lo, h.hi, h.counts.tolist())
                 for k, h in sorted(st.histograms.items())},
        "freq": {k: (f.count, hashlib.sha1(f.table.tobytes()).hexdigest())
                 for k, f in sorted(st.frequencies.items())},
        "topk": {k: sorted(t.counts.items()) for k, t in sorted(st.topk.items())},
        "z": None if st.z3 is None else (st.z_index, st.z3.total_bits,
                                         st.z3._keys.tolist(), st.z3._counts.tolist()),
    }


# -- StatsStore over every column kind ----------------------------------------

POINT_SPEC = "name:String,blob:Bytes,age:Integer,score:Double,dtg:Date,*geom:Point:srid=4326"
EXTENT_SPEC = "tag:String,rank:Integer,dtg:Date,*geom:Polygon:srid=4326"


def _columns(pkg, schema, n, seed):
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(-60, 50, n), rng.uniform(-40, 30, n)
    t = T0 + rng.integers(0, 20 * DAY, n)
    if schema == "pts":
        name = np.array(["alpha", "bravo", None, "delta"], dtype=object)[rng.integers(0, 4, n)]
        return {"name": name, "blob": np.array([b"\x00\xff", b"ab"], dtype=object)[
                    rng.integers(0, 2, n)],
                "age": rng.integers(0, 90, n).astype(np.int32),
                "score": np.round(rng.normal(0, 10, n), 2), "dtg": t, "geom": (x0, y0)}
    w, h = rng.uniform(0.01, 3.0, n), rng.uniform(0.01, 3.0, n)
    return {"tag": np.array(["UN", "NATO", "EU"])[rng.integers(0, 3, n)],
            "rank": rng.integers(0, 10, n).astype(np.int32), "dtg": t,
            "geom": pkg.geometry.PackedGeometryColumn.from_boxes(x0, y0, x0 + w, y0 + h)}


def _fc(pkg, schema, ids, seed):
    sft = pkg.FeatureType.from_spec(schema, POINT_SPEC if schema == "pts" else EXTENT_SPEC)
    return pkg.FeatureCollection.from_columns(sft, np.asarray(ids),
                                              _columns(pkg, schema, len(ids), seed))


ESTIMATES = {
    "pts": {"eq": [("name", "alpha"), ("name", ""), ("age", 3)],
            "range": [("age", 10.0, 40.0), ("score", -5.0, 5.0), ("dtg", T0, T0 + 5 * DAY),
                      ("geom.x", -10.0, 20.0)],
            "bounds": ["age", "score", "dtg", "geom.x", "geom.y", "name", "blob"]},
    "ext": {"eq": [("tag", "UN"), ("rank", 2)],
            "range": [("rank", 1.0, 4.0), ("dtg", T0 + DAY, T0 + 9 * DAY),
                      ("geom.y", -30.0, 0.0)],
            "bounds": ["rank", "dtg", "geom.x", "geom.y", "tag"]},
}
FILTERS = [
    "bbox(geom, -30, -20, 10, 10)",
    "bbox(geom, 0, 0, 40, 30) AND dtg DURING 2024-01-02T00:00:00Z/2024-01-09T00:00:00Z",
    "dtg DURING 2024-01-05T00:00:00Z/2024-01-06T12:00:00Z",
    "bbox(geom, 0, 0, 1, 1) AND bbox(geom, 5, 5, 6, 6)",
    "INTERSECTS(geom, POLYGON ((0 0, 20 0, 10 15, 0 0)))",
    "bbox(geom, -50, -30, -20, 0) OR bbox(geom, 10, 10, 40, 25)",
    "dtg < 2024-01-04T00:00:00Z",
]


@pytest.mark.parametrize("schema", ["pts", "ext"])
def test_statsstore_build_merge_and_every_estimate(schema):
    """Build two batches' sketches, merge them, and ask every estimate:
    point and extent geometry, Bytes (no sketch), None strings (sketched
    as ""), integers, doubles and dates."""
    out = []
    for pkg in PKGS:
        from importlib import import_module

        S = import_module(pkg.__name__ + ".stats").StatsStore
        ecql = import_module(pkg.__name__ + ".filter.ecql")
        a = _fc(pkg, schema, np.arange(600), seed=1)
        b = _fc(pkg, schema, np.arange(600, 1000), seed=2)
        st = S.build(a.sft, a)
        one = sketch_state(st)
        st.merge(S.build(b.sft, b))
        e = ESTIMATES[schema]
        res = {
            "one": one, "merged": sketch_state(st), "total": st.total_count(),
            "eq": [st.estimate_equality(k, v) for k, v in e["eq"]],
            "range": [st.estimate_range(k, lo, hi) for k, lo, hi in e["range"]],
            "bounds": [st.attribute_bounds(k) for k in e["bounds"]],
            "bbox": st.estimate_bbox("geom", -20, -20, 15, 25),
            "filter": [st.estimate_filter(a.sft, ecql.parse(q)) for q in FILTERS],
            "missing": (st.estimate_equality("nope", 1), st.estimate_range("nope", 0, 1),
                        st.estimate_bbox("nope", 0, 0, 1, 1)),
        }
        out.append(res)
    jax_res, port_res = out
    assert port_res == jax_res
    assert "blob" not in port_res["merged"]["json"]["minmax"]  # Bytes: no sketch
    assert port_res["total"] == 1000


def test_statsstore_z_sketch_and_estimate_scan():
    """observe_index_keys feeds the z sketch of the index named first;
    estimate_scan answers only for that index."""
    out = []
    for pkg in PKGS:
        ds = pkg.DataStore(tile=256, **KW[pkg])
        sft = pkg.FeatureType.from_spec("pts", POINT_SPEC)
        ds.create_schema(sft)
        ds.write("pts", _fc(pkg, "pts", np.arange(2000), seed=3))
        st = ds.stats_for("pts")
        res = [sketch_state(st)["z"][:2]]
        for q in FILTERS[:3]:
            for idx in ds.indexes("pts"):
                cfg = idx.scan_config(pkg.filter.ecql.parse(q))
                res.append(None if cfg is None or cfg.disjoint else st.estimate_scan(idx.name, cfg))
        out.append(res)
    assert out[1] == out[0]
    assert out[1][0] == ("z3", 63)


# -- stats_for after every mutation path -------------------------------------

MUTATIONS = ["write", "tiered", "fold", "fold_sliced", "upsert", "modify", "delete", "age_off",
             "persist"]


def _mutate(pkg, ds, op, tmp_path):
    if op == "tiered":
        ds.write("pts", _fc(pkg, "pts", np.arange(3000, 3200), seed=5))
    elif op in ("fold", "fold_sliced", "upsert"):
        fc = _fc(pkg, "pts", np.concatenate([np.arange(100, 400), np.arange(5000, 5100)]), seed=6)
        if op == "upsert":
            ds.upsert("pts", fc)
        else:
            ds.fold_upsert("pts", fc, slice_rows=97 if op == "fold_sliced" else 0)
    elif op == "modify":
        ds.modify_features("pts", {"age": 7}, "bbox(geom, -20, -20, 10, 10)")
    elif op == "delete":
        ds.delete_features("pts", "bbox(geom, 0, 0, 30, 20)")
    elif op == "age_off":
        ds.age_off("pts", ttl_ms=0, now_ms=T0 + 6 * DAY)
    elif op == "persist":
        from importlib import import_module

        persist = import_module(pkg.__name__ + ".storage.persist")
        root = tmp_path / pkg.__name__
        persist.save(ds, str(root))
        return persist.load(str(root), **KW[pkg])
    return ds


@pytest.mark.parametrize("op", MUTATIONS)
def test_stats_for_after_each_mutation(op, tmp_path):
    out = []
    for pkg in PKGS:
        ds = pkg.DataStore(tile=256, **KW[pkg])
        ds.create_schema(pkg.FeatureType.from_spec("pts", POINT_SPEC))
        ds.write("pts", _fc(pkg, "pts", np.arange(3000), seed=4))
        ds = _mutate(pkg, ds, op, tmp_path)
        out.append((sketch_state(ds.stats_for("pts")),
                    [ds.estimate_count("pts", q) for q in FILTERS],
                    np.asarray(ds.features("pts").ids).tolist()))
    assert out[1] == out[0]


def test_estimate_count_tiers_interceptors_and_analyze():
    """The three tiers, the interceptor rewrite, the empty store, and
    analyze_stats after drift: the port answers as the JAX package."""
    out = []
    for pkg in PKGS:
        from importlib import import_module

        guards = import_module(pkg.__name__ + ".planning.guards")
        ds = pkg.DataStore(tile=256, **KW[pkg])
        ds.create_schema(pkg.FeatureType.from_spec("pts", POINT_SPEC))
        empty = ds.estimate_count("pts", FILTERS[0])  # no sketch: exact fallback
        ds.write("pts", _fc(pkg, "pts", np.arange(3000), seed=7))
        res = [empty] + [ds.estimate_count("pts", q) for q in
                         FILTERS + ["name = 'alpha'", "age > 50", "INCLUDE"]]
        ds.fold_upsert("pts", _fc(pkg, "pts", np.arange(3000), seed=8))  # drift
        res += [ds.estimate_count("pts", q) for q in FILTERS]
        fresh = ds.analyze_stats("pts")
        res.append(sketch_state(fresh))
        res += [ds.estimate_count("pts", q) for q in FILTERS]
        ds.interceptors.append(guards.AgeOffInterceptor(ttl_ms=10 * DAY, now_ms=T0 + 15 * DAY))
        res += [ds.estimate_count("pts", q) for q in FILTERS + ["INCLUDE"]]
        out.append(res)
    assert out[1] == out[0]


# -- estimate accountability (after tests/test_ops.py) ------------------------

OPS_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
Q = "BBOX(geom, -20, -20, 20, 20)"


def _ops_fc(pkg, sft, n, seed=0, lo=-50.0, hi=50.0):
    rng = np.random.default_rng(seed)
    return pkg.FeatureCollection.from_columns(
        sft, [f"r{i}" for i in range(n)],
        {"name": np.array(["n"] * n), "dtg": T0 + rng.integers(0, 30 * DAY, n),
         "geom": (rng.uniform(lo, hi, n), rng.uniform(lo, hi, n))},
    )


def _ops_store(pkg, n=3000, spec=OPS_SPEC, indices=None):
    ds = pkg.DataStore(metrics=pkg.metrics.MetricsRegistry(), **KW[pkg])
    sft = pkg.FeatureType.from_spec("t", spec)
    if indices:
        sft.user_data["geomesa.indices.enabled"] = indices
    ds.create_schema(sft)
    if n:
        ds.write("t", _ops_fc(pkg, sft, n))
    return ds


def test_estimates_recorded_on_every_scan():
    reports = []
    for pkg in PKGS:
        exp = pkg.planning.explain.Explainer()
        ds = _ops_store(pkg)
        plan = ds.planner.plan("t", Q, explain=exp)
        assert plan.estimated_rows is not None and plan.estimated_rows > 0
        out = ds.planner.execute(plan, explain=exp)
        assert plan.actual_rows is not None and plan.actual_rows >= len(out)
        assert any(l.startswith("Estimated rows:") for l in exp.lines)
        assert any(l.startswith("Estimate vs actual:") for l in exp.lines)
        snap = ds.metrics.snapshot()["histograms"]
        assert snap["geomesa.plan.estimate.error"]["count"] == 1
        rows = ds.accuracy.report()["indexes"]
        assert len(rows) == 1 and rows[0]["type"] == "t" and rows[0]["count"] == 1
        assert 1.0 <= rows[0]["worst_error"] < float(tconf.PLAN_ESTIMATE_STALE_P90.get())
        est = (plan.estimated_rows, plan.actual_rows)
        _set("PLAN_ESTIMATE", False)  # the knob disables the whole loop
        plan2 = ds.planner.plan("t", Q)
        assert plan2.estimated_rows is None
        ds.planner.execute(plan2)
        assert ds.accuracy.sample_count() == 1
        for c in (jconf, tconf):
            c.PLAN_ESTIMATE.clear()
        reports.append((est, ds.accuracy.report(), [l for l in exp.lines if "Estimat" in l]))
    assert reports[1] == reports[0]


@pytest.mark.parametrize("auto", [False, True], ids=["manual", "auto"])
def test_stale_stats_and_reanalyze(auto):
    """The loop end to end: fold every point far away (accumulate-only
    drift), query the old region until the window trips stale; then
    analyze_stats (by hand, or the auto hook, exactly once) clears it."""
    _set("PLAN_ESTIMATE_MIN_COUNT", 8)
    _set("PLAN_ESTIMATE_AUTO_ANALYZE", auto)
    out = []
    for pkg in PKGS:
        ds = _ops_store(pkg, n=2000)
        sft = ds.get_schema("t")
        ds.fold_upsert("t", _ops_fc(pkg, sft, 2000, seed=1, lo=100.0, hi=140.0))
        for _ in range(12 if auto else 10):
            ds.query("t", Q)
        trace = [ds.accuracy.report()]
        if auto:
            assert ds.metrics.counter_value("geomesa.plan.estimate.analyze") == 1
        else:
            stale = ds.accuracy.stale()
            assert stale and stale[0][0] == "t"
            trace.append(stale)
            ds.analyze_stats("t")
            ds.accuracy.reset("t")
        for _ in range(12 if auto else 10):
            ds.query("t", Q)
        assert ds.accuracy.stale() == []
        if auto:
            assert ds.metrics.counter_value("geomesa.plan.estimate.analyze") == 1
        trace += [ds.accuracy.report(), sketch_state(ds.stats_for("t"))]
        out.append(trace)
    assert out[1] == out[0]


def test_estimate_compares_post_refinement_not_candidates():
    """The recorded actual is the matched count after refinement: a z2
    scan serving a spatio-temporal filter over-selects, and that must not
    flag fresh sketches stale."""
    _set("PLAN_ESTIMATE_MIN_COUNT", 4)
    q = "BBOX(geom, -40, -40, 40, 40) AND dtg DURING 2024-01-01T00:00:00Z/2024-01-02T00:00:00Z"
    out = []
    for pkg in PKGS:
        ds = _ops_store(pkg, n=4000, indices="z2")
        actual = []
        for _ in range(6):
            plan = ds.planner.plan("t", q)
            res = ds.planner.execute(plan)
            assert plan.index == "z2" and plan.actual_rows == len(res)
            actual.append(plan.actual_rows)
        assert ds.accuracy.stale() == []
        out.append((actual, ds.accuracy.report()))
    assert out[1] == out[0]


def test_estimate_union_with_limit_not_skewed():
    """A union with a limit records the union's matched rows, not the
    truncated result."""
    _set("PLAN_ESTIMATE_MIN_COUNT", 2)
    q = "BBOX(geom, -40, -40, 0, 40) OR name = 'n'"
    out = []
    for pkg in PKGS:
        ds = _ops_store(pkg, n=4000, spec="name:String:index=true,dtg:Date,*geom:Point:srid=4326")
        actual = []
        for _ in range(3):
            plan = ds.planner.plan("t", q, limit=5)
            res = ds.planner.execute(plan)
            assert plan.union is not None and len(res) == 5 and plan.actual_rows > 100
            actual.append((plan.estimated_rows, plan.actual_rows))
        assert ds.accuracy.stale() == []
        out.append((actual, ds.accuracy.report()))
    assert out[1] == out[0]


def test_auto_analyze_claim_is_single_winner():
    from geomesa_tpu_torch.obs.accuracy import EstimateAccuracy, error_factor

    acc = EstimateAccuracy()
    barrier = threading.Barrier(8)
    results = []

    def claimant():
        barrier.wait()
        results.append(acc.claim_analyze("t"))

    threads = [threading.Thread(target=claimant) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(results) == 1
    acc.reset("t")
    assert acc.claim_analyze("t")
    assert error_factor(9, 0) == error_factor(0, 9) == 10.0


def test_accuracy_windows_equal_the_jax_package():
    """The same (estimated, actual) pairs give the same report, staleness
    and sample counts, window by window."""
    from geomesa_tpu.obs.accuracy import EstimateAccuracy as J
    from geomesa_tpu_torch.obs.accuracy import EstimateAccuracy as T

    rng = np.random.default_rng(3)
    pairs = [(f"t{i % 2}", ["z3", "z2", None][i % 3], float(rng.integers(0, 500)),
              int(rng.integers(0, 500))) for i in range(300)]
    j, t = J(), T()
    for p in pairs:
        assert t.record(*p) == j.record(*p)
    assert t.report() == j.report()
    for thr, mc in ((2.0, 10), (4.0, 64), (0.0, 1), (1.5, 200)):
        assert t.stale(thr, mc) == j.stale(thr, mc)
    j.reset("t0")
    t.reset("t0")
    assert t.report() == j.report() and t.sample_count() == j.sample_count()


# -- store-level tests (after tests/test_stats.py) ----------------------------


def _stats_store(pkg, n=3000):
    sft = pkg.FeatureType.from_spec("t", "name:String,age:Int,dtg:Date,*geom:Point:srid=4326")
    ds = pkg.DataStore(tile=64, **KW[pkg])
    ds.create_schema(sft)
    rng = np.random.default_rng(5)
    ds.write("t", pkg.FeatureCollection.from_columns(
        sft, [str(i) for i in range(n)],
        {"name": np.array(["alice", "bob"] * (n // 2)), "age": rng.integers(0, 90, n),
         "dtg": T0 + rng.integers(0, 30 * DAY, n),
         "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))}))
    return ds


def test_store_stats_built_and_estimates():
    out = []
    for pkg in PKGS:
        ds = _stats_store(pkg)
        st = ds.stats_for("t")
        assert type(st).__name__ == "StatsStore" and st.total_count() == 3000
        assert st.estimate_equality("name", "alice") >= 1400
        lo, hi = st.attribute_bounds("age")
        assert st.estimate_range("age", float(lo), float(hi)) > 2500
        q = "bbox(geom, -60, -40, 60, 40) AND dtg DURING 2024-01-05T00:00:00Z/2024-01-15T00:00:00Z"
        est, exact = ds.estimate_count("t", q), ds.count("t", q)
        assert 0.5 * exact < est < 2.0 * exact
        traces = [ds.explain("t", "bbox(geom, -10, -10, 10, 10) AND dtg DURING "
                                  "2024-01-02T00:00:00Z/2024-01-04T00:00:00Z"),
                  ds.explain("t", "bbox(geom, -10, -10, 10, 10)")]
        assert "Strategy: z3" in traces[0] and "Strategy: z2" in traces[1]
        assert any("Estimated rows:" in t for t in traces)
        out.append((sketch_state(st), est, exact, traces))
    assert out[1] == out[0]


def test_incremental_write_stats():
    """Stats accumulate across write batches, the z sketch's mass equal
    to the row count exactly once."""
    out = []
    for pkg in PKGS:
        sft = pkg.FeatureType.from_spec("inc", "name:String,dtg:Date,*geom:Point:srid=4326")
        ds = pkg.DataStore(tile=64, **KW[pkg])
        ds.create_schema(sft)
        rng = np.random.default_rng(9)
        for k, n in ((0, 500), (1, 700)):
            ds.write("inc", pkg.FeatureCollection.from_columns(
                sft, [f"{k}-{i}" for i in range(n)],
                {"name": np.array([f"u{i % 5}" for i in range(n)]),
                 "dtg": T0 + rng.integers(0, DAY, n),
                 "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}))
        st = ds.stats_for("inc")
        assert st.total_count() == 1200 and sum(st.z3.cells.values()) == 1200
        out.append(sketch_state(st))
    assert out[1] == out[0]


def test_marginal_estimator_on_a_clustered_store():
    """bbox-only, spatio-temporal and disjoint estimates on a clustered
    z3-keyed store (after TestMarginalEstimator)."""
    rng = np.random.default_rng(31)
    n = 30_000
    x, y = rng.normal(0, 0.5, n), rng.normal(0, 0.5, n)
    t = T0 + rng.integers(0, 30 * DAY, n)
    qs = ["bbox(geom, -1, -1, 1, 1)",
          "bbox(geom, -1, -1, 1, 1) AND dtg DURING 2024-01-05T00:00:00Z/2024-01-20T00:00:00Z",
          "bbox(geom, 0, 0, 1, 1) AND bbox(geom, 5, 5, 6, 6)"]
    out = []
    for pkg in PKGS:
        sft = pkg.FeatureType.from_spec("st", "dtg:Date,*geom:Point:srid=4326")
        sft.user_data["geomesa.indices.enabled"] = "z3,z2"
        ds = pkg.DataStore(**KW[pkg])
        ds.create_schema(sft)
        ds.write("st", pkg.FeatureCollection.from_columns(
            sft, np.arange(n), {"dtg": t, "geom": (x, y)}), check_ids=False)
        out.append([ds.estimate_count("st", q) for q in qs])
    assert out[1] == out[0]
    box = (x >= -1) & (x <= 1) & (y >= -1) & (y <= 1)
    lo = T0 + 4 * DAY
    true = [int(box.sum()), int((box & (t >= lo) & (t < lo + 15 * DAY)).sum())]
    for est, tr in zip(out[1][:2], true):
        assert 0.3 * tr < est < 3 * tr
    assert out[1][2] == 0


def test_cost_changes_with_distribution():
    """The planner's cost follows the data: a bbox over the dense half
    costs far more than one over the empty half, in both packages alike."""
    n = 4000
    rng = np.random.default_rng(6)
    t = T0 + rng.integers(0, DAY, n)
    x, y = rng.uniform(10, 170, n), rng.uniform(-80, 80, n)
    costs = []
    for pkg in PKGS:
        sft = pkg.FeatureType.from_spec("d", "dtg:Date,*geom:Point:srid=4326")
        ds = pkg.DataStore(tile=64, **KW[pkg])
        ds.create_schema(sft)
        ds.write("d", pkg.FeatureCollection.from_columns(
            sft, [str(i) for i in range(n)], {"dtg": t, "geom": (x, y)}))
        idx = next(i for i in ds.indexes("d") if i.name == "z2")
        extra = (None,) if pkg is geomesa_tpu else ()
        c = [ds.planner.cost("d", "z2", idx.scan_config(pkg.filter.ecql.parse(q)), *extra)
             for q in ("bbox(geom, 10, -80, 170, 80)", "bbox(geom, -170, -80, -10, 80)")]
        assert c[0] > 100 * c[1]
        costs.append(c)
    assert costs[1] == costs[0]


@pytest.mark.parametrize("case", ["codes", "labels", "late-value", "bytes", "short", "numbers"])
def test_string_factorization_equals_numpy_unique(case):
    """The sketches' fast factorization of long string columns gives
    np.unique's arrays exactly (a value first seen past the leading
    sample takes numpy's sort), and Frequency / TopK over it equal the
    JAX package's per-row sketches."""
    from geomesa_tpu.stats.sketches import Frequency as JF
    from geomesa_tpu.stats.sketches import TopK as JT
    from geomesa_tpu_torch.stats import sketches as sk

    rng = np.random.default_rng(12)
    n = 200_000
    col = {
        "codes": np.array([f"{c:02d}" for c in range(1, 21)])[rng.integers(0, 20, n)],
        "labels": np.array(["", "analyst", "analyst&secret", "secret|ops"])[rng.integers(0, 4, n)],
        "late-value": np.concatenate([np.array(["a", "bb"])[rng.integers(0, 2, n)], ["zzz"]]),
        "bytes": np.array([b"\x00x", b"ab", b"abc"])[rng.integers(0, 3, n)],
        "short": np.array(["x", "y"])[rng.integers(0, 2, 100)],
        "numbers": rng.integers(0, 7, n),
    }[case]
    for inverse in (False, True):
        got = sk._unique_counts(col, inverse=inverse)
        want = np.unique(col, return_inverse=inverse, return_counts=True)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    if col.dtype.kind == "U":
        f, jf, t, jt = sk.Frequency(), JF(), sk.TopK(), JT()
        for s_, c in ((f, col), (jf, col), (t, col), (jt, col)):
            s_.observe(c)
        assert np.array_equal(f.table, jf.table) and f.count == jf.count
        assert list(t.counts.items()) == list(jt.counts.items())
