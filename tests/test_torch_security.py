"""The port's visibility tier and federated views against the JAX
package, on the CPU.

- ``security.visible``, ``validate`` and ``visibility_mask`` over seeded
  random expressions and label columns (None labels included), and
  hostile inputs (too long, nested too deep, bad tokens, trailing input,
  unbalanced parens) raising the same error with the same message;
- stores over the same labelled rows under auths ``None``, ``()``,
  ``("analyst",)``, ``("analyst", "secret")`` and ``("ops",)``: query
  ids in order (with ``limit``, through ``query_many`` and over unions),
  count, density, bounds and stats in both modes, ``estimate_count``;
  every aggregation while visibility is active counts one
  ``geomesa.query.vis_fallback``, as in the JAX package;
- the fallback signal and attribute visibility (after
  tests/test_guards.py's ``test_visibility_fallback_signal`` and
  ``TestAttributeVisibility``);
- ``MergedView`` and ``RoutedView`` (after tests/test_datastore.py's
  ``TestMergedViewAggregations``).

Both packages take their native host helpers. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import security as jsec
from geomesa_tpu_torch import security as tsec
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
PKGS = (geomesa_tpu, geomesa_tpu_torch)
KW = {geomesa_tpu: {}, geomesa_tpu_torch: {"device": "cpu"}}
LABELS = ("analyst", "secret", "ops", "admin", "a.b-c:d")


@pytest.fixture(autouse=True)
def _native():
    ensure_jax_native()


# -- the evaluator --------------------------------------------------------------


def _expr(rng, depth=0) -> str:
    r = rng.uniform()
    if depth >= 3 or r < 0.35:
        return LABELS[int(rng.integers(len(LABELS)))]
    op = "&" if r < 0.7 else "|"
    parts = [_expr(rng, depth + 1) for _ in range(int(rng.integers(2, 4)))]
    inner = op.join(parts)
    return f"({inner})" if rng.uniform() < 0.6 else inner


def _auths(rng):
    k = int(rng.integers(0, len(LABELS) + 1))
    return tuple(rng.choice(LABELS, k, replace=False).tolist())


@pytest.mark.parametrize("chunk", range(4))
def test_visible_and_mask_agree_on_random_expressions(chunk):
    rng = np.random.default_rng(100 + chunk)
    exprs = [_expr(rng) for _ in range(60)] + ["", "  ", " analyst ", "analyst|secret"]
    for _ in range(20):
        auths = _auths(rng)
        for e in exprs:
            jsec.validate(e)
            tsec.validate(e)
            assert tsec.visible(e, auths) == jsec.visible(e, auths), (e, auths)
        col = np.array(rng.choice(exprs, 200).tolist() + [None, ""], dtype=object)
        got, want = tsec.visibility_mask(col, auths), jsec.visibility_mask(col, auths)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        strs = np.array(rng.choice(exprs, 100).tolist())
        assert np.array_equal(tsec.visibility_mask(strs, auths), jsec.visibility_mask(strs, auths))


HOSTILE = [
    "a" * (jsec.MAX_EXPRESSION_LENGTH + 1),
    "(" * (jsec.MAX_EXPRESSION_DEPTH + 1) + "a" + ")" * (jsec.MAX_EXPRESSION_DEPTH + 1),
    "admin,ops", "admin&", "(admin", "admin)", "&admin", "ad min", "a|(b&)", "()", "a$b",
]


@pytest.mark.parametrize("expr", HOSTILE, ids=[f"hostile{i}" for i in range(len(HOSTILE))])
def test_hostile_expressions_raise_the_same_error(expr):
    with pytest.raises(jsec.VisibilityError) as je:
        jsec.validate(expr)
    with pytest.raises(tsec.VisibilityError) as te:
        tsec.validate(expr)
    assert str(te.value) == str(je.value)
    assert isinstance(te.value, ValueError)
    with pytest.raises(tsec.VisibilityError):
        tsec.visibility_mask(np.array([expr, ""]), ("a",))
    assert (tsec.MAX_EXPRESSION_LENGTH, tsec.MAX_EXPRESSION_DEPTH, tsec.VIS_FIELD_KEY) == (
        jsec.MAX_EXPRESSION_LENGTH, jsec.MAX_EXPRESSION_DEPTH, jsec.VIS_FIELD_KEY)
    # a depth right at the limit parses
    ok = "(" * jsec.MAX_EXPRESSION_DEPTH + "a" + ")" * jsec.MAX_EXPRESSION_DEPTH
    assert tsec.visible(ok, ("a",)) == jsec.visible(ok, ("a",)) is True


# -- stores under every kind of auths -------------------------------------------

N = 3_000
VIS_SPEC = "name:String,age:Integer,code:String:vis=secret,vis:String,dtg:Date,*geom:Point:srid=4326"
VIS_VALUES = np.array(["", "analyst", "analyst&secret", "secret|ops", "ops"])
VIS_P = np.array([0.5, 0.2, 0.15, 0.1, 0.05])
AUTHS = [None, (), ("analyst",), ("analyst", "secret"), ("ops",)]
AUTH_IDS = ["none", "public", "analyst", "analyst-secret", "ops"]
QUERIES = [
    "bbox(geom, -30, -20, 10, 10)",
    "bbox(geom, 0, 0, 40, 30) AND dtg DURING 2024-01-02T00:00:00Z/2024-01-09T00:00:00Z",
    "dtg DURING 2024-01-05T00:00:00Z/2024-01-06T00:00:00Z",
    "name = 'bravo'",
    "bbox(geom, -50, -30, -20, 0) OR dtg DURING 2024-01-15T00:00:00Z/2024-01-16T00:00:00Z",
    "INTERSECTS(geom, POLYGON ((0 0, 20 0, 10 15, 0 0)))",
    "age < 4 AND bbox(geom, -40, -30, 30, 30)",
    "IN ('1', '2', '3', '17', '2999')",
    "INCLUDE",
]
AGG_QUERIES = QUERIES[:3] + [QUERIES[5]]


def vis_data(seed=23, n=N):
    rng = np.random.default_rng(seed)
    return {
        "name": np.array(["alpha", "bravo", "charlie"])[rng.integers(0, 3, n)],
        "age": rng.integers(0, 30, n).astype(np.int32),
        "code": np.array(["01", "02", "19"])[rng.integers(0, 3, n)],
        "vis": VIS_VALUES[rng.choice(5, n, p=VIS_P)],
        "dtg": T0 + rng.integers(0, 20 * DAY, n),
        "geom": (rng.uniform(-60, 60, n), rng.uniform(-40, 40, n)),
    }


def vis_store(pkg, data, auths, writes=(N,), metrics=True, **kw):
    sft = pkg.FeatureType.from_spec("v", VIS_SPEC)
    sft.user_data[pkg.security.VIS_FIELD_KEY] = "vis"
    ds = pkg.DataStore(tile=256, auths=auths,
                       metrics=pkg.metrics.MetricsRegistry() if metrics else None,
                       **KW[pkg], **kw)
    ds.create_schema(sft)
    lo = 0
    for n in writes:
        cols = {k: (v[0][lo:lo + n], v[1][lo:lo + n]) if k == "geom" else v[lo:lo + n]
                for k, v in data.items()}
        ds.write("v", pkg.FeatureCollection.from_columns(sft, np.arange(lo, lo + n), cols))
        lo += n
    return ds


def _ids(fc):
    return np.asarray(fc.ids).tolist()


def brute_visible(data, auths) -> np.ndarray:
    """The label evaluator of the test: each label of VIS_VALUES by hand."""
    if auths is None:
        return np.ones(len(data["vis"]), bool)
    a = set(auths)
    rule = {"": True, "analyst": "analyst" in a, "analyst&secret": {"analyst", "secret"} <= a,
            "secret|ops": bool({"secret", "ops"} & a), "ops": "ops" in a}
    return np.array([rule[v] for v in data["vis"]])


@pytest.fixture(scope="module")
def vis_stores():
    data = vis_data()
    out = {}
    for i, auths in enumerate(AUTHS):
        writes = (N,) if i % 2 == 0 else (2_600, 400)  # half of them tiered
        out[AUTH_IDS[i]] = tuple(vis_store(pkg, data, auths, writes=writes) for pkg in PKGS)
    return data, out


@pytest.mark.parametrize("auth", AUTH_IDS)
def test_queries_agree_in_order_under_auths(vis_stores, auth):
    data, stores = vis_stores
    jds, tds = stores[auth]
    auths = AUTHS[AUTH_IDS.index(auth)]
    seen = brute_visible(data, auths)
    for q in QUERIES:
        if auths is not None and "secret" not in auths and "code" in q:
            continue
        want = jds.query("v", q)
        got = tds.query("v", q)
        assert _ids(got) == _ids(want), q
        assert list(got.columns) == list(want.columns), q
        assert seen[np.asarray(got.ids, dtype=np.int64)].all(), q  # no restricted row
        assert _ids(tds.query("v", q, limit=7)) == _ids(jds.query("v", q, limit=7)), q
    many_t, many_j = tds.query_many("v", QUERIES[:4]), jds.query_many("v", QUERIES[:4])
    assert [_ids(o) for o in many_t] == [_ids(o) for o in many_j]
    hidden = auths is not None and "secret" not in auths
    assert ("code" in tds.query("v", QUERIES[0]).columns) == (not hidden)


@pytest.mark.parametrize("auth", AUTH_IDS)
def test_aggregations_agree_under_auths(vis_stores, auth):
    """count, density, bounds and stats in both modes, estimate_count:
    the same answers and the same fallback signals."""
    from geomesa_tpu.planning.explain import Explainer as JExp
    from geomesa_tpu_torch.planning.explain import Explainer as TExp

    _, stores = vis_stores
    jds, tds = stores[auth]
    for q in AGG_QUERIES + ["INCLUDE"]:
        assert tds.count("v", q) == jds.count("v", q), q
        assert tds.estimate_count("v", q) == jds.estimate_count("v", q), q
        got = tds.density("v", q, envelope=(-60, -40, 60, 40), width=16, height=8)
        ref = jds.density("v", q, envelope=(-60, -40, 60, 40), width=16, height=8)
        assert np.array_equal(np.asarray(got), np.asarray(ref)), q
        for est in (True, False):
            assert tds.bounds("v", q, estimate=est) == jds.bounds("v", q, estimate=est), q
            got = tds.stats_query("v", "Count();MinMax(age)", q, estimate=est)
            ref = jds.stats_query("v", "Count();MinMax(age)", q, estimate=est)
            assert [s.to_json() for s in got] == [s.to_json() for s in ref], q
            got = tds.stats_query("v", "Count()", q, estimate=est)
            ref = jds.stats_query("v", "Count()", q, estimate=est)
            assert [s.to_json() for s in got] == [s.to_json() for s in ref], q
    grids = [ds.density_many("v", [(q, None) for q in AGG_QUERIES], width=8, height=8)
             for ds in (jds, tds)]
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(*grids))
    t_exp, j_exp = TExp(), JExp()
    tds.bounds("v", AGG_QUERIES[0], explain=t_exp)
    jds.bounds("v", AGG_QUERIES[0], explain=j_exp)
    assert ("visibility" in t_exp.render().lower()) == ("visibility" in j_exp.render().lower())
    jc, tc = jds.metrics.snapshot()["counters"], tds.metrics.snapshot()["counters"]
    assert tc.get("geomesa.query.vis_fallback", 0) == jc.get("geomesa.query.vis_fallback", 0)
    assert (tc.get("geomesa.query.vis_fallback", 0) > 0) == (AUTHS[AUTH_IDS.index(auth)] is not None)


def test_device_aggregations_step_aside_under_visibility(monkeypatch):
    """While visibility is active no aggregation reaches a gather-free
    table aggregation (count estimate, density, bounds); with auths None
    the same calls do."""
    from geomesa_tpu_torch.storage.table import IndexTable

    calls = []
    for name in ("count", "density_submit", "bounds_stats"):
        orig = getattr(IndexTable, name)
        monkeypatch.setattr(IndexTable, name, lambda self, *a, _n=name, _o=orig, **k:
                            calls.append(_n) or _o(self, *a, **k))
    data = vis_data(n=1_000)
    q = AGG_QUERIES[1]
    for auths, expect in ((("analyst",), []), (None, ["count", "density_submit",
                                                         "bounds_stats"])):
        calls.clear()
        ds = vis_store(geomesa_tpu_torch, data, auths, writes=(1_000,))
        ds.stats_query("v", "Count()", q, estimate=True)
        ds.density("v", q)
        ds.bounds("v", q, estimate=True)
        assert calls == expect
        counters = ds.metrics.snapshot()["counters"]
        assert counters.get("geomesa.query.vis_fallback", 0) == (3 if auths else 0)


def test_visibility_fallback_signal():
    out = []
    q = "bbox(geom, 0, 0, 10, 10) AND dtg DURING 2024-01-02T00:00:00Z/2024-01-04T00:00:00Z"
    for pkg in PKGS:
        from importlib import import_module

        Explainer = import_module(pkg.__name__ + ".planning.explain").Explainer
        sft = pkg.FeatureType.from_spec("v", "name:String,vis:String,dtg:Date,*geom:Point:srid=4326")
        sft.user_data[pkg.security.VIS_FIELD_KEY] = "vis"
        reg = pkg.metrics.MetricsRegistry()
        ds = pkg.DataStore(tile=64, auths=("admin",), metrics=reg, **KW[pkg])
        ds.create_schema(sft)
        n = 200
        rng = np.random.default_rng(1)
        ds.write("v", pkg.FeatureCollection.from_columns(
            sft, [str(i) for i in range(n)],
            {"name": np.array(["x"] * n), "vis": np.array(["admin", ""] * (n // 2)),
             "dtg": T0 + rng.integers(0, 30 * DAY, n),
             "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))}))
        lines = []
        for call in (lambda e: ds.density("v", q, explain=e),
                     lambda e: ds.bounds("v", q, explain=e),
                     lambda e: ds.stats_query("v", "Count()", q, estimate=True, explain=e)):
            exp = Explainer()
            call(exp)
            assert "visibility" in exp.render().lower()
            lines.append([l for l in exp.lines if "visibility" in l.lower()])
        assert reg.snapshot()["counters"]["geomesa.query.vis_fallback"] == 3
        open_ds = pkg.DataStore(tile=64, **KW[pkg])
        gsft = pkg.FeatureType.from_spec("g", "dtg:Date,*geom:Point:srid=4326")
        open_ds.create_schema(gsft)
        open_ds.write("g", pkg.FeatureCollection.from_columns(
            gsft, np.arange(n), {"dtg": T0 + rng.integers(0, 30 * DAY, n),
                                 "geom": (rng.uniform(0, 10, n), rng.uniform(0, 10, n))}))
        exp = Explainer()
        open_ds.density("g", q, explain=exp)
        assert "visibility" not in exp.render().lower()
        out.append(lines)
    assert out[1] == out[0]


AV_SPEC = "name:String,ssn:String:vis=admin,dtg:Date,*geom:Point:srid=4326"
Q_WIDE = "bbox(geom, -170, -80, 170, 80) AND dtg DURING 2024-01-01T00:00:00Z/2024-01-25T00:00:00Z"


def _av_store(pkg, auths):
    sft = pkg.FeatureType.from_spec("av", AV_SPEC)
    ds = pkg.DataStore(tile=64, auths=auths, **KW[pkg])
    ds.create_schema(sft)
    n = 50
    rng = np.random.default_rng(2)
    ds.write("av", pkg.FeatureCollection.from_columns(
        sft, [str(i) for i in range(n)],
        {"name": np.array(["x"] * n), "ssn": np.array([f"s{i}" for i in range(n)]),
         "dtg": T0 + rng.integers(0, 30 * DAY, n),
         "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))}))
    return ds


@pytest.mark.parametrize("auths,sees", [(("user",), False), (("admin",), True), (None, True)],
                         ids=["unauthorized", "authorized", "no-auths"])
def test_attribute_visibility(auths, sees):
    outs = []
    for pkg in PKGS:
        out = _av_store(pkg, auths).query("av", Q_WIDE)
        assert len(out) > 0 and "name" in out.columns
        assert ("ssn" in out.columns) == sees
        outs.append((_ids(out), list(out.columns)))
    assert outs[1] == outs[0]


def test_filter_on_hidden_attribute_rejected():
    """A filter over a vis-protected attribute raises at plan time for
    auths that cannot see it (probing must not recover hidden values),
    with the same message in both packages; authorized auths query it."""
    msgs = []
    for pkg in PKGS:
        from importlib import import_module

        errors = import_module(pkg.__name__ + ".planning.errors")
        with pytest.raises(errors.QueryGuardError) as e:
            _av_store(pkg, ("user",)).query("av", "ssn = 's1'")
        msgs.append(str(e.value))
        assert _ids(_av_store(pkg, ("admin",)).query("av", "ssn = 's1'")) == ["1"]
    assert msgs[1] == msgs[0]


# -- federated views --------------------------------------------------------------


def _view_stores(pkg, seed=0, overlap=0):
    rng = np.random.default_rng(seed)
    stores = []
    n = 2_000
    for k in range(2):
        sft = pkg.FeatureType.from_spec("ev", "dtg:Date,*geom:Point:srid=4326")
        ds = pkg.DataStore(**KW[pkg])
        ds.create_schema(sft)
        x, y = rng.uniform(-50, 50, n), rng.uniform(-50, 50, n)
        t = T0 + rng.integers(0, 10 * DAY, n) + k * 10 * DAY
        ids = np.arange(k * (n - overlap), k * (n - overlap) + n)
        ds.write("ev", pkg.FeatureCollection.from_columns(sft, ids, {"dtg": t, "geom": (x, y)}),
                 check_ids=False)
        stores.append(ds)
    return stores


VIEW_QUERIES = ["bbox(geom, -10, -10, 10, 10)", "INCLUDE",
                "bbox(geom, 0, 0, 30, 30) AND dtg DURING 2024-01-05T00:00:00Z/2024-01-15T00:00:00Z"]


@pytest.mark.parametrize("overlap", [0, 300], ids=["disjoint-ids", "duplicate-ids"])
def test_merged_view_agrees(overlap):
    """Ids in order (the first store wins a duplicate id), limit pushed to
    each store, count, density grid and bounds in both modes."""
    outs = []
    for pkg in PKGS:
        from importlib import import_module

        views = import_module(pkg.__name__ + ".views")
        v = views.MergedView(_view_stores(pkg, overlap=overlap), "ev")
        res = []
        for q in VIEW_QUERIES:
            res.append((_ids(v.query(q)), _ids(v.query(q, limit=25)), v.count(q),
                        np.asarray(v.density(q, envelope=(-10, -10, 10, 10), width=8,
                                             height=8)).tolist(),
                        v.bounds(q), v.bounds(q, estimate=False)))
        assert v.get_schema().to_spec() == v.stores[0].get_schema("ev").to_spec()
        outs.append(res)
    assert outs[1] == outs[0]
    if overlap:
        ids = outs[1][1][0]
        assert len(ids) == len(set(ids)) == 4_000 - overlap


def test_merged_view_refuses_mismatched_schemas():
    a = geomesa_tpu_torch.DataStore(device="cpu")
    a.create_schema(geomesa_tpu_torch.FeatureType.from_spec("ev", "dtg:Date,*geom:Point:srid=4326"))
    b = geomesa_tpu_torch.DataStore(device="cpu")
    b.create_schema(geomesa_tpu_torch.FeatureType.from_spec("ev", "*geom:Point:srid=4326"))
    with pytest.raises(ValueError, match="disagree"):
        geomesa_tpu_torch.views.MergedView([a, b], "ev")
    with pytest.raises(ValueError, match="at least one"):
        geomesa_tpu_torch.views.MergedView([], "ev")


def test_routed_view_answers_like_its_store():
    """A router by time half sends each query to one store, which answers
    it exactly as queried directly; a None route takes the default."""
    split = T0 + 10 * DAY
    outs = []
    for pkg in PKGS:
        from importlib import import_module

        views = import_module(pkg.__name__ + ".views")
        extract = import_module(pkg.__name__ + ".filter.extract")
        stores = _view_stores(pkg, seed=4)

        def router(f):
            iv = extract.extract_intervals(f, "dtg")
            if not iv.values:
                return None
            return 0 if max(i.hi for i in iv.values) <= split else 1

        v = views.RoutedView(stores, "ev", router, default=1)
        res = []
        for q in VIEW_QUERIES:
            iv = extract.extract_intervals(pkg.filter.ecql.parse(q), "dtg")
            want = stores[1 if not iv.values or max(i.hi for i in iv.values) > split else 0]
            assert _ids(v.query(q)) == _ids(want.query("ev", q))
            assert v.count(q) == want.count("ev", q)
            res.append((_ids(v.query(q, limit=9)), v.count(q)))
        outs.append(res)
    assert outs[1] == outs[0]
