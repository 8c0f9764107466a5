"""The port's attribute indexes against the JAX DataStore, both on the CPU.

A schema attribute with ``index=true`` gets an attribute index in both
packages (``attr_<name>``): the sort key is an order-preserving u64
lexicode of the value, strings add secondary sort words past the 8-byte
prefix, a value range prunes to row spans by searchsorted, and kernel
hits clip back to those spans. Rows therefore come back in value order
(then feature order within a value), and a ``limit`` page is that
order's prefix. Before the port had attribute indexes it answered these
filters with a full-table host scan (feature order) or a z index (z
order): the same sets, another order.

The same seeded rows go into a JAX ``geomesa_tpu.DataStore`` and a port
``geomesa_tpu_torch.DataStore(device="cpu")``: a point schema with an
Integer, a Double and a String attribute index (names longer than 8
bytes that share their prefixes, plus short and empty names), and an
extent schema with a String attribute index. Each is written once, in
two writes (the second kept in the delta tier), and in two writes then
compacted. Both packages take their native host helpers. Required:
the same strategy line, ids in order, under ``limit`` 1 and 3, through
``query_many``, and the same counts and count estimates. The mutation
surface (``fold_upsert``, ``delete_features``, ``modify_features``) on
the point schema keeps the same sort state, secondary sort words
included. Tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

N = 4_000
TILE = 4096
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
POINT_SPEC = ("age:Integer:index=true,score:Double:index=true,name:String:index=true,"
              "dtg:Date,*geom:Point:srid=4326")
EXTENT_SPEC = "tag:String:index=true,*geom:Polygon:srid=4326"
# names of 0-23 bytes: many share an 8-byte prefix ("UNITED S", "UNITED K"),
# so the secondary sort words decide the boundary runs
STEMS = ["UNITED STATES", "UNITED STATES NAVY", "UNITED KINGDOM", "UNITED KINGDOM POLICE",
         "UNITED NATIONS", "UNITED ARAB EMIRATES", "CHINA", "RUSSIA", "IRAN", "", "UN"]
CUTS = {"once": None, "tiered": 2_600, "compacted": 2_600}


def _data(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, N)
    y = rng.uniform(-90, 90, N)
    t = T0 + rng.integers(0, 28 * DAY, N)
    age = rng.integers(0, 100, N).astype(np.int32)
    score = np.round(rng.normal(0, 50, N), 1)
    stem = rng.integers(0, len(STEMS), N)
    suffix = rng.integers(0, 30, N)
    name = np.array([
        STEMS[s] + (f" {k}" if STEMS[s] and k % 3 else "") for s, k in zip(stem, suffix)
    ])
    tag = np.array([STEMS[s] + f"/{k}" for s, k in zip(stem, suffix)])
    w = rng.uniform(0.01, 2.0, N)
    h = rng.uniform(0.01, 2.0, N)
    return x, y, t, age, score, name, tag, w, h


def _fc(pkg, sft, data, lo, hi):
    x, y, t, age, score, name, tag, w, h = data
    sl = slice(lo, hi)
    if sft.name == "pts":
        cols = {"geom": (x[sl], y[sl]), "dtg": t[sl], "age": age[sl], "score": score[sl],
                "name": name[sl]}
    else:
        x0, y0 = np.clip(x[sl], -178, 176), np.clip(y[sl], -88, 86)
        cols = {"geom": pkg.geometry.PackedGeometryColumn.from_boxes(x0, y0, x0 + w[sl], y0 + h[sl]),
                "tag": tag[sl]}
    return pkg.FeatureCollection.from_columns(sft, np.arange(lo, hi), cols)


def _build(pkg, schema, cell, data, **kw):
    sft = pkg.FeatureType.from_spec(schema, POINT_SPEC if schema == "pts" else EXTENT_SPEC)
    ds = pkg.DataStore(tile=TILE, **kw)
    ds.create_schema(sft)
    cut = CUTS[cell]
    for lo, hi in ([(0, N)] if cut is None else [(0, cut), (cut, N)]):
        ds.write(schema, _fc(pkg, sft, data, lo, hi))
    if cell == "compacted":
        ds.compact(schema)
    return ds


@pytest.fixture(scope="module")
def stores():
    ensure_jax_native()  # both packages native, whatever a build race left
    data = _data()
    return {
        (schema, cell): (_build(geomesa_tpu, schema, cell, data),
                         _build(geomesa_tpu_torch, schema, cell, data, device="cpu"))
        for schema in ("pts", "ext") for cell in CUTS
    }


def _dur(d0, d1):
    return (f"dtg DURING {np.datetime64(T0 + d0 * DAY, 'ms')}Z/"
            f"{np.datetime64(T0 + d1 * DAY, 'ms')}Z")


QUERIES = {
    "pts": [
        "age = 42",
        "age BETWEEN 10 AND 12",
        "age < 3",
        "age > 95 AND bbox(geom, -180, -90, 0, 90)",
        "age IN (7, 70, 33)",
        f"age IN (3, 4, 5) AND bbox(geom, -100, -50, 100, 50) AND {_dur(2, 20)}",
        "age > 50 AND age < 10",  # disjoint
        "score >= 60.5",
        "score BETWEEN -10.0 AND 2.5",
        "score < -100 AND bbox(geom, 0, -90, 180, 90)",
        "name = 'UNITED KINGDOM 4'",
        "name = 'UNITED STATES'",
        "name BETWEEN 'UNITED KINGDOM 1' AND 'UNITED NATIONS 2'",
        "name BETWEEN 'UNITED STATES 2' AND 'UNITED STATES NAVY 1'",
        "name > 'UNITED STATES NAVY 2'",
        "name < 'UNITED ARAB'",
        "name IN ('RUSSIA 5', 'UNITED STATES NAVY 7', 'UN')",
        f"name BETWEEN 'UNITED K' AND 'UNITED S' AND bbox(geom, -120, -60, 60, 70) AND {_dur(0, 14)}",
        "name > 'Z' AND name < 'A'",  # disjoint
        f"name = 'UNITED KINGDOM 4' AND bbox(geom, -120, -60, 60, 70) AND {_dur(0, 14)}",
        f"age = 42 AND {_dur(3, 17)}",
    ],
    "ext": [
        "tag = 'UNITED KINGDOM/4'",
        "tag BETWEEN 'UNITED KINGDOM/1' AND 'UNITED NATIONS/2'",
        "tag < 'CHINA/2'",
        "tag > 'UNITED STATES NAVY/20'",
        "tag IN ('/3', 'IRAN/9', 'UNITED STATES/12')",
        "tag BETWEEN 'UNITED A' AND 'UNITED Z' AND bbox(geom, -60, -40, 60, 40)",
        "tag > 'Z' AND tag < 'A'",  # disjoint
        "tag = 'IRAN/9' AND bbox(geom, -60, -40, 60, 40)",
    ],
}
CASES = [(s, c, k) for s in QUERIES for c in CUTS for k in range(len(QUERIES[s]))]


def _ids(fc) -> list:
    return np.asarray(fc.ids).tolist()


def _strategy(ds, schema, q) -> list:
    return [ln.strip() for ln in ds.explain(schema, q).splitlines() if "Strategy:" in ln]


@pytest.mark.parametrize("schema,cell,k", CASES, ids=[f"{s}-{c}-{k}" for s, c, k in CASES])
def test_attribute_queries_return_jax_ids_in_order(stores, schema, cell, k):
    jds, tds = stores[(schema, cell)]
    q = QUERIES[schema][k]
    ref = _ids(jds.query(schema, q))
    assert _ids(tds.query(schema, q)) == ref
    for limit in (1, 3):
        assert _ids(tds.query(schema, q, limit=limit)) == _ids(jds.query(schema, q, limit=limit))
    assert _strategy(tds, schema, q) == _strategy(jds, schema, q)
    if "bbox" not in q and "dtg" not in q:  # pure attribute filters plan an attribute index
        assert tds.planner.plan(schema, q).index == jds.planner.plan(schema, q).index
        assert jds.planner.plan(schema, q).index.startswith("attr_")
    assert tds.count(schema, q) == jds.count(schema, q) == len(ref)
    plan = tds.planner.plan(schema, q)
    if plan.index is not None and plan.index.startswith("attr_"):
        # the table's count estimate: span lengths, or the clipped scan
        jplan = jds.planner.plan(schema, q)
        assert tds.table(schema, plan.index).count(plan.config) == \
            jds.table(schema, jplan.index).count(jplan.config)
    got = tds.stats_query(schema, "Count()", q, estimate=True)
    want = jds.stats_query(schema, "Count()", q, estimate=True)
    assert [s.to_json() for s in got] == [s.to_json() for s in want]


def test_value_order_is_not_feature_order(stores):
    """The case the port got wrong without attribute indexes: rows of a
    value range come back in value order, so a limit page is the first
    values, not the first rows written."""
    jds, tds = stores[("pts", "once")]
    q = "age BETWEEN 10 AND 12"
    ages = dict(zip(_ids(tds.query("pts", q)), tds.query("pts", q).columns["age"]))
    got = _ids(tds.query("pts", q))
    assert got == _ids(jds.query("pts", q))
    assert [ages[i] for i in got] == sorted(ages[i] for i in got)
    assert got != sorted(got)  # not feature order


@pytest.mark.parametrize("schema,cell", [(s, c) for s in QUERIES for c in CUTS])
def test_attribute_query_many_equals_sequential_and_jax(stores, schema, cell):
    jds, tds = stores[(schema, cell)]
    qs = QUERIES[schema]
    for limit in (None, 2):
        got = [_ids(r) for r in tds.query_many(schema, qs, limit=limit)]
        assert got == [_ids(r) for r in jds.query_many(schema, qs, limit=limit)]
        assert got == [_ids(tds.query(schema, q, limit=limit)) for q in qs]


def test_attribute_plans_stay_off_the_device_aggregations(stores):
    jds, tds = stores[("pts", "tiered")]
    env = (-180, -90, 180, 90)
    for q in ("age = 42", "name = 'UNITED KINGDOM 4' AND bbox(geom, -120, -60, 60, 70)"):
        plan = tds.planner.plan("pts", q)
        assert plan.index.startswith("attr_") and plan.config.clip_rows
        assert not tds._device_aggregable("pts", plan)
        got = tds.density("pts", q, envelope=env, width=32, height=16)
        assert np.array_equal(got, np.asarray(jds.density("pts", q, envelope=env, width=32, height=16)))
        for est in (True, False):
            assert tds.bounds("pts", q, estimate=est) == jds.bounds("pts", q, estimate=est)


def test_indices_enabled_attr_keeps_every_attribute_index():
    for pkg in (geomesa_tpu, geomesa_tpu_torch):
        sft = pkg.FeatureType.from_spec("pts", POINT_SPEC)
        sft.user_data["geomesa.indices.enabled"] = "z3,attr"
        ds = pkg.DataStore(tile=TILE, **({"device": "cpu"} if pkg is geomesa_tpu_torch else {}))
        ds.create_schema(sft)
        assert [i.name for i in ds.indexes("pts")] == ["z3", "attr_age", "attr_score", "attr_name"]


# ------------------------------------------------------------- mutation


def _sort_state(ds, schema) -> dict:
    out = {"ids": np.asarray(ds.features(schema).ids)}
    for idx in ds.indexes(schema):
        t = ds.table(schema, idx.name)
        main = getattr(t, "main", t)
        for k in ("perm", "bins", "zs", "ubins", "bin_starts"):
            out[f"{idx.name}.{k}"] = np.asarray(getattr(main, k))
        sub = main.subkeys
        out[f"{idx.name}.subkeys"] = np.zeros((0, 0), np.uint64) if sub is None else sub
        out.update({f"{idx.name}.cols3.{k}": np.asarray(v) for k, v in main.cols3.items()})
    return out


def _assert_same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


MUTATION_QUERIES = ["age BETWEEN 10 AND 12", "name BETWEEN 'UNITED KINGDOM 1' AND 'UNITED STATES 4'",
                    f"score > 40 AND bbox(geom, -120, -60, 60, 70) AND {_dur(0, 14)}"]


@pytest.mark.parametrize("cell", ["once", "tiered"])
def test_mutations_keep_the_jax_sort_state(cell):
    data = _data(seed=12)
    fresh = _data(seed=13)  # the upserted rows' values
    pair = [_build(geomesa_tpu, "pts", cell, data),
            _build(geomesa_tpu_torch, "pts", cell, data, device="cpu")]
    steps = [
        # ids 0-399 exist: the fold replaces them with other values
        ("fold_upsert", lambda pkg, ds: ds.fold_upsert(
            "pts", _fc(pkg, ds.get_schema("pts"), fresh, 0, 400))),
        ("delete_features", lambda pkg, ds: ds.delete_features(
            "pts", "name BETWEEN 'UNITED KINGDOM' AND 'UNITED NATIONS 9'")),
        ("modify_features", lambda pkg, ds: ds.modify_features(
            "pts", {"name": "UNITED STATES NAVY 99"}, "age < 5")),
        ("fold_upsert again", lambda pkg, ds: ds.fold_upsert(
            "pts", _fc(pkg, ds.get_schema("pts"), fresh, 1000, 1200))),
    ]
    for label, op in steps:
        outs = [op(pkg, ds) for pkg, ds in zip((geomesa_tpu, geomesa_tpu_torch), pair)]
        assert outs[0] == outs[1], label
        _assert_same(_sort_state(pair[0], "pts"), _sort_state(pair[1], "pts"))
        for q in MUTATION_QUERIES:
            assert _ids(pair[1].query("pts", q)) == _ids(pair[0].query("pts", q)), (label, q)


def test_fold_with_wider_names_keeps_value_order():
    """A fold whose names need more secondary words than the table's pads
    the narrower words with zeros before the rebuild (a shorter string
    sorts before any extension): the folded store answers as a store
    written once with the same rows."""
    data = _data(seed=14)
    sft = geomesa_tpu_torch.FeatureType.from_spec("pts", POINT_SPEC)
    ds = _build(geomesa_tpu_torch, "pts", "once", data, device="cpu")
    wide = list(data)
    wide[5] = np.array([f"{n} OF THE REPUBLIC OF SOMEWHERE" for n in data[5]])
    batch = _fc(geomesa_tpu_torch, sft, tuple(wide), 0, 300)
    ds.fold_upsert("pts", batch)
    assert ds.table("pts", "attr_name").subkeys.shape[1] > 2
    once = geomesa_tpu_torch.DataStore(tile=TILE, device="cpu")
    once.create_schema(geomesa_tpu_torch.FeatureType.from_spec("pts", POINT_SPEC))
    once.write("pts", geomesa_tpu_torch.FeatureCollection.concat(
        [_fc(geomesa_tpu_torch, sft, data, 300, N), batch]))
    for q in ("name BETWEEN 'UNITED KINGDOM' AND 'UNITED STATES 9'", "name > 'UNITED S'",
              f"name = '{wide[5][0]}'"):
        got = _ids(ds.query("pts", q))
        assert len(got) and got == _ids(once.query("pts", q)), q
