"""The port's id plans against the JAX DataStore, both on the CPU.

An id filter (``IN ('a', 'b')`` without a property) plans in both
packages as an id lookup ahead of every index: the filter's ids, sorted
and deduplicated, probe a per-chunk sorted id index, the rows gather in
that order, and the full filter refines them. So ids must agree **in
order** (sorted-id order, not feature order), under a limit and through
``query_many``; an OR whose disjuncts are all unsatisfiable plans as an
empty id lookup. ``id_lookup`` / ``id_exists_mask`` and the duplicate-id
refusal run through the same index, across the chunks of a tiered store.
The same seeded points (numpy) go into a JAX ``geomesa_tpu.DataStore``
and a port ``geomesa_tpu_torch.DataStore`` (device="cpu") on Z3 + Z2,
written once and in two writes (the second kept in the delta tier), with
integer and string ids. The JAX package's C++ host helpers are off, so
both take the same numpy ranges. Tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu_torch import native as tnative

# one intra-op thread per test process (the suite runs several side by side)
torch.set_num_threads(1)

N = 5_000
TILE = 4096
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
SPEC = "age:Integer,dtg:Date,*geom:Point:srid=4326"
# cell -> (write sizes, string ids)
CELLS = {
    "once": ([N], False),
    "tiered": ([3_000, 2_000], False),  # the second write stays in the delta
    "str-tiered": ([3_000, 2_000], True),
}


def _data(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, N)
    y = rng.uniform(-90, 90, N)
    t = T0 + rng.integers(0, 28 * DAY, N)
    age = rng.integers(0, 100, N).astype(np.int32)
    return x, y, t, age


def _ids_of(cell, lo, hi):
    ids = np.arange(lo, hi)
    return np.array([f"f{i}" for i in ids]) if CELLS[cell][1] else ids


def _build(pkg, cell, data, **kw):
    writes, _ = CELLS[cell]
    sft = pkg.FeatureType.from_spec("pts", SPEC)
    ds = pkg.DataStore(tile=TILE, **kw)
    ds.create_schema(sft)
    x, y, t, age = data
    start = 0
    for n in writes:
        sl = slice(start, start + n)
        ds.write("pts", pkg.FeatureCollection.from_columns(
            sft, _ids_of(cell, start, start + n),
            {"geom": (x[sl], y[sl]), "dtg": t[sl], "age": age[sl]},
        ))
        start += n
    return ds


@pytest.fixture(scope="module")
def stores():
    from geomesa_tpu import native

    data = _data()
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        yield {
            cell: (_build(geomesa_tpu, cell, data),
                   _build(geomesa_tpu_torch, cell, data, device="cpu"))
            for cell in CELLS
        }


def _id_queries(cell):
    p = "f" if CELLS[cell][1] else ""
    lst = ", ".join(f"'{p}{i}'" for i in (40, 7, 3999, 12, 4321, 2500))
    return [
        f"IN ({lst})",
        f"IN ({lst}) AND age > 10",
        f"IN ('{p}40', '{p}7') OR IN ('{p}12', '{p}3', '{p}4999')",
        f"IN ({lst}) AND bbox(geom, -180, -90, 0, 90)",
        f"IN ('{p}40', '{p}99999', '{p}7')",  # one id is not stored
    ]


CASES = [(c, k) for c in CELLS for k in range(len(_id_queries(c)))]


def _ids(fc) -> list:
    return np.asarray(fc.ids).tolist()


def _strategy(ds, q) -> str:
    return next(ln for ln in ds.explain("pts", q).splitlines() if "strategy=" in ln)


@pytest.mark.parametrize("cell,k", CASES, ids=[f"{c}-{k}" for c, k in CASES])
def test_id_queries_return_jax_ids_in_order(stores, cell, k):
    jds, tds = stores[cell]
    q = _id_queries(cell)[k]
    assert _strategy(tds, q) == _strategy(jds, q) == "Plan: strategy=id-lookup"
    ref = _ids(jds.query("pts", q))
    assert len(ref) and _ids(tds.query("pts", q)) == ref
    # sorted-id order: not the rows' order in the store
    assert ref == sorted(ref, key=str)
    for limit in (1, 3):
        assert _ids(tds.query("pts", q, limit=limit)) == _ids(jds.query("pts", q, limit=limit))
        assert _ids(tds.query("pts", q, limit=limit)) == ref[:limit]
    assert tds.count("pts", q) == jds.count("pts", q) == len(ref)


def test_id_order_is_not_feature_order(stores):
    """The case the port got wrong before it planned id lookups: the
    stored order of ids 7, 12, 40, 3999 is not their sorted-string order."""
    jds, tds = stores["once"]
    q = "IN ('40','7','3999','12')"
    assert _ids(jds.query("pts", q)) == _ids(tds.query("pts", q)) == [12, 3999, 40, 7]
    assert _ids(tds.query("pts", "IN ('40','7') OR IN ('12','3')")) == [12, 3, 40, 7]


@pytest.mark.parametrize("q", [
    "(bbox(geom, 0, 0, 1, 1) AND bbox(geom, 5, 5, 6, 6)) OR "
    "(dtg DURING 2024-01-02T00:00:00Z/2024-01-03T00:00:00Z AND "
    "dtg DURING 2024-01-06T00:00:00Z/2024-01-07T00:00:00Z)",
    "IN ('1', '2') AND IN ('3')",
])
def test_unsatisfiable_filters_plan_an_empty_id_lookup(stores, q):
    jds, tds = stores["tiered"]
    jplan, tplan = jds.planner.plan("pts", q), tds.planner.plan("pts", q)
    assert tplan.strategy == jplan.strategy == "id-lookup"
    assert tplan.ids == jplan.ids == []
    assert tplan.config.disjoint and jplan.config.disjoint
    assert len(tds.query("pts", q)) == len(jds.query("pts", q)) == 0
    assert tds.count("pts", q) == 0


@pytest.mark.parametrize("cell", list(CELLS))
def test_id_query_many_equals_jax(stores, cell):
    jds, tds = stores[cell]
    queries = _id_queries(cell) + [
        "bbox(geom, -60, -30, 60, 40)",
        "bbox(geom, 100, -80, 170, -10) AND dtg DURING 2024-01-03T00:00:00Z/2024-01-20T00:00:00Z",
    ]
    for limit in (None, 2):
        got = tds.query_many("pts", queries, limit=limit)
        ref = jds.query_many("pts", queries, limit=limit)
        assert len(got) == len(queries)
        for q, g, r in zip(queries, got, ref):
            assert _ids(g) == _ids(r), q


@pytest.mark.parametrize("cell", list(CELLS))
def test_aggregations_under_id_filters_equal_jax(stores, cell):
    """count, density and bounds (estimate on and off) over id plans: the
    port takes the host path over the gathered rows, as the JAX package
    does."""
    jds, tds = stores[cell]
    for q in _id_queries(cell):
        assert tds.count("pts", q) == jds.count("pts", q)
        for est in (True, False):
            assert tds.bounds("pts", q, estimate=est) == jds.bounds("pts", q, estimate=est)
        got = tds.density("pts", q, envelope=(-180, -90, 180, 90), width=32, height=16)
        ref = jds.density("pts", q, envelope=(-180, -90, 180, 90), width=32, height=16)
        assert np.array_equal(got, np.asarray(ref)) and got.sum() > 0
        got = tds.stats_query("pts", "Count()", q, estimate=True)
        ref = jds.stats_query("pts", "Count()", q, estimate=True)
        assert [s.to_json() for s in got] == [s.to_json() for s in ref]


@pytest.mark.parametrize("cell", ["tiered", "str-tiered"])
def test_id_lookup_and_exists_mask_on_a_tiered_store(stores, cell):
    jds, tds = stores[cell]
    assert len(tds.chunk_snapshot("pts")) == 2  # main chunk + delta chunk
    rng = np.random.default_rng(7)
    want = np.concatenate([rng.choice(N, 40, replace=False), N + np.arange(5)])
    rng.shuffle(want)
    probes = [_ids_of(cell, 0, N + 10)[want]]
    if not CELLS[cell][1]:
        probes.append(np.array([str(i) for i in want]))  # ECQL-style string ids
    for ids in probes:
        got = tds.id_lookup("pts", ids)
        assert np.array_equal(got, jds.id_lookup("pts", ids))
        assert np.array_equal(got, want[want < N])  # ordinals are the ids here
        mask = tds.id_exists_mask("pts", ids)
        assert np.array_equal(mask, jds.id_exists_mask("pts", ids))
        assert np.array_equal(mask, want < N)


@pytest.mark.parametrize("cell", ["tiered", "str-tiered"])
def test_duplicate_ids_are_refused_across_chunks(cell):
    data = _data(seed=4)
    pair = [_build(geomesa_tpu, cell, data), _build(geomesa_tpu_torch, cell, data, device="cpu")]
    x, y, t, age = data
    for pkg, ds in zip((geomesa_tpu, geomesa_tpu_torch), pair):
        sft = ds.get_schema("pts")

        def batch(ids):
            k = len(ids)
            return pkg.FeatureCollection.from_columns(
                sft, ids, {"geom": (x[:k], y[:k]), "dtg": t[:k], "age": age[:k]})

        # an id of the first chunk, then of the delta chunk
        for dup in (17, 4_321):
            ids = _ids_of(cell, N + 100, N + 103)
            ids[1] = _ids_of(cell, dup, dup + 1)[0]
            with pytest.raises(ValueError, match="duplicate"):
                ds.write("pts", batch(ids))
        with pytest.raises(ValueError, match="duplicate"):
            ds.write("pts", batch(_ids_of(cell, N + 200, N + 201).repeat(2)))
        assert ds.row_count("pts") == N  # nothing of a refused batch lands
        # an id wider than the stored ids' width is no duplicate
        wide = np.array(["f12345678"]) if CELLS[cell][1] else np.array([123_456_789])
        assert ds.write("pts", batch(wide)) == 1
    assert _ids(pair[1].query("pts", "IN ('f12345678', '123456789')")) == _ids(
        pair[0].query("pts", "IN ('f12345678', '123456789')"))
