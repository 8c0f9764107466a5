"""The port's union plans against the JAX DataStore, both on the CPU.

A filter that no single index serves but whose DNF disjuncts each have an
index (``bbox(...) OR dtg DURING ...``) plans as a union of index scans in
both packages: each branch scans its own index with its own disjunct
filter, the branches concatenate in disjunct order, and rows dedup by
first occurrence, so ids must agree **in order**, under a limit and
through ``query_many``. A disjunct that needs a full scan keeps the whole
query on one full-table scan. The same seeded points (numpy) go into a
JAX ``geomesa_tpu.DataStore`` and a port ``geomesa_tpu_torch.DataStore``
(device="cpu") on Z3 + Z2, with packed time off and on, and once in two
writes so the branches read a delta tier. The copied ``rewrite_dnf`` is
held to the JAX package's on seeded filter trees. The JAX package's C++
host helpers are off, so both take the same numpy ranges. Tolerance is
exact equality.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu_torch import native as tnative
from geomesa_tpu.filter import dnf as jdnf
from geomesa_tpu_torch.filter import dnf as tdnf

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

N = 20_000
TILE = 4096
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
SPEC = "age:Integer,dtg:Date,*geom:Point:srid=4326"
CELLS = {
    "z3": ({}, [N]),
    "z3-packed": ({"geomesa.z3.packed-time": "true"}, [N]),
    "z3-tiered": ({}, [12_000, 8_000]),  # the second write stays in the delta
}


def _data(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, N)
    y = rng.uniform(-90, 90, N)
    t = T0 + rng.integers(0, 28 * DAY, N)
    age = rng.integers(0, 100, N).astype(np.int32)
    return x, y, t, age


def _build(pkg, cell, data, **kw):
    ud, writes = CELLS[cell]
    sft = pkg.FeatureType.from_spec("pts", SPEC)
    sft.user_data.update(ud)
    ds = pkg.DataStore(tile=TILE, **kw)
    ds.create_schema(sft)
    x, y, t, age = data
    start = 0
    for n in writes:
        sl = slice(start, start + n)
        ds.write("pts", pkg.FeatureCollection.from_columns(
            sft, np.arange(start, start + n), {"geom": (x[sl], y[sl]), "dtg": t[sl], "age": age[sl]}
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
            cell: (_build(geomesa_tpu, cell, data), _build(geomesa_tpu_torch, cell, data,
                                                           device="cpu"))
            for cell in CELLS
        }


def _dur(d0, d1):
    lo = np.datetime64(T0 + d0 * DAY, "ms")
    hi = np.datetime64(T0 + d1 * DAY, "ms")
    return f"dtg DURING {lo}Z/{hi}Z"


POLY = "INTERSECTS(geom, POLYGON ((0 -10, 30 -10, 25 20, 5 15, 0 -10)))"
EMPTY_BOX = "(bbox(geom, 0, 0, 1, 1) AND bbox(geom, 5, 5, 6, 6))"
# each plans as a union of a z2 scan (the spatial disjunct) and a z3 scan
# (the window) in both packages
UNIONS = [
    f"bbox(geom, -60, -30, 60, 40) OR {_dur(3, 9)}",
    f"bbox(geom, 100, -80, 170, -10) OR {_dur(20, 21)}",
    f"{POLY} OR {_dur(10, 11)}",
    # one unsatisfiable disjunct, dropped from the union
    f"{EMPTY_BOX} OR bbox(geom, -20, -20, 0, 0) OR {_dur(3, 4)}",
    # De Morgan: NOT (NOT a AND NOT b) is a OR b
    f"NOT (NOT bbox(geom, -60, -30, 60, 40) AND NOT {_dur(3, 9)})",
]
FULL_SCAN = "bbox(geom, -20, -20, 0, 0) OR age > 50"
CASES = [(c, q) for c in CELLS for q in UNIONS]
CASE_IDS = [f"{c}-{i}" for c in CELLS for i in range(len(UNIONS))]


def _ids(fc) -> np.ndarray:
    return np.asarray(fc.ids, np.int64)


def _strategy(ds, q) -> str:
    return next(ln for ln in ds.explain("pts", q).splitlines() if "strategy=" in ln)


@pytest.mark.parametrize("cell,q", CASES, ids=CASE_IDS)
def test_union_ids_in_order_and_limits_equal_jax(stores, cell, q):
    jds, tds = stores[cell]
    assert "union of 2 index scans" in tds.explain("pts", q)
    assert _strategy(tds, q) == _strategy(jds, q) == "Plan: strategy=union(z2+z3)"
    ref = _ids(jds.query("pts", q))
    assert len(ref) and np.array_equal(_ids(tds.query("pts", q)), ref)
    for limit in (1, 7):
        got = _ids(tds.query("pts", q, limit=limit))
        assert np.array_equal(got, ref[:limit])
        assert np.array_equal(got, _ids(jds.query("pts", q, limit=limit)))
    assert tds.count("pts", q) == jds.count("pts", q) == len(ref)


def test_union_is_branch_one_then_unseen_rows_of_branch_two(stores):
    """The port's union alone: the spatial branch's ids in its scan order,
    then the window branch's ids not already returned, in theirs."""
    tds = stores["z3"][1]
    box, win = "bbox(geom, -60, -30, 60, 40)", _dur(3, 9)
    first, second = _ids(tds.query("pts", box)), _ids(tds.query("pts", win))
    expect = np.concatenate([first, second[~np.isin(second, first)]])
    assert np.array_equal(_ids(tds.query("pts", f"{box} OR {win}")), expect)


@pytest.mark.parametrize("cell", list(CELLS))
def test_union_query_many_equal_jax(stores, cell):
    jds, tds = stores[cell]
    queries = [*UNIONS, FULL_SCAN]
    for limit in (None, 7):
        got = tds.query_many("pts", queries, limit=limit)
        ref = jds.query_many("pts", queries, limit=limit)
        assert len(got) == len(queries)
        for q, g, r in zip(queries, got, ref):
            assert np.array_equal(_ids(g), _ids(r)), q


@pytest.mark.parametrize("cell", list(CELLS))
def test_or_with_a_full_scan_disjunct_stays_one_full_scan(stores, cell):
    jds, tds = stores[cell]
    exp = tds.explain("pts", FULL_SCAN)
    assert "a disjunct needs a full scan" in exp
    assert _strategy(tds, FULL_SCAN) == _strategy(jds, FULL_SCAN) == "Plan: strategy=full-scan"
    ref = _ids(jds.query("pts", FULL_SCAN))
    assert len(ref) and np.array_equal(_ids(tds.query("pts", FULL_SCAN)), ref)
    assert np.array_equal(_ids(tds.query("pts", FULL_SCAN, limit=7)), ref[:7])


def test_or_of_unsatisfiable_disjuncts_is_empty(stores):
    """Every disjunct unsatisfiable: both packages plan an empty id lookup
    and return nothing."""
    jds, tds = stores["z3"]
    q = f"{EMPTY_BOX} OR ({_dur(1, 2)} AND {_dur(5, 6)})"
    assert _strategy(tds, q) == _strategy(jds, q) == "Plan: strategy=id-lookup"
    assert len(jds.query("pts", q)) == len(tds.query("pts", q)) == 0
    assert tds.count("pts", q) == 0


LEAVES = [
    "bbox(geom, 0, 0, 10, 10)",
    "bbox(geom, -40, -20, -20, -10)",
    "age > 50",
    "age <= 7",
    f"dtg DURING {np.datetime64(T0, 'ms')}Z/{np.datetime64(T0 + DAY, 'ms')}Z",
    POLY,
]


def _tree(pkg, rng, depth, root=True):
    """A random And / Or / Not tree over LEAVES (never a bare leaf at the
    root), built from one seeded stream so both packages get the same
    tree."""
    preds = pkg.filter.predicates
    kind = int(rng.integers(0, 3 if root else 4)) if depth > 0 else 3
    if kind == 3:
        return pkg.filter.ecql.parse(LEAVES[int(rng.integers(0, len(LEAVES)))])
    if kind == 2:
        return preds.Not(_tree(pkg, rng, depth - 1, False))
    cls = preds.And if kind == 0 else preds.Or
    return cls([_tree(pkg, rng, depth - 1, False) for _ in range(int(rng.integers(2, 4)))])


@pytest.mark.parametrize("seed", range(12))
def test_rewrite_dnf_equals_jax(seed):
    jf = _tree(geomesa_tpu, np.random.default_rng(seed), 4)
    tf = _tree(geomesa_tpu_torch, np.random.default_rng(seed), 4)
    assert repr(tf) == repr(jf)
    for limit in (4, tdnf.MAX_DISJUNCTS):
        got, ref = tdnf.rewrite_dnf(tf, limit), jdnf.rewrite_dnf(jf, limit)
        assert (got is None) == (ref is None)
        assert repr(got) == repr(ref)
