"""A seeded differential test of the port's query path against the JAX
package, on the CPU.

Two hundred random filter trees, made from a fixed seed: leaves are
BBOX, DURING, integer, double and string comparisons, LIKE, id IN,
INTERSECTS with a triangle and DWITHIN, under up to two levels of AND,
OR and NOT. Each tree gets random hints: sort ascending or descending
on a random attribute, ``offset`` with a ``limit``, sampling (plain or
stratified), ``loose`` and transforms. Half the trees run on a point
schema (Z3 and Z2 indexes), half on a dated extent schema (XZ3 and XZ2),
each written once and in two writes whose second stays in the delta
tier. Both packages take their native host helpers. Required for every
tree: the same ids in the same order, with and without the hints, and
the same pages under ``limit`` and ``offset``. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu.planning.hints import QueryHints as JHints
from geomesa_tpu_torch.planning.hints import QueryHints as THints
from test_torch_hints import DAY, NAMES, T0, point_data, point_store
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

N = 3_000
TILE = 1024
SEED = 20261017
N_TREES = 100  # per schema
CHUNK = 10
EXTENT_SPEC = "tag:String,rank:Integer,dtg:Date,*geom:Polygon:srid=4326"
ATTRS = {
    "pts": {"int": "age", "float": "score", "str": "name", "sort": ["dtg", "age", "name", "score"]},
    "ext": {"int": "rank", "float": None, "str": "tag", "sort": ["dtg", "rank", "tag"]},
}


def extent_data(seed=13, n=N):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-60, 58, n)
    y0 = rng.uniform(-40, 38, n)
    w = rng.uniform(0.01, 2.0, n)
    h = rng.uniform(0.01, 2.0, n)
    t = T0 + rng.integers(0, 20 * DAY, n)
    tag = NAMES[rng.integers(0, len(NAMES), n)]
    rank = rng.integers(0, 10, n).astype(np.int32)
    return x0, y0, x0 + w, y0 + h, t, tag, rank


def extent_store(pkg, data, writes=(N,), **kw):
    sft = pkg.FeatureType.from_spec("ext", EXTENT_SPEC)
    ds = pkg.DataStore(tile=TILE, **kw)
    ds.create_schema(sft)
    x0, y0, x1, y1, t, tag, rank = data
    lo = 0
    for n in writes:
        sl = slice(lo, lo + n)
        cols = {"geom": pkg.geometry.PackedGeometryColumn.from_boxes(x0[sl], y0[sl], x1[sl], y1[sl]),
                "dtg": t[sl], "tag": tag[sl], "rank": rank[sl]}
        ds.write("ext", pkg.FeatureCollection.from_columns(sft, np.arange(lo, lo + n), cols))
        lo += n
    return ds


def _stamp(ms) -> str:
    return f"{np.datetime64(int(ms), 'ms')}Z"


def _leaf(rng, schema) -> str:
    a = ATTRS[schema]
    kinds = ["bbox", "during", "int", "str", "like", "ids", "intersects", "dwithin"]
    if a["float"]:
        kinds.append("float")
    kind = kinds[int(rng.integers(len(kinds)))]
    if kind == "bbox":
        x0, y0 = rng.uniform(-65, 50), rng.uniform(-45, 30)
        return f"bbox(geom, {x0:.3f}, {y0:.3f}, {x0 + rng.uniform(1, 40):.3f}, {y0 + rng.uniform(1, 30):.3f})"
    if kind == "during":
        d0 = int(rng.integers(0, 19 * DAY))
        return f"dtg DURING {_stamp(T0 + d0)}/{_stamp(T0 + d0 + int(rng.integers(3_600_000, 8 * DAY)))}"
    if kind == "int":
        op = ["<", "<=", ">", ">=", "="][int(rng.integers(5))]
        return f"{a['int']} {op} {int(rng.integers(0, 30))}"
    if kind == "float":
        op = ["<", ">="][int(rng.integers(2))]
        return f"{a['float']} {op} {rng.normal(0, 10):.2f}"
    if kind == "str":
        return f"{a['str']} = '{NAMES[int(rng.integers(len(NAMES)))]}'"
    if kind == "like":
        return f"{a['str']} LIKE '{['UN%', '%a', '_r%', 'e%o'][int(rng.integers(4))]}'"
    if kind == "ids":
        ids = rng.choice(N, int(rng.integers(1, 30)), replace=False)
        return "IN (" + ", ".join(f"'{i}'" for i in ids) + ")"
    if kind == "intersects":
        cx, cy, r = rng.uniform(-55, 50), rng.uniform(-35, 30), rng.uniform(2, 25)
        return (f"INTERSECTS(geom, POLYGON (({cx:.3f} {cy:.3f}, {cx + r:.3f} {cy:.3f}, "
                f"{cx + r / 3:.3f} {cy + r:.3f}, {cx:.3f} {cy:.3f})))")
    cx, cy = rng.uniform(-55, 55), rng.uniform(-35, 35)
    return f"DWITHIN(geom, POINT ({cx:.3f} {cy:.3f}), {rng.uniform(50, 1500):.1f}, kilometers)"


def _tree(rng, schema, depth=0) -> str:
    r = rng.uniform()
    if depth >= 2 or r < 0.3:
        return _leaf(rng, schema)
    if r < 0.4:
        return f"NOT ({_tree(rng, schema, depth + 1)})"
    op = " AND " if r < 0.75 else " OR "
    parts = [_tree(rng, schema, depth + 1) for _ in range(int(rng.integers(2, 4)))]
    return "(" + op.join(parts) + ")"


def _hints(rng, schema):
    """(hints kwargs, limit) for one tree."""
    kw, limit = {}, None
    if rng.uniform() < 0.5:
        key = ATTRS[schema]["sort"][int(rng.integers(len(ATTRS[schema]["sort"])))]
        kw["sort_by"] = key if rng.uniform() < 0.5 else "-" + key
    if rng.uniform() < 0.3:
        kw["offset"] = int(rng.integers(0, 20))
        limit = int(rng.integers(1, 40))
    if rng.uniform() < 0.25:
        kw["sample"] = float(rng.choice([0.1, 0.25, 0.5]))
        if rng.uniform() < 0.5:
            kw["sample_by"] = ATTRS[schema]["str"]
    if rng.uniform() < 0.3:
        kw["loose"] = True
    if rng.uniform() < 0.25:
        kw["transforms"] = ["dtg", ATTRS[schema]["str"]]
    return kw, limit


def cases(schema):
    rng = np.random.default_rng(SEED + (schema == "ext"))
    return [(_tree(rng, schema), *_hints(rng, schema)) for _ in range(N_TREES)]


CASES = {"pts": cases("pts"), "ext": cases("ext")}
STORES = [(s, w) for s in ("pts", "ext") for w in ("once", "tiered")]


@pytest.fixture(scope="module")
def stores():
    ensure_jax_native()
    pdata, edata = point_data(seed=17, n=N), extent_data()
    out = {}
    for schema, w in STORES:
        writes = (N,) if w == "once" else (2_500, 500)
        if schema == "pts":
            pair = (point_store(geomesa_tpu, pdata, writes=writes),
                    point_store(geomesa_tpu_torch, pdata, writes=writes, device="cpu"))
        else:
            pair = (extent_store(geomesa_tpu, edata, writes=writes),
                    extent_store(geomesa_tpu_torch, edata, writes=writes, device="cpu"))
        out[(schema, w)] = pair
    return out


PARAMS = [(s, w, c) for s, w in STORES for c in range(N_TREES // CHUNK)]


@pytest.mark.parametrize("schema,writes,chunk", PARAMS,
                         ids=[f"{s}-{w}-{c}" for s, w, c in PARAMS])
def test_random_trees_agree_in_order(stores, schema, writes, chunk):
    jds, tds = stores[(schema, writes)]
    nonempty = 0
    for q, kw, limit in CASES[schema][chunk * CHUNK:(chunk + 1) * CHUNK]:
        want = np.asarray(jds.query(schema, q).ids).tolist()
        assert np.asarray(tds.query(schema, q).ids).tolist() == want, q
        nonempty += bool(want)
        got = tds.query(schema, q, limit=limit, hints=THints(**kw))
        ref = jds.query(schema, q, limit=limit, hints=JHints(**kw))
        assert np.asarray(got.ids).tolist() == np.asarray(ref.ids).tolist(), (q, kw, limit)
        assert list(got.columns) == list(ref.columns), (q, kw)
        if want:
            page = dict(kw, offset=len(want) // 3)
            got = tds.query(schema, q, limit=5, hints=THints(**page))
            ref = jds.query(schema, q, limit=5, hints=JHints(**page))
            assert np.asarray(got.ids).tolist() == np.asarray(ref.ids).tolist(), (q, page)
    assert nonempty  # every chunk exercises some non-empty results
