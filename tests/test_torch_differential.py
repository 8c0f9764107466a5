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
the same pages under ``limit`` and ``offset``. The two-write stores run
again after ``compact``.

The aggregations run on a seeded subset of the trees, on the point and
the dated extent store (once and tiered): ``count`` exact and as an
estimate (``stats_query("Count()", estimate=True)``), ``density``,
``bounds`` in both modes, ``stats_query`` in both modes, and
``density_many`` over batches of trees. Two seeded 25-step mutation
sequences, one per schema, draw from ``fold_upsert`` (monolithic and
sliced with a small ``slice_rows``), ``upsert``, ``write``,
``compact``, ``delete_features``, ``modify_features`` and ``age_off``;
after each step the stores' rows and a few trees' ids (with and without
``limit``) must agree in order. The trees run again on a point store
with visibility labels under two auths and on cached stores (each tree
twice, the second time a cache hit); ``estimate_count`` joins the
aggregations; and the mutation sequences run once more on cached stores,
where every answer, cold and warm, equals the uncached sequence's and
the stats sketches (``stats_for(...).to_json()``) and estimates equal
the JAX package's after each step. A seeded 25-step standing-query
sequence runs on both packages' LambdaStore: ``subscribe`` (geofence
squares and stars, some fused, proximity and tube subscriptions, a
replace), ``unsubscribe``, ``write`` and ``flush``; after each step the
drained alert dicts, the live subscription ids and the store's ids in
order must agree. Tolerance: exact.
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
STORES = [(s, w) for s in ("pts", "ext") for w in ("once", "tiered", "compacted")]


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
        if w == "compacted":
            for ds in pair:
                ds.compact(schema)
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


# -- aggregations -------------------------------------------------------------

AGG_TREES = 30  # per schema: the first trees of CASES
AGG_CHUNK = 10
AGG_STORES = [(s, w) for s in ("pts", "ext") for w in ("once", "tiered")]
AGG_PARAMS = [(s, w, c) for s, w in AGG_STORES for c in range(AGG_TREES // AGG_CHUNK)]
ENVELOPE = (-60.0, -40.0, 60.0, 40.0)
STAT_SPECS = {"pts": ["Count();MinMax(age)", "MinMax(dtg)"],
              "ext": ["Count();MinMax(rank)", "MinMax(dtg)"]}


def _stats_json(stats) -> list:
    return [(type(s).__name__, s.to_json()) for s in stats]


@pytest.mark.parametrize("schema,writes,chunk", AGG_PARAMS,
                         ids=[f"{s}-{w}-{c}" for s, w, c in AGG_PARAMS])
def test_aggregations_agree(stores, schema, writes, chunk):
    jds, tds = stores[(schema, writes)]
    for i, (q, _, _) in enumerate(CASES[schema][chunk * AGG_CHUNK:(chunk + 1) * AGG_CHUNK]):
        assert tds.count(schema, q) == jds.count(schema, q), q
        got = tds.stats_query(schema, "Count()", q, estimate=True)
        ref = jds.stats_query(schema, "Count()", q, estimate=True)
        assert _stats_json(got) == _stats_json(ref), q
        env = ENVELOPE if i % 2 else None
        got = tds.density(schema, q, envelope=env, width=32, height=16)
        ref = jds.density(schema, q, envelope=env, width=32, height=16)
        assert np.asarray(got).dtype == np.asarray(ref).dtype
        assert np.array_equal(np.asarray(got), np.asarray(ref)), q
        for estimate in (True, False):
            assert tds.bounds(schema, q, estimate=estimate) == jds.bounds(
                schema, q, estimate=estimate), (q, estimate)
            spec = STAT_SPECS[schema][i % 2]
            got = tds.stats_query(schema, spec, q, estimate=estimate)
            ref = jds.stats_query(schema, spec, q, estimate=estimate)
            assert _stats_json(got) == _stats_json(ref), (q, spec, estimate)


@pytest.mark.parametrize("schema,writes", AGG_STORES, ids=[f"{s}-{w}" for s, w in AGG_STORES])
def test_density_many_agrees(stores, schema, writes):
    jds, tds = stores[(schema, writes)]
    trees = [q for q, _, _ in CASES[schema][:AGG_TREES]]
    for b in range(0, len(trees), 8):
        reqs = [(q, ENVELOPE if k % 3 else None) for k, q in enumerate(trees[b:b + 8])]
        got = tds.density_many(schema, reqs, width=24, height=12)
        ref = jds.density_many(schema, reqs, width=24, height=12)
        assert len(got) == len(ref) == len(reqs)
        for (q, _), g, r in zip(reqs, got, ref):
            assert np.array_equal(np.asarray(g), np.asarray(r)), q


# -- mutation sequences -------------------------------------------------------

N_STEPS = 25
MUT_SEED = SEED + 7
SLICE_ROWS = 97
OPS = ("fold", "fold_sliced", "upsert", "write", "compact", "delete", "modify", "age_off")


def _rows(rng, schema, ids):
    """Seeded column arrays for a batch of ``ids`` (both packages build
    their collections from these)."""
    n = len(ids)
    x0, y0 = rng.uniform(-60, 58, n), rng.uniform(-40, 38, n)
    t = T0 + rng.integers(0, 20 * DAY, n)
    name = NAMES[rng.integers(0, len(NAMES), n)]
    num = rng.integers(0, 30, n).astype(np.int32)
    if schema == "pts":
        return {"geom": ("pts", x0, y0), "dtg": t, "age": num % 30,
                "score": np.round(rng.normal(0, 10, n), 2), "name": name}
    w, h = rng.uniform(0.01, 2.0, n), rng.uniform(0.01, 2.0, n)
    return {"geom": ("ext", x0, y0, x0 + w, y0 + h), "dtg": t, "tag": name, "rank": num % 10}


def _fc(pkg, ds, schema, ids, rows):
    sft = ds.get_schema(schema)
    cols = dict(rows)
    g = rows["geom"]
    cols["geom"] = (g[1], g[2]) if g[0] == "pts" else \
        pkg.geometry.PackedGeometryColumn.from_boxes(*g[1:])
    return pkg.FeatureCollection.from_columns(sft, np.asarray(ids), cols)


def _mutation_steps(schema):
    """The seeded sequence: (op, args) per step, ``args`` in numpy only,
    plus the trees read after each step."""
    rng = np.random.default_rng(MUT_SEED + (schema == "ext"))
    live = list(range(N))
    next_id = 100_000
    cutoff = T0
    steps = []
    for _ in range(N_STEPS):
        op = OPS[int(rng.integers(len(OPS)))]
        if op in ("fold", "fold_sliced", "upsert"):
            k_old = int(rng.integers(20, 200))
            k_new = int(rng.integers(0, 100))
            old = rng.choice(live, min(k_old, len(live)), replace=False).tolist()
            ids = old + list(range(next_id, next_id + k_new))
            next_id += k_new
            live += ids[len(old):]
            args = (ids, _rows(rng, schema, ids))
        elif op == "write":
            k = int(rng.integers(50, 400))
            ids = list(range(next_id, next_id + k))
            next_id += k
            live += ids
            args = (ids, _rows(rng, schema, ids))
        elif op == "delete":
            if rng.uniform() < 0.5:
                gone = rng.choice(live, int(rng.integers(5, 60)), replace=False).tolist()
                f = "IN (" + ", ".join(f"'{i}'" for i in gone) + ")"
            else:
                x0, y0 = rng.uniform(-60, 50), rng.uniform(-40, 30)
                f = f"bbox(geom, {x0:.3f}, {y0:.3f}, {x0 + rng.uniform(1, 8):.3f}, {y0 + rng.uniform(1, 6):.3f})"
            args = (f,)
        elif op == "modify":
            which = int(rng.integers(4))
            if which == 0:
                upd = {ATTRS[schema]["int"]: int(rng.integers(0, 10))}
            elif which == 1:
                upd = {ATTRS[schema]["str"]: str(NAMES[int(rng.integers(len(NAMES)))]) + "x"}
            elif which == 2:
                upd = {"dtg": _stamp(T0 + int(rng.integers(0, 20 * DAY)))}
            else:
                upd = {"geom": (float(rng.uniform(-50, 50)), float(rng.uniform(-30, 30)))}
            sel = rng.choice(live, int(rng.integers(3, 40)), replace=False).tolist()
            f = "IN (" + ", ".join(f"'{i}'" for i in sel) + ")"
            if rng.uniform() < 0.3:
                f = _tree(rng, schema)
            args = (upd, f)
        elif op == "age_off":
            cutoff += int(rng.integers(0, DAY // 2))
            args = (cutoff,)
        else:
            args = ()
        trees = [_tree(rng, schema) for _ in range(3)] + [_leaf(rng, schema)]
        steps.append((op, args, trees, int(rng.integers(1, 12))))
    return steps


def _apply(pkg, ds, schema, op, args):
    if op in ("fold", "fold_sliced", "upsert", "write"):
        fc = _fc(pkg, ds, schema, *args)
        if op == "write":
            return ds.write(schema, fc)
        if op == "upsert":
            return ds.upsert(schema, fc)
        return ds.fold_upsert(schema, fc, slice_rows=SLICE_ROWS if op == "fold_sliced" else 0)
    if op == "compact":
        return ds.compact(schema)
    if op == "delete":
        return ds.delete_features(schema, args[0])
    if op == "modify":
        upd, f = args
        if "geom" in upd:
            x, y = upd["geom"]
            g = pkg.geometry
            upd = {"geom": g.Point(x, y) if schema == "pts" else g.Polygon(
                np.array([[x, y], [x + 1, y], [x + 1, y + 1], [x, y + 1], [x, y]]))}
        return ds.modify_features(schema, upd, f)
    return ds.age_off(schema, ttl_ms=0, now_ms=args[0])


@pytest.fixture(scope="module")
def mutation_runs():
    """Both sequences run once; per step the returns, rows and query ids
    of each package."""
    ensure_jax_native()
    pdata, edata = point_data(seed=17, n=N), extent_data()
    out = {}
    for schema in ("pts", "ext"):
        if schema == "pts":
            pair = (point_store(geomesa_tpu, pdata), point_store(geomesa_tpu_torch, pdata, device="cpu"))
        else:
            pair = (extent_store(geomesa_tpu, edata), extent_store(geomesa_tpu_torch, edata, device="cpu"))
        for op, args, trees, limit in _mutation_steps(schema):
            rec = []
            for pkg, ds in zip((geomesa_tpu, geomesa_tpu_torch), pair):
                ret = _apply(pkg, ds, schema, op, args)
                ids = np.asarray(ds.features(schema).ids).tolist()
                res = [(np.asarray(ds.query(schema, q).ids).tolist(),
                        np.asarray(ds.query(schema, q, limit=limit).ids).tolist()) for q in trees]
                rec.append((ret, ids, res))
            out.setdefault(schema, []).append((op, trees, rec))
    return out


MUT_PARAMS = [(s, i) for s in ("pts", "ext") for i in range(N_STEPS)]


@pytest.mark.parametrize("schema,step", MUT_PARAMS, ids=[f"{s}-{i}" for s, i in MUT_PARAMS])
def test_mutation_sequence_agrees(mutation_runs, schema, step):
    op, trees, (ref, got) = mutation_runs[schema][step]
    assert got[0] == ref[0], op
    assert got[1] == ref[1], op  # the rows, in order
    for q, (want, want_lim), (have, have_lim) in zip(trees, ref[2], got[2]):
        assert have == want, (op, q)
        assert have_lim == want_lim, (op, q)


def test_mutation_sequences_draw_every_op():
    """The seeds cover every operation and leave rows behind."""
    drawn = {op for s in ("pts", "ext") for op, *_ in _mutation_steps(s)}
    assert drawn == set(OPS)


# -- visibility, cache and estimate variants ------------------------------------
#
# The trees once more on a point store with a visibility label column
# under two auths, and on cached stores where each tree runs twice (the
# second run a cache hit); the aggregation subset's estimate_count; the
# two mutation sequences once more on cached stores, with the stats
# sketches checked after each step and every answer equal to the
# uncached sequence's.

VIS_LABELS = np.array(["", "analyst", "analyst&secret", "secret|ops"])
VIS_AUTHS = {"vis-analyst": ("analyst",), "vis-secret": ("analyst", "secret")}
VARIANTS = [("pts", "vis-analyst"), ("pts", "vis-secret"), ("pts", "cached"), ("ext", "cached")]


def _vis_point_store(pkg, data, auths, **kw):
    """point_store's rows with a ``vis`` label column drawn from a seed."""
    from test_torch_hints import POINT_SPEC

    sft = pkg.FeatureType.from_spec("pts", POINT_SPEC + ",vis:String")
    sft.user_data["geomesa.vis.field"] = "vis"
    ds = pkg.DataStore(tile=TILE, auths=auths, **kw)
    ds.create_schema(sft)
    x, y, t, age, score, name = data
    vis = VIS_LABELS[np.random.default_rng(SEED + 11).integers(0, len(VIS_LABELS), len(x))]
    ds.write("pts", pkg.FeatureCollection.from_columns(sft, np.arange(len(x)), {
        "geom": (x, y), "dtg": t, "age": age, "score": score, "name": name, "vis": vis}))
    return ds


@pytest.fixture(scope="module")
def variant_stores():
    ensure_jax_native()
    pdata, edata = point_data(seed=17, n=N), extent_data()
    out = {}
    for schema, v in VARIANTS:
        pair = []
        for pkg, kw in ((geomesa_tpu, {}), (geomesa_tpu_torch, {"device": "cpu"})):
            if v in VIS_AUTHS:
                pair.append(_vis_point_store(pkg, pdata, VIS_AUTHS[v], **kw))
            else:
                make, data = (point_store, pdata) if schema == "pts" else (extent_store, edata)
                pair.append(make(pkg, data, writes=(2_500, 500), cache=True,
                                 metrics=pkg.metrics.MetricsRegistry(), **kw))
        out[(schema, v)] = tuple(pair)
    return out


VARIANT_TREES = 60  # per variant: the first trees of CASES
VARIANT_PARAMS = [(s, v, c) for s, v in VARIANTS for c in range(VARIANT_TREES // (2 * CHUNK))]


@pytest.mark.parametrize("schema,variant,chunk", VARIANT_PARAMS,
                         ids=[f"{s}-{v}-{c}" for s, v, c in VARIANT_PARAMS])
def test_random_trees_agree_on_variant_stores(variant_stores, schema, variant, chunk):
    """The first VARIANT_TREES trees (twenty per parameter) on each variant:
    ids in order with and without hints and limit; a cached store answers
    each tree twice, the second time from its cache, and equal to the
    JAX package's cached store both times."""
    jds, tds = variant_stores[(schema, variant)]
    runs = 2 if variant == "cached" else 1
    for q, kw, limit in CASES[schema][2 * chunk * CHUNK:(2 * chunk + 2) * CHUNK]:
        for _ in range(runs):
            want = np.asarray(jds.query(schema, q).ids).tolist()
            assert np.asarray(tds.query(schema, q).ids).tolist() == want, q
            got = tds.query(schema, q, limit=limit, hints=THints(**kw))
            ref = jds.query(schema, q, limit=limit, hints=JHints(**kw))
            assert np.asarray(got.ids).tolist() == np.asarray(ref.ids).tolist(), (q, kw, limit)
            assert list(got.columns) == list(ref.columns), (q, kw)
            got = tds.query(schema, q, limit=7)
            assert np.asarray(got.ids).tolist() == np.asarray(jds.query(schema, q, limit=7).ids).tolist()
    if variant == "cached":
        counters = [{k: v for k, v in ds.metrics.counters.items() if k.startswith("geomesa.cache.")}
                    for ds in (jds, tds)]
        assert counters[1] == counters[0] and counters[1]["geomesa.cache.hit"] > 0


@pytest.mark.parametrize("schema,writes,chunk", AGG_PARAMS,
                         ids=[f"{s}-{w}-{c}" for s, w, c in AGG_PARAMS])
def test_estimate_count_agrees(stores, schema, writes, chunk):
    jds, tds = stores[(schema, writes)]
    for q, _, _ in CASES[schema][chunk * AGG_CHUNK:(chunk + 1) * AGG_CHUNK]:
        assert tds.estimate_count(schema, q) == jds.estimate_count(schema, q), q
    assert tds.stats_for(schema).to_json() == jds.stats_for(schema).to_json()


@pytest.fixture(scope="module")
def cached_mutation_runs():
    """Both sequences once more on cached stores; per step the returns,
    rows, query ids (each read twice: cold, then warm), the stats
    sketches and estimate_count answers of each package."""
    ensure_jax_native()
    pdata, edata = point_data(seed=17, n=N), extent_data()
    out = {}
    for schema in ("pts", "ext"):
        make = point_store if schema == "pts" else extent_store
        data = pdata if schema == "pts" else edata
        pair = (make(geomesa_tpu, data, cache=True),
                make(geomesa_tpu_torch, data, cache=True, device="cpu"))
        for op, args, trees, limit in _mutation_steps(schema):
            rec = []
            for pkg, ds in zip((geomesa_tpu, geomesa_tpu_torch), pair):
                ret = _apply(pkg, ds, schema, op, args)
                ids = np.asarray(ds.features(schema).ids).tolist()
                res = []
                for _ in range(2):
                    res.append([(np.asarray(ds.query(schema, q).ids).tolist(),
                                 np.asarray(ds.query(schema, q, limit=limit).ids).tolist())
                                for q in trees])
                st = ds.stats_for(schema)
                rec.append((ret, ids, res, None if st is None else st.to_json(),
                            [ds.estimate_count(schema, q) for q in trees]))
            out.setdefault(schema, []).append((op, trees, rec))
    return out


@pytest.mark.parametrize("schema,step", MUT_PARAMS, ids=[f"{s}-{i}" for s, i in MUT_PARAMS])
def test_cached_mutation_sequence_agrees(mutation_runs, cached_mutation_runs, schema, step):
    """After every step of the sequence the cached stores answer like the
    uncached ones, cold and warm, in order; the port's stats sketches and
    estimates equal the JAX package's."""
    op, trees, (ref, got) = cached_mutation_runs[schema][step]
    _, _, (plain_ref, _) = mutation_runs[schema][step]
    assert got[0] == ref[0] == plain_ref[0], op
    assert got[1] == ref[1] == plain_ref[1], op
    for cold_warm in (got[2], ref[2]):
        for res in cold_warm:
            assert res == plain_ref[2], (op, trees)
    assert got[3] == ref[3], op
    assert got[4] == ref[4], (op, trees)


# -- standing queries on LambdaStore ---------------------------------------------

SQ_STEPS = 25
SQ_SEED = SEED + 19
SQ_OPS = ("subscribe", "subscribe", "write", "write", "unsubscribe", "flush")
SQ_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"


def _sq_steps():
    """Package-neutral steps: (op, args) drawn from a fixed seed; the
    first four subscribe one of each kind, then every other step
    writes."""
    rng = np.random.default_rng(SQ_SEED)
    steps, live, n_sub, n_row = [], [], 0, 0
    for i in range(SQ_STEPS):
        op = ("subscribe" if i < 4 else "write" if i % 2 else
              SQ_OPS[int(rng.integers(0, len(SQ_OPS)))])
        if op == "unsubscribe" and not live:
            op = "subscribe"
        if op == "subscribe":
            kinds = ("geofence", "star", "proximity", "tube")
            kind = kinds[i] if i < 4 else kinds[int(rng.integers(0, 4))]
            if live and rng.random() < 0.2:
                sid = live[int(rng.integers(0, len(live)))]  # a replace
            else:
                sid = f"q{n_sub}"
                n_sub += 1
            args = {"id": sid, "kind": kind, "cx": float(rng.uniform(-15, 15)),
                    "cy": float(rng.uniform(-15, 15)), "r": float(rng.uniform(1, 6)),
                    "arms": int(rng.integers(5, 60)), "seed": int(rng.integers(0, 1 << 30))}
            live = [x for x in live if x != sid] + [sid]
        elif op == "unsubscribe":
            sid = live.pop(int(rng.integers(0, len(live))))
            args = {"id": sid if rng.random() < 0.9 else "never-registered"}
        elif op == "write":
            k = int(rng.integers(50, 400))
            ids = [f"e{n_row + j}" if rng.random() < 0.8 else f"e{int(rng.integers(0, n_row + 1))}"
                   for j in range(k)]
            n_row += k
            args = {"ids": list(dict.fromkeys(ids)), "seed": int(rng.integers(0, 1 << 30))}
            args["x"] = np.random.default_rng(args["seed"]).uniform(-20, 20, len(args["ids"]))
            args["y"] = np.random.default_rng(args["seed"] + 1).uniform(-20, 20, len(args["ids"]))
        else:
            args = {}
        steps.append((op, args))
    return steps


def _sq_subscription(pkg, args):
    from importlib import import_module

    geo = import_module(pkg.__name__ + ".geometry")
    sq = import_module(pkg.__name__ + ".streaming.standing")
    cx, cy, r = args["cx"], args["cy"], args["r"]
    if args["kind"] == "geofence":
        return sq.Subscription(args["id"], "geofence", geom=geo.Polygon(
            [(cx, cy), (cx + r, cy), (cx + r, cy + r), (cx, cy + r), (cx, cy)]),
            attrs={"step": args["seed"] % 97})
    if args["kind"] == "star":
        rng = np.random.default_rng(args["seed"])
        n = args["arms"]
        a = np.linspace(0, 2 * np.pi, 2 * n + 1)[:-1]
        rad = np.where(np.arange(2 * n) % 2 == 0, r, r * rng.uniform(0.3, 0.7, 2 * n))
        return sq.Subscription(args["id"], "geofence", geom=geo.Polygon(
            [(cx + rr * np.cos(t), cy + rr * np.sin(t)) for t, rr in zip(a, rad)]))
    if args["kind"] == "proximity":
        return sq.Subscription(args["id"], "proximity", points=[(cx, cy), (cy, cx)],
                               distance_m=r * 50_000)
    return sq.Subscription(args["id"], "tube", track_xy=[(cx, cy), (cx + r, cy - r)],
                           track_times_ms=[T0, T0 + 400], buffer_m=r * 40_000)


def _sq_run(pkg, kw):
    from importlib import import_module

    st = import_module(pkg.__name__ + ".streaming")
    geo = import_module(pkg.__name__ + ".geometry")
    ds = pkg.DataStore(**kw)
    ds.create_schema(pkg.FeatureType.from_spec("t", SQ_SPEC))
    lam = st.LambdaStore(ds, "t", config=st.StreamConfig(workers=2, chunk_rows=64,
                                                          fold_rows=150, slice_rows=64))
    # the gate off: which path a candidate takes must not follow the clock
    eng = lam.standing(st.StandingConfig(fused_min_points=16, fused_gate=False))
    out = []
    try:
        for op, args in _sq_steps():
            if op == "subscribe":
                lam.subscribe(_sq_subscription(pkg, args))
            elif op == "unsubscribe":
                lam.unsubscribe(args["id"])
            elif op == "write":
                lam.write([{"name": "n", "dtg": np.datetime64(T0 + j % 500, "ms"),
                            "geom": geo.Point(float(x), float(y))}
                           for j, (x, y) in enumerate(zip(args["x"], args["y"]))],
                          ids=args["ids"])
            else:
                lam.flush()
            out.append((eng.alerts.drain(), eng.index.subscription_ids(),
                        [str(i) for i in lam.query("bbox(geom, -12, -12, 14, 9)").ids.tolist()],
                        len(lam.hot)))
    finally:
        lam.close()
    return out


@pytest.fixture(scope="module")
def standing_runs():
    return [_sq_run(pkg, kw) for pkg, kw in ((geomesa_tpu, {}),
                                            (geomesa_tpu_torch, {"device": "cpu"}))]


@pytest.mark.parametrize("step", range(SQ_STEPS))
def test_standing_sequence_agrees(standing_runs, step):
    jax_run, port_run = standing_runs
    assert port_run[step] == jax_run[step]


def test_standing_sequence_draws_every_op(standing_runs):
    ops = {op for op, _ in _sq_steps()}
    kinds = {a["kind"] for op, a in _sq_steps() if op == "subscribe"}
    assert ops == {"subscribe", "unsubscribe", "write", "flush"}
    assert kinds == {"geofence", "star", "proximity", "tube"}
    assert sum(len(alerts) for alerts, _, _, _ in standing_runs[1]) > 0
