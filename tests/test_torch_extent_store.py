"""The port's extent stores (XZ2, XZ3) against the JAX DataStore, both on
the CPU.

An XZ2 store of rectangles (``PackedGeometryColumn.from_boxes``, building
footprints) and an XZ3 store mixing rectangles with triangles, 5-arm
stars, LineStrings and a MultiPolygon (``from_geometries``, joined with
``concat``), made from a seed with numpy, go into a JAX
``geomesa_tpu.DataStore`` and a port ``geomesa_tpu_torch.DataStore``
(device="cpu"). ``INTERSECTS`` with rectangle and non-rectangle polygons,
``BBOX``, each ``AND dtg DURING`` on XZ3, and DURING alone must return
the same ids and counts one by one and through ``query_many``, whose
fused chunks (block and query ids, projected columns, no polygon stacks)
must equal the JAX table's. The table-level aggregations (count, density,
bounds_stats) must equal the JAX table's, and a table carried across with
``load_table_state`` must scan identically. The JAX package's C++ host
helpers are off for the module, so both packages take the same numpy XZ
ranges. Tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu_torch import native as tnative
from geomesa_tpu.scan import block_kernels as jbk
from geomesa_tpu_torch.scan import block_kernels as tbk
from geomesa_tpu_torch.state import load_table_state

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

N_XZ2 = 24_000
N_RECT3, N_OTHER3 = 9_000, 1_200
TILE = 4096
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000


def _footprints(rng, n):
    """Building-footprint-like rectangles around 12 city centres, a few
    exactly on the queries' edges."""
    cx = rng.uniform(-60, 60, 12)
    cy = rng.uniform(-40, 40, 12)
    k = rng.integers(0, 12, n)
    x0 = cx[k] + rng.normal(0, 4.0, n)
    y0 = cy[k] + rng.normal(0, 3.0, n)
    w = rng.uniform(1e-4, 0.05, n) * np.where(rng.random(n) < 0.05, 40, 1)
    h = rng.uniform(1e-4, 0.05, n)
    x0[:40] = 10.0  # left edge on a query's right edge
    y0[40:80] = -5.0 - h[40:80]  # top edge on a query's bottom edge
    x0[80:120] = rng.uniform(20.0, 20.5, 40)  # under the smallest query
    y0[80:120] = rng.uniform(10.0, 10.25, 40)
    return x0, y0, x0 + w, y0 + h


def _star_ring(cx, cy, arms, r_in, r_out):
    a = np.linspace(0, 2 * np.pi, 2 * arms, endpoint=False)
    r = np.where(np.arange(2 * arms) % 2 == 0, r_out, r_in)
    ring = np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1)
    return np.vstack([ring, ring[:1]])


def _others(rng, n):
    """(kind, coordinate arrays) of n non-rectangle features: triangles,
    5-arm stars, 2-6-vertex LineStrings and, every 100th, a two-part
    MultiPolygon."""
    out = []
    cx = rng.uniform(-50, 50, n)
    cy = rng.uniform(-35, 35, n)
    for i in range(n):
        s = rng.uniform(0.02, 0.6)
        if i % 100 == 99:
            out.append(("multi", [_star_ring(cx[i], cy[i], 5, s / 3, s),
                                  _star_ring(cx[i] + 2 * s, cy[i], 5, s / 3, s)]))
        elif i % 3 == 0:
            tri = np.array([[cx[i], cy[i]], [cx[i] + s, cy[i]], [cx[i], cy[i] + s]])
            out.append(("poly", np.vstack([tri, tri[:1]])))
        elif i % 3 == 1:
            out.append(("poly", _star_ring(cx[i], cy[i], 5, s / 3, s)))
        else:
            nv = int(rng.integers(2, 7))
            out.append(("line", np.stack([cx[i] + np.cumsum(rng.normal(0, s, nv)),
                                          cy[i] + np.cumsum(rng.normal(0, s, nv))], axis=1)))
    return out


def _data(seed=41):
    rng = np.random.default_rng(seed)
    xz2 = _footprints(rng, N_XZ2)
    rect3 = _footprints(rng, N_RECT3)
    others = _others(rng, N_OTHER3)
    t = T0 + rng.integers(0, 40 * DAY, N_RECT3 + N_OTHER3)
    return xz2, rect3, others, t


def _geoms(pkg, others):
    g = pkg.geometry
    out = []
    for kind, c in others:
        if kind == "poly":
            out.append(g.Polygon(c))
        elif kind == "line":
            out.append(g.LineString(c))
        else:
            out.append(g.MultiPolygon([g.Polygon(r) for r in c]))
    return out


def _build(pkg, cell, data, **kw):
    xz2, rect3, others, t = data
    packed = pkg.geometry.PackedGeometryColumn
    if cell == "xz2":
        sft = pkg.FeatureType.from_spec("ext", "*geom:Polygon:srid=4326")
        cols = {"geom": packed.from_boxes(*xz2)}
        n = N_XZ2
    else:
        sft = pkg.FeatureType.from_spec("ext", "dtg:Date,*geom:Geometry:srid=4326")
        col = packed.concat([packed.from_boxes(*rect3),
                             packed.from_geometries(_geoms(pkg, others))])
        cols = {"geom": col, "dtg": t}
        n = N_RECT3 + N_OTHER3
    ds = pkg.DataStore(tile=TILE, **kw)
    ds.create_schema(sft)
    ds.write("ext", pkg.FeatureCollection.from_columns(sft, np.arange(n), cols))
    return ds


CELLS = ["xz2", "xz3"]


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
        }, data


def _dur(d0, d1, ms=0):
    lo = np.datetime64(T0 + d0 * DAY + ms, "ms")
    hi = np.datetime64(T0 + d1 * DAY, "ms")
    return f"dtg DURING {lo}Z/{hi}Z"


STAR = "POLYGON (({}))".format(", ".join(
    f"{x:.4f} {y:.4f}" for x, y in _star_ring(-8.0, 4.0, 5, 4.0, 11.0)))
RECT = "POLYGON ((-30 -25, 10 -25, 10 -5, -30 -5, -30 -25))"
SPATIAL = [
    f"INTERSECTS(geom, {RECT})",
    f"INTERSECTS(geom, {STAR})",
    "INTERSECTS(geom, POLYGON ((0 -10, 30 -10, 25 20, 5 15, 0 -10)))",
    "bbox(geom, -40, -20, -20, -10)",
    "bbox(geom, 20, 10, 20.5, 10.25)",
]
# XZ3 windows: week bins start on Thursdays (days 3, 10, 17, ... after
# T0), so most windows stay in one bin and the numpy range search stays
# short; one spans two bins
WINDOWS = [(4, 9), (3, 16), (11, 13), (18, 23), (25, 30)]
QUERIES = {
    "xz2": SPATIAL,
    "xz3": [f"{q} AND {_dur(d0, d1, ms=123)}" for q, (d0, d1) in zip(SPATIAL, WINDOWS)]
    + [_dur(4, 5, ms=77)],
}
CASES = [(c, q) for c in CELLS for q in QUERIES[c]]
CASE_IDS = [f"{c}-{i}" for c in CELLS for i in range(len(QUERIES[c]))]


def _ids(fc) -> np.ndarray:
    return np.sort(np.asarray(fc.ids, np.int64))


def test_extent_schemas_plan_xz_indexes():
    for spec, want in (("*geom:Polygon:srid=4326", ["xz2"]),
                       ("dtg:Date,*geom:MultiPolygon:srid=4326", ["xz3", "xz2"]),
                       ("dtg:Date,*geom:LineString:srid=4326", ["xz3", "xz2"]),
                       ("name:String,*geom:LineString:srid=4326", ["xz2"])):
        tds = geomesa_tpu_torch.DataStore(device="cpu")
        jds = geomesa_tpu.DataStore()
        for ds in (tds, jds):
            ds.create_schema("t", spec)
        assert [i.name for i in tds.indexes("t")] == [i.name for i in jds.indexes("t")] == want


@pytest.mark.parametrize("cell,q", CASES, ids=CASE_IDS)
def test_query_ids_and_count_equal_jax(stores, cell, q):
    jds, tds = stores[0][cell]
    tp, jp = tds.planner.plan("ext", q), jds.planner.plan("ext", q)
    assert tp.index == jp.index == cell
    for f in ("range_bins", "range_lo", "range_hi", "boxes", "windows"):
        a, b = getattr(tp.config, f), getattr(jp.config, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    assert not tp.config.geom_precise and tp.config.extent_mode
    got, ref = _ids(tds.query("ext", q)), _ids(jds.query("ext", q))
    assert len(ref) and np.array_equal(got, ref)
    assert tds.count("ext", q) == jds.count("ext", q) == len(ref)
    assert f"Strategy: {cell}" in tds.explain("ext", q)


def _capture(monkeypatch, module, name):
    """Record (bids, qids, kw) of every call of ``module.name``."""
    calls = []
    fn = getattr(module, name)

    def spy(cols3, bids, qids, *args, **kw):
        calls.append((np.asarray(bids).copy(), np.asarray(qids).copy(), kw))
        return fn(cols3, bids, qids, *args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _batch(cell):
    """The cell's queries and three boxes shifted in space: enough members
    that the chunks fuse."""
    out = list(QUERIES[cell])
    for i, dx in enumerate((-12, 0, 14)):
        q = f"bbox(geom, {-30 + dx}, -20, {-5 + dx}, 5)"
        out.append(q if cell == "xz2" else f"{q} AND {_dur(*WINDOWS[i])}")
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_query_many_and_fused_chunks_equal_jax(stores, cell, monkeypatch):
    jds, tds = stores[0][cell]
    queries = _batch(cell)
    jcalls = _capture(monkeypatch, jbk, "block_scan_multi")
    tcalls = _capture(monkeypatch, tbk, "scan_planes_multi")
    got = tds.query_many("ext", queries)
    ref = jds.query_many("ext", queries)
    monkeypatch.undo()
    assert len(got) == len(queries)
    for q, g, r in zip(queries, got, ref):
        assert np.array_equal(_ids(g), _ids(r)), q
    assert len(tcalls) == len(jcalls) >= 1
    for (tb, tq, tkw), (jb, jq, jkw) in zip(tcalls, jcalls):
        assert np.array_equal(tb, jb) and np.array_equal(tq, jq)
        assert tkw["extent"] and jkw["extent"]
        for k in ("n_edges", "n_rints", "has_boxes", "has_windows", "col_names"):
            assert tkw.get(k, 0) == jkw.get(k, 0), k
        for k in ("edges", "spip", "rasts"):
            assert tkw.get(k) is None, k


@pytest.mark.parametrize("cell,q", CASES, ids=CASE_IDS)
def test_table_aggregations_equal_jax(stores, cell, q):
    """IndexTable.count, density and bounds_stats on the XZ table: the
    extent legs of the popcount, density and bounds kernels."""
    jds, tds = stores[0][cell]
    jt, tt = jds.table("ext", cell), tds.table("ext", cell)
    jc, tc = jds.planner.plan("ext", q).config, tds.planner.plan("ext", q).config
    assert tt.extent and tt._agg_cols(tc) == jt._agg_cols(jc)
    n = tt.count(tc)
    assert n == jt.count(jc) and n >= tds.count("ext", q)
    for env, w, h in (((-70, -45, 70, 45), 64, 32), ((-30.5, -25.25, 10, -5), 33, 17)):
        got = tt.density(tc, env, w, h)
        assert got.dtype == np.float32 and got.shape == (h, w)
        assert np.array_equal(got, np.asarray(jt.density(jc, env, w, h)))
    assert tt.bounds_stats(tc) == jt.bounds_stats(jc)


@pytest.mark.parametrize("cell", CELLS)
def test_datastore_aggregations_equal_jax(stores, cell):
    """DataStore-level aggregations on an XZ table never push down (the
    mask never decides an extent filter): bounds, Count() and density
    come from the refined hits, as in the JAX package."""
    jds, tds = stores[0][cell]
    for q in QUERIES[cell][:2]:
        for est in (True, False):
            assert tds.bounds("ext", q, estimate=est) == jds.bounds("ext", q, estimate=est)
            got = tds.stats_query("ext", "Count()", q, estimate=est)
            ref = jds.stats_query("ext", "Count()", q, estimate=est)
            assert [st.to_json() for st in got] == [st.to_json() for st in ref]
        env = (-45.5, -30.25, 45, 30)
        got = tds.density("ext", q, envelope=env, width=33, height=17)
        assert np.array_equal(got, jds.density("ext", q, envelope=env, width=33, height=17))


def test_results_match_brute_force(stores):
    """The XZ2 store alone against an f64 brute force: a rectangle query
    over rectangles is box algebra on the f64 source boxes."""
    (x0, y0, x1, y1), _, _, _ = stores[1]
    tds = stores[0]["xz2"][1]
    expect = np.flatnonzero((x0 <= 10) & (x1 >= -30) & (y0 <= -5) & (y1 >= -25))
    got = _ids(tds.query("ext", SPATIAL[0]))
    assert len(expect) and np.array_equal(got, expect)


@pytest.mark.parametrize("cell", CELLS)
def test_loaded_table_state_gives_same_planes(stores, cell):
    """load_table_state over a JAX XZ table's numpy state: the same extent
    columns, and the same planes and (ordinals, certain) on a scan."""
    jds, tds = stores[0][cell]
    jt = jds.table("ext", cell)
    state = {k: getattr(jt, k) for k in ("perm", "bins", "zs", "ubins", "bin_starts", "block")}
    state["cols3"] = {k: np.asarray(v) for k, v in jt.cols3.items()}
    assert set(tbk.EXTENT_COLS) <= set(state["cols3"])
    tidx = next(i for i in tds.indexes("ext") if i.name == cell)
    pt = load_table_state(state, tidx, "cpu")
    assert pt.extent
    for k, v in state["cols3"].items():
        assert np.array_equal(pt.cols3[k].numpy(), v)
    jidx = next(i for i in jds.indexes("ext") if i.name == cell)
    q = QUERIES[cell][1]
    jcfg = jidx.scan_config(geomesa_tpu.filter.ecql.parse(q))
    tcfg = tidx.scan_config(geomesa_tpu_torch.filter.ecql.parse(q))
    jboxes, jwins = jt._params(jcfg)
    tboxes, twins = pt._params(tcfg)
    assert np.array_equal(jboxes, tboxes) and np.array_equal(jwins, twins)
    names = pt._scan_cols(tcfg)
    assert names == jt._scan_cols(jcfg)
    bids, _ = tbk.pad_bids(np.arange(pt.n_blocks), pt.n_blocks)
    kw = dict(col_names=names, has_boxes=True, has_windows=cell == "xz3", extent=True)
    jw, ji = jbk.block_scan(jt._cols_args(names), bids, jboxes, jwins, **kw)
    tw, ti = tbk.block_scan(pt._cols_args(names), bids, tboxes, twins, **kw)
    assert ji is None and ti is None
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    jo, jc = jt.scan(jcfg)
    to, tc = pt.scan(tcfg)
    assert np.array_equal(to, jo) and np.array_equal(tc, jc) and not tc.any()


# -- the delta tier against the JAX package's ------------------------------

TIERED_RECT3, TIERED_OTHER3 = 5_400, 600
WRITES = [4_000, 2_000]  # the second write stays in the delta of both
TIERED_QUERIES = {
    "xz2": SPATIAL[:3],
    "xz3": [QUERIES["xz3"][0], QUERIES["xz3"][1], QUERIES["xz3"][5]],
}
TIERED_CASES = [(c, q) for c in CELLS for q in TIERED_QUERIES[c]]
TIERED_IDS = [f"{c}-{i}" for c in CELLS for i in range(len(TIERED_QUERIES[c]))]


def _tiered_data(seed=43):
    rng = np.random.default_rng(seed)
    xz2 = _footprints(rng, sum(WRITES))
    rect3 = _footprints(rng, TIERED_RECT3)
    others = _others(rng, TIERED_OTHER3)
    t = T0 + rng.integers(0, 40 * DAY, TIERED_RECT3 + TIERED_OTHER3)
    return xz2, rect3, others, t


def _write_extents(pkg, ds, cell, data, writes, start=0):
    """Write features [start, start + sum(writes)), one batch per entry of
    ``writes``; on XZ3 each batch takes its share of the rectangles and of
    the other geometries (rectangles first), so every batch mixes both."""
    xz2, rect3, others, t = data
    packed = pkg.geometry.PackedGeometryColumn
    sft = ds.get_schema("ext")
    for n in writes:
        ids = np.arange(start, start + n)
        if cell == "xz2":
            cols = {"geom": packed.from_boxes(*(c[start:start + n] for c in xz2))}
        else:
            # feature k of the store: rectangle k // 10 * 9 + ..., i.e. the
            # rectangles and others interleave in batches in a 9 : 1 ratio
            r0, r1 = start * 9 // 10, (start + n) * 9 // 10
            o0, o1 = start - r0, start + n - r1
            col = packed.concat([packed.from_boxes(*(c[r0:r1] for c in rect3)),
                                 packed.from_geometries(_geoms(pkg, others[o0:o1]))])
            cols = {"geom": col, "dtg": np.concatenate([t[r0:r1], t[TIERED_RECT3 + o0:
                                                                      TIERED_RECT3 + o1]])}
        ds.write("ext", pkg.FeatureCollection.from_columns(sft, ids, cols))
        start += n


def _tiered_store(pkg, cell, data, writes, **kw):
    spec = ("*geom:Polygon:srid=4326" if cell == "xz2"
            else "dtg:Date,*geom:Geometry:srid=4326")
    ds = pkg.DataStore(tile=TILE, **kw)
    ds.create_schema("ext", spec)
    _write_extents(pkg, ds, cell, data, writes)
    return ds


@pytest.fixture(scope="module")
def tiered():
    from geomesa_tpu import native

    data = _tiered_data()
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        yield {
            cell: (_tiered_store(geomesa_tpu, cell, data, WRITES),
                   _tiered_store(geomesa_tpu_torch, cell, data, WRITES, device="cpu"))
            for cell in CELLS
        }, data


def _ordered(fc) -> np.ndarray:
    return np.asarray(fc.ids, np.int64)


@pytest.mark.parametrize("cell,q", TIERED_CASES, ids=TIERED_IDS)
def test_tiered_ids_in_order_and_limits_equal_jax(tiered, cell, q):
    from geomesa_tpu_torch.storage.delta import TieredTable

    jds, tds = tiered[0][cell]
    assert isinstance(tds.table("ext", cell), TieredTable)
    ref = _ordered(jds.query("ext", q))
    assert len(ref) and (ref >= WRITES[0]).any()
    assert np.array_equal(_ordered(tds.query("ext", q)), ref)
    for limit in (1, 5, 7):
        got = _ordered(tds.query("ext", q, limit=limit))
        assert np.array_equal(got, ref[:limit])
        assert np.array_equal(got, _ordered(jds.query("ext", q, limit=limit)))
    assert tds.count("ext", q) == jds.count("ext", q) == len(ref)


@pytest.mark.parametrize("cell,q", TIERED_CASES, ids=TIERED_IDS)
def test_tiered_aggregations_equal_jax(tiered, cell, q):
    """Bounds (estimate on and off) and Count() through the store, and the
    tiered table's own count, density and bounds_stats: the main table's
    kernels plus the host delta's bbox-intersects and bbox centres."""
    jds, tds = tiered[0][cell]
    for est in (True, False):
        assert tds.bounds("ext", q, estimate=est) == jds.bounds("ext", q, estimate=est)
        got = tds.stats_query("ext", "Count()", q, estimate=est)
        ref = jds.stats_query("ext", "Count()", q, estimate=est)
        assert [st.to_json() for st in got] == [st.to_json() for st in ref]
    env = (-45.5, -30.25, 45, 30)
    got = tds.density("ext", q, envelope=env, width=33, height=17)
    assert np.array_equal(got, jds.density("ext", q, envelope=env, width=33, height=17))
    jt, tt = jds.table("ext", cell), tds.table("ext", cell)
    jc, tc = jds.planner.plan("ext", q).config, tds.planner.plan("ext", q).config
    assert tt.count(tc) == jt.count(jc)
    assert np.array_equal(tt.density(tc, env, 64, 32), np.asarray(jt.density(jc, env, 64, 32)))
    assert tt.bounds_stats(tc) == jt.bounds_stats(jc)


@pytest.mark.parametrize("cell", CELLS)
def test_tiered_query_many_and_density_many_equal_jax(tiered, cell):
    jds, tds = tiered[0][cell]
    queries = TIERED_QUERIES[cell]
    for limit in (None, 7):
        got = tds.query_many("ext", queries, limit=limit)
        ref = jds.query_many("ext", queries, limit=limit)
        for q, g, r in zip(queries, got, ref):
            assert np.array_equal(_ordered(g), _ordered(r)), q
    reqs = [(q, (-45.5, -30.25, 45, 30)) for q in queries]
    for g, r in zip(tds.density_many("ext", reqs, width=33, height=17),
                    jds.density_many("ext", reqs, width=33, height=17)):
        assert np.array_equal(g, np.asarray(r))


@pytest.mark.parametrize("cell", CELLS)
def test_compaction_keeps_the_reference_order(tiered, cell):
    """A third write past a lowered ``geomesa.tpu.compact.min.rows``
    compacts both stores, and so does an explicit ``compact()``; ids stay
    equal in order, and under a limit, to the JAX package's."""
    from geomesa_tpu import conf as jconf
    from geomesa_tpu import native

    from geomesa_tpu_torch import conf as tconf
    from geomesa_tpu_torch.storage.table import IndexTable

    data = tiered[1]
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        jconf.COMPACT_MIN_ROWS.set(1_000)
        tconf.COMPACT_MIN_ROWS.set(1_000)
        try:
            pair = [_tiered_store(geomesa_tpu, cell, data, [4_000, 500]),
                    _tiered_store(geomesa_tpu_torch, cell, data, [4_000, 500], device="cpu")]
            # 1,500 more: a delta of 2,000 > max(1,000, 6,000 // 8)
            _write_extents(geomesa_tpu, pair[0], cell, data, [1_500], start=4_500)
            _write_extents(geomesa_tpu_torch, pair[1], cell, data, [1_500], start=4_500)
        finally:
            jconf.COMPACT_MIN_ROWS.clear()
            tconf.COMPACT_MIN_ROWS.clear()
        explicit = [_tiered_store(geomesa_tpu, cell, data, WRITES),
                    _tiered_store(geomesa_tpu_torch, cell, data, WRITES, device="cpu")]
        for ds in explicit:
            ds.compact("ext")
        for jds, tds in (pair, explicit):
            assert isinstance(tds.table("ext", cell), IndexTable)
            for q in TIERED_QUERIES[cell][:2]:
                ref = _ordered(jds.query("ext", q))
                assert len(ref) and np.array_equal(_ordered(tds.query("ext", q)), ref)
                assert np.array_equal(_ordered(tds.query("ext", q, limit=7)), ref[:7])
