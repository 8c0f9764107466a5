"""The port's store against the JAX DataStore, both on the CPU.

The same features, made from a seed with numpy, go into a JAX
``geomesa_tpu.DataStore`` and a port ``geomesa_tpu_torch.DataStore``
(device="cpu"); every query must return the same ids and count, and
every density grid and ``bounds(estimate=True)`` must be equal. Cells:
Z3 with packed time off and on, and Z2. The JAX package's C++ host
helpers are switched off for the module so both packages take the same
numpy range decomposition (the helpers' ranges can differ from the numpy
ones, which moves the candidate blocks a loose aggregation covers).
Stores written in two batches keep the second in their delta tier: ids
must then agree in order and under a limit, before and after a
compaction. Tolerance is exact equality throughout.
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
from geomesa_tpu_torch.storage.delta import TieredTable
from geomesa_tpu_torch.storage.table import IndexTable

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

N = 60_000
TILE = 4096
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000


def _data(seed=7, n=N):
    rng = np.random.default_rng(seed)
    half = n // 2
    cx = rng.uniform(-160, 160, 16)
    cy = rng.uniform(-55, 65, 16)
    which = rng.integers(0, 16, half)
    x = np.concatenate([rng.uniform(-180, 180, n - half),
                        np.clip(cx[which] + rng.normal(0, 3.0, half), -180, 180)])
    y = np.concatenate([rng.uniform(-90, 90, n - half),
                        np.clip(cy[which] + rng.normal(0, 2.0, half), -90, 90)])
    t = T0 + rng.integers(0, 28 * DAY, n)
    age = rng.integers(0, 100, n).astype(np.int32)
    # a few points exactly on query edges exercise the f32 boundary band
    x[:50] = 10.0
    y[50:100] = -5.0
    return x, y, t, age


SPECS = {
    "z3": ("age:Integer,dtg:Date,*geom:Point:srid=4326", {}),
    "z3-packed": ("age:Integer,dtg:Date,*geom:Point:srid=4326",
                  {"geomesa.z3.packed-time": "true"}),
    "z2": ("age:Integer,*geom:Point:srid=4326", {}),
}


def _build(pkg, cell, data, writes=None, **kw):
    """A store of ``data`` in one write, or in one write per row count of
    ``writes``."""
    spec, ud = SPECS[cell]
    sft = pkg.FeatureType.from_spec("pts", spec)
    sft.user_data.update(ud)
    ds = pkg.DataStore(tile=TILE, **kw)
    ds.create_schema(sft)
    _write(pkg, ds, data, writes or [len(data[0])])
    return ds


def _write(pkg, ds, data, writes, start=0):
    """Write rows [start, start + sum(writes)) of ``data``, one batch per
    entry of ``writes``; ids are the row numbers."""
    sft = ds.get_schema("pts")
    x, y, t, age = data
    for n in writes:
        sl = slice(start, start + n)
        cols = {"geom": (x[sl], y[sl]), "age": age[sl]}
        if sft.dtg_field is not None:
            cols["dtg"] = t[sl]
        ds.write("pts", pkg.FeatureCollection.from_columns(sft, np.arange(sl.start, sl.stop), cols))
        start += n


@pytest.fixture(scope="module")
def stores():
    from geomesa_tpu import native

    data = _data()
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        out = {
            cell: (_build(geomesa_tpu, cell, data),
                   _build(geomesa_tpu_torch, cell, data, device="cpu"))
            for cell in SPECS
        }
        yield out, data


def _dur(d0, d1, ms=0):
    lo = np.datetime64(T0 + d0 * DAY + ms, "ms")
    hi = np.datetime64(T0 + d1 * DAY, "ms")
    return f"dtg DURING {lo}Z/{hi}Z"


POLY = "INTERSECTS(geom, POLYGON ((0 -10, 30 -10, 25 20, 5 15, 0 -10)))"
TIME_QUERIES = [
    f"bbox(geom, -30, -25, 10, -5) AND {_dur(3, 16, ms=123)}",
    f"bbox(geom, -40, -20, -20, -10) AND {_dur(1, 11)}",
    f"bbox(geom, 0, -15, 40, 25) AND {_dur(0, 28)}",
    _dur(4, 5, ms=77),
    f"dtg >= {np.datetime64(T0 + 20 * DAY, 'ms')}Z",
    f"{POLY} AND {_dur(2, 9)}",
    f"(bbox(geom, -100, 0, -80, 10) OR bbox(geom, 60, -30, 80, -20)) AND {_dur(5, 19)}",
    f"bbox(geom, 10, -5, 30, 20) AND age > 50 AND {_dur(0, 14)}",
    f"bbox(geom, 170, -40, 190, 40) AND {_dur(7, 21)}",
]
SPATIAL_QUERIES = [
    "bbox(geom, -30, -25, 10, -5)",
    "bbox(geom, -40, -20, -20, -10)",
    POLY,
    "bbox(geom, -100, 0, -80, 10) OR bbox(geom, 60, -30, 80, -20)",
    "bbox(geom, 10, -5, 30, 20) AND age > 50",
    "bbox(geom, 170, -40, 190, 40)",
]
QUERIES = (
    [("z3", q) for q in TIME_QUERIES + SPATIAL_QUERIES[:1]]
    + [("z3-packed", q) for q in TIME_QUERIES]
    + [("z2", q) for q in SPATIAL_QUERIES]
)
IDS = [f"{c}-{i}" for i, (c, _) in enumerate(QUERIES)]


@pytest.mark.parametrize("cell,q", QUERIES, ids=IDS)
def test_query_ids_and_count_equal(stores, cell, q):
    jds, tds = stores[0][cell]
    got = tds.query("pts", q)
    ref = jds.query("pts", q)
    assert len(ref)
    assert np.array_equal(
        np.sort(np.asarray(got.ids, np.int64)), np.sort(np.asarray(ref.ids, np.int64))
    )
    assert tds.count("pts", q) == jds.count("pts", q) == len(ref)


@pytest.mark.parametrize("cell,q", QUERIES, ids=IDS)
def test_density_and_bounds_equal(stores, cell, q):
    jds, tds = stores[0][cell]
    for env, w, h in (((-180, -90, 180, 90), 64, 32), ((-45.5, -30.25, 45, 30), 33, 17)):
        got = tds.density("pts", q, envelope=env, width=w, height=h)
        ref = jds.density("pts", q, envelope=env, width=w, height=h)
        assert got.dtype == np.float32 and got.shape == (h, w)
        assert np.array_equal(got, ref)
    assert tds.bounds("pts", q, estimate=True) == jds.bounds("pts", q, estimate=True)


def test_results_match_brute_force(stores):
    """The port alone against an f64 numpy filter over the source columns."""
    x, y, t, age = stores[1]
    tds = stores[0]["z3"][1]
    q = f"bbox(geom, 0, -15, 40, 25) AND {_dur(3, 16, ms=123)}"
    lo, hi = T0 + 3 * DAY + 123, T0 + 16 * DAY
    expect = np.flatnonzero((x >= 0) & (x <= 40) & (y >= -15) & (y <= 25) & (t >= lo) & (t < hi))
    got = np.sort(np.asarray(tds.query("pts", q).ids, np.int64))
    assert len(expect) and np.array_equal(got, expect)


def test_explain_names_strategy(stores):
    tds = stores[0]["z3"][1]
    assert "Strategy: z3" in tds.explain("pts", TIME_QUERIES[0])
    # a polygon filter rides the index scan's polygon legs; a filter with
    # no spatio-temporal constraint takes the full-table host scan
    assert "Strategy: z3" in tds.explain("pts", TIME_QUERIES[5])
    assert "full-table host scan" in tds.explain("pts", "age > 50")


def _ordered(fc) -> np.ndarray:
    return np.asarray(fc.ids, np.int64)


def test_two_writes_return_main_then_delta_rows_in_order():
    """Two writes: both packages keep the second batch in their delta
    tier and return the main table's hits, then the delta's, so the ids
    agree in order."""
    data = _data(seed=9)
    stores = [_build(geomesa_tpu, "z3", data, writes=[40_000, 20_000]),
              _build(geomesa_tpu_torch, "z3", data, writes=[40_000, 20_000], device="cpu")]
    assert isinstance(stores[1].table("pts", "z3"), TieredTable)
    delta_hits = 0
    for q in TIME_QUERIES[:3]:
        ref, got = (_ordered(d.query("pts", q)) for d in stores)
        assert len(ref) and np.array_equal(got, ref)
        n_delta = int((ref >= 40_000).sum())
        assert (ref[len(ref) - n_delta:] >= 40_000).all()  # the delta's hits come last
        delta_hits += n_delta
    assert delta_hits


# -- the delta tier against the JAX package's ------------------------------

N_TIERED = 20_000
WRITES = [12_000, 8_000]  # the second write stays in the delta of both
TIERED_QUERIES = {
    "z3": TIME_QUERIES[:3] + TIME_QUERIES[6:7],
    "z3-packed": TIME_QUERIES[1:3] + TIME_QUERIES[6:7],
    "z2": SPATIAL_QUERIES[1:4],
}
TIERED_CASES = [(c, q) for c in SPECS for q in TIERED_QUERIES[c]]
TIERED_IDS = [f"{c}-{i}" for c in SPECS for i in range(len(TIERED_QUERIES[c]))]


@pytest.fixture(scope="module")
def tiered():
    from geomesa_tpu import native

    data = _data(seed=11, n=N_TIERED)
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        yield {
            cell: (_build(geomesa_tpu, cell, data, writes=WRITES),
                   _build(geomesa_tpu_torch, cell, data, writes=WRITES, device="cpu"))
            for cell in SPECS
        }, data


def _index_of(cell):
    return "z2" if cell == "z2" else "z3"


@pytest.mark.parametrize("cell,q", TIERED_CASES, ids=TIERED_IDS)
def test_tiered_ids_in_order_and_limits_equal_jax(tiered, cell, q):
    jds, tds = tiered[0][cell]
    assert isinstance(tds.table("pts", _index_of(cell)), TieredTable)
    ref = _ordered(jds.query("pts", q))
    assert len(ref) and np.array_equal(_ordered(tds.query("pts", q)), ref)
    for limit in (1, 5, 7):
        got = _ordered(tds.query("pts", q, limit=limit))
        assert np.array_equal(got, _ordered(jds.query("pts", q, limit=limit)))
        assert np.array_equal(got, ref[:limit])
    assert tds.count("pts", q) == jds.count("pts", q) == len(ref)


@pytest.mark.parametrize("cell,q", TIERED_CASES, ids=TIERED_IDS)
def test_tiered_aggregations_equal_jax(tiered, cell, q):
    """Bounds (estimate on and off), density grids and the Count()
    estimate over the main table's kernels plus the host delta."""
    jds, tds = tiered[0][cell]
    for est in (True, False):
        assert tds.bounds("pts", q, estimate=est) == jds.bounds("pts", q, estimate=est)
        got = tds.stats_query("pts", "Count()", q, estimate=est)
        ref = jds.stats_query("pts", "Count()", q, estimate=est)
        assert [st.to_json() for st in got] == [st.to_json() for st in ref]
    for env, w, h in (((-180, -90, 180, 90), 64, 32), ((-45.5, -30.25, 45, 30), 33, 17)):
        got = tds.density("pts", q, envelope=env, width=w, height=h)
        assert np.array_equal(got, jds.density("pts", q, envelope=env, width=w, height=h))


@pytest.mark.parametrize("cell", list(SPECS))
def test_tiered_query_many_and_density_many_equal_jax(tiered, cell):
    jds, tds = tiered[0][cell]
    queries = TIERED_QUERIES[cell]
    for limit in (None, 7):
        got = tds.query_many("pts", queries, limit=limit)
        ref = jds.query_many("pts", queries, limit=limit)
        for q, g, r in zip(queries, got, ref):
            assert np.array_equal(_ordered(g), _ordered(r)), q
    reqs = [(q, (-45.5, -30.25, 45, 30)) for q in queries]
    for g, r in zip(tds.density_many("pts", reqs, width=33, height=17),
                    jds.density_many("pts", reqs, width=33, height=17)):
        assert np.array_equal(g, np.asarray(r))


@pytest.mark.parametrize("cell", list(SPECS))
def test_compaction_keeps_the_reference_order(tiered, cell):
    """A third write past a lowered ``geomesa.tpu.compact.min.rows``
    compacts both stores; an explicit ``compact()`` does too. Ids stay
    equal in order, under a limit, to the JAX package's."""
    from geomesa_tpu import conf as jconf
    from geomesa_tpu import native

    from geomesa_tpu_torch import conf as tconf

    data = tiered[1]
    queries = TIERED_QUERIES[cell][:2]
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        jconf.COMPACT_MIN_ROWS.set(4_000)
        tconf.COMPACT_MIN_ROWS.set(4_000)
        try:
            pair = [_build(geomesa_tpu, cell, data, writes=[12_000, 2_000]),
                    _build(geomesa_tpu_torch, cell, data, writes=[12_000, 2_000], device="cpu")]
            assert isinstance(pair[1].table("pts", _index_of(cell)), TieredTable)
            # 6,000 more: a delta of 8,000 > max(4,000, 20,000 // 8)
            _write(geomesa_tpu, pair[0], data, [6_000], start=14_000)
            _write(geomesa_tpu_torch, pair[1], data, [6_000], start=14_000)
        finally:
            jconf.COMPACT_MIN_ROWS.clear()
            tconf.COMPACT_MIN_ROWS.clear()
        explicit = [_build(geomesa_tpu, cell, data, writes=WRITES),
                    _build(geomesa_tpu_torch, cell, data, writes=WRITES, device="cpu")]
        for ds in explicit:
            ds.compact("pts")
        for jds, tds in (pair, explicit):
            assert isinstance(tds.table("pts", _index_of(cell)), IndexTable)
            assert tds.row_count("pts") == N_TIERED
            for q in queries:
                ref = _ordered(jds.query("pts", q))
                assert len(ref) and np.array_equal(_ordered(tds.query("pts", q)), ref)
                got = _ordered(tds.query("pts", q, limit=7))
                assert np.array_equal(got, _ordered(jds.query("pts", q, limit=7)))


@pytest.mark.parametrize("cell", ["z3", "z3-packed", "z2"])
def test_loaded_table_state_gives_same_planes(stores, cell):
    """load_table_state over a JAX table's numpy state: the port's table
    holds the same columns, and its scan gives the JAX table's planes and
    (ordinals, certain)."""
    jds, tds = stores[0][cell]
    iname = "z2" if cell == "z2" else "z3"
    jt = jds.table("pts", iname)
    state = {k: getattr(jt, k) for k in ("perm", "bins", "zs", "ubins", "bin_starts", "block")}
    state["cols3"] = {k: np.asarray(v) for k, v in jt.cols3.items()}
    tidx = next(i for i in tds.indexes("pts") if i.name == iname)
    pt = load_table_state(state, tidx, "cpu")
    for k, v in state["cols3"].items():
        assert np.array_equal(pt.cols3[k].numpy(), v)
        assert pt.cols3[k].dtype == {np.dtype(np.float32): torch.float32,
                                     np.dtype(np.int32): torch.int32}[v.dtype]
    jidx = next(i for i in jds.indexes("pts") if i.name == iname)
    q = TIME_QUERIES[1] if iname == "z3" else SPATIAL_QUERIES[1]
    jcfg = jidx.scan_config(geomesa_tpu.filter.ecql.parse(q))
    tcfg = tidx.scan_config(geomesa_tpu_torch.filter.ecql.parse(q))
    jboxes, jwins = jt._params(jcfg)
    tboxes, twins = pt._params(tcfg)
    assert np.array_equal(jboxes, tboxes) and np.array_equal(jwins, twins)
    names = pt._scan_cols(tcfg)
    assert names == jt._scan_cols(jcfg)
    bids, _ = tbk.pad_bids(np.arange(pt.n_blocks), pt.n_blocks)
    kw = dict(col_names=names, has_boxes=tcfg.boxes is not None,
              has_windows=tcfg.windows is not None)
    jw, ji = jbk.block_scan(jt._cols_args(names), bids, jboxes, jwins, extent=False, **kw)
    tw, ti = tbk.block_scan(pt._cols_args(names), bids, tboxes, twins, **kw)
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    jo, jc = jt.scan(jcfg)
    to, tc = pt.scan(tcfg)
    assert np.array_equal(to, jo) and np.array_equal(tc, jc)
