"""The port's store against the JAX DataStore, both on the CPU.

The same features, made from a seed with numpy, go into a JAX
``geomesa_tpu.DataStore`` and a port ``geomesa_tpu_torch.DataStore``
(device="cpu"); every query must return the same ids and count, and
every density grid and ``bounds(estimate=True)`` must be equal. Cells:
Z3 with packed time off and on, and Z2. The JAX package's C++ host
helpers are switched off for the module so both packages take the same
numpy range decomposition (the helpers' ranges can differ from the numpy
ones, which moves the candidate blocks a loose aggregation covers).
Tolerance is exact equality throughout.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu.scan import block_kernels as jbk
from geomesa_tpu_torch.scan import block_kernels as tbk
from geomesa_tpu_torch.state import load_table_state

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

N = 60_000
TILE = 4096
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000


def _data(seed=7):
    rng = np.random.default_rng(seed)
    half = N // 2
    cx = rng.uniform(-160, 160, 16)
    cy = rng.uniform(-55, 65, 16)
    which = rng.integers(0, 16, half)
    x = np.concatenate([rng.uniform(-180, 180, N - half),
                        np.clip(cx[which] + rng.normal(0, 3.0, half), -180, 180)])
    y = np.concatenate([rng.uniform(-90, 90, N - half),
                        np.clip(cy[which] + rng.normal(0, 2.0, half), -90, 90)])
    t = T0 + rng.integers(0, 28 * DAY, N)
    age = rng.integers(0, 100, N).astype(np.int32)
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


def _build(pkg, cell, data, **kw):
    spec, ud = SPECS[cell]
    sft = pkg.FeatureType.from_spec("pts", spec)
    sft.user_data.update(ud)
    ds = pkg.DataStore(tile=TILE, **kw)
    ds.create_schema(sft)
    x, y, t, age = data
    cols = {"geom": (x, y), "age": age}
    if "dtg" in spec:
        cols["dtg"] = t
    ds.write("pts", pkg.FeatureCollection.from_columns(sft, np.arange(N), cols))
    return ds


@pytest.fixture(scope="module")
def stores():
    from geomesa_tpu import native

    data = _data()
    with pytest.MonkeyPatch.context() as mp:
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


def test_rebuild_on_write_equals_lsm_path():
    """Two writes: the port rebuilds its table from all rows, the JAX store
    keeps the second batch in its delta tier; answers agree."""
    data = _data(seed=9)
    x, y, t, age = data
    stores = []
    for pkg, kw in ((geomesa_tpu, {}), (geomesa_tpu_torch, {"device": "cpu"})):
        sft = pkg.FeatureType.from_spec("pts", SPECS["z3"][0])
        ds = pkg.DataStore(tile=TILE, **kw)
        ds.create_schema(sft)
        for sl in (slice(0, 40_000), slice(40_000, N)):
            ds.write("pts", pkg.FeatureCollection.from_columns(
                sft, np.arange(N)[sl], {"geom": (x[sl], y[sl]), "age": age[sl], "dtg": t[sl]}
            ))
        stores.append(ds)
    for q in TIME_QUERIES[:3]:
        ref, got = (np.sort(np.asarray(d.query("pts", q).ids, np.int64)) for d in stores)
        assert len(ref) and np.array_equal(got, ref)


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
