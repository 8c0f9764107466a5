"""Polygon queries on the port's point stores through the many-query path
and the aggregations, against the JAX DataStore, both on the CPU.

The stores, polygons and raster settings of
tests/test_torch_polygon_store.py: ``query_many`` ids, the fused chunks
(block, query and selector ids, edge and raster stacks per launch) and
the aggregations (count, bounds, density, the Count() estimate) must
equal the JAX package's, and a polygon config must stay off the
gather-free aggregation kernels. Tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.scan import block_kernels as jbk
from geomesa_tpu_torch import native as tnative
from geomesa_tpu_torch.scan import block_kernels as tbk
from test_torch_store import _dur
from test_torch_polygon_store import (  # noqa: F401  (stores is a fixture)
    CELLS, POLYGONS, SETTINGS, SLIVER, _eq, _filter, _ids, raster_setting, star, stores,
)

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)


# the polygons of the batch and aggregation tests: no raster (PIP alone),
# a raster with a hole, past the edge ladder (raster alone), two parts
BATCH_PIDS = ["pip-only", "e120-hole", "e300", "multi"]


def _batch(cell):
    """Two queries per polygon (two time windows on z3; the same filter
    twice on z2) and two box queries: polygon members of one leg
    combination fuse into one chunk."""
    out = []
    for pid in BATCH_PIDS:
        wkt = POLYGONS[pid]
        out.append(_filter(cell, wkt))
        out.append(_filter(cell, wkt, d0=9) if cell != "z2" else _filter(cell, wkt))
    for b in ("-30, -25, 10, -5", "100, 0, 140, 30"):
        q = f"bbox(geom, {b})"
        out.append(q if cell == "z2" else f"{q} AND {_dur(1, 20)}")
    return out


def _capture(monkeypatch, module, name):
    """Record (bids, qids, kw) of every call of ``module.name``."""
    calls = []
    fn = getattr(module, name)

    def spy(cols3, bids, qids, *args, **kw):
        calls.append((np.asarray(bids).copy(), np.asarray(qids).copy(), kw))
        return fn(cols3, bids, qids, *args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("cell", CELLS)
def test_query_many_and_fused_chunks_equal_jax(stores, cell, setting, monkeypatch):
    jds, tds = stores[0][cell]
    queries = _batch(cell)
    with raster_setting(setting, jds, tds):
        jcalls = _capture(monkeypatch, jbk, "block_scan_multi")
        tcalls = _capture(monkeypatch, tbk, "scan_planes_multi")
        got = tds.query_many("pts", queries)
        ref = jds.query_many("pts", queries)
        monkeypatch.undo()
        for q, g, r in zip(queries, got, ref):
            assert np.array_equal(_ids(g), _ids(r)), q
    assert len(got) == len(queries)
    # the chunks: every launch's ids, selector and stacks equal the JAX
    # table's; polygon chunks are among them
    assert len(tcalls) == len(jcalls) >= 2
    assert any(kw.get("n_edges") or kw.get("n_rints") for _, _, kw in tcalls)
    for (tb, tq, tkw), (jb, jq, jkw) in zip(tcalls, jcalls):
        assert np.array_equal(tb, jb) and np.array_equal(tq, jq)
        for k in ("n_edges", "n_rints", "has_boxes", "has_windows", "col_names"):
            assert tkw.get(k, 0) == jkw.get(k, 0), k
        for k in ("edges", "spip", "rasts"):
            assert _eq(tkw.get(k), jkw.get(k)), k


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("cell", CELLS)
def test_polygon_aggregations_equal_jax(stores, cell, setting):
    jds, tds = stores[0][cell]
    with raster_setting(setting, jds, tds):
        for pid in BATCH_PIDS[:3]:
            q = _filter(cell, POLYGONS[pid])
            assert tds.count("pts", q) == jds.count("pts", q), pid
            for est in (True, False):
                assert tds.bounds("pts", q, estimate=est) == jds.bounds("pts", q, estimate=est)
                g = tds.stats_query("pts", "Count()", q, estimate=est)
                r = jds.stats_query("pts", "Count()", q, estimate=est)
                assert [s.to_json() for s in g] == [s.to_json() for s in r], (pid, est)
            env = (-70.5, -45.25, 70, 45)
            got = tds.density("pts", q, envelope=env, width=33, height=17)
            ref = jds.density("pts", q, envelope=env, width=33, height=17)
            assert np.array_equal(got, ref), pid
        requests = [(_filter(cell, POLYGONS[pid]), None) for pid in BATCH_PIDS[:3]]
        grids = tds.density_many("pts", requests, width=24, height=12)
        refs = jds.density_many("pts", requests, width=24, height=12)
        for g, r in zip(grids, refs):
            assert np.array_equal(g, r)


@pytest.mark.parametrize("cell", CELLS)
def test_polygon_aggregations_are_not_bbox_aggregations(stores, cell):
    """The gather-free aggregation kernels test the box only: a polygon
    config must not reach them (``_device_aggregable`` passes
    ``for_aggregation``), or the count estimate, the bounds estimate and
    the density grid would cover the sliver's whole bbox."""
    (jds, tds), (x, y, t, _) = stores[0][cell], stores[1]
    q = _filter(cell, SLIVER)
    plan = tds.planner.plan("pts", q)
    assert plan.config.poly is not None and plan.config.rast is None
    exact = tds.query("pts", q)
    bbox_q = _filter(cell, "POLYGON ((-60 -40, 60 -40, 60 41.5, -60 41.5, -60 -40))")
    n_bbox = len(tds.query("pts", bbox_q))
    assert 0 < 20 * len(exact) < n_bbox
    est = tds.stats_query("pts", "Count()", q, estimate=True)[0].count
    assert est == len(exact) == jds.stats_query("pts", "Count()", q, estimate=True)[0].count
    env = tds.bounds("pts", q, estimate=True)
    xs, ys = exact.geom_column.x, exact.geom_column.y
    assert env == (float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max()))
    grid = tds.density("pts", q, envelope=(-60, -40, 60, 41.5), width=16, height=16)
    assert grid.sum() == len(exact)


def test_raster_aggregation_skips_the_gather(stores, monkeypatch):
    """count, bounds and Count() over a polygon with a raster accept the
    scan's certain rows without gathering them: only the residue gathers."""
    jds, tds = stores[0]["z2"]
    q = _filter("z2", POLYGONS["e20"])
    ordinals, certain = tds.table("pts", "z2").scan(tds.planner.plan("pts", q).config)
    assert certain.any() and (~certain).any()
    gathered = []
    gather = tds.gather

    def spy(type_name, ords, chunks=None):
        gathered.append(len(ords))
        return gather(type_name, ords, chunks=chunks)

    monkeypatch.setattr(tds, "gather", spy)
    n = tds.count("pts", q)
    assert n == jds.count("pts", q) and gathered == [int((~certain).sum())]
    assert tds.stats_query("pts", "Count()", q)[0].count == n
    assert tds.bounds("pts", q, estimate=False) == jds.bounds("pts", q, estimate=False)
    assert gathered == [int((~certain).sum())] * 3


# -- a publish between the raster scan and its residue gather -----------------

# a 12-edge star polygon (above geomesa.raster.min.edges, so it gets a
# raster) over a point schema with no date (the Z2 index, where the
# raster's full cells are certain)
PIN_Q = f"INTERSECTS(geom, {star(10, 5, 6, 12, 30)})"


def _pin_store(pkg, mesh=None, **kw):
    """20,000 seeded points in two writes, each row named n0..n9."""
    rng = np.random.default_rng(11)
    n = 20_000
    x, y = rng.uniform(-40, 60, n), rng.uniform(-40, 50, n)
    names = np.array([f"n{i % 10}" for i in range(n)])
    sft = pkg.FeatureType.from_spec("pts", "name:String,*geom:Point:srid=4326")
    ds = pkg.DataStore(mesh=mesh, **kw) if mesh is not None else pkg.DataStore(**kw)
    ds.create_schema(sft)
    for sl in (slice(0, n // 2), slice(n // 2, n)):
        ds.write("pts", pkg.FeatureCollection.from_columns(sft, np.arange(sl.start, sl.stop), {
            "name": names[sl], "geom": (x[sl], y[sl])}))
    return ds


def _publish_before_gather(monkeypatch, ds):
    """Every residue gather first deletes the next name's rows (a publish
    that renumbers the table), then gathers: the interleaving a flush, a
    fold or a delete can produce between a scan and its gather."""
    gather = ds.gather
    deleted = []

    def hooked(type_name, ords, chunks=None):
        if not getattr(hooked, "busy", False):
            hooked.busy = True
            try:
                deleted.append(ds.delete_features(type_name, f"name = 'n{len(deleted)}'"))
            finally:
                hooked.busy = False
        return gather(type_name, ords, chunks=chunks)

    monkeypatch.setattr(ds, "gather", hooked)
    return deleted


@pytest.mark.parametrize("layout", ["single", "mesh"])
def test_raster_aggregation_answers_from_its_pinned_snapshot(layout, monkeypatch):
    """count, bounds (both estimate settings) and Count() of a
    raster-eligible polygon answer from the snapshot their scan ran on,
    as the JAX package's do, when a publish lands between the scan and
    the residue gather (before the pin, the port gathered the scan's
    ordinals from the new chunk list and raised IndexError)."""
    from geomesa_tpu import native
    from geomesa_tpu.parallel import make_mesh as jmake_mesh
    from geomesa_tpu_torch.parallel import make_mesh

    import geomesa_tpu
    import geomesa_tpu_torch

    jmesh, tmesh = (jmake_mesh(8), make_mesh(devices=["cpu"] * 8)) if layout == "mesh" else (None, None)
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        jds = _pin_store(geomesa_tpu, mesh=jmesh)
        tds = _pin_store(geomesa_tpu_torch, mesh=tmesh, device="cpu")
        plan = tds.planner.plan("pts", PIN_Q)
        assert tds._raster_agg_eligible("pts", plan)
        ordinals, certain = tds.table("pts", plan.index).scan(plan.config)
        assert certain.any() and (~certain).any()
        jdel = _publish_before_gather(monkeypatch, jds)
        tdel = _publish_before_gather(monkeypatch, tds)
        assert tds.count("pts", PIN_Q) == jds.count("pts", PIN_Q)
        for est in (True, False):
            assert tds.bounds("pts", PIN_Q, estimate=est) == jds.bounds("pts", PIN_Q, estimate=est)
        g = tds.stats_query("pts", "Count()", PIN_Q)
        r = jds.stats_query("pts", "Count()", PIN_Q)
        assert [s.to_json() for s in g] == [s.to_json() for s in r]
        # every call published before its gather, in both packages alike
        assert tdel == jdel and len(tdel) == 4 and all(d > 0 for d in tdel)
