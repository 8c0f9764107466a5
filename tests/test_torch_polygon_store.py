"""Polygon queries on the port's point stores against the JAX DataStore,
both on the CPU.

``INTERSECTS(geom, <polygon>)`` (with holes, a MultiPolygon, polygons
below the raster's edge minimum and past the edge ladder) alone on Z2 and
``AND dtg DURING`` on Z3 with packed time off and on, under the JAX
package's three raster settings: the default (raster leg, host residue),
``geomesa.raster.residue=device`` (both legs) and
``geomesa.raster.enabled=false`` (the point-in-polygon leg alone). The
scan configs and query ids must equal the JAX package's
(tests/test_torch_polygon_batch.py holds ``query_many``, the fused chunks
and the aggregations). The JAX package's C++ host helpers are off for the
module, as in tests/test_torch_store.py. Tolerance is exact equality.
"""

from contextlib import contextmanager

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu_torch import native as tnative
from geomesa_tpu import conf as jconf
from geomesa_tpu.filter import raster as jfr
from geomesa_tpu_torch import conf as tconf
from geomesa_tpu_torch.filter import raster as tfr
from test_torch_store import _build, _data, _dur

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

CELLS = ["z3", "z3-packed", "z2"]


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


def _ring(cx, cy, arms, r_in, r_out, reverse=False):
    a = np.linspace(0, 2 * np.pi, 2 * arms, endpoint=False)
    if reverse:
        a = a[::-1]
    r = np.where(np.arange(2 * arms) % 2 == 0, r_out, r_in)
    pts = [(cx + ri * np.cos(ai), cy + ri * np.sin(ai)) for ai, ri in zip(a, r)]
    pts.append(pts[0])
    return "(" + ", ".join(f"{x:.4f} {y:.4f}" for x, y in pts) + ")"


def star(cx, cy, arms, r_in, r_out, hole=0.0):
    """WKT of a star polygon (2 * arms edges), optionally with a hole."""
    rings = [_ring(cx, cy, arms, r_in, r_out)]
    if hole:
        rings.append(_ring(cx, cy, arms, hole * r_in, hole * r_in, reverse=True))
    return f"POLYGON ({', '.join(rings)})"


# a thin sliver triangle: 3 edges (no raster), its bbox holds ~80x the
# points the polygon does
SLIVER = "POLYGON ((-60 -40, 60 40, 58 41.5, -60 -40))"
POLYGONS = {
    "pip-only": star(-10, 5, 3, 9, 22),
    "e20": star(15, -10, 10, 8, 20),
    "e120-hole": star(-20, -15, 30, 12, 26, hole=0.5),
    "e300": star(5, 20, 150, 14, 24),
    "multi": "MULTIPOLYGON (({}), ({}))".format(
        star(-40, 10, 6, 5, 14)[9:-1], star(40, -20, 12, 6, 15, hole=0.4)[9:-1]
    ),
    "sliver": SLIVER,
}
PIDS = list(POLYGONS)
SETTINGS = ["default", "device", "raster-off"]


def _filter(cell, wkt, d0=2):
    q = f"INTERSECTS(geom, {wkt})"
    return q if cell == "z2" else f"{q} AND {_dur(d0, d0 + 6, ms=321)}"


@contextmanager
def raster_setting(name, jds=None, tds=None):
    """The same raster knobs in both packages; both planners' scan-config
    memos and both raster caches are dropped around it."""
    knobs = {"device": ("RASTER_RESIDUE", "device"),
             "raster-off": ("RASTER_ENABLED", False)}.get(name)

    def reset():
        jfr.clear_cache()
        tfr.clear_cache()
        for ds in (jds, tds):
            if ds is not None:
                ds.planner.invalidate_config_memo()

    if knobs:
        for c in (jconf, tconf):
            getattr(c, knobs[0]).set(knobs[1])
    reset()
    try:
        yield
    finally:
        if knobs:
            for c in (jconf, tconf):
                getattr(c, knobs[0]).clear()
        reset()


def _ids(fc) -> np.ndarray:
    return np.sort(np.asarray(fc.ids, np.int64))


def _eq(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)


CONFIG_CASES = [(s, c, p) for s in SETTINGS for c in CELLS for p in PIDS]


@pytest.mark.parametrize("setting,cell,pid", CONFIG_CASES,
                         ids=[f"{s}-{c}-{p}" for s, c, p in CONFIG_CASES])
def test_scan_config_equals_jax(stores, setting, cell, pid):
    jds, tds = stores[0][cell]
    q = _filter(cell, POLYGONS[pid])
    with raster_setting(setting, jds, tds):
        jp = jds.planner.plan("pts", q)
        tp = tds.planner.plan("pts", q)
    assert tp.index == jp.index  # the cheaper index, by the same costs
    jc, tc = jp.config, tp.config
    for f in ("range_bins", "range_lo", "range_hi", "range_contained", "boxes", "windows",
              "boxes_inner", "windows_inner", "poly", "rast"):
        assert _eq(getattr(tc, f), getattr(jc, f)), f
    for f in ("geom_precise", "time_precise", "contained_exact", "disjoint"):
        assert getattr(tc, f) == getattr(jc, f), f
    # which legs ride, by the JAX rules
    n_edges = {"pip-only": 6, "sliver": 3}.get(pid, 100)
    has_raster = setting != "raster-off" and n_edges >= 8
    assert (tc.rast is not None) == has_raster
    if pid == "e300" or (has_raster and setting == "default"):
        assert tc.poly is None
    else:
        assert tc.poly is not None


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("cell", CELLS)
def test_query_ids_and_count_equal_jax(stores, cell, setting):
    (jds, tds), (x, y, t, _) = stores[0][cell], stores[1]
    seen = 0
    with raster_setting(setting, jds, tds):
        for pid, wkt in POLYGONS.items():
            q = _filter(cell, wkt)
            got, ref = _ids(tds.query("pts", q)), _ids(jds.query("pts", q))
            assert np.array_equal(got, ref), pid
            assert tds.count("pts", q) == len(ref), pid
            assert "Strategy: z" in tds.explain("pts", q)
            seen += len(ref)
    assert seen > 0
