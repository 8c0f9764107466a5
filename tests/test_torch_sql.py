"""The port's SQL tier (geomesa_tpu_torch.sql) against the JAX package's,
on the CPU.

- every ST_ function: the registries hold the same names, and each
  function, called on the same arguments from a zoo of geometries (points,
  lines open, closed and self-crossing, polygons with and without holes,
  concave stars, multi-geometries, antimeridian shapes), returns the same
  value in both packages (geometries by type and WKT, bytes, floats and
  booleans exactly) or raises the same error;
- ``spatial_join`` (the host grid join): points in polygons, polygon
  pairs, ``dwithin``, a callable predicate, empty and disjoint inputs,
  and the exact, raster and adaptive strategies with
  ``geomesa.join.adaptive`` on and off: pairs equal to the JAX package's
  and to an f64 brute force;
- ``spatial_join_indexed`` (one fused scan of every left geometry through
  K2's plain version on the CPU): rectangles and concave stars with
  ``contains`` and ``intersects``, rasters off and on, the adaptive
  ``host_raster`` route on and off, a delta tier, a polygon past the
  edge ladder, and a missing index; pairs equal across packages, to the
  host join and to a brute force;
- ``sql_query``: push-downs, residual ST_ calls, ORDER BY / LIMIT /
  OFFSET, select expressions and aliases, refusals; ids and columns in
  order.
Mirrors tests/test_sql.py, tests/test_sql_query.py and the join cases of
tests/test_raster_join.py.
Tolerance: exact.
"""

import math
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)


def _pkg(pkg, kw):
    name = pkg.__name__
    return SimpleNamespace(
        name=name, pkg=pkg, kw=kw,
        sql=import_module(name + ".sql"),
        F=import_module(name + ".sql.functions"),
        join=import_module(name + ".sql.join"),
        query=import_module(name + ".sql.query"),
        geo=import_module(name + ".geometry"),
        conf=import_module(name + ".conf"),
        raster=import_module(name + ".filter.raster"),
        metrics=import_module(name + ".metrics"),
    )


JAX = _pkg(geomesa_tpu, {})
PORT = _pkg(geomesa_tpu_torch, {"device": "cpu"})
BOTH = (JAX, PORT)
KNOBS = ("RASTER_ENABLED", "RASTER_MIN_EDGES", "RASTER_RESIDUE", "JOIN_ADAPTIVE",
         "JOIN_BROAD_FRACTION", "JOIN_SAMPLE")


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


@pytest.fixture(autouse=True)
def _clean():
    for P in BOTH:
        P.raster.clear_cache()
    yield
    for P in BOTH:
        for k in KNOBS:
            getattr(P.conf, k).clear()
        P.raster.clear_cache()


def alike(fn):
    """Run ``fn(P)`` for both packages; the results must be equal."""
    out = [fn(P) for P in BOTH]
    assert out[1] == out[0]
    return out[1]


# ------------------------------------------------------------ ST_ functions

ZOO = {
    "point": "POINT (3.5 -2.25)",
    "point_in": "POINT (1 1)",
    "point_edge": "POINT (4 2)",
    "line": "LINESTRING (0 0, 3 4, 6 0)",
    "line_through": "LINESTRING (-1 1, 5 1)",
    "ring": "LINESTRING (0 0, 2 0, 2 2, 0 2, 0 0)",
    "bowtie": "LINESTRING (0 0, 2 2, 2 0, 0 2)",
    "box": "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))",
    "box2": "POLYGON ((2 2, 6 2, 6 6, 2 6, 2 2))",
    "far": "POLYGON ((10 10, 11 10, 11 11, 10 11, 10 10))",
    "holed": "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (6 4, 9 4, 9 6, 6 6, 6 4))",
    "concave": "POLYGON ((0 0, 6 0, 6 6, 3 2, 0 6, 0 0))",
    "mpoint": "MULTIPOINT ((0 0), (1 1), (5 5))",
    "mline": "MULTILINESTRING ((0 0, 1 1), (1 1, 2 0), (3 3, 4 4))",
    "mpoly": "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 1, 0 0)), ((2 2, 3 2, 3 3, 2 3, 2 2)))",
    "seam_line": "LINESTRING (170 0, -170 5)",
    "seam_poly": "POLYGON ((170 -5, -170 -5, -170 5, 170 5, 170 -5))",
}
UNARY_NAMES = ("point", "line", "ring", "bowtie", "box", "holed", "concave", "mpoint",
               "mline", "mpoly", "seam_line", "seam_poly")
BINARY_NAMES = ("point_in", "point_edge", "line_through", "box", "box2", "far", "concave",
                "mpoly", "mline", "ring")


def _norm(v, P):
    if isinstance(v, P.geo.Geometry):
        return ("geom", v.geom_type, v.wkt)
    if isinstance(v, (bytes, bytearray)):
        return ("bytes", bytes(v))
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x, P) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _norm(x, P)) for k, x in v.items()))
    if isinstance(v, (np.floating, float)):
        v = float(v)
        return ("nan",) if math.isnan(v) else v
    if isinstance(v, np.generic):
        return v.item()
    return v


def _call(P, fn, args):
    try:
        return _norm(fn(*args), P)
    except Exception as e:  # the same refusal in both packages
        return ("raises", type(e).__name__, str(e))


def _geoms(P, names):
    return [P.geo.from_wkt(ZOO[n]) for n in names]


def _args(P, name):
    """Argument tuples for one function: from its signature's kinds."""
    g = dict(zip(ZOO, _geoms(P, ZOO)))
    unary = [(g[n],) for n in UNARY_NAMES]
    pairs = [(g[a], g[b]) for a in BINARY_NAMES for b in BINARY_NAMES]
    special = {
        "st_point": [(1.0, 2.0), (-180.0, 90.0)], "st_makepoint": [(1.0, 2.0)],
        "st_makepointm": [(1.0, 2.0, 3.0)],
        "st_makebbox": [(0, 0, 2, 2), (-10.5, -3.0, 7.25, 8.0)],
        "st_makebox": [(g["point_in"], g["point"])],
        "st_makeline": [([P.geo.Point(0, 0), P.geo.Point(3, 4)],), ([(0, 0), (1, 1), (2, 0)],)],
        "st_makepolygon": [(g["ring"],), ([(0, 0), (4, 0), (4, 4), (0, 0)],)],
        "st_polygon": [(g["ring"],)],
        "st_geomfromwkt": [(w,) for w in ZOO.values()] + [("NOT WKT",)],
        "st_geomfromwkb": [(g[n].wkb if hasattr(g[n], "wkb") else P.geo.to_wkb(g[n]),) for n in UNARY_NAMES],
        "st_pointfromwkb": [(P.geo.to_wkb(g["point"]),), (P.geo.to_wkb(g["box"]),)],
        "st_pointfromtext": [(ZOO["point"],), (ZOO["box"],)],
        "st_linefromtext": [(ZOO["line"],), (ZOO["point"],)],
        "st_polygonfromtext": [(ZOO["holed"],), (ZOO["line"],)],
        "st_mpointfromtext": [(ZOO["mpoint"],), (ZOO["point"],)],
        "st_mlinefromtext": [(ZOO["mline"],), (ZOO["line"],)],
        "st_mpolyfromtext": [(ZOO["mpoly"],), (ZOO["box"],)],
        "st_bufferpoint": [(g["point"], 111_320.0), (P.geo.Point(0, 89.9), 5000.0, 8)],
        "st_translate": [(g[n], 5.0, -2.0) for n in UNARY_NAMES],
        "st_simplify": [(g[n], tol) for n in UNARY_NAMES for tol in (0.0, 0.5, 2.0)],
        "st_dwithin": [(a, b, d) for a, b in pairs for d in (0.1, 3.0)],
        "st_relatebool": [(a, b, pat) for a, b in pairs[:30]
                          for pat in ("T*F**F***", "FF*FF****", "T********")],
        "st_interiorringn": [(g["holed"], 1), (g["holed"], 2), (g["box"], 1)],
        "st_pointn": [(g["line"], n) for n in (1, 2, 3, 4, -1)],
        "st_geometryn": [(g[n], k) for n in ("mpoint", "mpoly", "box") for k in (1, 2, 5)],
        "st_geohash": [(g["point"], p) for p in (1, 5, 12)] + [(P.geo.Point(-179.99, -89.99),)],
        "st_geomfromgeohash": [("9q8yy",), ("s",), ("ezs42e44yx96",)],
        "st_pointfromgeohash": [("9q8yy",), ("u4pruydqqvj",)],
        "st_astwkb": [(g[n], p) for n in UNARY_NAMES for p in (0, 3, 7)],
        "st_geomfromtwkb": [],
        "st_geomfromgeojson": [('{"type": "Point", "coordinates": [1.5, 2]}',),
                               ({"type": "Polygon", "coordinates": [[[0, 0], [1, 0], [1, 1], [0, 0]]]},),
                               ('{"type": "MultiLineString", "coordinates": [[[0, 0], [1, 1]]]}',)],
        "st_aslatlontext": [(g["point"],), (P.geo.Point(-122.4194, 37.7749),), (P.geo.Point(0.9999999, -0.5),)],
        "st_bytearray": [("abc",), ("",), ("héllo",)],
        "st_aggregatedistancesphere": [([P.geo.Point(0, 0), P.geo.Point(1, 1), P.geo.Point(2, 0)],),
                                       ([P.geo.Point(0, 0)],)],
    }
    special["st_geomfromtwkb"] = [(a[0],) for a in (
        [(P.F.st_astwkb(g[n], 5),) for n in UNARY_NAMES])]
    if name in special:
        return special[name]
    params = list(__import__("inspect").signature(P.F.FUNCTIONS[name]).parameters)
    return pairs if len(params) == 2 else unary


def test_function_registries_are_equal():
    names = alike(lambda P: sorted(P.F.FUNCTIONS))
    assert len(names) == 83
    assert set(PORT.sql.FUNCTIONS) == set(names)


@pytest.mark.parametrize("name", sorted(JAX.F.FUNCTIONS))
def test_st_function_equals_the_jax_package(name):
    results = alike(lambda P: [_call(P, P.F.FUNCTIONS[name], args) for args in _args(P, name)])
    assert results and any(r[:1] != ("raises",) if isinstance(r, tuple) else True for r in results)


def test_st_call_dispatch_and_unknown_names():
    def case(P):
        p = P.sql.st_call("ST_Point", 1.0, 2.0)
        with pytest.raises(KeyError):
            P.sql.st_call("ST_Bogus", 1)
        return p.x, p.y, P.sql.st_call("st_area", P.geo.box(0, 0, 4, 4))

    assert alike(case) == (1.0, 2.0, 16.0)


@pytest.mark.parametrize("wkt", [ZOO["holed"], ZOO["concave"], ZOO["line"], ZOO["box"]])
def test_planar_area_and_length(wkt):
    def case(P):
        g = P.geo.from_wkt(wkt)
        return (getattr(g, "area", None), getattr(g, "length", None),
                P.F.st_area(g), P.F.st_length(g))

    alike(case)


# ------------------------------------------------------- the host grid join


def _points_fc(P, xy, name="pts"):
    sft = P.pkg.FeatureType.from_spec(name, "*geom:Point:srid=4326")
    xy = np.asarray(xy, dtype=np.float64).reshape(-1, 2)
    return P.pkg.FeatureCollection.from_columns(sft, np.arange(len(xy)).astype(str),
                                                {"geom": (xy[:, 0], xy[:, 1])})


def _polys_fc(P, polys, name="polys"):
    sft = P.pkg.FeatureType.from_spec(name, "*geom:Polygon:srid=4326")
    return P.pkg.FeatureCollection.from_columns(
        sft, np.arange(len(polys)).astype(str),
        {"geom": P.geo.PackedGeometryColumn.from_geometries(polys)})


def jagged_star(P, cx, cy, r, n_arms, seed=0):
    rng = np.random.default_rng(seed)
    a = np.linspace(0, 2 * np.pi, 2 * n_arms + 1)[:-1]
    rad = np.where(np.arange(2 * n_arms) % 2 == 0, r, r * rng.uniform(0.3, 0.7, 2 * n_arms))
    return P.geo.Polygon([(cx + rr * np.cos(t), cy + rr * np.sin(t)) for t, rr in zip(a, rad)])


def donut(P, cx, cy, r_out, r_in, n=24):
    a = np.linspace(0, 2 * np.pi, n + 1)
    return P.geo.Polygon([(cx + r_out * np.cos(t), cy + r_out * np.sin(t)) for t in a],
                         [[(cx + r_in * np.cos(t), cy + r_in * np.sin(t)) for t in a]])


def _stars(P, n_poly, seed=31):
    rng = np.random.default_rng(seed)
    polys = [jagged_star(P, float(rng.uniform(-40, 40)), float(rng.uniform(-30, 30)),
                         float(rng.uniform(1.0, 8.0)), int(rng.integers(4, 50)), seed=k)
             for k in range(n_poly)]
    return polys + [donut(P, 20.0, -10.0, 6.0, 3.0)]


def _pairs(lr):
    return list(zip(np.asarray(lr[0]).tolist(), np.asarray(lr[1]).tolist()))


def _brute_pairs(P, polys, x, y, predicate):
    want = []
    for k, g in enumerate(polys):
        m = P.geo.points_in_polygon(x, y, g)
        if predicate == "intersects":
            m |= P.geo.points_on_boundary(x, y, g)
        want += [(k, int(j)) for j in np.flatnonzero(m)]
    return sorted(want)


@pytest.mark.parametrize("predicate", ["contains", "intersects"])
@pytest.mark.parametrize("strategy", ["exact", "raster", "auto"])
@pytest.mark.parametrize("adaptive", [True, False])
def test_spatial_join_points_in_stars(predicate, strategy, adaptive):
    rng = np.random.default_rng(5)
    n = 20_000
    x, y = rng.uniform(-50, 50, n), rng.uniform(-40, 40, n)
    # points exactly on a box edge and corner: the predicates differ there
    x[:3], y[:3] = [20.0, 20.0, 26.0], [-10.0, 0.0, -10.0]

    def case(P):
        P.conf.JOIN_ADAPTIVE.set(adaptive)
        polys = _stars(P, 10) + [P.geo.box(20.0, -10.0, 26.0, 0.0)]
        reg = P.metrics.MetricsRegistry()
        got = _pairs(P.sql.spatial_join(_polys_fc(P, polys), _points_fc(P, np.stack([x, y], 1)),
                                        predicate, strategy=strategy, metrics=reg))
        assert got == _brute_pairs(P, polys, x, y, predicate)
        decided = reg.counter_value("geomesa.join.raster.decided")
        return got, (decided > 0) if strategy == "raster" and adaptive else None

    got, decided = alike(case)
    assert len(got) > 100 and decided in (None, True)


@pytest.mark.parametrize("case_", ["polygon_pairs", "dwithin", "callable", "within",
                                   "empty", "disjoint", "lines"])
def test_spatial_join_other_predicates(case_):
    def case(P):
        g = P.geo
        if case_ == "polygon_pairs":
            a = [g.box(0, 0, 2, 2), g.box(10, 10, 12, 12)]
            b = [g.box(1, 1, 3, 3), g.box(20, 20, 21, 21), g.box(11, 9, 13, 11)]
            return _pairs(P.sql.spatial_join(_polys_fc(P, a), _polys_fc(P, b, "b"), "intersects"))
        if case_ == "dwithin":
            a = _points_fc(P, [(0, 0), (5, 5)])
            b = _points_fc(P, [(0.5, 0.0), (4.0, 4.0), (30, 30)], "b")
            return _pairs(P.sql.spatial_join(a, b, "dwithin", max_distance=1.6))
        if case_ == "callable":
            a = _polys_fc(P, [g.box(0, 0, 5, 5), g.box(3, 3, 9, 9)])
            b = _polys_fc(P, [g.box(1, 1, 2, 2), g.box(4, 4, 6, 6)], "b")
            return _pairs(P.sql.spatial_join(a, b, lambda p, q: g.contains(p, q)))
        if case_ == "within":
            a = _points_fc(P, [(1, 1), (7, 7), (50, 50)])
            b = _polys_fc(P, [g.box(0, 0, 5, 5), g.box(3, 3, 9, 9)], "b")
            return _pairs(P.sql.spatial_join(a, b, "within"))
        if case_ == "empty":
            return _pairs(P.sql.spatial_join(_points_fc(P, np.zeros((0, 2))), _points_fc(P, [(1, 1)])))
        if case_ == "disjoint":
            return _pairs(P.sql.spatial_join(_points_fc(P, [(0, 0)]), _points_fc(P, [(50, 50)], "b")))
        sft = P.pkg.FeatureType.from_spec("ln", "*geom:LineString:srid=4326")
        lines = [g.LineString([(0, 0), (4, 4)]), g.LineString([(10, 0), (10, 5)])]
        a = P.pkg.FeatureCollection.from_columns(
            sft, ["0", "1"], {"geom": g.PackedGeometryColumn.from_geometries(lines)})
        return _pairs(P.sql.spatial_join(a, _points_fc(P, [(2, 2), (10, 3), (5, 1)]), "intersects"))

    got = alike(case)
    want = {"polygon_pairs": [(0, 0), (1, 2)], "dwithin": [(0, 0), (1, 1)],
            "callable": [(0, 0), (1, 1)], "within": [(0, 0), (1, 1)],
            "empty": [], "disjoint": [], "lines": [(0, 0), (1, 1)]}[case_]
    assert got == want


def test_spatial_join_refusals():
    for P in BOTH:
        a = _points_fc(P, [(0, 0)])
        with pytest.raises(ValueError):
            P.sql.spatial_join(a, a, "dwithin")
        with pytest.raises(ValueError):
            P.sql.spatial_join(a, a, "touches")
        with pytest.raises(ValueError):
            P.sql.spatial_join(a, a, strategy="fastest")


# ---------------------------------------------------------- the indexed join


def _point_store(P, n, seed, index="z2", tile=256):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-90, 90, n), rng.uniform(-45, 45, n)
    sft = P.pkg.FeatureType.from_spec("jp", "*geom:Point:srid=4326")
    sft.user_data["geomesa.indices.enabled"] = index
    ds = P.pkg.DataStore(tile=tile, **P.kw)
    ds.create_schema(sft)
    ds.write("jp", P.pkg.FeatureCollection.from_columns(sft, np.arange(n), {"geom": (x, y)}),
             check_ids=False)
    return ds, x, y


def _left(P, kind, n_poly=24, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "boxes":
        px0, py0 = rng.uniform(-85, 70, n_poly), rng.uniform(-40, 30, n_poly)
        pw, ph = rng.uniform(1, 12, n_poly), rng.uniform(1, 8, n_poly)
        polys = [P.geo.box(a, b, a + w, b + h) for a, b, w, h in zip(px0, py0, pw, ph)]
    elif kind == "stars":
        polys = [jagged_star(P, float(rng.uniform(-70, 70)), float(rng.uniform(-35, 35)),
                             float(rng.uniform(2, 10)), int(rng.integers(8, 128)), seed=k)
                 for k in range(n_poly)]
        polys.append(donut(P, 0.0, 0.0, 8.0, 4.0))
    else:  # past the edge ladder: every candidate refines on the host
        a = np.linspace(0, 2 * np.pi, 301)[:-1]
        polys = [P.geo.Polygon([(30 * np.cos(t), 15 * np.sin(t)) for t in a])]
    return polys, _polys_fc(P, polys, "adm")


@pytest.mark.parametrize("kind", ["boxes", "stars", "ellipse"])
@pytest.mark.parametrize("predicate", ["contains", "intersects"])
@pytest.mark.parametrize("rasters", ["off", "on"])
@pytest.mark.parametrize("adaptive", ["off", "on"])
def test_indexed_join_equals_the_host_join_and_brute_force(kind, predicate, rasters, adaptive):
    def case(P):
        P.conf.RASTER_ENABLED.set(rasters == "on")
        P.conf.JOIN_ADAPTIVE.set(adaptive == "on")
        if adaptive == "on":
            P.conf.JOIN_BROAD_FRACTION.set(0.05)
        ds, x, y = _point_store(P, 8000, 5)
        polys, left = _left(P, kind)
        reg = P.metrics.MetricsRegistry()
        got = _pairs(P.sql.spatial_join_indexed(ds, "jp", left, predicate, metrics=reg))
        host = _pairs(P.sql.spatial_join(left, ds.features("jp"), predicate, strategy="exact"))
        assert got == host == _brute_pairs(P, polys, x, y, predicate)
        counters = {k: reg.counter_value(k) for k in (
            "geomesa.join.strategy.probe", "geomesa.join.strategy.host_raster")}
        return got, counters

    got, counters = alike(case)
    assert len(got) > 50
    assert counters["geomesa.join.strategy.probe"] + counters["geomesa.join.strategy.host_raster"] > 0
    if adaptive == "off":
        assert counters["geomesa.join.strategy.host_raster"] == 0


def test_indexed_join_sees_the_delta_tier():
    def case(P):
        ds, _, _ = _point_store(P, 5000, 7)
        rng = np.random.default_rng(13)
        sft = ds.get_schema("jp")
        ds.write("jp", P.pkg.FeatureCollection.from_columns(
            sft, np.arange(100000, 100200),
            {"geom": (rng.uniform(-90, 90, 200), rng.uniform(-45, 45, 200))}), check_ids=False)
        _, left = _left(P, "boxes")
        got = _pairs(P.sql.spatial_join_indexed(ds, "jp", left, "contains"))
        assert got == _pairs(P.sql.spatial_join(left, ds.features("jp"), "contains"))
        return got

    assert any(r >= 5000 for _, r in alike(case))


def test_indexed_join_refusals():
    for P in BOTH:
        ds, _, _ = _point_store(P, 100, 1)
        _, left = _left(P, "boxes", n_poly=2)
        with pytest.raises(ValueError, match="s2"):
            P.sql.spatial_join_indexed(ds, "jp", left, "contains", index="s2")
        with pytest.raises(ValueError):
            P.sql.spatial_join_indexed(ds, "jp", left, "touches")
        empty = left.take(np.zeros(0, np.int64))
        assert len(P.sql.spatial_join_indexed(ds, "jp", empty)[0]) == 0


# ------------------------------------------------------------------ sql_query

N_SQL = 4000


@pytest.fixture(scope="module")
def sql_stores():
    rng = np.random.default_rng(77)
    x, y = rng.uniform(-90, 90, N_SQL), rng.uniform(-45, 45, N_SQL)
    name = np.array(["a", "b", "c", "d"])[rng.integers(0, 4, N_SQL)]
    score = rng.uniform(0, 100, N_SQL)
    t = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64)) + rng.integers(0, 30 * 86_400_000, N_SQL)
    out = {}
    for P in BOTH:
        sft = P.pkg.FeatureType.from_spec(
            "pts", "name:String:index=true,score:Double,dtg:Date,*geom:Point:srid=4326")
        ds = P.pkg.DataStore(tile=64, **P.kw)
        ds.create_schema(sft)
        ds.write("pts", P.pkg.FeatureCollection.from_columns(
            sft, [str(i) for i in range(N_SQL)], {"name": name, "score": score, "dtg": t, "geom": (x, y)}))
        out[P.name] = ds
    return out, (x, y, name, score)


def _sql_state(fc):
    cols = {}
    for k, col in fc.columns.items():
        cols[k] = ((np.asarray(col.x).tolist(), np.asarray(col.y).tolist()) if hasattr(col, "x")
                   else np.asarray(col).tolist())
    return np.asarray(fc.ids).astype(str).tolist(), cols


SQL = [
    "SELECT * FROM pts WHERE st_intersects(geom, st_geomfromwkt('POLYGON((0 0, 40 0, 40 20, 0 20, 0 0))'))",
    "SELECT name FROM pts WHERE st_contains(st_makebbox(-50, -30, 10, 10), geom) AND name = 'a'",
    "SELECT * FROM pts WHERE score BETWEEN 20 AND 30",
    "SELECT * FROM pts WHERE name IN ('a', 'c')",
    "SELECT * FROM pts WHERE 50 < score",
    "SELECT name, score FROM pts ORDER BY score DESC LIMIT 5",
    "SELECT score FROM pts ORDER BY score DESC LIMIT 5 OFFSET 2",
    "SELECT * FROM pts WHERE st_bbox(geom, -20, -20, 20, 20) AND st_x(geom) > 5",
    "SELECT * FROM pts WHERE st_bbox(geom, -90, -45, 90, 45) AND st_x(geom) > 0 ORDER BY score LIMIT 7",
    "SELECT st_x(geom) AS lon, name FROM pts LIMIT 10",
    "SELECT * FROM pts WHERE score > 90 OR st_x(geom) > 85",
    "SELECT st_x(geom) AS lon FROM pts WHERE st_bbox(geom, -20, -20, 20, 20) ORDER BY lon DESC LIMIT 6",
    "SELECT st_x(geom) AS lon FROM pts WHERE st_bbox(geom, -20, -20, 20, 20) AND st_y(geom) > 0 "
    "ORDER BY lon LIMIT 4",
    "SELECT * FROM pts WHERE st_dwithin(geom, st_point(10, 10), 5)",
    "SELECT * FROM pts WHERE st_within(geom, st_geomfromwkt('POLYGON((-30 -30, 30 -30, 0 30, -30 -30))'))",
    "SELECT name FROM pts WHERE name LIKE 'b%' AND st_bbox(geom, 0, 0, 90, 45) ORDER BY name LIMIT 20",
    "SELECT * FROM pts WHERE NOT name = 'a' AND score < 3",
    "SELECT * FROM pts WHERE st_area(st_bufferpoint(geom, 1000)) > 0 AND score > 97",
]


@pytest.mark.parametrize("sql", SQL)
def test_sql_query_equals_the_jax_package(sql_stores, sql):
    ds, _ = sql_stores
    alike(lambda P: _sql_state(P.sql.sql_query(ds[P.name], sql)))


def test_sql_query_against_brute_force(sql_stores):
    ds, (x, y, name, score) = sql_stores
    for P in BOTH:
        run = lambda q: P.sql.sql_query(ds[P.name], q)  # noqa: E731
        assert len(run(SQL[0])) == int(((x >= 0) & (x <= 40) & (y >= 0) & (y <= 20)).sum())
        want = (x > -50) & (x < 10) & (y > -30) & (y < 10) & (name == "a")
        out = run(SQL[1])
        assert len(out) == int(want.sum()) and list(out.columns) == ["name"]
        assert len(run(SQL[2])) == int(((score >= 20) & (score <= 30)).sum())
        assert len(run(SQL[10])) == int(((score > 90) | (x > 85)).sum())
        lons = np.asarray(run(SQL[11]).columns["lon"])
        sel = (x >= -20) & (x <= 20) & (y >= -20) & (y <= 20)
        assert lons.tolist() == np.sort(x[sel])[::-1][:6].tolist()
        plan = ds[P.name].planner.plan("pts", P.query.parse_select(SQL[0], ds[P.name].get_schema("pts")).filter)
        assert plan.index is not None


@pytest.mark.parametrize("sql", ["SELECT * WHERE x = 1", "SELECT * FROM pts WHERE",
                                 "SELECT * FROM pts LIMIT 3 junk"])
def test_sql_query_refusals(sql_stores, sql):
    ds, _ = sql_stores
    for P in BOTH:
        with pytest.raises(ValueError):
            P.sql.sql_query(ds[P.name], sql)


@pytest.mark.parametrize("sql", SQL[:6])
def test_parse_select_plans_equal(sql_stores, sql):
    ds, _ = sql_stores
    alike(lambda P: repr(P.query.parse_select(sql, ds[P.name].get_schema("pts"))).replace(P.name, "pkg"))
