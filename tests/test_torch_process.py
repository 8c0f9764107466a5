"""The port's analytic processes (geomesa_tpu_torch.process) against the
JAX package's, on the CPU.

The same seeded numpy rows go into a store of each package, and every
process runs on both: kNN (``knn_search``, the batched ``knn_many`` with
its speculative 4x windows and its rounds through
``planner.submit_many``, the radius estimate from the sketches, the
antimeridian), ``proximity_search``, ``tube_select``, ``route_search``,
``unique_values``, ``join_search``, the track transforms
(``point2point``, ``track_label``, ``date_offset``), the BIN and Arrow
conversions, the thin query / sampling / min-max processes, and the
standing forms ``standing_proximity`` and ``standing_tube`` on a
LambdaStore. Feature ids must be equal in order, BIN and Arrow bytes
equal, and every search also equals an f64 brute force. Mirrors
tests/test_process.py and tests/test_transforms.py.
Tolerance: exact.
"""

from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

SPEC = "kind:String,dtg:Date,*geom:Point:srid=4326"
DAY = 86_400_000
HOUR = 3_600_000
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))


def _pkg(pkg, kw):
    name = pkg.__name__
    return SimpleNamespace(
        name=name, pkg=pkg, kw=kw,
        proc=import_module(name + ".process"),
        knn=import_module(name + ".process.knn"),
        route=import_module(name + ".process.route"),
        ecql=import_module(name + ".filter.ecql"),
        geo=import_module(name + ".geometry"),
        st=import_module(name + ".streaming"),
        metrics=import_module(name + ".metrics"),
        bin_format=import_module(name + ".utils.bin_format"),
    )


JAX = _pkg(geomesa_tpu, {})
PORT = _pkg(geomesa_tpu_torch, {"device": "cpu"})
BOTH = (JAX, PORT)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


def alike(fn):
    """Run ``fn(P)`` for both packages; the results must be equal."""
    out = [fn(P) for P in BOTH]
    assert out[1] == out[0]
    return out[1]


def ids(fc):
    return np.asarray(fc.ids).astype(str).tolist()


def _haversine(lon1, lat1, lon2, lat2):
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(v, np.float64)) for v in (lon1, lat1, lon2, lat2))
    a = (np.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2)
    return 2 * 6_371_000.0 * np.arcsin(np.minimum(1.0, np.sqrt(a)))


def _rows(n=4000, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10, 10, n)
    y = rng.uniform(-10, 10, n)
    t = T0 + rng.integers(0, 10 * DAY, n)
    kind = np.array(["a", "b", "c"])[rng.integers(0, 3, n)]
    return x, y, t, kind


def _store(P, x, y, t, kind, tile=64, name="p", spec=SPEC):
    sft = P.pkg.FeatureType.from_spec(name, spec)
    ds = P.pkg.DataStore(tile=tile, **P.kw)
    ds.create_schema(sft)
    cols = {"geom": (x, y)}
    if "dtg" in spec:
        cols["dtg"] = t
    if "kind" in spec:
        cols["kind"] = kind
    ds.write(name, P.pkg.FeatureCollection.from_columns(sft, [str(i) for i in range(len(x))], cols))
    return ds


@pytest.fixture(scope="module")
def stores():
    x, y, t, kind = _rows()
    return {P.name: _store(P, x, y, t, kind) for P in BOTH}, (x, y, t, kind)


# --------------------------------------------------------------------- kNN


@pytest.mark.parametrize("q", [
    (1.0, 2.0, 15, 5_000.0, None),
    (0.0, 0.0, 5, None, "kind = 'a'"),
    (-9.5, 9.5, 25, None, None),
    (3.3, -7.1, 1, 100.0, "kind <> 'c'"),
])
def test_knn_search_equals_the_jax_package_and_brute_force(stores, q):
    ds, (x, y, _, kind) = stores
    qx, qy, k, est, cql = q

    def case(P):
        f = P.ecql.parse(cql) if cql else P.pkg.filter.predicates.Include()
        out = P.knn.knn_search(ds[P.name], "p", qx, qy, k=k, estimated_distance_m=est, filter=f)
        return ids(out)

    got = alike(case)
    d = _haversine(qx, qy, x, y)
    if cql:
        ok = kind == "a" if "= 'a'" in cql else kind != "c"
        d[~ok] = np.inf
    want = np.argsort(d, kind="stable")[:k]
    assert got == [str(i) for i in want]


def test_knn_k_larger_than_the_data(stores):
    ds, _ = stores
    got = alike(lambda P: ids(P.knn.knn_search(ds[P.name], "p", 0.0, 0.0, k=10**6,
                                               max_distance_m=5_000_000)))
    assert len(got) == 4000


@pytest.mark.parametrize("cql,est", [(None, None), ("kind = 'b'", None), (None, 50.0)])
def test_knn_many_equals_per_point_search_and_the_jax_package(stores, cql, est):
    ds, _ = stores
    rng = np.random.default_rng(33)
    pts = [(float(rng.uniform(-9, 9)), float(rng.uniform(-9, 9))) for _ in range(8)]
    pts.append((60.0, 60.0))  # far away: forces the expansion rounds

    def case(P):
        store = ds[P.name]
        f = P.ecql.parse(cql) if cql else P.pkg.filter.predicates.Include()
        rounds = []
        submit = store.planner.submit_many

        def counting(plans, *a, **kw):
            rounds.append(len(plans))
            return submit(plans, *a, **kw)

        store.planner.submit_many = counting
        try:
            batched = P.knn.knn_many(store, "p", pts, k=6, estimated_distance_m=est,
                                     max_distance_m=2e7, filter=f)
        finally:
            del store.planner.submit_many
        single = [P.knn.knn_search(store, "p", qx, qy, k=6, estimated_distance_m=est,
                                   max_distance_m=2e7, filter=f) for qx, qy in pts]
        assert [ids(b) for b in batched] == [ids(s) for s in single]
        return [ids(b) for b in batched], rounds

    got, rounds = alike(case)
    assert all(len(b) == 6 for b in got)
    assert rounds[0] == len(pts)
    if est is not None:  # a 50 m start radius needs the 16x rounds
        assert len(rounds) >= 2


def test_knn_wraps_the_antimeridian():
    x = np.array([-179.9, -179.5, 178.0, 170.0, 0.0])
    y = np.zeros(5)

    def case(P):
        ds = _store(P, x, y, None, None, tile=64, name="s", spec="*geom:Point:srid=4326")
        one = P.knn.knn_search(ds, "s", 179.8, 0.0, k=2, estimated_distance_m=30_000)
        many = P.knn.knn_many(ds, "s", [(179.8, 0.0)], k=2, estimated_distance_m=30_000)
        assert ids(many[0]) == ids(one)
        return ids(one)

    assert alike(case) == ["0", "1"]


def test_knn_radius_estimate_from_the_sketches():
    rng = np.random.default_rng(14)
    n = 20000
    x, y = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)

    def case(P):
        ds = _store(P, x, y, None, None, tile=4096, spec="*geom:Point:srid=4326")
        r = P.knn._estimate_radius_m(ds, "p", 10, 0.0, 0.0, 1_000_000.0)
        empty = P.pkg.DataStore(**P.kw)
        empty.create_schema(P.pkg.FeatureType.from_spec("e", "*geom:Point:srid=4326"))
        fallback = P.knn._estimate_radius_m(empty, "e", 10, 0.0, 0.0, 1_000_000.0)
        return r, fallback

    r, fallback = alike(case)
    assert 1000 < r < 200_000 and fallback == 10_000.0


def test_knn_local_radius_grows_in_a_sparse_region():
    rng = np.random.default_rng(21)
    n = 30000
    x, y = rng.normal(0, 0.5, n), rng.normal(0, 0.5, n)

    def case(P):
        ds = _store(P, x, y, None, None, tile=4096, name="c", spec="*geom:Point:srid=4326")
        dense = P.knn._estimate_radius_m(ds, "c", 10, 0.0, 0.0, 5e6)
        sparse = P.knn._estimate_radius_m(ds, "c", 10, 40.0, 40.0, 5e6)
        out = P.knn.knn_search(ds, "c", 40.0, 40.0, k=5, max_distance_m=2e7)
        return dense, sparse, ids(out)

    dense, sparse, got = alike(case)
    assert sparse > 10 * dense and len(got) == 5


@pytest.mark.parametrize("m,lat", [(1000.0, 0.0), (50_000.0, 60.0), (2e6, 89.5), (10.0, -45.0)])
def test_meter_degree_conversions(m, lat):
    alike(lambda P: (P.knn._meters_to_degrees(m, lat), P.knn._degrees_to_meters(m / 1e5, lat)))


# ----------------------------------------------------- proximity and tube


@pytest.mark.parametrize("pts,dist", [
    ([(0.0, 0.0), (5.0, 5.0)], 100_000.0),
    ([(-9.9, 3.0)], 250_000.0),
    ([(1.0, 1.0), (1.1, 1.1), (-4.0, 8.0)], 30_000.0),
])
def test_proximity_search(stores, pts, dist):
    ds, (x, y, _, _) = stores
    got = alike(lambda P: ids(P.proc.proximity_search(ds[P.name], "p", pts, distance_m=dist)))
    d = np.min([_haversine(px, py, x, y) for px, py in pts], axis=0)
    assert sorted(got, key=int) == [str(i) for i in np.flatnonzero(d <= dist)]


def test_proximity_of_no_points(stores):
    ds, _ = stores
    assert alike(lambda P: len(P.proc.proximity_search(ds[P.name], "p", [], 1000))) == 0


@pytest.mark.parametrize("bin_ms", [None, 6 * HOUR, DAY])
def test_tube_select(stores, bin_ms):
    ds, (x, y, t, _) = stores
    track_xy = [(-5.0, -5.0), (0.0, 0.0), (5.0, 5.0)]
    track_t = [T0, T0 + 5 * DAY, T0 + 10 * DAY]
    got = alike(lambda P: ids(P.proc.tube_select(ds[P.name], "p", track_xy, track_t,
                                                 buffer_m=150_000, bin_ms=bin_ms)))
    px = np.interp(t, np.array(track_t), np.array([p[0] for p in track_xy]))
    py = np.interp(t, np.array(track_t), np.array([p[1] for p in track_xy]))
    assert sorted(got, key=int) == [str(i) for i in np.flatnonzero(_haversine(x, y, px, py) <= 150_000)]


@pytest.mark.parametrize("track", [([(0, 0)], [0]), ([(0, 0), (1, 1)], [5, 1])])
def test_tube_rejects_a_bad_track(stores, track):
    ds, _ = stores
    for P in BOTH:
        with pytest.raises(ValueError):
            P.proc.tube_select(ds[P.name], "p", track[0], track[1], buffer_m=100)


def test_tube_matches_continuous_interpolation():
    rng = np.random.default_rng(0)
    n = 20000
    x, y = rng.uniform(-5, 15, n), rng.uniform(-5, 15, n)
    t = T0 + rng.integers(0, HOUR, n)
    track = np.stack([np.linspace(0, 10, 20), np.linspace(0, 10, 20)], axis=1)
    times = T0 + np.linspace(0, HOUR, 20).astype(np.int64)

    def case(P):
        ds = _store(P, x, y, t, None, tile=1024, name="ev", spec="dtg:Date,*geom:Point:srid=4326")
        return ids(P.proc.tube_select(ds, "ev", track, times, buffer_m=100_000, bin_ms=60_000))

    got = alike(case)
    cx, cy = np.interp(t, times, track[:, 0]), np.interp(t, times, track[:, 1])
    exact = np.flatnonzero(_haversine(x, y, cx, cy) <= 100_000)
    assert sorted(got, key=int) == [str(i) for i in exact] and len(exact) > 50


# ------------------------------------------------------------------ route


ROUTE = np.array([[0.0, 0.0], [2.0, 0.0], [2.0, 2.0]])


@pytest.fixture(scope="module")
def route_stores():
    rng = np.random.default_rng(11)
    n = 3000
    x, y = rng.uniform(-1, 3, n), rng.uniform(-1, 3, n)
    heading = rng.uniform(0, 360, n)
    out = {}
    for P in BOTH:
        sft = P.pkg.FeatureType.from_spec("trk", "heading:Double,*geom:Point:srid=4326")
        ds = P.pkg.DataStore(tile=64, **P.kw)
        ds.create_schema(sft)
        ds.write("trk", P.pkg.FeatureCollection.from_columns(
            sft, [str(i) for i in range(n)], {"heading": heading, "geom": (x, y)}))
        out[P.name] = ds
    return out, (x, y, heading)


def _route_brute(P, x, y, heading, buffer_m, thr, bidirectional):
    d, b = P.route._point_segment_distances(x, y, ROUTE[:-1], ROUTE[1:])
    k = np.argmin(d, axis=1)
    r = np.arange(len(k))
    diff = P.route.heading_diff(b[r, k], heading)
    m = diff <= thr
    if bidirectional:
        m |= np.abs(diff - 180.0) <= thr
    return (d[r, k] <= buffer_m) & m


@pytest.mark.parametrize("case_", ["one_way", "both_ways", "wkt_and_filter", "tight"])
def test_route_search(route_stores, case_):
    ds, (x, y, heading) = route_stores
    buffer_m, thr = (5_000.0, 10.0) if case_ == "tight" else (30_000.0, 25.0)

    def case(P):
        kw = {"heading_field": "heading", "bidirectional": case_ == "both_ways"}
        route = ROUTE
        if case_ == "wkt_and_filter":
            route = "LINESTRING(0 0, 2 0, 2 2)"
            kw["filter"] = P.ecql.parse("bbox(geom, -1, -1, 1, 1)")
        out = P.proc.route_search(ds[P.name], "trk", route, buffer_m, thr, **kw)
        brute = _route_brute(P, x, y, heading, buffer_m, thr, case_ == "both_ways")
        if case_ == "wkt_and_filter":
            brute &= (x >= -1) & (x <= 1) & (y >= -1) & (y <= 1)
        return ids(out), [str(i) for i in np.flatnonzero(brute)]

    got, brute = alike(case)
    assert sorted(got, key=int) == brute and len(brute) > 0


def test_route_needs_a_heading_for_points(route_stores):
    ds, _ = route_stores
    for P in BOTH:
        with pytest.raises(ValueError, match="heading_field"):
            P.proc.route_search(ds[P.name], "trk", ROUTE, 1000, 10.0)


@pytest.mark.parametrize("a,b", [(0.0, 350.0), (90.0, 270.0), (359.0, 1.0), (45.5, 45.5)])
def test_heading_diff(a, b):
    alike(lambda P: float(P.proc.heading_diff(np.array([a]), np.array([b]))[0]))


# ----------------------------------------------------------- unique, join


@pytest.mark.parametrize("args", [
    ("kind", "INCLUDE", True), ("kind", "bbox(geom, -5, -5, 5, 5)", False),
    ("kind", "kind = 'zz'", False),
])
def test_unique_values(stores, args):
    ds, (_, _, _, kind) = stores
    attr, cql, by_count = args
    got = alike(lambda P: P.proc.unique_values(ds[P.name], "p", attr, cql, sort_by_count=by_count))
    if cql == "INCLUDE":
        vals, cnts = np.unique(kind, return_counts=True)
        assert dict(got) == dict(zip(vals.tolist(), cnts.tolist()))
        assert got[0][1] == max(cnts)


def _join_stores(P):
    rng = np.random.default_rng(9)
    ds = P.pkg.DataStore(**P.kw)
    tracks = P.pkg.FeatureType.from_spec("tracks", "vessel:String:index=true,dtg:Date,*geom:Point:srid=4326")
    info = P.pkg.FeatureType.from_spec("vessels", "vessel:String:index=true,flag:String,*geom:Point:srid=4326")
    ds.create_schema(tracks)
    ds.create_schema(info)
    n = 2000
    ds.write("tracks", P.pkg.FeatureCollection.from_columns(
        tracks, [str(i) for i in range(n)],
        {"vessel": np.array([f"v{i % 40}" for i in range(n)]),
         "dtg": T0 + rng.integers(0, DAY, n),
         "geom": (rng.uniform(-60, 60, n), rng.uniform(-45, 45, n))}))
    ds.write("vessels", P.pkg.FeatureCollection.from_columns(
        info, [f"m{i}" for i in range(60)],
        {"vessel": np.array([f"v{i}" for i in range(60)]),
         "flag": np.array([f"f{i % 5}" for i in range(60)]),
         "geom": (rng.uniform(-60, 60, 60), rng.uniform(-45, 45, 60))}))
    return ds


@pytest.mark.parametrize("case_", ["by_attribute", "secondary_filter", "value_cap",
                                   "empty_primary", "broad_selectivity"])
def test_join_search(case_):
    def case(P):
        ds = _join_stores(P)
        reg = P.metrics.MetricsRegistry()
        kw = {"metrics": reg}
        if case_ == "by_attribute":
            kw["primary_filter"] = "bbox(geom, -20, -15, 20, 15)"
        elif case_ == "secondary_filter":
            kw.update(primary_filter="bbox(geom, -60, -45, 60, 45)", secondary_filter="flag = 'f2'")
        elif case_ == "value_cap":
            kw["max_values"] = 3
        elif case_ == "empty_primary":
            kw["primary_filter"] = "vessel = 'nope'"
        out = P.proc.join_search(ds, "tracks", "vessels", "vessel", **kw)
        counters = {k: v for k, v in reg.snapshot()["counters"].items() if k.startswith("geomesa.join")}
        return ids(out), out.sft.name, sorted(set(np.asarray(out.columns["flag"]).tolist())), counters

    got, name, flags, _ = alike(case)
    assert name == "vessels"
    if case_ == "empty_primary":
        assert got == []
    else:
        assert len(got) > 0
    if case_ == "secondary_filter":
        assert flags == ["f2"]


def test_join_rejects_an_unknown_attribute():
    for P in BOTH:
        with pytest.raises(ValueError):
            P.proc.join_search(_join_stores(P), "tracks", "vessels", "missing")


# ------------------------------------------------------------- transforms


def _tracks(P):
    sft = P.pkg.FeatureType.from_spec("trk2", "track:String,dtg:Date,*geom:Point:srid=4326")
    t0 = int(np.datetime64("2024-03-01T00:00:00", "ms").astype(np.int64))
    rows = [("a", t0 + 22 * HOUR, 0.0, 0.0), ("a", t0 + 23 * HOUR, 1.0, 0.0),
            ("a", t0 + 25 * HOUR, 2.0, 0.0), ("b", t0 + 1 * HOUR, 5.0, 5.0),
            ("b", t0 + 2 * HOUR, 5.0, 5.0), ("c", t0 + 3 * HOUR, 9.0, 9.0)]
    return P.pkg.FeatureCollection.from_columns(sft, [str(i) for i in range(len(rows))], {
        "track": np.array([r[0] for r in rows]),
        "dtg": np.array([r[1] for r in rows], dtype=np.int64),
        "geom": (np.array([r[2] for r in rows]), np.array([r[3] for r in rows])),
    })


def _fc_state(fc):
    cols = {}
    for name, col in fc.columns.items():
        if hasattr(col, "geometries"):
            cols[name] = [g.wkt for g in col.geometries()]
        elif hasattr(col, "x"):
            cols[name] = (np.asarray(col.x).tolist(), np.asarray(col.y).tolist())
        else:
            cols[name] = np.asarray(col).tolist()
    return ids(fc), cols


@pytest.mark.parametrize("kw", [
    {"min_points": 1}, {"min_points": 1, "break_on_day": True},
    {"min_points": 1, "filter_singular": False}, {"min_points": 3},
])
def test_point2point(kw):
    got, cols = alike(lambda P: _fc_state(P.proc.point2point(_tracks(P), "track", "dtg", **kw)))
    if kw == {"min_points": 1}:
        assert got == ["a-0", "a-1"] and cols["track"] == ["a", "a"]


@pytest.mark.parametrize("dtg", ["dtg", None])
def test_track_label(dtg):
    got, _ = alike(lambda P: _fc_state(P.proc.track_label(_tracks(P), "track", dtg)))
    assert len(got) == 3


def test_date_offset():
    def case(P):
        fc = _tracks(P)
        out = P.proc.date_offset(fc, "dtg", 60_000)
        assert out.columns["dtg"] is not fc.columns["dtg"]
        return _fc_state(out)

    alike(case)


@pytest.mark.parametrize("kw", [{}, {"label_field": "track"}, {"sort": True}])
def test_bin_conversion_bytes(kw):
    data = alike(lambda P: P.proc.bin_conversion(_tracks(P), "track", "dtg", **kw))
    dec = PORT.bin_format.decode(data, label="label_field" in kw)
    assert len(dec["lat"]) == 6


@pytest.mark.parametrize("dictionary", [True, False])
def test_arrow_conversion_bytes(dictionary):
    pytest.importorskip("pyarrow")
    alike(lambda P: P.proc.arrow_conversion(_tracks(P), dictionary=dictionary))


def test_query_sampling_and_minmax(stores):
    ds, (x, y, t, _) = stores

    def case(P):
        store = ds[P.name]
        q = ids(P.proc.query_process(store, "p", "bbox(geom, -5, -5, 5, 5)"))
        s = ids(P.proc.sampling_process(store.features("p"), 0.25))
        s2 = ids(P.proc.sampling_process(store.features("p"), 0.1, "kind"))
        mm = [int(v) for v in P.proc.minmax_process(store, "p", "dtg")]
        mm2 = [int(v) for v in P.proc.minmax_process(store, "p", "dtg", "bbox(geom, -5, -5, 5, 5)")]
        return q, s, s2, mm, mm2

    q, s, _, mm, mm2 = alike(case)
    want = np.flatnonzero((x >= -5) & (x <= 5) & (y >= -5) & (y <= 5))
    assert sorted(q, key=int) == [str(i) for i in want]
    assert 0 < len(s) < 4000
    assert mm == [int(t.min()), int(t.max())] and mm2[0] == int(t[want].min())


# ------------------------------------------------------------ standing forms


@pytest.mark.parametrize("kind_", ["proximity", "tube"])
def test_standing_forms_alert_like_the_jax_package(kind_):
    rng = np.random.default_rng(5)
    n = 400
    x, y = rng.uniform(-3, 3, n), rng.uniform(-3, 3, n)
    t = T0 + rng.integers(0, 4 * HOUR, n)

    def case(P):
        ds = P.pkg.DataStore(**P.kw)
        ds.metrics = P.metrics.MetricsRegistry()
        ds.create_schema(P.pkg.FeatureType.from_spec("t", "name:String,dtg:Date,*geom:Point:srid=4326"))
        lam = P.st.LambdaStore(ds, "t")
        try:
            if kind_ == "proximity":
                sub = P.proc.standing_proximity(lam, "near", [(0.0, 0.0), (2.0, -2.0)], 80_000,
                                                attrs={"team": "x"})
            else:
                sub = P.proc.standing_tube(lam, "tube", [(-3.0, -3.0), (3.0, 3.0)],
                                           [T0, T0 + 4 * HOUR], 60_000)
            rows = [{"name": f"n{i}", "dtg": np.datetime64(int(t[i]), "ms"),
                     "geom": P.geo.Point(float(x[i]), float(y[i]))} for i in range(n)]
            for s in range(0, n, 100):
                lam.write(rows[s:s + 100], ids=[f"e{i}" for i in range(s, min(s + 100, n))])
            alerts = lam.standing().alerts.drain()
            return sub.sub_id, sub.kind, sorted((a["sub"], a["id"]) for a in alerts)
        finally:
            lam.close()

    _, _, alerts = alike(case)
    if kind_ == "proximity":
        d = np.minimum(_haversine(0.0, 0.0, x, y), _haversine(2.0, -2.0, x, y))
        want = np.flatnonzero(d <= 80_000)
    else:
        cx = np.interp(t, [T0, T0 + 4 * HOUR], [-3.0, 3.0])
        want = np.flatnonzero(_haversine(x, y, cx, cx) <= 60_000)
    assert sorted(a[1] for a in alerts) == sorted(f"e{i}" for i in want) and len(want) > 0


@pytest.mark.parametrize("bad", [([(0, 0)], [0]), ([(0, 0), (1, 1)], [5, 1])])
def test_standing_tube_rejects_a_bad_track(bad):
    for P in BOTH:
        with pytest.raises(ValueError):
            P.proc.standing_tube(None, "x", bad[0], bad[1], 100.0)
