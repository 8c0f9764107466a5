"""The port's standing queries (streaming/standing.py) against the JAX
package's, on the CPU (the cases of tests/test_standing.py, which skips
here for want of shapely, through both packages).

- the inverted index: FULL-cell routing, bulk against per-subscription
  registration, replace / unregister and the dead-slot payloads, the
  wide-cover bulk path, kind validation; routed pair arrays equal the
  JAX package's;
- the matcher: fused against host bit-identical on the port, with K2's
  plain version on the CPU (``block_scan_multi_plain`` through the
  matcher's ``[n_blocks, 32, 128]`` columns with ``+inf`` pad rows and
  128-slot chunks), the planes of each fused E bucket equal the JAX
  package's word for word, every fuzz polygon's match set equals the
  JAX package's, proximity and tube semantics, the rectangle fast path,
  the measured gate (seeded EWMAs, the bounded probe, gate off);
- windows: incremental panes compose bit-identically to a recompute and
  to the JAX package's partials, rows without a time skipped, pane
  retention, the FeatureStream sink;
- delivery: the bounded alert queue (columnar blocks and lists), matcher
  faults never un-acknowledge a write, the latency histogram and its SLO
  objective, the flusher's arrival hook; alert dicts equal the JAX
  package's;
- durability: subscriptions survive a crash, checkpoint retirement and
  recovery, in both directions across packages; an unregistrable record
  never poisons the log; batched replay equals record-at-a-time;
- a kill-anywhere chaos case under both packages' fault points, and the
  scheduler case of tests/test_standing.py:1085 with deterministic
  assertions only (the matcher matched, queries answered, every thread
  closed).

Tolerance: exact.
"""

import json
import os
import threading
import time
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))


def _pkg(pkg, kw):
    name = pkg.__name__
    return SimpleNamespace(
        name=name, pkg=pkg, kw=kw,
        conf=import_module(name + ".conf"),
        fault=import_module(name + ".fault"),
        geo=import_module(name + ".geometry"),
        metrics=import_module(name + ".metrics"),
        persist=import_module(name + ".storage.persist"),
        st=import_module(name + ".streaming"),
        sq=import_module(name + ".streaming.standing"),
        bk=import_module(name + ".scan.block_kernels"),
        slo=import_module(name + ".obs.slo"),
    )


JAX = _pkg(geomesa_tpu, {})
PORT = _pkg(geomesa_tpu_torch, {"device": "cpu"})
BOTH = (JAX, PORT)
KNOBS = ("STANDING_FUSED_MIN_POINTS", "STANDING_GRID_LEVEL", "STREAM_WAL_REPLAY_BATCH",
         "STANDING_QUEUE_MAX")


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("GEOMESA_TPU_IO_BACKOFF_S", "0.0001")
    yield
    for P in BOTH:
        for k in KNOBS:
            getattr(P.conf, k).clear()
        P.fault.injector().reset()


def sft(P):
    return P.pkg.FeatureType.from_spec("t", SPEC)


def jagged_star(P, cx, cy, r, n_arms, seed=0):
    rng = np.random.default_rng(seed)
    a = np.linspace(0, 2 * np.pi, 2 * n_arms + 1)[:-1]
    rad = np.where(np.arange(2 * n_arms) % 2 == 0, r, r * rng.uniform(0.3, 0.7, 2 * n_arms))
    return P.geo.Polygon([(cx + rr * np.cos(t), cy + rr * np.sin(t)) for t, rr in zip(a, rad)])


def donut(P, cx, cy, r_out, r_in, n=24):
    a = np.linspace(0, 2 * np.pi, n + 1)
    shell = [(cx + r_out * np.cos(t), cy + r_out * np.sin(t)) for t in a]
    hole = [(cx + r_in * np.cos(t), cy + r_in * np.sin(t)) for t in a]
    return P.geo.Polygon(shell, [hole])


def square(P, x0, y0, w=1.0):
    return P.geo.Polygon([(x0, y0), (x0 + w, y0), (x0 + w, y0 + w), (x0, y0 + w), (x0, y0)])


def engine(P, **cfg):
    return P.sq.StandingQueryEngine(sft(P), P.sq.StandingConfig(**cfg),
                                    metrics=P.metrics.MetricsRegistry(), **P.kw)


def match_set(eng, x, y, t=None):
    pt, ords = eng.match_points(x, y, t_ms=t)
    ids = eng.index._ids
    return sorted((int(p), ids[int(o)]) for p, o in zip(pt, ords))


def routed(idx, x, y):
    pt, ords, full = idx.route(x, y)
    return sorted(zip(pt.tolist(), [idx._ids[o] for o in ords.tolist()], full.tolist()))


def point_row(P, x, y, t=T0, name="n"):
    return {"name": name, "dtg": np.datetime64(t, "ms"), "geom": P.geo.Point(float(x), float(y))}


def alike(fn):
    """Run ``fn(P)`` for both packages; the results must be equal."""
    out = [fn(P) for P in BOTH]
    assert out[1] == out[0]
    return out[1]


# -- the inverted index -------------------------------------------------------


def test_full_cells_match_with_zero_geometry_work():
    def case(P):
        idx = P.sq.SubscriptionIndex(P.sq.StandingConfig(grid_level=8))
        idx.register(P.sq.Subscription("big", "geofence", geom=P.geo.Polygon(
            [(-10, -10), (10, -10), (10, 10), (-10, 10), (-10, -10)])))
        pt, ords, full = idx.route(np.array([0.0, 9.99, 50.0]), np.array([0.0, 9.99, 50.0]))
        got = dict(zip(pt.tolist(), full.tolist()))
        assert got[0] is True and got[1] is False and 2 not in got
        return pt.tolist(), ords.tolist(), full.tolist()

    alike(case)


def test_bulk_registration_equals_per_sub():
    def case(P):
        rng = np.random.default_rng(3)
        geoms = [jagged_star(P, float(rng.uniform(-40, 40)), float(rng.uniform(-30, 30)),
                             float(rng.uniform(0.2, 2.0)), int(rng.integers(4, 20)), seed=i)
                 for i in range(40)]
        ids = [f"g{i}" for i in range(40)]
        a = P.sq.SubscriptionIndex(P.sq.StandingConfig())
        a.register_geofences(ids, geoms)
        b = P.sq.SubscriptionIndex(P.sq.StandingConfig())
        for i, g in zip(ids, geoms):
            b.register(P.sq.Subscription(i, "geofence", geom=g))
        x = rng.uniform(-45, 45, 4000)
        y = rng.uniform(-35, 35, 4000)
        assert routed(a, x, y) == routed(b, x, y)
        return routed(a, x, y), [np.asarray(v).tolist() for v in a._csr]

    alike(case)


def _population(P, kind, n=3000, seed=0):
    """(ids, geoms) of one registration population: tiny squares at every
    scale the routing grid sees (windows of 1-3 cells a side), with
    rectangles, rotated quads, unclosed rings, stars, holes and
    MultiPolygons mixed in, or re-registering ids in and across chunks."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(-179, 179, n), rng.uniform(-89, 89, n)
    w = rng.uniform(0.001, 0.2, n)
    geoms = []
    for i in range(n):
        sel = i % 9 if kind != "tiny" else 0
        if sel in (0, 1, 2, 3):
            geoms.append(square(P, cx[i], cy[i], float(w[i])))
        elif sel == 4:  # a rotated quad
            geoms.append(P.geo.Polygon([(cx[i], cy[i] - w[i]), (cx[i] + w[i], cy[i]),
                                        (cx[i], cy[i] + w[i]), (cx[i] - w[i], cy[i])]))
        elif sel == 5:  # an unclosed ring the constructor closes, a degenerate edge
            geoms.append(P.geo.Polygon([(cx[i], cy[i]), (cx[i] + w[i], cy[i]),
                                        (cx[i] + w[i], cy[i]), (cx[i], cy[i] + w[i])]))
        elif sel == 6:
            geoms.append(jagged_star(P, cx[i], cy[i], float(w[i]) * 5, 4 + i % 20, seed=i))
        elif sel == 7:
            geoms.append(donut(P, cx[i], cy[i], float(w[i]) * 4, float(w[i]), n=5 + i % 8))
        else:
            geoms.append(P.geo.MultiPolygon([square(P, cx[i], cy[i], float(w[i])),
                                             square(P, cx[i] + 1, cy[i], float(w[i]))]))
    ids = [f"g{i}" for i in range(n)]
    if kind == "replace":
        ids = [f"g{i % 2500}" if i % 7 else f"g{(i * 13) % 900}" for i in range(n)]
    return ids, geoms


@pytest.mark.parametrize("kind", ["tiny", "mixed", "replace"])
def test_bulk_registry_state_equals_the_jax_package(kind):
    """The port covers a bulk chunk's plain quadrilaterals in array passes:
    the registry it leaves (ids, ordinals, liveness, edge segments, bbox
    blocks, rect flags, rasters, the CSR after compaction) equals the JAX
    package's, element for element; and a registration with an invalid
    body raises in both before the chunk registers."""
    def case(P):
        ids, geoms = _population(P, kind, n=10_000 if kind == "tiny" else 3000)
        idx = P.sq.SubscriptionIndex(P.sq.StandingConfig(grid_level=11, raster_cells=4096))
        idx.register_geofences(ids[:1000], geoms[:1000])
        idx.register_geofences(ids[1000:], geoms[1000:])
        kinds, eoff, segs, bbox, rect = idx._ensure_arrays()
        bad = [P.geo.Point(0.0, 0.0)]
        with pytest.raises(ValueError, match="needs a"):
            idx.register_geofences(["bad"], bad)
        assert "bad" not in idx._by_id
        return (idx._ids, idx._alive, sorted(idx._by_id.items()), kinds.tolist(),
                eoff.tolist(), segs.tolist(), bbox.tolist(), rect.tolist(),
                sorted(idx._rast), [np.asarray(v).tolist() for v in idx._csr])

    alike(case)


def test_replace_and_unregister():
    def case(P):
        idx = P.sq.SubscriptionIndex(P.sq.StandingConfig())
        idx.register(P.sq.Subscription("a", "geofence", geom=square(P, 0, 0)))
        idx.register(P.sq.Subscription("a", "geofence", geom=square(P, 50, 50)))
        assert len(idx) == 1
        pt, _, _ = idx.route(np.array([0.5, 50.5]), np.array([0.5, 50.5]))
        assert pt.tolist() == [1]
        assert idx.unregister("a") is True and idx.unregister("a") is False
        pt2, _, _ = idx.route(np.array([50.5]), np.array([50.5]))
        assert len(pt2) == 0
        idx2 = P.sq.SubscriptionIndex(P.sq.StandingConfig())
        idx2.register(P.sq.Subscription("b", "geofence", geom=square(P, 0, 0)))
        assert idx2.unregister("b") is True
        pt3, _, _ = idx2.route(np.array([0.5]), np.array([0.5]))
        assert len(pt3) == 0
        return idx._ids, idx._alive

    alike(case)


def test_bulk_then_mutate_keeps_match_arrays_homogeneous():
    def case(P):
        idx = P.sq.SubscriptionIndex(P.sq.StandingConfig())
        geoms = [square(P, 2.0 * i, 0) for i in range(5)]
        idx.register_geofences([f"b{i}" for i in range(5)], geoms)
        assert idx.unregister("b0") is True
        idx.register(P.sq.Subscription("x", "geofence", geom=geoms[0]))
        _, _, _, bbox, rect = idx._ensure_arrays()
        assert bbox.shape == (len(idx._ids), 4)
        assert rect[[idx._by_id[s] for s in idx.subscription_ids()]].all()
        eng = engine(P)
        eng.index = idx
        eng.matcher.index = idx
        pt, ords = eng.match_points(np.array([0.5, 2.5]), np.array([0.5, 0.5]))
        got = sorted((int(p), idx._ids[int(o)]) for p, o in zip(pt, ords))
        assert got == [(0, "x"), (1, "b1")]
        return got, bbox.tolist(), rect.tolist()

    alike(case)


def test_wide_proximity_cover_routes_exactly():
    def case(P):
        eng = engine(P)
        eng.register(P.sq.Subscription("wide", "proximity", points=[(10.0, 10.0)],
                                       distance_m=600_000.0))
        with eng.index._lock:
            assert eng.index._bulk, "wide cover did not take the bulk path"
        got = match_set(eng, np.array([10.2, 10.0, 40.0]), np.array([10.2, 14.0, 40.0]))
        assert got == [(0, "wide"), (1, "wide")]
        return got, routed(eng.index, np.array([10.2, 10.0]), np.array([10.2, 14.0]))

    alike(case)


def test_empty_bulk_registration_keeps_the_gauge():
    def case(P):
        reg = P.metrics.MetricsRegistry()
        idx = P.sq.SubscriptionIndex(P.sq.StandingConfig(), metrics=reg)
        idx.register(P.sq.Subscription("a", "geofence", geom=square(P, 0, 0)))
        assert idx.register_geofences([], []) == 1
        return reg.gauges["geomesa.standing.subscriptions"]

    assert alike(case) == 1


def test_replace_frees_dead_ordinal_payloads():
    def case(P):
        idx = P.sq.SubscriptionIndex(P.sq.StandingConfig())
        for step in range(50):
            idx.register(P.sq.Subscription("mover", "geofence", geom=square(P, step * 0.1, 0)))
        assert len(idx) == 1
        assert sum(e is not None for e in idx._edges_l) == 1
        _, eoff, segs, _, _ = idx._ensure_arrays()
        assert eoff[-1] == 4
        pt, ords, _ = idx.route(np.array([0.2, 5.4]), np.array([0.5, 0.5]))
        assert pt.tolist() == [1]
        return segs.tolist(), ords.tolist()

    alike(case)


def test_unsubscribe_racing_match_skips_only_that_subscription():
    def case(P):
        eng = engine(P)
        eng.register(P.sq.Subscription("p1", "proximity", points=[(0.0, 0.0)], distance_m=50_000))
        eng.register(P.sq.Subscription("p2", "proximity", points=[(0.5, 0.0)], distance_m=50_000))
        eng.register(P.sq.Subscription("tb", "tube", track_xy=[(0.0, 0.0), (1.0, 0.0)],
                                       track_times_ms=[0, 1000], buffer_m=50_000))
        x = np.array([0.1, 0.45])
        y = np.zeros(2)
        t = np.array([500, 500], np.int64)
        pt, ords, full = eng.index.route(x, y)
        assert len(pt) >= 4
        with eng.index._lock:
            eng.index._prox.pop(eng.index._by_id["p1"])
            eng.index._tube.pop(eng.index._by_id["tb"])
        out_pt, out_ord = eng._match_pairs(x, y, t, pt, ords, full)
        got = sorted((int(p), eng.index._ids[int(o)]) for p, o in zip(out_pt, out_ord))
        assert got == [(0, "p2"), (1, "p2")]
        return got

    alike(case)


@pytest.mark.parametrize("P", BOTH, ids=["jax", "port"])
def test_kind_validation(P):
    idx = P.sq.SubscriptionIndex(P.sq.StandingConfig())
    with pytest.raises(ValueError, match="unknown subscription kind"):
        P.sq.Subscription("x", "nope")
    with pytest.raises(ValueError, match="needs a"):
        idx._cover(P.sq.Subscription("x", "geofence"))
    with pytest.raises(ValueError, match="needs points"):
        idx._cover(P.sq.Subscription("x", "proximity", points=[], distance_m=10))
    with pytest.raises(ValueError, match=">= 2 track points"):
        idx._cover(P.sq.Subscription("x", "tube", track_xy=[(0, 0)], track_times_ms=[0],
                                     buffer_m=10))


def test_subscription_records_round_trip_across_packages():
    """``to_record`` bodies are equal, and each package's body decodes in
    the other through the WAL value codec (geometry as WKB)."""
    def subs(P):
        return [
            P.sq.Subscription("g", "geofence", geom=donut(P, 1.0, 2.0, 3.0, 1.0), attrs={"k": 1}),
            P.sq.Subscription("p", "proximity", points=[(1.0, 2.0), (3.0, 4.0)], distance_m=9.5),
            P.sq.Subscription("t", "tube", track_xy=[(0, 0), (1, 1)], track_times_ms=[0, 10],
                              buffer_m=3.0),
        ]

    def enc(P, sub):
        return json.dumps(sub.to_record(), default=P.st.wal._enc_json, sort_keys=True)

    for P, Q in ((JAX, PORT), (PORT, JAX)):
        for a, b in zip(subs(P), subs(Q)):
            body = enc(P, a)
            assert body == enc(Q, b)
            back = Q.sq.Subscription.from_record(json.loads(body))
            assert enc(Q, back) == body


# -- the matcher ----------------------------------------------------------------


def fuzz_polygons(P):
    return [
        ("concave_star", jagged_star(P, 10.0, 20.0, 3.0, 12, seed=1)),
        ("mid_star_128e", jagged_star(P, 12.0, 21.0, 2.5, 60, seed=2)),
        ("big_star_256e", jagged_star(P, 9.0, 18.5, 4.0, 127, seed=3)),
        ("past_ladder_300e", jagged_star(P, 11.0, 19.0, 3.5, 150, seed=4)),
        ("donut_hole", donut(P, 10.5, 20.5, 3.0, 1.5)),
        ("thin_sliver", P.geo.Polygon([(8.0, 20.0), (12.0, 20.0001), (12.0, 20.0002),
                                       (8.0, 20.0001), (8.0, 20.0)])),
    ]


FUZZ_NAMES = [n for n, _ in fuzz_polygons(JAX)]


def test_fused_vs_host_bit_identical():
    """Mixed E-ladder candidate blocks in one engine: the fused path (K2's
    plain version on the port's CPU engine) returns the all-host match
    set, in each package, and the two packages agree."""
    rng = np.random.default_rng(5)
    x = rng.uniform(5.0, 16.0, 6000)
    y = rng.uniform(14.0, 26.0, 6000)

    def case(P):
        results = {}
        for label, min_pts in (("fused", 1), ("host", 0)):
            eng = engine(P, fused_min_points=min_pts, fused_gate=False)
            for name, poly in fuzz_polygons(P):
                eng.register(P.sq.Subscription(name, "geofence", geom=poly))
            results[label] = match_set(eng, x, y)
            fused = eng.metrics.counter_value("geomesa.standing.fused")
            assert (fused > 0) == (min_pts > 0)
        assert results["fused"] == results["host"]
        return results["fused"]

    assert alike(case)


@pytest.mark.parametrize("name", FUZZ_NAMES)
def test_fuzz_polygon_matches_equal_the_jax_package(name):
    """Per polygon, a boundary-concentrated cloud plus every vertex and edge
    midpoint: the fused match set equals the JAX package's, and the
    all-host one."""
    def case(P):
        poly = dict(fuzz_polygons(P))[name]
        rng = np.random.default_rng(11)
        x0, y0, x1, y1 = poly.bounds()
        pad = max(x1 - x0, y1 - y0) * 0.2 + 1e-3
        shell = np.asarray(poly.shell, np.float64)
        mids = (shell[:-1] + shell[1:]) / 2.0
        x = np.concatenate([rng.uniform(x0 - pad, x1 + pad, 3000), shell[:, 0], mids[:, 0]])
        y = np.concatenate([rng.uniform(y0 - pad, y1 + pad, 3000), shell[:, 1], mids[:, 1]])
        out = []
        for min_pts in (1, 0):
            eng = engine(P, fused_min_points=min_pts, fused_gate=False)
            eng.register(P.sq.Subscription("p", "geofence", geom=poly))
            out.append(match_set(eng, x, y))
        assert out[0] == out[1]
        return out[0]

    assert alike(case)


def _matcher_chunk(P, e_bucket, n_rows=20_000, n_members=128):
    """A full 128-slot chunk of ``e_bucket``-edge stars over one batch of
    ``n_rows`` points (5 matcher blocks at 20,000 rows: the last one part
    pad)."""
    rng = np.random.default_rng(e_bucket)
    arms = {16: 6, 64: 24, 256: 100}[e_bucket]
    # no match-time rasters: the fused path never reads them, and building
    # 128 of them dominates the test
    eng = engine(P, fused_min_points=1, fused_gate=False, raster_cells=0)
    for i in range(n_members):
        eng.register(P.sq.Subscription(f"s{i}", "geofence", geom=jagged_star(
            P, float(rng.uniform(-1, 1)), float(rng.uniform(-1, 1)),
            float(rng.uniform(0.5, 1.5)), arms, seed=i)))
    x = rng.uniform(-2, 2, n_rows)
    y = rng.uniform(-2, 2, n_rows)
    return eng, x, y


@pytest.mark.parametrize("e_bucket", [16, 64, 256])
def test_matcher_shape_planes_equal_the_jax_package(e_bucket):
    """K2 at the matcher's shape: SUB 32 (one word group a stripe), a full
    128-slot chunk, ``+inf`` pad rows, pad slots with ``spip`` 0. The
    port's plain planes equal the JAX package's word for word, and the
    decoded (rows, certain) of every member are equal."""
    planes, decoded = [], []
    for P in BOTH:
        eng, x, y = _matcher_chunk(P, e_bucket, n_rows=3000)
        cols = P.sq._BatchColumns(x, y, **P.kw)
        ords = list(range(128))
        members = [(o, eng.index.kernel_block(o)) for o in ords]
        assert {P.bk.fused_e_bucket(b.shape[0]) for _, b in members} == {e_bucket}
        nb = cols.n_blocks
        edges = np.zeros((128, e_bucket, 128), np.float32)
        for q, (_, blk) in enumerate(members):
            edges[q, : blk.shape[0]] = blk
        boxes = np.zeros((128, 8, 128), np.float32)
        wins = np.zeros((128, 8, 128), np.int32)
        bids = np.zeros(P.bk.bucket_of(128 * nb), np.int32)
        qids = np.zeros(len(bids), np.int32)
        spip = np.zeros(len(bids), np.int32)
        bids[: 128 * nb] = np.tile(np.arange(nb, dtype=np.int32), 128)
        qids[: 128 * nb] = np.repeat(np.arange(128, dtype=np.int32), nb)
        spip[: 128 * nb] = 1
        w, i = P.bk.block_scan_multi(
            cols.cols3(), bids, qids, boxes, wins, col_names=("x", "y"), has_boxes=False,
            has_windows=False, extent=False, edges=edges, spip=spip, n_edges=e_bucket)
        w = w.numpy() if P is PORT else np.asarray(w)
        i = i.numpy() if P is PORT else np.asarray(i)
        assert w.shape == (len(bids), 1, 128)
        planes.append((w, i))
        out, host = eng.matcher.match(cols, ords)
        assert host == []
        decoded.append({o: (r.tolist(), c.tolist()) for o, (r, c) in out.items()})
    np.testing.assert_array_equal(planes[1][0], planes[0][0])
    np.testing.assert_array_equal(planes[1][1], planes[0][1])
    assert decoded[1] == decoded[0]


def test_batch_columns_on_the_device_and_pads():
    """The port's batch columns: torch f32 [n_blocks, 32, 128] on the
    engine's device, one tensor underneath, +inf pad rows."""
    x = np.arange(5000, dtype=np.float64)
    cols = PORT.sq._BatchColumns(x, -x, "cpu")
    cx, cy = cols.cols3()
    assert cx.shape == (2, 32, 128) and cx.dtype == torch.float32 and cx.is_contiguous()
    assert cx.untyped_storage().data_ptr() == cy.untyped_storage().data_ptr()
    assert torch.isinf(cx.reshape(-1)[5000:]).all() and torch.isinf(cy.reshape(-1)[5000:]).all()
    ref = JAX.sq._BatchColumns(x, -x).cols3()
    np.testing.assert_array_equal(cx.numpy(), ref[0])
    np.testing.assert_array_equal(cy.numpy(), ref[1])


def test_engine_device_is_checked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.sq.StandingQueryEngine(sft(PORT), PORT.sq.StandingConfig())
    eng = engine(PORT)
    assert eng.device == torch.device("cpu") and eng.matcher.device == eng.device


def test_proximity_and_tube_semantics():
    def case(P):
        eng = engine(P)
        eng.register(P.sq.Subscription("near", "proximity", points=[(0.0, 0.0), (1.0, 1.0)],
                                       distance_m=30_000))
        eng.register(P.sq.Subscription("tube", "tube", track_xy=np.array([(20.0, 20.0), (21.0, 20.0)]),
                                       track_times_ms=[T0, T0 + 3_600_000], buffer_m=25_000))
        x = np.array([0.1, 0.9, 3.0, 20.5, 20.5, 20.5])
        y = np.array([0.1, 1.1, 3.0, 20.0, 20.0, 23.0])
        t = np.array([T0, T0, T0, T0 + 1_800_000, T0 - 10, T0 + 1_800_000])
        got = match_set(eng, x, y, t)
        assert (0, "near") in got and (1, "near") in got and (3, "tube") in got
        assert all(p not in (2, 4, 5) for p, _ in got)
        return got

    alike(case)
    from geomesa_tpu.process.knn import EARTH_RADIUS_M as j_r, haversine_m as j_h
    from geomesa_tpu_torch.process.knn import EARTH_RADIUS_M as t_r, haversine_m as t_h

    args = (np.array([0.1, 3.0]), np.array([0.1, -7.0]), np.array([0.0, 120.0]),
            np.array([0.0, 45.0]))
    assert j_r == t_r
    np.testing.assert_array_equal(t_h(*args), j_h(*args))


def test_rect_fast_path_bit_identical_to_ray_cast():
    def case(P):
        rect = P.geo.Polygon([(2.0, 3.0), (6.0, 3.0), (6.0, 9.0), (2.0, 9.0), (2.0, 3.0)])
        octo = P.geo.Polygon([(2.0, 3.0), (4.0, 3.0), (6.0, 3.0), (6.0, 6.0), (6.0, 9.0),
                              (4.0, 9.0), (2.0, 9.0), (2.0, 6.0), (2.0, 3.0)])
        ea, eb = engine(P), engine(P)
        ea.register(P.sq.Subscription("r", "geofence", geom=rect))
        eb.register(P.sq.Subscription("r", "geofence", geom=octo))
        assert ea.index._ensure_arrays()[4][0] and not eb.index._ensure_arrays()[4][0]
        rng = np.random.default_rng(7)
        x = np.concatenate([rng.uniform(1.0, 7.0, 2000), [2.0, 6.0, 4.0, 4.0, 2.0, 6.0, 2.0, 6.0]])
        y = np.concatenate([rng.uniform(2.0, 10.0, 2000), [5.0, 5.0, 3.0, 9.0, 3.0, 3.0, 9.0, 9.0]])
        got_a, got_b = match_set(ea, x, y), match_set(eb, x, y)
        assert got_a == got_b
        assert (2000, "r") in got_a and (2001, "r") not in got_a
        assert (2002, "r") in got_a and (2003, "r") not in got_a
        return got_a

    alike(case)


def test_is_axis_rect_rejects_non_rectangles():
    def case(P):
        segs = P.sq._sub_segments
        tri = P.geo.Polygon([(0, 0), (4, 0), (2, 3), (0, 0)])
        box = P.geo.Polygon([(0, 0), (4, 0), (4, 2), (0, 2), (0, 0)])
        rot = P.geo.Polygon([(0, 0), (2, 2), (4, 0), (2, -2), (0, 0)])
        out = [P.sq._is_axis_rect(segs(g), g.bounds()) for g in (tri, box, rot)]
        out.append(P.sq._is_axis_rect(None, (0, 0, 1, 1)))
        assert out == [False, True, False, False]
        return out, segs(tri).tolist()

    alike(case)


def test_gate_keeps_slow_fused_on_host_and_counts():
    def case(P):
        out = []
        rng = np.random.default_rng(9)
        x = rng.uniform(8.0, 12.0, 4000)
        y = rng.uniform(8.0, 12.0, 4000)
        for fused_s, expect_fused in ((1e-3, 0), (1e-12, 1)):
            eng = engine(P, fused_min_points=1)
            eng.register(P.sq.Subscription("s", "geofence",
                                           geom=jagged_star(P, 10.0, 10.0, 2.0, 24, seed=3)))
            eng.gate.update("host_s", 4e-9, 1)
            eng.gate.update("fused_s", fused_s, 1)
            got = match_set(eng, x, y)
            fused = eng.metrics.counter_value("geomesa.standing.fused")
            kept = eng.metrics.counter_value("geomesa.standing.gate.host")
            assert (fused >= 1 and kept == 0) if expect_fused else (fused == 0 and kept >= 1)
            out.append((got, fused, kept))
        assert out[0][0] == out[1][0]
        return out

    alike(case)


def test_gate_probe_is_bounded_and_seeds_measurement():
    def case(P):
        eng = engine(P, fused_min_points=1)
        for i in range(24):
            eng.register(P.sq.Subscription(f"s{i}", "geofence",
                                           geom=jagged_star(P, 10.0, 10.0, 2.0, 8, seed=i)))
        assert eng.gate.fused_s is None
        got = match_set(eng, np.full(16, 10.0), np.full(16, 10.0))
        assert eng.gate.fused_s is not None
        counts = (eng.metrics.counter_value("geomesa.standing.fused"),
                  eng.metrics.counter_value("geomesa.standing.gate.host"))
        assert counts == (1, 23)
        return got, counts

    alike(case)


def test_match_raster_on_off_bit_identical():
    def case(P):
        polys = [("star", jagged_star(P, 10.0, 10.0, 2.0, 24, seed=3)),
                 ("donut", donut(P, 14.0, 18.0, 2.0, 1.0))]
        rng = np.random.default_rng(17)
        x = rng.uniform(7.0, 17.0, 8000)
        y = rng.uniform(7.0, 21.0, 8000)
        results = {}
        for label, cells in (("raster", 262_144), ("plain", 0)):
            eng = engine(P, fused_min_points=0, raster_cells=cells)
            for name, p in polys:
                eng.register(P.sq.Subscription(name, "geofence", geom=p))
            assert eng.index.has_rasters() == (cells > 0)
            results[label] = match_set(eng, x, y)
        assert results["raster"] == results["plain"]
        return results["raster"]

    alike(case)


def test_gate_off_always_fuses():
    def case(P):
        eng = engine(P, fused_min_points=1, fused_gate=False)
        eng.gate.update("host_s", 1e-12, 1)
        eng.gate.update("fused_s", 1.0, 1)
        eng.register(P.sq.Subscription("s", "geofence",
                                       geom=jagged_star(P, 10.0, 10.0, 2.0, 24, seed=3)))
        got = match_set(eng, np.full(8, 10.0), np.full(8, 10.0))
        assert eng.metrics.counter_value("geomesa.standing.fused") >= 1
        assert eng.metrics.counter_value("geomesa.standing.gate.host") == 0
        return got

    alike(case)


def test_cost_ewma_primitives_equal_the_jax_package():
    from geomesa_tpu.tuning import primitives as jp
    from geomesa_tpu_torch.tuning import primitives as tp

    def case(m):
        e = m.CostEwma()
        seq = [e.update_cost(s, u) for s, u in ((0.5, 10), (0.0, 3), (1.0, 0), (0.2, 4))]
        g = m.ProbeGate(explore_min=2, reprobe_every=3)
        blocks = [g.block() for _ in range(7)]
        g.note_trial()
        return (seq, e.value_or(9.0), m.CostEwma().value_or(9.0), blocks, g.exploring,
                [m.doubling_ladder(w, 4, 64) for w in (1, 5, 63, 500)], m.ewma_step(None, 2.0))

    assert case(tp) == case(jp)


# -- windows ----------------------------------------------------------------------


WINDOW_SPECS = [
    dict(size_ms=10_000, agg="count"),
    dict(size_ms=10_000, slide_ms=4_000, agg="count"),
    dict(size_ms=12_000, slide_ms=3_000, agg="stats", fieldname="v"),
    dict(size_ms=8_000, agg="bounds"),
]


@pytest.mark.parametrize("spec", WINDOW_SPECS, ids=["tumbling", "sliding", "stats", "bounds"])
def test_compose_equals_recompute_bit_identical(spec):
    """Ragged, shuffled batches: the composed windows equal a recompute
    from raw rows grouped by pane, and the JAX package's windows and pane
    partials."""
    def case(P):
        s = P.sq.WindowSpec(**spec)
        rng = np.random.default_rng(17)
        n = 500
        ts = T0 + rng.integers(0, 60_000, n)
        vals = rng.uniform(-1e6, 1e6, n)
        xs = rng.uniform(-50, 50, n)
        ys = rng.uniform(-50, 50, n)
        rows = [{"name": "n", "dtg": int(ts[i]), "v": float(vals[i]),
                 "geom": P.geo.Point(float(xs[i]), float(ys[i]))} for i in range(n)]
        agg = P.sq.WindowedAggregator(s, time_field="dtg", max_panes=4096)
        order = rng.permutation(n)
        for k in range(0, n, 37):
            sel = order[k: k + 37]
            agg.accept_rows([rows[i] for i in sel], times_ms=ts[sel], xs=xs[sel], ys=ys[sel])
        upto = int(ts.max()) + s.size_ms + 1
        got = agg.windows(upto)
        panes: dict = {}
        for i in order:
            panes.setdefault(int(ts[i]) // s.pane_ms, []).append(i)
        parts = {}
        for pane, members in panes.items():
            part = agg._zero()
            for i in members:
                agg._fold_row(part, rows[i], i, xs, ys)
            parts[pane] = part
        slide = s.effective_slide_ms
        start = (min(panes) * s.pane_ms // slide) * slide
        want = []
        while start + s.size_ms <= upto:
            v = P.sq.compose_partials(s, [parts[k] for k in range(start // s.pane_ms,
                                                                   (start + s.size_ms) // s.pane_ms)
                                          if k in parts])
            if v["n"]:
                want.append((start, v))
            start += slide
        assert got and got == want
        return got, agg.partials()

    alike(case)


def test_rows_without_event_time_are_skipped():
    def case(P):
        agg = P.sq.WindowedAggregator(P.sq.WindowSpec(size_ms=1000, slide_ms=500),
                                      metrics=P.metrics.MetricsRegistry())
        n = agg.accept_rows([{"v": 1}, {"v": 2}, {"v": 3}],
                            times_ms=np.array([T0, -1, T0 + 100], np.int64))
        assert n == 2 and agg.value(T0 + 1000)["n"] == 2 and min(agg.partials()) >= 0
        wins = agg.windows(T0 + 2000)
        assert sum(v["n"] for _, v in wins) > 0 and all(s >= T0 - 1000 for s, _ in wins)
        return wins

    alike(case)


def test_pane_retention_bounded():
    def case(P):
        agg = P.sq.WindowedAggregator(P.sq.WindowSpec(size_ms=1000, agg="count"),
                                      time_field="dtg", metrics=P.metrics.MetricsRegistry(),
                                      max_panes=4)
        agg.accept_rows([{"dtg": i * 1000} for i in range(10)])
        assert len(agg.partials()) == 4
        return agg.partials(), agg.metrics.counter_value("geomesa.standing.window.dropped")

    assert alike(case)[1] == 6


def test_feature_stream_sink():
    def case(P):
        cache = P.st.StreamingFeatureCache(sft(P))
        agg = P.sq.WindowedAggregator(P.sq.WindowSpec(size_ms=60_000, agg="count"),
                                      time_field="dtg")
        P.st.FeatureStream.wrap(cache).to(agg)
        cache.upsert([{"__id__": "a", "name": "n", "dtg": T0, "geom": P.geo.Point(0.0, 0.0)},
                      {"__id__": "b", "name": "n", "dtg": T0 + 1, "geom": P.geo.Point(1.0, 1.0)}])
        cache.delete(["a"])
        return agg.value(T0 + 60_000)

    assert alike(case)["n"] == 2


# -- delivery ---------------------------------------------------------------------


def test_alert_queue_bounded_drops_oldest():
    def case(P):
        q = P.sq.AlertQueue(maxlen=3, metrics=P.metrics.MetricsRegistry())
        q.put_many([{"i": i} for i in range(5)])
        assert q.dropped == 2
        out = q.drain()
        assert [a["i"] for a in out] == [2, 3, 4]
        return out, q.metrics.counter_value("geomesa.standing.dropped")

    alike(case)


def test_alert_queue_columnar_blocks_bound_across_boundaries():
    def case(P):
        q = P.sq.AlertQueue(maxlen=4, metrics=P.metrics.MetricsRegistry())
        kinds = np.zeros(2, np.int8)
        q.put_block(P.sq._AlertBlock(np.arange(3), np.zeros(3, np.int64), ["e0", "e1", "e2"],
                                     ["a", "b"], kinds, {0: {"k": 1}}))
        q.put_block(P.sq._AlertBlock(np.arange(3), np.full(3, 1, np.int64), ["f0", "f1", "f2"],
                                     ["a", "b"], kinds, {}))
        assert len(q) == 4 and q.dropped == 2
        head = q.drain(max_n=1)
        assert head == [{"sub": "a", "kind": "geofence", "id": "e2", "attrs": {"k": 1}}]
        q.put_many([{"sub": "x", "kind": "geofence", "id": "m0"}])
        rest = q.drain()
        assert [a["id"] for a in rest] == ["f0", "f1", "f2", "m0"] and len(q) == 0
        return head, rest

    alike(case)


def _lam(P, **kw):
    ds = P.pkg.DataStore(**P.kw)
    ds.metrics = P.metrics.MetricsRegistry()
    ds.create_schema(sft(P))
    return P.st.LambdaStore(ds, "t", **kw)


def test_matcher_fault_never_unacks_the_write():
    def case(P):
        lam = _lam(P)
        try:
            lam.subscribe(P.sq.Subscription("g", "geofence", geom=square(P, -1, -1, 2.0)))
            for point in ("standing.match", "standing.deliver"):
                with P.fault.inject(point, kind="io_error", after=0, times=1):
                    assert lam.write([point_row(P, 0.0, 0.0)], ids=[point]) == 1
            eng = lam.standing()
            assert eng.metrics.counter_value("geomesa.standing.errors") == 2
            assert lam.count() == 2 and len(eng.alerts) == 0
            lam.write([point_row(P, 0.0, 0.0)], ids=["ok"])
            return eng.alerts.drain()
        finally:
            lam.close()

    assert [a["id"] for a in alike(case)] == ["ok"]


def test_latency_histogram_and_slo_objective():
    def case(P):
        names = {o.name: o for o in P.slo.default_objectives()}
        assert names["standing_alert_p99"].metric == "geomesa.standing.latency"
        lam = _lam(P)
        try:
            reg = lam.standing().metrics
            slo = P.slo.SloTracker([names["standing_alert_p99"]], window_s=60,
                                   slices=6).attach(reg)
            lam.subscribe(P.sq.Subscription("g", "geofence", geom=square(P, -1, -1, 2.0)))
            lam.write([point_row(P, 0.0, 0.0)], ids=["a"])
            snap = reg.snapshot()["histograms"]
            assert snap["geomesa.standing.latency"]["count"] == 1
            assert snap["geomesa.standing.match"]["count"] == 1
            row = slo.report()["objectives"][0]
            assert row["objective"] == "standing_alert_p99" and row["count"] == 1
            assert "geomesa_standing_latency_seconds_bucket" in reg.render_prometheus()
            return {k: reg.counter_value(k) for k in (
                "geomesa.standing.candidates", "geomesa.standing.matched",
                "geomesa.standing.alerts")}
        finally:
            lam.close()

    alike(case)


def test_flusher_arrival_hook():
    def case(P):
        lam = _lam(P)
        try:
            eng = P.sq.StandingQueryEngine(lam.cold.get_schema("t"), P.sq.StandingConfig(),
                                           metrics=P.metrics.MetricsRegistry(), **P.kw)
            eng.register(P.sq.Subscription("g", "geofence", geom=square(P, -1, -1, 2.0)))
            eng.attach_flusher(lam.flusher)
            lam.write([point_row(P, 0.0, 0.0)], ids=["a"])
            assert len(eng.alerts) == 0
            lam.flush()
            return eng.alerts.drain()
        finally:
            lam.close()

    assert [a["id"] for a in alike(case)] == ["a"]


def test_store_alerts_equal_the_jax_package():
    """A LambdaStore with geofences (rectangles, stars fused and host,
    holes), proximity and tube subscriptions with attrs: the alert dicts
    of every batch are equal, in order."""
    def case(P):
        lam = _lam(P)
        out = []
        try:
            # the gate off: which path a candidate takes (and so the alert
            # order within a batch) must not follow the host's clock
            lam.standing(P.sq.StandingConfig(fused_gate=False, fused_min_points=8))
            rng = np.random.default_rng(29)
            for i in range(12):
                lam.subscribe(P.sq.Subscription(f"r{i}", "geofence", geom=square(
                    P, float(rng.uniform(-5, 4)), float(rng.uniform(-5, 4)), 1.5), attrs={"i": i}))
            for i in range(4):
                lam.subscribe(P.sq.Subscription(f"star{i}", "geofence", geom=jagged_star(
                    P, float(rng.uniform(-3, 3)), float(rng.uniform(-3, 3)), 2.0, 10 + 30 * i,
                    seed=i)))
            lam.subscribe(P.sq.Subscription("d", "geofence", geom=donut(P, 0, 0, 3, 1)))
            lam.subscribe(P.sq.Subscription("near", "proximity", points=[(1.0, 1.0)],
                                            distance_m=80_000, attrs={"who": "x"}))
            lam.subscribe(P.sq.Subscription("tb", "tube", track_xy=[(-4, 0), (4, 0)],
                                            track_times_ms=[T0, T0 + 8000], buffer_m=50_000))
            for b in range(4):
                n = 300
                xs, ys = rng.uniform(-6, 6, n), rng.uniform(-6, 6, n)
                ts = T0 + rng.integers(0, 9000, n)
                lam.write([point_row(P, xs[k], ys[k], int(ts[k])) for k in range(n)],
                          ids=[f"b{b}_{k}" for k in range(n)])
                out.append(lam.standing().alerts.drain())
                if b == 1:
                    lam.unsubscribe("star0")
                    lam.flush()
            assert sum(map(len, out)) > 0
            return out
        finally:
            lam.close()

    alike(case)


# -- durability -------------------------------------------------------------------


def _saved_store(P, root, sync="always"):
    ds = P.pkg.DataStore(**P.kw)
    ds.create_schema(sft(P))
    P.persist.save(ds, root)
    return P.st.LambdaStore(ds, "t", config=P.st.StreamConfig(chunk_rows=256),
                            wal_dir=os.path.join(root, "_wal"),
                            wal_config=P.st.WalConfig(sync=sync, segment_bytes=8 << 10))


def _squares(P):
    return {f"s{i}": square(P, i * 2.0, 0.0) for i in range(8)}


def _crash(lam):
    lam.wal.crash()
    lam.flusher.close()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX), (PORT, PORT)],
                         ids=["jax_to_port", "port_to_jax", "port_to_port"])
def test_subscriptions_survive_kill(tmp_path, writer, reader):
    root = str(tmp_path / "s")
    lam = _saved_store(writer, root)
    for sid, g in _squares(writer).items():
        lam.subscribe(writer.sq.Subscription(sid, "geofence", geom=g, attrs={"k": sid}))
    lam.unsubscribe("s3")
    _crash(lam)
    rec = reader.st.LambdaStore.recover(root, **reader.kw)
    try:
        assert rec.standing().index.subscription_ids() == sorted(set(_squares(reader)) - {"s3"})
        rec.write([point_row(reader, 4.5, 0.5)], ids=["e"])
        alerts = rec.standing().alerts.drain()
        assert [(a["sub"], a["id"], a["attrs"]["k"]) for a in alerts] == [("s2", "e", "s2")]
    finally:
        rec.close()


@pytest.mark.parametrize("P", BOTH, ids=["jax", "port"])
def test_subscriptions_survive_checkpoint_retirement(tmp_path, P):
    root = str(tmp_path / "s")
    lam = _saved_store(P, root)
    for sid, g in _squares(P).items():
        lam.subscribe(P.sq.Subscription(sid, "geofence", geom=g))
    for b in range(4):
        lam.write([{"name": "x" * 50, "dtg": np.datetime64(T0, "ms"),
                    "geom": P.geo.Point(float(i % 90), 0.5)} for i in range(200)],
                  ids=[f"r{b}_{i}" for i in range(200)])
        lam.flush()
    lam.unsubscribe("s0")
    lam.checkpoint(root)
    assert lam.wal.metrics.counter_value("geomesa.stream.wal.retired") >= 1
    _crash(lam)
    want = sorted(set(_squares(P)) - {"s0"})
    rec = P.st.LambdaStore.recover(root, **P.kw)
    assert rec.standing().index.subscription_ids() == want and rec.count() == 800
    rec.checkpoint(root)
    _crash(rec)
    rec2 = P.st.LambdaStore.recover(root, **P.kw)
    assert rec2.standing().index.subscription_ids() == want
    rec2.close()


def test_checkpoint_relog_bytes_equal_the_jax_package(tmp_path):
    """The same registrations and checkpoint give the same WAL bytes in
    both packages (the re-logged live set above the cover included)."""
    files = []
    for P in BOTH:
        root = str(tmp_path / P.name)
        lam = _saved_store(P, root)
        for sid, g in _squares(P).items():
            lam.subscribe(P.sq.Subscription(sid, "geofence", geom=g, attrs={"k": sid}))
        lam.subscribe(P.sq.Subscription("t", "tube", track_xy=[(0, 0), (1, 1)],
                                        track_times_ms=[0, 10], buffer_m=3.0))
        lam.unsubscribe("s5")
        lam.checkpoint(root)
        _crash(lam)
        wal_dir = os.path.join(root, "_wal")
        files.append({n: open(os.path.join(wal_dir, n), "rb").read()
                      for n in sorted(os.listdir(wal_dir)) if n.endswith(".log")})
    assert files[1] == files[0]


@pytest.mark.parametrize("P", BOTH, ids=["jax", "port"])
def test_invalid_subscription_never_poisons_the_wal(tmp_path, P):
    root = str(tmp_path / "s")
    lam = _saved_store(P, root)
    lam.subscribe(P.sq.Subscription("good", "geofence", geom=_squares(P)["s0"]))
    with pytest.raises(ValueError):
        lam.subscribe(P.sq.Subscription("bad", "geofence", geom=None))
    with pytest.raises(ValueError):
        lam.subscribe(P.sq.Subscription("bad2", "proximity", points=np.zeros((0, 2)),
                                        distance_m=10.0))
    with pytest.raises(ValueError, match="one time per"):
        lam.subscribe(P.sq.Subscription("bad3", "tube", track_xy=[(0, 0), (1, 1), (2, 2)],
                                        track_times_ms=[0, 1000], buffer_m=500.0))
    with pytest.raises(ValueError, match="ascending"):
        lam.subscribe(P.sq.Subscription("bad4", "tube", track_xy=[(0, 0), (1, 1)],
                                        track_times_ms=[1000, 0], buffer_m=500.0))
    lam.wal.append("s", {"sub": {"id": "planted", "kind": "geofence"}})
    _crash(lam)
    rec = P.st.LambdaStore.recover(root, **P.kw)
    assert rec.standing().index.subscription_ids() == ["good"]
    assert list(rec._sub_records) == ["good"]
    rec.close()


@pytest.mark.parametrize("P", BOTH, ids=["jax", "port"])
def test_replay_batched_equals_record_at_a_time(tmp_path, P):
    root = str(tmp_path / "s")
    lam = _saved_store(P, root, sync="off")
    rng = np.random.default_rng(23)
    for b in range(6):
        ids = [f"r{rng.integers(0, 300)}" for _ in range(120)]
        xs, ys = rng.uniform(-50, 50, 120), rng.uniform(-50, 50, 120)
        lam.write([{"name": f"v{b}_{i}", "dtg": np.datetime64(T0 + b, "ms"),
                    "geom": P.geo.Point(float(xs[i]), float(ys[i]))} for i in range(120)],
                  ids=ids)
        if b % 2 == 0:
            lam.flush()
        if b == 3:
            lam.delete([f"r{i}" for i in range(20)])
    lam.wal.sync()
    _crash(lam)

    def answers():
        rec = P.st.LambdaStore.recover(root, **P.kw)
        fc = rec.query("INCLUDE")
        out = sorted(zip((str(i) for i in fc.ids.tolist()),
                         (str(v) for v in np.asarray(fc.columns["name"]).tolist())))
        rec.close()
        return out

    batched = answers()
    P.conf.STREAM_WAL_REPLAY_BATCH.set(0)
    assert batched == answers() and len(batched) > 0


def test_bulk_insert_points_equals_insert():
    def case(P):
        BucketIndex = import_module(P.name + ".utils.spatial_index").BucketIndex
        rng = np.random.default_rng(31)
        n = 2000
        keys = [f"k{rng.integers(0, 1200)}" for _ in range(n)]
        xs, ys = rng.uniform(-179, 179, n), rng.uniform(-89, 89, n)
        a, b = BucketIndex(), BucketIndex()
        a.bulk_insert_points(keys, xs, ys)
        for k, x, y in zip(keys, xs, ys):
            b.insert(k, (x, y, x, y))
        assert len(a) == len(b)
        out = []
        for box in [(-50, -50, 50, 50), (-179, -89, 179, 89), (0, 0, 1, 1)]:
            assert sorted(a.query(box)) == sorted(b.query(box))
            out.append(sorted(a.query(box)))
        return out

    alike(case)


# -- kill-anywhere chaos ----------------------------------------------------------


@pytest.mark.parametrize("P", BOTH, ids=["jax", "port"])
def test_kill_anywhere_no_registration_lost_or_invented(tmp_path, P):
    root = str(tmp_path / "s")
    lam = _saved_store(P, root)
    acked, attempted, errors = {}, set(), []
    stop = threading.Event()
    test_lock = threading.Lock()

    def registrar():
        i = 0
        rng = np.random.default_rng(41)
        while not stop.is_set():
            i += 1
            sid = f"sub{i}"
            cx, cy = float(rng.uniform(-60, 60)), float(rng.uniform(-40, 40))
            with test_lock:
                try:
                    lam.subscribe(P.sq.Subscription(sid, "geofence",
                                                    geom=square(P, cx - 0.5, cy - 0.5)))
                except (P.fault.InjectedCrash, OSError):
                    attempted.add(sid)
                    continue
                acked[sid] = (cx, cy)
            time.sleep(0.002)

    def writer():
        rng = np.random.default_rng(43)
        b = 0
        while not stop.is_set():
            b += 1
            try:
                lam.write([point_row(P, rng.uniform(-60, 60), rng.uniform(-40, 40))
                           for _ in range(8)], ids=[f"w{b}_{k}" for k in range(8)])
            except (P.fault.InjectedCrash, OSError):
                pass
            time.sleep(0.001)

    def flusher():
        i = 0
        while not stop.is_set():
            time.sleep(0.04)
            i += 1
            try:
                if i % 6 == 0:
                    lam.checkpoint(root)
                else:
                    lam.flush()
            except (P.fault.InjectedCrash, OSError):
                continue
            except Exception as e:
                errors.append(repr(e))
                stop.set()

    threads = [threading.Thread(target=t) for t in (registrar, writer, flusher)]
    with P.fault.chaos(seed=777, rate=0.03, points="stream.*,streaming.*,persist.*,standing.*",
                       kinds=("io_error", "latency"), delay_s=0.002) as spec:
        for t in threads:
            t.start()
        time.sleep(1.5)
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors[:3]
    assert spec.fired > 0
    _crash(lam)
    rec = P.st.LambdaStore.recover(root, **P.kw)
    try:
        live = set(rec.standing().index.subscription_ids())
        assert not set(acked) - live
        assert not live - set(acked) - attempted
        probes = list(acked.items())[:20]
        if probes:
            rec.write([point_row(P, cx, cy, name="p") for _, (cx, cy) in probes],
                      ids=[f"probe_{sid}" for sid, _ in probes])
            got = {(a["sub"], a["id"]) for a in rec.standing().alerts.drain()}
            for sid, _ in probes:
                assert (sid, f"probe_{sid}") in got, sid
            assert all(sub in live for sub, _ in got)
    finally:
        rec.close()


# -- scheduler isolation ----------------------------------------------------------


def test_matcher_beside_served_queries():
    """tests/test_standing.py:1085 with deterministic assertions only:
    queries admitted through the serving scheduler while a writer thread
    ingests with the matcher armed all answer, the matcher matched, and
    ``close()`` ends the scheduler thread."""
    P = PORT
    rng = np.random.default_rng(53)
    ds = P.pkg.DataStore(**P.kw)
    s = sft(P)
    ds.create_schema(s)
    n = 20_000
    ds.write("t", P.pkg.FeatureCollection.from_columns(s, np.arange(n).astype(str), {
        "name": np.array(["c"] * n), "dtg": T0 + rng.integers(0, 86_400_000, n),
        "geom": (rng.uniform(-60, 60, n), rng.uniform(-40, 40, n))}), check_ids=False)
    ds.compact("t")
    lam = P.st.LambdaStore(ds, "t", config=P.st.StreamConfig(chunk_rows=4096))
    lam.serve()
    eng = lam.standing()
    for i in range(50):
        eng.register(P.sq.Subscription(f"g{i}", "geofence", geom=jagged_star(
            P, float(rng.uniform(-60, 60)), float(rng.uniform(-40, 40)), 1.0, 12, seed=i)))
    stop = threading.Event()
    batches = []

    def ingest():
        k = 0
        while not stop.is_set() or k < 3:
            k += 1
            xs, ys = rng.uniform(-60, 60, 1000), rng.uniform(-40, 40, 1000)
            lam.write([point_row(P, xs[i], ys[i], name="s") for i in range(1000)],
                      ids=[f"i{k}_{i}" for i in range(1000)])
            lam.flush()
            batches.append(k)

    t = threading.Thread(target=ingest)
    t.start()
    answered = [len(lam.query("bbox(geom, -20, -20, 20, 20)")) for _ in range(5)]
    stop.set()
    t.join()
    try:
        assert all(a > 0 for a in answered) and len(batches) >= 3
        assert eng.metrics.counter_value("geomesa.standing.matched") > 0
    finally:
        lam.close()
        ds.close()
    assert ds.scheduler.closed
    assert not [x for x in threading.enumerate() if x.name == "geomesa-serving" and x.is_alive()
                and getattr(getattr(x, "_target", None), "__self__", None) is ds.scheduler]
