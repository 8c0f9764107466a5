"""The port's map-tile tier (geomesa_tpu_torch.tiles) against the JAX
package's, on the CPU.

Both packages hold the same seeded rows, and their pyramids must agree:
the lattice (tile counts, exact edges, half-open leaf binning, children,
the leaf tiles a box overlaps), the PNG bytes of every rendering kind,
and every composed grid bit for bit, equal to ``TilePyramid.fresh`` and
to the other package's, at every zoom: fuzzed rows, points on every
leaf-tile edge, a LambdaStore's flushes and a fold that replaces rows, a
sliced fold whose slices straddle a tile edge, an uncached store. Scoped
invalidation: a localized write leaves far tiles warm and recomposes one
tile per zoom; the tick is the ETag source; the delta accounting, the
schema-drop and quarantine hooks through the cache tier's pyramid seam;
the TTL jitter schedule; the ``tiles.compose`` and ``tiles.leaf.scan``
fault points. Mirrors tests/test_tiles.py.
Tolerance: exact.
"""

import struct
import time
import zlib
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
DAY = 86_400_000


def _pkg(pkg, kw):
    name = pkg.__name__
    return SimpleNamespace(
        name=name, pkg=pkg, kw=kw,
        tiles=import_module(name + ".tiles"),
        cache=import_module(name + ".cache"),
        gens=import_module(name + ".cache.generations"),
        result=import_module(name + ".cache.result"),
        conf=import_module(name + ".conf"),
        fault=import_module(name + ".fault"),
        geo=import_module(name + ".geometry"),
        st=import_module(name + ".streaming"),
        metrics=import_module(name + ".metrics"),
    )


JAX = _pkg(geomesa_tpu, {})
PORT = _pkg(geomesa_tpu_torch, {"device": "cpu"})
BOTH = (JAX, PORT)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


@pytest.fixture(autouse=True)
def _clean():
    yield
    for P in BOTH:
        P.fault.injector().reset()
        P.conf.CACHE_TTL_JITTER.clear()


def alike(fn):
    """Run ``fn(P)`` for both packages; the results must be equal."""
    out = [fn(P) for P in BOTH]
    assert out[1] == out[0]
    return out[1]


def small(P):
    """2 + 8 + 32 tiles of 32 x 32 pixels: the full matrix stays quick."""
    return P.tiles.TilesConfig(leaf_zoom=2, px=32)


def _store(P, n=0, seed=0, cache=True):
    ds = P.pkg.DataStore(cache=P.cache.CacheConfig(max_bytes=1 << 22) if cache else None, **P.kw)
    ds.metrics = P.metrics.MetricsRegistry()
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds.create_schema(sft)
    if n:
        ds.write("t", _fc(P, sft, [f"c{i}" for i in range(n)], seed=seed))
    return ds, sft


def _fc(P, sft, ids, seed=0, lon=(-179.9, 179.9), lat=(-89.9, 89.9)):
    rng = np.random.default_rng(seed)
    n = len(ids)
    return P.pkg.FeatureCollection.from_columns(sft, list(ids), {
        "name": np.array(["n"] * n),
        "dtg": T0 + rng.integers(0, 30 * DAY, n),
        "geom": (rng.uniform(*lon, n), rng.uniform(*lat, n)),
    })


def _xy_fc(P, sft, ids, x, y):
    n = len(ids)
    return P.pkg.FeatureCollection.from_columns(sft, list(ids), {
        "name": np.array(["n"] * n),
        "dtg": np.full(n, T0, dtype=np.int64),
        "geom": (np.asarray(x, float), np.asarray(y, float)),
    })


def _identical(pyramid, type_name="t", zooms=None):
    """Every tile at every zoom equals the from-scratch oracle bit for
    bit and every zoom's total is the same (no double binning). Returns
    the grids' bytes, for the comparison across packages, and the total."""
    grids, total = [], None
    for z in zooms or range(pyramid.lattice.leaf_zoom + 1):
        nx, ny = pyramid.lattice.n_tiles(z)
        zsum = 0.0
        for x in range(nx):
            for y in range(ny):
                warm = pyramid.fetch(type_name, z, x, y)
                oracle = pyramid.fresh(type_name, z, x, y)
                assert warm.grid.dtype == np.float64
                assert np.array_equal(warm.grid, oracle.grid), (z, x, y)
                grids.append(warm.grid.tobytes())
                zsum += warm.grid.sum()
        total = zsum if total is None else total
        assert zsum == total, (z, zsum, total)
    return grids, total


# ------------------------------------------------------------- the lattice


@pytest.mark.parametrize("leaf,px", [(3, 256), (2, 32), (0, 8)])
def test_lattice_counts_validity_and_edges(leaf, px):
    def case(P):
        lat = P.tiles.TileLattice(leaf_zoom=leaf, px=px)
        counts = [lat.n_tiles(z) for z in range(leaf + 1)]
        valid = [lat.valid(z, x, y) for z in (-1, 0, leaf, leaf + 1) for x in (-1, 0, 1, 2) for y in (-1, 0, 1)]
        bboxes = [lat.tile_bbox(z, x, y) for z in range(leaf + 1)
                  for x in range(lat.n_tiles(z)[0]) for y in range(lat.n_tiles(z)[1])]
        return counts, valid, lat.xe.tobytes(), lat.ye.tobytes(), bboxes

    counts, _, _, _, bboxes = alike(case)
    assert counts[0] == (2, 1) and len(bboxes) == sum(2 * 4**z for z in range(leaf + 1))


def test_lattice_half_open_binning_and_world_edges():
    def case(P):
        lat = P.tiles.TileLattice(leaf_zoom=2, px=32)
        rng = np.random.default_rng(3)
        x = np.concatenate([lat.xe[::7], [180.0, -180.0, 180.1, -999.0], rng.uniform(-180, 180, 500)])
        y = np.concatenate([lat.ye[::7], [90.0, -90.0, 0.0, 0.0], rng.uniform(-90, 90, 500)])
        n = min(len(x), len(y))
        col, row, ok = lat.bin_leaf(x[:n], y[:n])
        return col.tolist(), row.tolist(), ok.tolist()

    col, row, ok = alike(case)
    assert not all(ok)


@pytest.mark.parametrize("tile", [(1, 2, 1), (0, 1, 0), (2, 7, 3)])
def test_lattice_children_and_leaf_spans(tile):
    def case(P):
        lat = P.tiles.TileLattice(leaf_zoom=3, px=64)
        kids = lat.children_of(*tile)
        return lat.leaf_span(*tile), [tuple(k) for k in kids], [lat.leaf_span(*k) for k in kids]

    alike(case)


@pytest.mark.parametrize("bounds", [None, (10.0, 10.0, 20.0, 20.0), (-1.0, 10.0, 1.0, 20.0),
                                    (-1.0, -1.0, 1.0, 1.0), (170.0, 80.0, 999.0, 999.0)])
def test_lattice_leaf_tiles_overlapping(bounds):
    alike(lambda P: P.tiles.TileLattice(leaf_zoom=2, px=32).leaf_tiles_overlapping(bounds))


# --------------------------------------------------------------------- PNG


@pytest.mark.parametrize("kind", ["count", "density", "heat"])
@pytest.mark.parametrize("grid", ["random", "empty", "ramp"])
def test_png_bytes_equal(kind, grid):
    rng = np.random.default_rng(0)
    g = {"random": rng.integers(0, 50, (32, 32)).astype(np.float64),
         "empty": np.zeros((16, 16)),
         "ramp": np.arange(64, dtype=np.float64).reshape(8, 8)}[grid]
    png = alike(lambda P: P.tiles.render(kind, g))
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and png.endswith(b"IEND\xaeB`\x82")
    assert tuple(PORT.tiles.KINDS) == tuple(JAX.tiles.KINDS)
    w, h = struct.unpack(">II", png[16:24])
    i = png.index(b"IDAT")
    (length,) = struct.unpack(">I", png[i - 4:i])
    raw = zlib.decompress(png[i + 4:i + 4 + length])
    assert (w, h) == g.shape[::-1] and len(raw) == h * (1 + w)


def test_png_refusals():
    for P in BOTH:
        with pytest.raises(ValueError):
            P.tiles.render("viridis", np.zeros((4, 4)))
        with pytest.raises(ValueError):
            P.tiles.encode_png(np.zeros((4, 4, 5), np.uint8))


def test_encode_png_gray_and_rgb_bytes():
    rng = np.random.default_rng(4)
    gray = rng.integers(0, 255, (9, 7)).astype(np.uint8)
    rgb = rng.integers(0, 255, (5, 6, 3)).astype(np.uint8)
    alike(lambda P: (P.tiles.encode_png(gray), P.tiles.encode_png(rgb)))


# ---------------------------------------------------------- bit identity


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_identity_matrix_fuzzed(seed):
    def case(P):
        ds, _ = _store(P, n=800, seed=seed)
        try:
            return _identical(P.tiles.TilePyramid(ds, small(P)))
        finally:
            ds.close()

    assert alike(case)[1] == 800.0


def test_identity_with_points_on_every_tile_edge():
    def case(P):
        ds, sft = _store(P)
        lat = P.tiles.TileLattice(2, 32)
        xs = [float(lat.xe[c]) for c in range(0, lat.nx, 32)][1:]
        ys = [float(lat.ye[r]) for r in range(0, lat.ny, 32)][1:-1]
        px_, py_ = (a.ravel() for a in np.meshgrid(np.array(xs), np.array(ys)))
        ds.write("t", _xy_fc(P, sft, [f"e{i}" for i in range(len(px_))], px_, py_))
        try:
            return _identical(P.tiles.TilePyramid(ds, small(P))), len(px_)
        finally:
            ds.close()

    (_, total), n = alike(case)
    assert total == float(n)


def test_identity_under_flushes_and_a_replacing_fold():
    def case(P):
        ds, sft = _store(P, n=400, seed=3)
        p = P.tiles.TilePyramid(ds, small(P))
        steps = [_identical(p)]
        lam = P.st.LambdaStore(ds, "t", config=P.st.StreamConfig(chunk_rows=32, fold_rows=8))
        rng = np.random.default_rng(9)
        try:
            for r in range(3):
                rows = [{"name": "h", "dtg": T0 + r,
                         "geom": P.geo.Point(float(rng.uniform(-170, 170)), float(rng.uniform(-80, 80)))}
                        for _ in range(40)]
                lam.write(rows, ids=[f"h{r}_{i}" for i in range(40)])
                lam.flush()
                steps.append(_identical(p))
            ds.fold_upsert("t", _fc(P, sft, [f"c{i}" for i in range(50)], seed=77))
            steps.append(_identical(p))
            return steps, ds.metrics.counter_value("geomesa.tiles.compose")
        finally:
            lam.close()

    steps, _ = alike(case)
    assert [s[1] for s in steps] == [400.0, 440.0, 480.0, 520.0, 520.0]


def test_fold_slices_straddling_tile_boundaries():
    def case(P):
        ds, sft = _store(P, n=200, seed=4)
        p = P.tiles.TilePyramid(ds, small(P))
        _identical(p)
        n = 64
        x = np.where(np.arange(n) % 2 == 0, -0.25, 0.25)
        batch = _xy_fc(P, sft, [f"s{i}" for i in range(n)], x, np.linspace(-40, 40, n))
        ds.fold_upsert("t", batch, slice_rows=8)
        try:
            return _identical(p)
        finally:
            ds.close()

    assert alike(case)[1] == 264.0


def test_uncached_store_still_correct():
    def case(P):
        ds, _ = _store(P, n=150, seed=5, cache=False)
        p = P.tiles.TilePyramid(ds, small(P))
        try:
            out = _identical(p, zooms=(0, 2))
            assert p.stats()["tile_grid_entries"] == 0
            return out
        finally:
            ds.close()

    assert alike(case)[1] == 150.0


# ---------------------------------------------------- scoped invalidation


def test_a_write_dirties_only_the_touched_tiles():
    def case(P):
        ds, sft = _store(P, n=300, seed=6)
        p = P.tiles.TilePyramid(ds, small(P))
        _identical(p)
        compose0 = ds.metrics.counter_value("geomesa.tiles.compose")
        ds.write("t", _xy_fc(P, sft, ["probe"], [8.0], [8.0]))
        far = p.peek("t", 2, 0, 0)
        touched = p.peek("t", 2, 4, 1)
        grids = _identical(p)
        recomposed = ds.metrics.counter_value("geomesa.tiles.compose") - compose0
        ds.close()
        return far is not None, touched is None, recomposed, grids

    far_warm, touched_stale, recomposed, _ = alike(case)
    assert far_warm and touched_stale and recomposed == 3


def test_tick_is_the_etag_source():
    def case(P):
        ds, sft = _store(P, n=100, seed=7)
        p = P.tiles.TilePyramid(ds, small(P))
        g1 = p.fetch("t", 0, 0, 0)
        same = p.fetch("t", 0, 0, 0).tick == g1.tick
        ds.write("t", _xy_fc(P, sft, ["w"], [-89.0], [45.0]))
        g2 = p.fetch("t", 0, 0, 0)
        ds.close()
        return same, g2.tick > g1.tick, g1.count, g2.count

    assert alike(case)[:2] == (True, True)


def test_note_delta_accounting_and_stats():
    def case(P):
        ds, sft = _store(P, n=50, seed=8)
        p = P.tiles.TilePyramid(ds, small(P))
        s0 = p.stats()
        ds.write("t", _xy_fc(P, sft, ["a"], [10.0], [10.0]))
        s1 = p.stats()
        merged = ds.cache.stats()
        ds.close()
        return s0, s1, {k: merged[k] for k in s1}, ds.metrics.counter_value("geomesa.tiles.dirty")

    s0, s1, _, dirty = alike(case)
    assert s1["tile_deltas"] == s0["tile_deltas"] + 1 and dirty >= 1


@pytest.mark.parametrize("hook", ["schema_dropped", "quarantine", "sweep"])
def test_schema_drop_and_quarantine_hooks(hook):
    def case(P):
        ds, _ = _store(P, n=60, seed=9)
        p = P.tiles.TilePyramid(ds, small(P))
        p.fetch("t", 0, 0, 0)
        before = p.stats()["tile_grid_entries"]
        if hook == "schema_dropped":
            ds.cache.on_schema_dropped("t")
            dropped = None
        elif hook == "quarantine":
            dropped = ds.cache.on_quarantine("t")
        else:
            dropped = p.sweep("t")
        after = p.stats()["tile_grid_entries"]
        ds.close()
        return before, after, dropped

    before, after, _ = alike(case)
    assert before == 21 and (after == 0 or hook == "sweep")


def test_out_of_pyramid_tiles_and_unknown_types_are_refused():
    for P in BOTH:
        ds, _ = _store(P, n=10)
        p = P.tiles.TilePyramid(ds, small(P))
        for z, x, y in ((3, 0, 0), (0, 2, 0), (-1, 0, 0), (1, 0, 2)):
            with pytest.raises(ValueError, match="outside the pyramid"):
                p.fetch("t", z, x, y)
        with pytest.raises(KeyError):
            p.fetch("nope", 0, 0, 0)
        assert p.peek("t", 5, 0, 0) is None
        ds.close()


# ------------------------------------------------------------- TTL jitter


def _expiries(P, jitter, keys):
    cache = P.result.ResultCache(
        P.result.ResultCacheConf(max_bytes=1 << 20, ttl_s=100.0, ttl_jitter=jitter),
        P.gens.GenerationTracker(),
    )
    out = {}
    for key in keys:
        t0 = time.monotonic()
        cache.admit(key, "t", P.gens.KeyRange.everything(), np.zeros(4), 1.0, cache.generations.tick())
        out[key] = round(cache._entries[key].expires_at - t0, 1)
    return out


@pytest.mark.parametrize("jitter", [0.0, 0.25, 0.5])
def test_ttl_jitter_schedule(jitter):
    keys = [f"tiles/t/2/{x}/{y}" for x in range(4) for y in range(2)]
    got = alike(lambda P: _expiries(P, jitter, keys))
    assert all(100.0 <= e <= 100.0 * (1 + jitter) + 0.1 for e in got.values())
    if jitter:
        assert max(got.values()) - min(got.values()) > 5.0


def test_tiles_knobs_reach_the_pyramid():
    def case(P):
        P.conf.CACHE_TTL_JITTER.set(0.25)
        P.conf.TILES_PX.set(64)
        try:
            cfg = P.tiles.TilesConfig.from_properties()
            ds = P.pkg.DataStore(cache=P.cache.CacheConfig.from_properties(), **P.kw)
            ds.create_schema(P.pkg.FeatureType.from_spec("t", SPEC))
            p = P.tiles.TilePyramid(ds)
            out = (cfg.leaf_zoom, cfg.px, cfg.cache_max_bytes, cfg.ttl_s, cfg.ttl_jitter,
                   cfg.max_age_s, p._result.conf.ttl_jitter, ds.cache.pyramid is p)
            ds.close()
            return out
        finally:
            P.conf.TILES_PX.clear()

    assert alike(case) == (3, 64, 128 << 20, None, 0.25, 0.0, 0.25, True)


# ----------------------------------------------------------- fault points


@pytest.mark.parametrize("points,zoom", [("tiles.*", 0), ("tiles.leaf.*", 2)])
def test_tiles_fault_points_fire_and_recover(points, zoom):
    def case(P):
        ds, _ = _store(P, n=80, seed=10)
        p = P.tiles.TilePyramid(ds, small(P))
        with P.fault.chaos(seed=1, rate=1.0, points=points, kinds=("io_error",)) as spec:
            with pytest.raises(P.fault.InjectedIOError):
                p.fetch("t", zoom, 0, 0)
            fired = spec.fired
        out = _identical(p, zooms=(0,))
        ds.close()
        return fired >= 1, out

    fired, (_, total) = alike(case)
    assert fired and total == 80.0


@pytest.mark.parametrize("point", ["tiles.compose", "tiles.leaf.scan"])
def test_a_crash_at_a_tiles_point_leaves_the_cache_clean(point):
    def case(P):
        ds, _ = _store(P, n=120, seed=11)
        p = P.tiles.TilePyramid(ds, small(P))
        with P.fault.inject(point, kind="crash"):
            with pytest.raises(P.fault.InjectedCrash):
                p.fetch("t", 1, 1, 0)
        entries = p.stats()["tile_grid_entries"]
        out = _identical(p)
        ds.close()
        return entries, out

    entries, (_, total) = alike(case)
    assert total == 120.0
