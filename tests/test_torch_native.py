"""The port's native host helpers against the JAX package's and against
the port's own numpy versions, all on the CPU.

Three parts:

- each helper of ``geomesa_tpu_torch.native`` against the same helper of
  ``geomesa_tpu.native`` on seeded inputs, with the edge values
  ``tests/test_native.py`` uses (boundary coordinates, pre-epoch and
  far-future dates, the int32 sign bit in the planes, points exactly on
  slanted edges): exact equality of range lists, XZ codes, write keys,
  permutations, gathers, decodes, merged spans and point-in-polygon bits;
- each helper against the port's numpy version (the path its callers
  take under ``native.disabled()``) wherever the reference promises
  equality: every helper except the two range decompositions, which may
  emit different covering lists (they are checked for covering instead);
- Z3, Z2, XZ2 and XZ3 stores, written once and in two writes (the second
  kept in the delta tier), with both packages native: the same ids in
  order, density grids, bounds and count estimates, loose ones included.

Also: two processes building into one empty directory at once, a broken
source raising with g++'s output, and ``native.disabled()`` restoring the
library on exit. Tolerance is exact equality throughout.

The JAX package's loader builds its library with no lock, straight into
``geomesa_tpu/native/build/``; under xdist several workers import
``tests/test_native.py`` at once, and a worker that loads a half-written
file records the library as unavailable for the rest of its life. Every
comparison here first calls :func:`ensure_jax_native`, which builds the
JAX package's own source with its own flags into a private copy under a
lock and loads that, whatever the worker's collection left behind.
"""

import fcntl
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import native as jn
from geomesa_tpu.curve.binnedtime import MAX_BIN, MAX_OFFSET, TimePeriod
from geomesa_tpu.curve.xzsfc import XZSFC as JXZSFC
from geomesa_tpu.curve.xzsfc import XElement as JXElement
from geomesa_tpu_torch import geometry as tgeo
from geomesa_tpu_torch import native as tn
from geomesa_tpu_torch.curve import zorder as tzo
from geomesa_tpu_torch.curve.xzsfc import XZSFC as TXZSFC
from geomesa_tpu_torch.curve.xzsfc import XElement as TXElement
from geomesa_tpu_torch.curve.zranges import ZBox, zranges
from geomesa_tpu_torch.index.z2 import Z2Index
from geomesa_tpu_torch.index.z3 import Z3Index
from geomesa_tpu_torch.scan import block_kernels as tbk
from geomesa_tpu_torch.sft import FeatureType
from geomesa_tpu_torch.storage.table import _merge_sorted_rows, _rows_in_spans, _span_rows

import test_torch_extent_store as ext
import test_torch_store as pts

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------ the reference's library

# the JAX package's g++ flags (geomesa_tpu/native/__init__.py, _build)
JAX_GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")
JAX_LIB_COPY = tn.BUILD_DIR / "jax_native" / "libgeomesa_native.so"


def _build_jax_copy() -> Path:
    """Compile ``geomesa_tpu/native/geomesa_native.cpp`` into
    ``JAX_LIB_COPY`` if it is missing or older than the source: a private
    file per process, renamed into place under an exclusive lock, as the
    port's own ``native.build`` does. Raises with g++'s output."""
    out = JAX_LIB_COPY
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".build.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if out.exists() and out.stat().st_mtime >= jn._SRC.stat().st_mtime:
                return out
            tmp = out.parent / f".libgeomesa_native.{os.getpid()}.so"
            errors = []
            for extra in (("-fopenmp",), ()):  # threaded first, as the reference
                r = subprocess.run(
                    ["g++", JAX_GXX_FLAGS[0], *extra, *JAX_GXX_FLAGS[1:], str(jn._SRC), "-o", str(tmp)],
                    capture_output=True, text=True, timeout=300,
                )
                if r.returncode == 0:
                    os.replace(tmp, out)
                    return out
                errors.append(r.stderr)
            tmp.unlink(missing_ok=True)
            raise RuntimeError("g++ failed to build the JAX package's library:\n" + "\n".join(errors))
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def ensure_jax_native() -> None:
    """Leave ``geomesa_tpu.native`` loaded from a complete library. When
    this process has not loaded it yet, or recorded it unavailable (the
    state a lost build race leaves), load the locked private copy: the
    module's library path points at it only while it loads, and
    ``GEOMESA_TPU_NO_NATIVE`` (which forces that same state) is lifted
    for the load. No file of the JAX package changes."""
    if jn._lib not in (None, False):
        return
    lib = _build_jax_copy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jn, "_LIB", lib)
        mp.delenv("GEOMESA_TPU_NO_NATIVE", raising=False)
        jn._lib = None
        jn.available()


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


# ------------------------------------------------------------------ inputs


def _points(seed, n=20_000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    x[:4] = [-180.0, 180.0, 0.0, -0.0]
    y[:4] = [-90.0, 90.0, 0.0, 179.9999 % 90]
    t0 = np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64)
    millis = t0 + rng.integers(0, 400 * 86_400_000, n)
    millis[:2] = [0, t0]
    return x, y, millis


def _planes(seed, n_real=6, pack=4, sorted_bids=True):
    rng = np.random.default_rng(seed)
    # the full u32 range: bit 31 (the int32 sign bit) is exercised
    wide = rng.integers(0, 1 << 32, (n_real, pack, 128), dtype=np.uint64).astype(np.uint32).view(np.int32)
    wide[rng.uniform(size=wide.shape) < 0.7] = 0
    inner = wide & rng.integers(0, 1 << 32, wide.shape, dtype=np.uint64).astype(np.uint32).view(np.int32)
    bids = rng.choice(50, n_real, replace=False).astype(np.int64)
    if sorted_bids:
        bids = np.sort(bids)
    return wide, inner, bids


def _spans_rows(seed):
    rng = np.random.default_rng(seed)
    spans, pos = [], 0
    for _ in range(rng.integers(1, 6)):
        pos += int(rng.integers(5, 40))
        end = pos + int(rng.integers(1, 30))
        spans.append((pos, end))
        pos = end
    rows = np.unique(rng.integers(0, pos + 50, 60)).astype(np.int64)
    cert = rng.uniform(size=len(rows)) < 0.5
    return spans, rows, cert


def _polygon_cases():
    """(px, py, rings, ring_part): a concave polygon with a hole and a
    second part over random points; a lattice of points on a square's
    grid lines; points exactly on a triangle's slanted edges."""
    rng = np.random.default_rng(0)
    px, py = rng.uniform(-5, 15, 50_000), rng.uniform(-5, 15, 50_000)
    shell = np.array([[0, 0], [10, 0], [10, 10], [6, 10], [6, 4], [4, 4], [4, 10], [0, 10], [0, 0]], float)
    hole = np.array([[1, 1], [3, 1], [3, 3], [1, 3], [1, 1]], float)
    part2 = np.array([[12, 12], [14, 12], [14, 14], [12, 14], [12, 12]], float)
    xs, ys = np.meshgrid(np.linspace(-1, 3, 81), np.linspace(-1, 3, 81))
    sq = np.array([[0, 0], [2, 0], [2, 2], [0, 2], [0, 0]], float)
    tri = np.array([[0, 0], [7, 3], [2, 9], [0, 0]], float)
    ts = np.linspace(0.01, 0.99, 1997)
    on = np.concatenate([a + ts[:, None] * (b - a) for a, b in zip(tri[:-1], tri[1:])])
    return [
        (px, py, [shell, hole, part2], [0, 0, 1]),
        (xs.ravel(), ys.ravel(), [sq], [0]),
        (on[:, 0], on[:, 1], [tri], [0]),
    ]


def _zboxes(seed, dims):
    """Ordinal query boxes on a curve of ``dims`` dimensions (one or two
    boxes), with inner boxes shrunk by a few ordinals."""
    rng = np.random.default_rng(seed)
    bits = 31 if dims == 2 else 21
    top = (1 << bits) - 1
    boxes, inner = [], []
    for _ in range(1 + seed % 2):
        lo = rng.integers(0, top // 2, dims)
        hi = lo + rng.integers(1, top // (4 + 8 * (seed % 3)), dims)
        hi = np.minimum(hi, top)
        boxes.append((tuple(int(v) for v in lo), tuple(int(v) for v in hi)))
        inner.append((tuple(int(v) + 3 for v in lo), tuple(int(v) - 3 for v in hi)))
    return bits, boxes, inner


def _xqueries(seed, dims):
    rng = np.random.default_rng(seed)
    qs = []
    for _ in range(int(rng.integers(1, 3))):
        lo = rng.uniform(0, 0.9, dims)
        hi = np.minimum(lo + rng.uniform(0.001, 0.1, dims) ** (1 + seed % 2), 1.0)
        qs.append((tuple(lo), tuple(hi)))
    return qs


def _xz(dims):
    g = 12 if dims == 2 else 10
    return g, TXZSFC(g, dims), JXZSFC(g, dims)


# ------------------------------------------ part 1: against the JAX helpers


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _case_inputs(name, k):
    """(args, kwargs) of helper ``name`` for seeded case ``k``."""
    rng = np.random.default_rng(100 + k)
    if name == "morton2":
        return (rng.integers(0, 1 << 31, 10_000).astype(np.uint64),
                rng.integers(0, 1 << 31, 10_000).astype(np.uint64)), {}
    if name in ("morton3", "morton3_decode"):
        xyz = [rng.integers(0, 1 << 21, 10_000).astype(np.uint64) for _ in range(3)]
        xyz[0][:2] = [0, (1 << 21) - 1]
        return (tuple(xyz) if name == "morton3" else (jn.morton3(*xyz),)), {}
    if name == "z3_write_keys":
        period = ("day", "week")[k % 2]
        x, y, millis = _points(k)
        return (x, y, millis, period, MAX_OFFSET[TimePeriod(period)], MAX_BIN), {}
    if name == "z2_write_keys":
        x, y, _ = _points(k)
        return (x, y), {}
    if name == "sort_bins_z":
        n = 50_000
        bins = rng.integers(0, 6, n).astype(np.int32)
        zs = rng.integers(0, 1 << 62, n, dtype=np.uint64)
        zs[: n // 4] = zs[n // 4 : n // 2]  # key ties: the sort is stable
        return (bins, zs), {}
    if name == "take":
        dt = [np.float32, np.int32, np.int64, np.uint64, np.float64][k % 5]
        src = (rng.standard_normal(30_000) * 1e6).astype(dt)
        return (src, rng.integers(0, len(src), 70_000).astype(np.uint32)), {}
    if name == "take_rows":
        dt = [np.float32, np.float64][k % 2]
        src = rng.standard_normal((20_000, 10)).astype(dt)
        return (src, rng.integers(0, len(src), 90_000).astype(np.uint32)), {}
    if name in ("bitmask_decode_pair", "bitmask_decode"):
        wide, inner, bids = _planes(k, sorted_bids=k % 2 == 0)
        block = wide.shape[1] * 32 * 128
        if name == "bitmask_decode":
            return (wide, bids, len(bids), block), {}
        return (wide, inner, bids, len(bids), block), {}
    if name == "merge_rows_spans":
        return _spans_rows(k), {}
    if name == "counting_argsort":
        return (rng.integers(0, 1024, 100_000).astype(np.int64), 1024), {}
    if name == "zranges":
        dims = 2 + k % 2
        bits, boxes, inner = _zboxes(k, dims)
        mins = np.array([b[0] for b in boxes], np.uint64)
        maxes = np.array([b[1] for b in boxes], np.uint64)
        imins = np.array([b[0] for b in inner], np.uint64)
        imaxes = np.array([b[1] for b in inner], np.uint64)
        return (dims, bits, mins, maxes, imins, imaxes, (64, 2000)[k // 2 % 2], 7), {}
    if name == "xz_index":
        dims = 2 + k % 2
        g, t, _ = _xz(dims)
        lo = rng.uniform(0, 0.98, (20_000, dims))
        hi = lo + rng.uniform(0, 0.02, (20_000, dims)) ** 2
        lo[:5], hi[:5] = 0.0, 1.0  # full-extent elements
        hi[5:10] = lo[5:10]  # point-like elements
        return (lo, hi, dims, g, t.subtree_size), {}
    if name == "xz_ranges":
        dims = 2 + k % 2
        g, t, _ = _xz(dims)
        qs = _xqueries(k, dims)
        return (dims, g, t.subtree_size, np.array([q[0] for q in qs]),
                np.array([q[1] for q in qs]), (50, 200_000)[k // 2 % 2]), {}
    if name == "points_in_polygon":
        return _polygon_cases()[k % 3], {}
    raise KeyError(name)


N_CASES = 4
HELPER_CASES = [(h, k) for h in tn.HELPERS for k in range(N_CASES)]


@pytest.mark.parametrize("name,k", HELPER_CASES, ids=[f"{h}-{k}" for h, k in HELPER_CASES])
def test_helper_equals_jax_helper(name, k):
    args, kw = _case_inputs(name, k)
    before = tn.calls[name]
    got = getattr(tn, name)(*args, **kw)
    ref = getattr(jn, name)(*args, **kw)
    assert got is not None and ref is not None
    _same(got, ref)
    assert tn.calls[name] == before + 1  # one call into the library, counted


def test_repair_loads_the_reference_after_a_lost_build_race(monkeypatch):
    """Fault C7: a worker that lost the JAX loader's unlocked build race
    holds ``_lib = False``; the repair loads the library again, and a
    helper then equals the port's exactly."""
    monkeypatch.setattr(jn, "_lib", False)
    assert not jn.available()
    ensure_jax_native()
    assert jn.available()
    args, kw = _case_inputs("sort_bins_z", 1)
    ref = jn.sort_bins_z(*args, **kw)
    assert ref is not None
    _same(tn.sort_bins_z(*args, **kw), ref)


def test_z3_write_keys_rejects_bad_dates_as_jax_does():
    far = np.array([(MAX_BIN + 10) * 7 * 86_400_000], dtype=np.int64)
    for millis in (np.array([-5]), far):
        args = (np.zeros(1), np.zeros(1), millis, "week", MAX_OFFSET[TimePeriod.WEEK], MAX_BIN)
        with pytest.raises(ValueError):
            jn.z3_write_keys(*args)
        with pytest.raises(ValueError):
            tn.z3_write_keys(*args)


def test_calendar_period_and_out_of_range_keys_take_numpy_as_jax_does():
    args = (np.zeros(1), np.zeros(1), np.array([0]), "month", 1, 1)
    assert tn.z3_write_keys(*args) is None and jn.z3_write_keys(*args) is None
    keys = np.array([0, 5, 1024])
    assert tn.counting_argsort(keys, 1024) is None and jn.counting_argsort(keys, 1024) is None
    assert tn.take(np.zeros(3, np.int16), np.zeros(2, np.uint32)) is None


# -------------------------------------- part 2: against the port's numpy


def test_morton_equals_the_port_curves():
    (x, y), _ = _case_inputs("morton2", 0)
    assert np.array_equal(tn.morton2(x, y), tzo.Z2.index(x, y))
    xyz, _ = _case_inputs("morton3", 1)
    z = tn.morton3(*xyz)
    assert np.array_equal(z, tzo.Z3.index(*xyz))
    for got, want in zip(tn.morton3_decode(z), xyz):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("period", ["day", "week"])
def test_write_keys_equal_the_port_numpy_keys(period):
    x, y, millis = _points(5)
    sft = FeatureType.from_spec("p", "dtg:Date,*geom:Point:srid=4326")
    sft.user_data["geomesa.z3.interval"] = period
    fc = geomesa_tpu_torch.FeatureCollection.from_columns(
        sft, np.arange(len(x)), {"geom": (x, y), "dtg": millis})
    for idx in (Z3Index(sft), Z2Index(sft)):
        calls = tn.calls[f"{idx.name}_write_keys"]
        got = idx.write_keys(fc)
        assert tn.calls[f"{idx.name}_write_keys"] == calls + 1
        with tn.disabled():
            want = idx.write_keys(fc)
        _same((got.bins, got.zs, got.device_cols), (want.bins, want.zs, want.device_cols))


@pytest.mark.parametrize("k", range(3))
def test_sort_bins_z_equals_lexsort(k):
    (bins, zs), _ = _case_inputs("sort_bins_z", k)
    perm = tn.sort_bins_z(bins, zs)
    assert perm.dtype == np.uint32
    assert np.array_equal(perm.astype(np.int64), np.lexsort((zs, bins)))


@pytest.mark.parametrize("name", ["take", "take_rows"])
def test_gathers_equal_numpy_indexing(name):
    for k in range(5 if name == "take" else 2):
        (src, idx), _ = _case_inputs(name, k)
        _same(getattr(tn, name)(src, idx), src[idx.astype(np.int64)])


@pytest.mark.parametrize("k", range(4))
def test_decode_equals_the_port_numpy_decode(k):
    wide, inner, bids = _planes(k, sorted_bids=k % 2 == 0)
    for planes in ((wide, inner), (wide, None)):
        before = tn.calls["bitmask_decode_pair"] + tn.calls["bitmask_decode"]
        got = tbk.decode_bits_pair(*planes, bids, len(bids))
        assert tn.calls["bitmask_decode_pair"] + tn.calls["bitmask_decode"] == before + 1
        with tn.disabled():
            want = tbk.decode_bits_pair(*planes, bids, len(bids))
        _same(got, want)
        assert np.all(np.diff(got[0]) > 0)  # ascending, unsorted bids resorted


@pytest.mark.parametrize("k", range(6))
def test_merge_rows_spans_equals_the_port_numpy_merge(k):
    spans, rows, cert = _spans_rows(k)
    dup = _rows_in_spans(rows, spans)
    want = _merge_sorted_rows(_span_rows(spans), rows[~dup], cert[~dup])
    _same(tn.merge_rows_spans(spans, rows, cert), want)


def test_counting_argsort_equals_a_stable_argsort():
    (keys, nb), _ = _case_inputs("counting_argsort", 0)
    assert np.array_equal(tn.counting_argsort(keys, nb).astype(np.int64), np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("dims", [2, 3])
def test_xz_index_equals_the_port_numpy_index(dims):
    (lo, hi, _, _, _), _ = _case_inputs("xz_index", dims - 2)
    _, t, _ = _xz(dims)
    got = t.index(lo, hi)
    with tn.disabled():
        want = t.index(lo, hi)
    _same(got, want)


@pytest.mark.parametrize("k", range(3))
def test_points_in_polygon_equals_the_port_numpy_ray_cast(k):
    px, py, rings, part = _polygon_cases()[k]
    parts = {}
    for r, p in zip(rings, part):
        parts.setdefault(p, []).append(r)
    polys = [tgeo.Polygon(rs[0], rs[1:]) for rs in parts.values()]
    poly = polys[0] if len(polys) == 1 else tgeo.MultiPolygon(polys)
    before = tn.calls["points_in_polygon"]
    got = tgeo.points_in_polygon(px, py, poly)
    assert tn.calls["points_in_polygon"] == before + 1
    with tn.disabled():
        want = tgeo.points_in_polygon(px, py, poly)
    _same(got, want)


def _covered(ranges, codes) -> np.ndarray:
    lo = np.array([r.lower for r in ranges], np.uint64)
    hi = np.array([r.upper for r in ranges], np.uint64)
    order = np.argsort(lo)
    lo, hi = lo[order], hi[order]
    i = np.searchsorted(lo, codes, side="right") - 1
    ok = i >= 0
    return ok & (codes <= hi[np.clip(i, 0, None)])


@pytest.mark.parametrize("dims", [2, 3])
def test_zranges_cover_every_point_of_the_box_both_ways(dims):
    """The two decompositions may differ (fault C3): each must still cover
    every z-code inside the query box, and contained ranges only hold
    codes inside the inner box."""
    curve = tzo.Z2 if dims == 2 else tzo.Z3
    rng = np.random.default_rng(dims)
    for k in range(4):
        bits, boxes, inner = _zboxes(k, dims)
        zb = [ZBox(lo, hi) for lo, hi in boxes]
        ib = [ZBox(lo, hi) for lo, hi in inner]
        pts = np.concatenate([
            rng.integers(np.array(lo), np.array(hi) + 1, (2000, dims)) for lo, hi in boxes
        ]).astype(np.uint64)
        codes = curve.index(*pts.T).astype(np.uint64)
        for budget in (64, 2000):
            native_r = zranges(curve, zb, budget, inner_boxes=ib)
            with tn.disabled():
                numpy_r = zranges(curve, zb, budget, inner_boxes=ib)
            for rs in (native_r, numpy_r):
                assert _covered(rs, codes).all()
                cont = [r for r in rs if r.contained]
                if cont:
                    inside = np.zeros(len(codes), bool)
                    for lo, hi in inner:
                        inside |= np.all((pts >= np.array(lo, np.uint64)) & (pts <= np.array(hi, np.uint64)), 1)
                    assert not (_covered(cont, codes) & ~inside).any()


@pytest.mark.parametrize("dims", [2, 3])
def test_xz_ranges_cover_every_element_both_ways(dims):
    """XZ ranges, native and numpy: every element that meets a query box
    has its code inside a range."""
    _, t, _ = _xz(dims)
    rng = np.random.default_rng(10 + dims)
    lo = rng.uniform(0, 0.98, (30_000, dims))
    hi = np.minimum(lo + rng.uniform(0, 0.05, (30_000, dims)) ** 2, 1.0)
    codes = t.index(lo, hi).astype(np.uint64)
    for k in range(4):
        qs = _xqueries(k, dims)
        meets = np.zeros(len(lo), bool)
        for qlo, qhi in qs:
            meets |= np.all((lo <= np.array(qhi)) & (hi >= np.array(qlo)), axis=1)
        for budget in (50, 200_000):
            for off in (False, True):
                if off:
                    with tn.disabled():
                        rs = t.ranges([TXElement(a, b) for a, b in qs], budget)
                else:
                    rs = t.ranges([TXElement(a, b) for a, b in qs], budget)
                assert _covered(rs, codes[meets]).all()


def test_xz_ranges_uncapped_equal_the_jax_numpy_pass():
    """Uncapped, the port's native XZ ranges equal the JAX package's
    numpy pass (the reference's own uncapped promise)."""
    for dims in (2, 3):
        _, t, j = _xz(dims)
        for k in range(6):
            qs = _xqueries(k, dims)
            got = t.ranges([TXElement(a, b) for a, b in qs], 200_000)
            saved, jn._lib = jn._lib, False
            try:
                want = j.ranges([JXElement(a, b) for a, b in qs], 200_000)
            finally:
                jn._lib = saved
            assert [(r.lower, r.upper, r.contained) for r in got] == \
                [(r.lower, r.upper, r.contained) for r in want]


# ---------------------------------- part 3: stores, both packages native


def _extent_store(pkg, cell, data, tiered, **kw):
    xz2, rect3, others, t = data
    packed = pkg.geometry.PackedGeometryColumn
    if cell == "xz2":
        sft = pkg.FeatureType.from_spec("ext", "*geom:Polygon:srid=4326")
        cols, n = {"geom": packed.from_boxes(*xz2)}, ext.N_XZ2
    else:
        sft = pkg.FeatureType.from_spec("ext", "dtg:Date,*geom:Geometry:srid=4326")
        col = packed.concat([packed.from_boxes(*rect3),
                             packed.from_geometries(ext._geoms(pkg, others))])
        cols, n = {"geom": col, "dtg": t}, ext.N_RECT3 + ext.N_OTHER3
    ds = pkg.DataStore(tile=ext.TILE, **kw)
    ds.create_schema(sft)
    fc = pkg.FeatureCollection.from_columns(sft, np.arange(n), cols)
    cuts = [0, n * 2 // 3, n] if tiered else [0, n]
    for a, b in zip(cuts[:-1], cuts[1:]):
        ds.write("ext", fc.take(np.arange(a, b)))
    return ds


STORE_CELLS = [f"{c}-{w}" for c in ("z3", "z2", "xz2", "xz3") for w in ("once", "tiered")]


@pytest.fixture(scope="module")
def native_stores():
    pdata, edata = pts._data(n=30_000), ext._data()
    out = {}
    for cell in STORE_CELLS:
        kind, w = cell.split("-")
        if kind in ("z3", "z2"):
            writes = [20_000, 10_000] if w == "tiered" else None
            pair = (pts._build(geomesa_tpu, kind, pdata, writes=writes),
                    pts._build(geomesa_tpu_torch, kind, pdata, writes=writes, device="cpu"))
            out[cell] = ("pts", pair)
        else:
            pair = (_extent_store(geomesa_tpu, kind, edata, w == "tiered"),
                    _extent_store(geomesa_tpu_torch, kind, edata, w == "tiered", device="cpu"))
            out[cell] = ("ext", pair)
    return out


def _store_queries(cell):
    kind = cell.split("-")[0]
    if kind == "z3":
        return pts.TIME_QUERIES
    if kind == "z2":
        return pts.SPATIAL_QUERIES
    boxes = ["bbox(geom, -30, -25, 10, -5)", "bbox(geom, 20, 10, 20.5, 10.25)",
             "bbox(geom, -60, -40, 60, 40)"]
    if kind == "xz3":
        return [f"{b} AND {pts._dur(2, 30)}" for b in boxes] + boxes
    return boxes


@pytest.mark.parametrize("cell", STORE_CELLS)
def test_native_stores_agree_in_order(native_stores, cell):
    assert jn.available() and tn.loaded()
    name, (jds, tds) = native_stores[cell]
    before = dict(tn.calls)
    for q in _store_queries(cell):
        ref = np.asarray(jds.query(name, q).ids).tolist()
        assert np.asarray(tds.query(name, q).ids).tolist() == ref, q
        assert np.asarray(tds.query(name, q, limit=3).ids).tolist() == ref[:3], q
    ranges = "zranges" if cell[0] == "z" else "xz_ranges"
    assert tn.calls[ranges] > before[ranges]


@pytest.mark.parametrize("cell", STORE_CELLS)
def test_native_stores_agree_on_aggregations(native_stores, cell):
    name, (jds, tds) = native_stores[cell]
    env = (-180, -90, 180, 90)
    for q in _store_queries(cell):
        assert tds.count(name, q) == jds.count(name, q), q
        for est in (True, False):
            assert tds.bounds(name, q, estimate=est) == jds.bounds(name, q, estimate=est), q
        got = tds.density(name, q, envelope=env, width=48, height=24)
        assert np.array_equal(got, np.asarray(jds.density(name, q, envelope=env, width=48, height=24))), q
        got = tds.stats_query(name, "Count()", q, estimate=True)
        ref = jds.stats_query(name, "Count()", q, estimate=True)
        assert [s.to_json() for s in got] == [s.to_json() for s in ref], q


# ------------------------------------------------------------- the loader


def test_disabled_routes_to_numpy_and_restores_the_library():
    lib = tn.library()
    bins, zs = np.array([1, 0, 1], np.int32), np.array([3, 2, 1], np.uint64)
    with tn.disabled():
        assert tn.sort_bins_z(bins, zs) is None
        with tn.disabled():
            assert tn.zranges(2, 31, np.zeros(2, np.uint64), np.ones(2, np.uint64),
                              np.zeros(2, np.uint64), np.ones(2, np.uint64), 8, 7) is None
        assert tn.sort_bins_z(bins, zs) is None
    assert tn.library() is lib
    assert tn.sort_bins_z(bins, zs).tolist() == [1, 2, 0]
    with pytest.raises(RuntimeError):
        with tn.disabled():
            raise RuntimeError("inside")
    assert tn.sort_bins_z(bins, zs) is not None


_BUILD_SCRIPT = textwrap.dedent("""
    import sys
    from pathlib import Path
    import numpy as np
    from geomesa_tpu_torch import native
    native.BUILD_DIR = Path(sys.argv[1])
    native.LIB_PATH = native.BUILD_DIR / "libgeomesa_native.so"
    if len(sys.argv) > 2:
        native._SRC = Path(sys.argv[2])
    perm = native.sort_bins_z(np.array([2, 1, 2], np.int32), np.array([5, 9, 4], np.uint64))
    print(perm.tolist())
""")


def _build_proc(*args):
    return subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, *map(str, args)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def test_two_processes_build_into_an_empty_directory_at_once(tmp_path):
    build = tmp_path / "build"
    procs = [_build_proc(build), _build_proc(build)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[1, 2, 0]"
    assert sorted(f.name for f in build.iterdir()) == [".native.lock", "libgeomesa_native.so"]


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" void sort_bins_z( { this is not C++\n')
    p = _build_proc(tmp_path / "build", src)
    out, err = p.communicate(timeout=300)
    assert p.returncode != 0 and not out.strip()
    assert "g++ failed to build the native helpers" in err and "error" in err
