"""The names the port once left out, held against the JAX package.

tests/test_torch_surface.py finds a name the port lacks; this file holds
each name ported for it against the reference on the same seeded inputs,
with exact equality:

- the package exports (``AttributeDescriptor``; ``curve.XZ2SFC`` /
  ``XZ3SFC``; ``planning.QueryPlanner`` / ``QueryPlan`` / ``Explainer``;
  ``storage.IndexTable``; ``scan.aggregations`` / ``block_kernels``; the
  20 names of ``filter``), each the object of its module, and ``parse``
  giving the reference's trees;
- ``curve``: ``Z2SFC`` / ``Z3SFC.normalize`` and ``invert`` on 10^5
  points, ``NormalizedDimension.denormalize`` / ``bin_min`` /
  ``bin_max``, ``BinnedTime.bin_start_millis``, ``max_mask``,
  ``zranges.ranges_to_arrays``;
- ``FeatureType.index_of``, ``geometry.pad_polygon`` (holed polygon,
  MultiPolygon, the cap), ``predicates.GeometryColumn``;
- ``HostTable.perm`` / ``candidate_spans_split`` / ``scan`` / ``density``
  against the reference's ``HostAdapter`` store, ``SortedKeys.pad_cols``;
- ``block_kernels.decode_bits`` on seeded planes (native and numpy in
  both) and the column-set constants;
- ``ServingConfig.from_properties``, ``StreamingFeatureCache.clear``,
  ``native.available``, ``DataStore.COMPACT_MIN_ROWS`` and the class
  defaults ``server`` / ``accuracy``.
"""

import importlib

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import native as jnative
from geomesa_tpu.curve import binnedtime as jbt
from geomesa_tpu.curve import normalize as jnorm
from geomesa_tpu.curve import z2sfc as jz2
from geomesa_tpu.curve import z3sfc as jz3
from geomesa_tpu.curve import zorder as jzo
from geomesa_tpu.curve import zranges as jzr
from geomesa_tpu.scan import block_kernels as jbk
from geomesa_tpu.storage import adapter as jadapter
from geomesa_tpu_torch import native as tnative
from geomesa_tpu_torch.curve import binnedtime as tbt
from geomesa_tpu_torch.curve import normalize as tnorm
from geomesa_tpu_torch.curve import z2sfc as tz2
from geomesa_tpu_torch.curve import z3sfc as tz3
from geomesa_tpu_torch.curve import zorder as tzo
from geomesa_tpu_torch.curve import zranges as tzr
from geomesa_tpu_torch.scan import block_kernels as tbk
from geomesa_tpu_torch.storage import adapter as tadapter
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
N_POINTS = 100_000
PERIODS = ["day", "week", "month", "year"]


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# -- package exports ----------------------------------------------------------

EXPORTS = {
    "": ["AttributeDescriptor", "DataStore", "FeatureCollection", "FeatureType"],
    "curve": ["XZ2SFC", "XZ3SFC"],
    "planning": ["QueryPlanner", "QueryPlan", "Explainer"],
    "storage": ["IndexTable"],
    "scan": ["aggregations", "block_kernels"],
    "filter": ["parse", "parse_dt_millis", "Bounds", "Contains", "DWithin", "EXCLUDE",
               "Exclude", "FilterValues", "IdFilter", "In", "Interval", "IsNull", "Like",
               "PointColumn", "Within", "extract_attribute_bounds", "extract_geometries",
               "extract_ids", "extract_intervals", "geometry_bounds"],
}


def _where(pkg, name) -> str:
    """The module the reference's package imports ``name`` from."""
    ref = importlib.import_module(f"geomesa_tpu{'.' + pkg if pkg else ''}")
    obj = getattr(ref, name)
    return obj.__name__ if hasattr(obj, "__path__") or type(obj).__name__ == "module" \
        else getattr(obj, "__module__", None) or type(obj).__module__


@pytest.mark.parametrize("pkg", sorted(EXPORTS))
def test_package_exports_are_their_modules_objects(pkg):
    port = importlib.import_module(f"geomesa_tpu_torch{'.' + pkg if pkg else ''}")
    for name in EXPORTS[pkg]:
        assert name in port.__all__
        src = _where(pkg, name).replace("geomesa_tpu", "geomesa_tpu_torch", 1)
        obj = getattr(port, name)
        if type(obj).__name__ == "module":
            assert obj.__name__ == src
        else:
            assert obj is getattr(importlib.import_module(src), name), (pkg, name)


FILTERS = [
    "bbox(geom, -10, -5, 10, 5) AND dtg DURING 2024-01-01T00:00:00Z/2024-01-02T00:00:00Z",
    "CONTAINS(geom, POINT(1 2)) OR WITHIN(geom, POLYGON((0 0, 4 0, 4 4, 0 4, 0 0)))",
    "DWITHIN(geom, POINT(0 0), 10, kilometers) AND name LIKE 'a%'",
    "name IN ('a', 'b') AND NOT (age IS NULL)",
    "IN ('1', '2') OR EXCLUDE",
]


@pytest.mark.parametrize("ecql", FILTERS)
def test_filter_exports_parse_and_extract_as_the_reference(ecql):
    jf, tf = geomesa_tpu.filter.parse(ecql), geomesa_tpu_torch.filter.parse(ecql)
    assert repr(tf) == repr(jf)
    assert repr(geomesa_tpu_torch.filter.extract_ids(tf)) == repr(
        geomesa_tpu.filter.extract_ids(jf))
    assert repr(geomesa_tpu_torch.filter.extract_intervals(tf, "dtg")) == repr(
        geomesa_tpu.filter.extract_intervals(jf, "dtg"))
    assert geomesa_tpu_torch.filter.parse_dt_millis("2024-01-02T03:04:05Z") == \
        geomesa_tpu.filter.parse_dt_millis("2024-01-02T03:04:05Z")


def test_attribute_descriptor_export():
    spec = "name:String:index=true,age:Integer,dtg:Date,*geom:Point:srid=4326"
    t = geomesa_tpu_torch.FeatureType.from_spec("t", spec)
    j = geomesa_tpu.FeatureType.from_spec("t", spec)
    assert all(isinstance(a, geomesa_tpu_torch.AttributeDescriptor) for a in t.attributes)
    assert [repr(a) for a in t.attributes] == [repr(a) for a in j.attributes]


# -- curve --------------------------------------------------------------------


def _points(seed, max_offset=None):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, N_POINTS)
    y = rng.uniform(-90, 90, N_POINTS)
    t = None if max_offset is None else rng.uniform(0, max_offset, N_POINTS)
    return x, y, t


@pytest.mark.parametrize("period", PERIODS)
def test_z3sfc_normalize_and_invert_equal_the_reference(period):
    j, t = jz3.Z3SFC.for_period(period), tz3.Z3SFC.for_period(period)
    x, y, off = _points(3, float(jbt.MAX_OFFSET[jbt.TimePeriod.parse(period)]))
    for a, b in zip(t.normalize(x, y, off), j.normalize(x, y, off)):
        _equal(a, b)
    z = j.index(x, y, off)
    _equal(t.index(x, y, off), z)
    for a, b in zip(t.invert(z), j.invert(z)):
        _equal(a, b)


def test_z2sfc_normalize_and_invert_equal_the_reference():
    j, t = jz2.Z2SFC(), tz2.Z2SFC()
    x, y, _ = _points(2)
    for a, b in zip(t.normalize(x, y), j.normalize(x, y)):
        _equal(a, b)
    z = j.index(x, y)
    for a, b in zip(t.invert(z), j.invert(z)):
        _equal(a, b)


@pytest.mark.parametrize("make", ["lon", "lat", "time"])
def test_normalized_dimension_bins_equal_the_reference(make):
    def build(mod, precision):
        if make == "time":
            return mod.NormalizedTime(precision, 604_800.0)
        return (mod.NormalizedLon if make == "lon" else mod.NormalizedLat)(precision)

    rng = np.random.default_rng(5)
    for precision in (21, 31):
        j, t = build(jnorm, precision), build(tnorm, precision)
        i = rng.integers(0, j.max_index + 1, 10_000)
        for name in ("denormalize", "bin_min", "bin_max"):
            _equal(getattr(t, name)(i), getattr(j, name)(i))
        _equal(t.denormalize(t.normalize(t.bin_min(i))), j.denormalize(j.normalize(j.bin_min(i))))


@pytest.mark.parametrize("period", PERIODS)
def test_bin_start_millis_equals_the_reference(period):
    bins = np.random.default_rng(9).integers(0, 3000, 1000).astype(np.int32)
    _equal(tbt.BinnedTime(period).bin_start_millis(bins),
           jbt.BinnedTime(period).bin_start_millis(bins))


def test_max_mask_equals_the_reference():
    assert (tzo.Z2.max_mask, tzo.Z3.max_mask) == (jzo.Z2.max_mask, jzo.Z3.max_mask)


def test_ranges_to_arrays_equals_the_reference():
    boxes = [(-20.0, -10.0, 40.0, 35.0), (100.0, 0.0, 101.5, 1.0)]
    times = [(0.0, 200_000.0)]
    j = jz3.Z3SFC.for_period("week").ranges(boxes, times)
    t = tz3.Z3SFC.for_period("week").ranges(boxes, times)
    assert len(j) > 10
    for a, b in zip(tzr.ranges_to_arrays(t), jzr.ranges_to_arrays(j)):
        _equal(a, b)
    for a, b in zip(tzr.ranges_to_arrays([]), jzr.ranges_to_arrays([])):
        _equal(a, b)


# -- schema and geometry ------------------------------------------------------


def test_index_of_equals_the_reference():
    spec = "a:String,b:Integer,dtg:Date,*geom:Point:srid=4326"
    t = geomesa_tpu_torch.FeatureType.from_spec("t", spec)
    j = geomesa_tpu.FeatureType.from_spec("t", spec)
    for name in ("a", "b", "dtg", "geom"):
        assert t.index_of(name) == j.index_of(name)
    with pytest.raises(KeyError):
        t.index_of("missing")


def _polygons(geo):
    ring = [(0, 0), (10, 0), (10, 10), (0, 10), (0, 0)]
    hole = [(2, 2), (4, 2), (4, 4), (2, 4), (2, 2)]
    holed = geo.Polygon(np.array(ring, float), [np.array(hole, float)])
    star = geo.Polygon(np.array([(20, 0), (24, 8), (28, 0), (20, 5), (28, 5), (20, 0)],
                                float))
    return [holed, geo.MultiPolygon([holed, star])]


@pytest.mark.parametrize("which", [0, 1])
def test_pad_polygon_equals_the_reference(which):
    j = _polygons(geomesa_tpu.geometry)[which]
    t = _polygons(geomesa_tpu_torch.geometry)[which]
    for max_verts in (16, 64):
        for a, b in zip(geomesa_tpu_torch.geometry.pad_polygon(t, max_verts),
                        geomesa_tpu.geometry.pad_polygon(j, max_verts)):
            _equal(a, b)
    with pytest.raises(ValueError) as terr:
        geomesa_tpu_torch.geometry.pad_polygon(t, 4)
    with pytest.raises(ValueError) as jerr:
        geomesa_tpu.geometry.pad_polygon(j, 4)
    assert str(terr.value) == str(jerr.value)


def test_geometry_column_alias_equals_the_reference():
    assert geomesa_tpu_torch.filter.predicates.GeometryColumn == \
        geomesa_tpu.filter.predicates.GeometryColumn


# -- storage ------------------------------------------------------------------

HOST_SPEC = "name:String:index=true,dtg:Date,*geom:Point:srid=4326"
DURING = " AND dtg DURING 2024-01-03T00:00:00Z/2024-01-12T00:00:00Z"
HOST_QUERIES = [
    "bbox(geom, -40, -20, 40, 20)",
    "bbox(geom, 0, 0, 90, 45)",
    "INTERSECTS(geom, POLYGON((0 0, 60 0, 30 40, 0 0)))",
]
# (index, query): z2 serves the spatial filters, z3 the same with a window
HOST_CASES = [("z2", q) for q in HOST_QUERIES] + [("z3", q + DURING) for q in HOST_QUERIES]


def _host_store(pkg, adapter, **kw):
    n = 6000
    rng = np.random.default_rng(21)
    cols = {
        "name": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "dtg": T0 + rng.integers(0, 30 * DAY, n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
    }
    ds = pkg.DataStore(adapter=adapter, tile=64, **kw)
    ds.create_schema(pkg.FeatureType.from_spec("t", HOST_SPEC))
    ds.write("t", pkg.FeatureCollection.from_columns(
        ds.get_schema("t"), [str(i) for i in range(n)], cols))
    return ds


@pytest.fixture(scope="module")
def host_stores():
    return (_host_store(geomesa_tpu_torch, tadapter.HostAdapter(), device="cpu"),
            _host_store(geomesa_tpu, jadapter.HostAdapter()))


def _index(ds, name):
    return next(i for i in ds.indexes("t") if i.name == name)


@pytest.mark.parametrize("index, q", HOST_CASES)
def test_host_table_surface_equals_the_reference(host_stores, index, q):
    tds, jds = host_stores
    tt, jt = tds.table("t", index), jds.table("t", index)
    assert type(tt) is tadapter.HostTable and type(jt) is jadapter.HostTable
    assert tt.extent == jt.extent
    _equal(tt.perm, jt.perm)
    tcfg = _index(tds, index).scan_config(geomesa_tpu_torch.filter.ecql.parse(q))
    jcfg = _index(jds, index).scan_config(geomesa_tpu.filter.ecql.parse(q))
    assert tcfg is not None and jcfg is not None
    assert tt.candidate_spans_split(tcfg) == jt.candidate_spans_split(jcfg)
    for a, b in zip(tt.scan(tcfg), jt.scan(jcfg)):
        _equal(a, b)
    envelope = (-180.0, -90.0, 180.0, 90.0)
    grid = tt.density(tcfg, envelope, 64, 32)
    _equal(grid, np.asarray(jt.density(jcfg, envelope, 64, 32)))
    assert float(np.asarray(grid).sum()) == tt.count(tcfg)


@pytest.fixture(scope="module")
def device_stores():
    return (_host_store(geomesa_tpu_torch, None, device="cpu"), _host_store(geomesa_tpu, None))


@pytest.mark.parametrize("index", ["z3", "z2", "attr_name"])
def test_pad_cols_equals_the_reference(device_stores, index):
    tds, jds = device_stores
    tt, jt = tds.table("t", index), jds.table("t", index)
    [tkeys], [jkeys] = tds._key_chunks[("t", index)], jds._key_chunks[("t", index)]
    for n_pad in (jt.n, jt.n_pad, jt.n_pad + 100):
        tcols, jcols = tt.pad_cols(tkeys, n_pad), jt.pad_cols(jkeys, n_pad)
        assert sorted(tcols) == sorted(jcols)
        for k in jcols:
            _equal(tcols[k], jcols[k])


# -- scan ---------------------------------------------------------------------


def _planes(seed, m=7, pack=4):
    r = np.random.default_rng(seed)
    plane = r.integers(-2**31, 2**31, (m, pack, 128), dtype=np.int64).astype(np.int32)
    plane[r.random((m, pack, 128)) < 0.5] = 0
    return plane


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("bids", [[0, 2, 5, 9, 11, 0, 0], [9, 2, 11, 0, 5, 0, 0]])
def test_decode_bits_equals_the_reference(monkeypatch, native, bids):
    bids = np.array(bids, np.int32)
    if not native:
        monkeypatch.setattr(jnative, "_lib", False)
    for seed in range(3):
        plane = _planes(seed)
        for n_real in (0, 1, 5):
            want = jbk.decode_bits(plane, bids, n_real)
            if native:
                got = tbk.decode_bits(plane, bids, n_real)
            else:
                with tnative.disabled():
                    got = tbk.decode_bits(plane, bids, n_real)
            _equal(got, want)


def test_column_sets_equal_the_reference():
    for name in ("POINT_COLS", "POINT_TIME_COLS", "EXTENT_COLS", "EXTENT_TIME_COLS"):
        assert getattr(tbk, name) == getattr(jbk, name)


# -- serving, streaming, native, the store ------------------------------------


def test_serving_config_from_properties_equals_the_reference():
    from geomesa_tpu import conf as jconf
    from geomesa_tpu.serving.scheduler import ServingConfig as JConfig
    from geomesa_tpu_torch import conf as tconf
    from geomesa_tpu_torch.serving.scheduler import ServingConfig as TConfig

    fields = ("window_ms", "queue_max", "batch_max")
    assert [getattr(TConfig.from_properties(), f) for f in fields] == \
        [getattr(JConfig.from_properties(), f) for f in fields]
    try:
        for c in (jconf, tconf):
            c.SERVING_WINDOW_MS.set(7.5)
            c.SERVING_BATCH_MAX.set(11)
        t, j = TConfig.from_properties(), JConfig.from_properties()
        assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
        assert (t.window_ms, t.batch_max) == (7.5, 11)
    finally:
        for c in (jconf, tconf):
            c.SERVING_WINDOW_MS.clear()
            c.SERVING_BATCH_MAX.clear()


def test_streaming_cache_clear_equals_the_reference():
    from geomesa_tpu.streaming import StreamingFeatureCache as JCache
    from geomesa_tpu_torch.streaming import StreamingFeatureCache as TCache

    out = []
    for pkg, cls in ((geomesa_tpu, JCache), (geomesa_tpu_torch, TCache)):
        sft = pkg.FeatureType.from_spec("s", "k:String,*geom:Point:srid=4326")
        cache = cls(sft)
        events = []
        cache.listeners.append(lambda ev, fid, row, events=events: events.append((ev, fid)))
        rng = np.random.default_rng(4)
        cache.upsert([{"k": f"k{i}", "geom": pkg.geometry.Point(*rng.uniform(-50, 50, 2))}
                      for i in range(40)], ids=[str(i) for i in range(40)])
        before = sorted(cache.query("bbox(geom, -20, -20, 20, 20)").ids)
        cache.clear()
        after = cache.query("bbox(geom, -50, -50, 50, 50)")
        out.append((events, before, len(after)))
    assert out[0] == out[1]
    assert out[1][2] == 0 and len(out[1][1]) > 0


def test_native_available_is_false_only_inside_disabled():
    assert tnative.available() is True and tnative.loaded()
    with tnative.disabled():
        assert tnative.available() is False
    assert tnative.available() is jnative.available() is True


def test_compact_min_rows_and_class_defaults_equal_the_reference():
    from geomesa_tpu import conf as jconf
    from geomesa_tpu_torch import conf as tconf

    t, j = geomesa_tpu_torch.DataStore(device="cpu"), geomesa_tpu.DataStore()
    assert t.COMPACT_MIN_ROWS == j.COMPACT_MIN_ROWS
    try:
        for c in (jconf, tconf):
            c.COMPACT_MIN_ROWS.set(1234)
        assert t.COMPACT_MIN_ROWS == j.COMPACT_MIN_ROWS == 1234
    finally:
        for c in (jconf, tconf):
            c.COMPACT_MIN_ROWS.clear()
    for name in ("server", "accuracy"):
        assert getattr(geomesa_tpu_torch.DataStore, name) is None
        assert getattr(geomesa_tpu.DataStore, name) is None
    assert t.server is None and j.server is None
    assert type(t.accuracy).__name__ == type(j.accuracy).__name__ == "EstimateAccuracy"


@pytest.mark.parametrize("threshold", [5, 1_000_000])
def test_compact_min_rows_override_drives_the_write_path(threshold):
    """A subclass that overrides ``COMPACT_MIN_ROWS`` moves the write
    path's compaction threshold, in the port as in the reference."""
    class T(geomesa_tpu_torch.DataStore):
        COMPACT_MIN_ROWS = threshold

    class J(geomesa_tpu.DataStore):
        COMPACT_MIN_ROWS = threshold

    rng = np.random.default_rng(7)
    x, y = rng.uniform(-180, 180, 72), rng.uniform(-90, 90, 72)
    dtg = T0 + rng.integers(0, 30 * DAY, 72)
    mains = []
    for store, pkg in ((T(device="cpu"), geomesa_tpu_torch), (J(), geomesa_tpu)):
        sft = pkg.FeatureType.from_spec("t", "dtg:Date,*geom:Point:srid=4326")
        store.create_schema(sft)
        for s in (slice(0, 56), slice(56, 72)):  # 16 delta rows on a 56-row main
            store.write("t", pkg.FeatureCollection.from_columns(
                sft, np.arange(s.start, s.stop).astype(str),
                {"dtg": dtg[s], "geom": (x[s], y[s])}))
        mains.append(store._main_rows["t"])
    assert mains == [72 if threshold < 16 else 56] * 2

