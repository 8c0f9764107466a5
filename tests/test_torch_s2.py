"""The port's S2 curve and its S2 / S3 indexes (curve/s2.py, index/s2.py)
against the JAX package's, on the CPU.

- the curve: leaf and coarse cell ids, the inversion to cell centers and
  the leaf-id range of a cell, bit for bit, on seeded points and on the
  six cube faces, the poles, +-180 and points on face edges (faces 4 and
  5 set bit 63 of the key); ``S2SFC.ranges`` equal lists for seeded boxes,
  boxes that cross faces and boxes that hit the ``max_cells`` budget;
- opt-in indexes: ``geomesa.indices.enabled`` naming ``s2`` / ``s3``
  builds the reference's index lists (``s2`` alone raised in the port
  before S2 was ported), and the default list stays ``["z3", "z2"]``;
- stores: S2 + S3 stores with rows on every face equal the JAX package's
  ids in order and under ``limit`` after a write, a compaction, a
  ``fold_upsert``, a ``BulkLoader`` load and a persist round trip (each
  package loading the other's save); keys stay unsigned through each;
  open-ended time predicates clamp to the S3 index's ``bin_range``.

Tolerance: exact everywhere (keys, range lists, ids in order).
"""

import numpy as np
import pytest

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu.curve import s2 as js2
from geomesa_tpu_torch.curve import s2 as ts2
from test_torch_native import ensure_jax_native
from test_torch_serving_tier import JAX, PORT

T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
# the face edges: lon +-45 / +-135 split the equatorial faces, lat
# atan(1/sqrt(2)) ~ 35.26 is the polar faces' reach
EDGE = float(np.degrees(np.arctan(1 / np.sqrt(2))))


@pytest.fixture(autouse=True)
def _native():
    ensure_jax_native()


def _special_points():
    lon = [0.0, 90.0, 180.0, -180.0, -90.0, 0.0, 0.0, 45.0, -45.0, 135.0, -135.0,
           45.0, 45.0, 12.5, -170.0, 179.999999, -179.999999, 0.0, 0.0, 90.0, -90.0,
           180.0, -180.0, 200.0, -200.0]
    lat = [0.0, 0.0, 0.0, 0.0, 0.0, 90.0, -90.0, 0.0, 0.0, 0.0, 0.0,
           EDGE, -EDGE, 89.999999, -89.999999, 10.0, -10.0, 45.0, -45.0, 60.0, -60.0,
           90.0, -90.0, 95.0, -95.0]
    return np.array(lon), np.array(lat)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    sx, sy = _special_points()
    return np.concatenate([sx, x]), np.concatenate([sy, y])


@pytest.mark.parametrize("level", [30, 17, 5, 0])
def test_cell_ids_inversion_and_ranges_bit_for_bit(level):
    x, y = _points(5000, seed=level)
    x, y = np.clip(x, -180, 180), np.clip(y, -90, 90)
    a = js2.cell_id_from_lonlat(x, y, level)
    b = ts2.cell_id_from_lonlat(x, y, level)
    assert b.dtype == np.uint64 and np.array_equal(a, b)
    if level == 30:
        # every face is hit, and faces 4 and 5 set bit 63
        faces = np.unique(b >> np.uint64(61))
        assert faces.tolist() == [0, 1, 2, 3, 4, 5]
        assert ((b >> np.uint64(63)) == 1).sum() > 0
    for fa, fb in zip(js2.cell_center_lonlat(a), ts2.cell_center_lonlat(b)):
        assert np.array_equal(fa, fb)
    for ra, rb in zip(js2.cell_range(a), ts2.cell_range(b)):
        assert np.array_equal(ra, rb)
    i = np.arange(len(x), dtype=np.uint64) % np.uint64(1 << 30)
    face = np.arange(len(x), dtype=np.uint64) % np.uint64(6)
    assert np.array_equal(js2.cell_id_from_face_ij(face, i, i[::-1], level),
                          ts2.cell_id_from_face_ij(face, i, i[::-1], level))


def test_sfc_index_clamps_like_the_reference():
    x, y = _special_points()
    assert np.array_equal(js2.S2SFC().index(x, y), ts2.S2SFC().index(x, y))
    assert np.array_equal(js2.S2SFC().invert(js2.S2SFC().index(x, y))[0],
                          ts2.S2SFC().invert(ts2.S2SFC().index(x, y))[0])


def _boxes():
    rng = np.random.default_rng(11)
    out = [(-30, 20, 40, 60), (-180, -90, 180, 90), (100, -89, 179, -30), (-10, 30, 10, 50),
           (40, -10, 50, 10), (130, -5, 140, 5), (-140, 30, -130, 40), (-1, 85, 1, 90),
           (-180, -90, -179, -89), (170, -20, 180, 20), (-50, -40, -40, -30), (0, 0, 0, 0)]
    for _ in range(20):
        x0, y0 = rng.uniform(-180, 170), rng.uniform(-90, 80)
        w, h = rng.uniform(0.001, 60), rng.uniform(0.001, 40)
        out.append((x0, y0, min(x0 + w, 180), min(y0 + h, 90)))
    return out


@pytest.mark.parametrize("kw", [
    {}, {"max_cells": 8}, {"max_cells": 64}, {"min_level": 4, "max_level": 20, "level_mod": 2},
    {"max_level": 10},
])
def test_range_lists_equal(kw):
    ja, ta = js2.S2SFC(**kw), ts2.S2SFC(**kw)
    boxes = _boxes()
    for box in boxes + [boxes[:3], boxes[3:9]]:
        bounds = box if isinstance(box, list) else [box]
        ra, rb = ja.ranges(bounds), ta.ranges(bounds)
        assert [(r.lower, r.upper, r.contained) for r in ra] == \
            [(r.lower, r.upper, r.contained) for r in rb], (kw, box)
    if kw.get("max_cells") == 8:
        # the budget bounds the cover
        assert len(ta.ranges([(-170, -80, 170, 80)])) <= 8 * 6
    for sfc in (ja, ta):
        with pytest.raises(ValueError):
            sfc.ranges([(10, 0, -10, 5)])


def _sft(P, enabled=None, name="s2t", spec=SPEC):
    sft = P.pkg.FeatureType.from_spec(name, spec)
    if enabled is not None:
        sft.user_data["geomesa.indices.enabled"] = enabled
    return sft


@pytest.mark.parametrize("enabled,want", [
    ("s2", ["s2"]), ("s3", ["s3"]), ("s3,s2", ["s3", "s2"]), ("z3,s2", ["z3", "s2"]),
    ("z2,s3,attr", ["z2", "s3"]), (None, ["z3", "z2"]),
])
def test_enabled_indexes_build_the_reference_lists(enabled, want):
    """``enabled=s2`` raised ``no supported index`` in the port before the
    S2 indexes were ported."""
    for P in (JAX, PORT):
        ds = P.pkg.DataStore(**P.kw)
        ds.create_schema(_sft(P, enabled))
        assert [i.name for i in ds.indexes("s2t")] == want, P.name
    # a spec string's user data carries the same switch
    ds = PORT.pkg.DataStore(**PORT.kw)
    ds.create_schema(PORT.pkg.FeatureType.from_spec(
        "p", "dtg:Date,*geom:Point:srid=4326;geomesa.indices.enabled=s2"))
    assert [i.name for i in ds.indexes("p")] == ["s2"]


def test_index_priorities():
    from geomesa_tpu.planning.planner import INDEX_PRIORITY as J
    from geomesa_tpu_torch.planning.planner import INDEX_PRIORITY as T

    assert T == J and T["s3"] == 1.2 and T["s2"] == 2.1


def _fc(P, sft, n, seed, prefix="r"):
    x, y = _points(n, seed)
    m = len(x)
    rng = np.random.default_rng(seed + 1)
    return P.pkg.FeatureCollection.from_columns(
        sft, [f"{prefix}{i}" for i in range(m)],
        {"name": np.array([f"n{i % 7}" for i in range(m)]),
         "dtg": T0 + rng.integers(0, 20 * DAY, m),
         "geom": (np.clip(x, -180, 180), np.clip(y, -90, 90))},
    )


QUERIES = (
    "bbox(geom, -30, 20, 40, 60)",
    "bbox(geom, -180, -90, 180, 90)",
    "bbox(geom, 100, -89, 179, -30)",
    "bbox(geom, -1, 80, 1, 90)",
    "bbox(geom, -60, -40, 60, 40) AND dtg DURING 2024-01-03T00:00:00Z/2024-01-12T00:00:00Z",
    "bbox(geom, 120, -90, 180, -30) AND dtg DURING 2024-01-01T00:00:00Z/2024-01-05T00:00:00Z",
    "dtg AFTER 2024-01-10T00:00:00Z",
    "bbox(geom, -170, -80, -100, 80) AND name = 'n3'",
    "dtg BEFORE 2024-01-04T00:00:00Z AND bbox(geom, -90, -90, 90, 0)",
)


def _assert_same(jd, td, name="s2t"):
    for q in QUERIES:
        a = jd.query(name, q)
        b = td.query(name, q)
        assert b.ids.tolist() == a.ids.tolist(), q
        assert jd.explain(name, q).splitlines()[-1] == td.explain(name, q).splitlines()[-1], q
        la = jd.query(name, q, limit=7).ids.tolist()
        assert td.query(name, q, limit=7).ids.tolist() == la, q
    for idx in ("s3", "s2"):
        try:
            tt, jt = td.table(name, idx), jd.table(name, idx)
        except KeyError:
            continue
        # a tiered table's keys: the main table's, then the delta's
        zs = getattr(tt, "main", tt).zs
        assert zs.dtype == np.uint64 and np.array_equal(zs, getattr(jt, "main", jt).zs)
        if hasattr(tt, "delta"):
            assert tt.delta.zs.dtype == np.uint64
            assert np.array_equal(tt.delta.zs, jt.delta.zs)


def _pair(enabled="s3,s2", n=3000, seed=5, **kw):
    out = []
    for P in (JAX, PORT):
        ds = P.pkg.DataStore(tile=64, **P.kw, **kw)
        sft = _sft(P, enabled)
        ds.create_schema(sft)
        ds.write("s2t", _fc(P, sft, n, seed))
        out.append(ds)
    return out


@pytest.mark.parametrize("enabled", ["s3,s2", "s2", "s3"])
def test_store_ids_in_order_after_write_and_compaction(enabled):
    jd, td = _pair(enabled)
    _assert_same(jd, td)
    # a second write lands in the delta tier, a compaction folds it in
    for P, ds in ((JAX, jd), (PORT, td)):
        ds.write("s2t", _fc(P, ds.get_schema("s2t"), 700, seed=9, prefix="b"))
    _assert_same(jd, td)
    for ds in (jd, td):
        ds.compact("s2t")
    _assert_same(jd, td)
    # open-ended time predicates clamp to the bins present
    assert td.indexes("s2t")[0].name != "s3" or td.indexes("s2t")[0].bin_range == \
        jd.indexes("s2t")[0].bin_range


def test_store_fold_upsert_and_stats():
    jd, td = _pair()
    for P, ds in ((JAX, jd), (PORT, td)):
        sft = ds.get_schema("s2t")
        # half new ids, half updates of rows already stored (moved points)
        ds.fold_upsert("s2t", _fc(P, sft, 600, seed=21, prefix="r"))
        ds.fold_upsert("s2t", _fc(P, sft, 300, seed=22, prefix="u"))
    _assert_same(jd, td)
    for q in QUERIES[:4]:
        assert td.estimate_count("s2t", q) == jd.estimate_count("s2t", q), q
        assert td.count("s2t", q) == jd.count("s2t", q), q


@pytest.mark.parametrize("workers", [1, 2])
def test_store_bulk_loader(workers):
    from importlib import import_module

    stores = []
    for P in (JAX, PORT):
        ingest = import_module(P.name + ".ingest")
        ds = P.pkg.DataStore(tile=64, **P.kw)
        sft = _sft(P, "s3,s2")
        ds.create_schema(sft)
        loader = ingest.BulkLoader(ds, "s2t", config=ingest.PipelineConfig(workers=workers))
        for k in range(3):
            loader.put(_fc(P, sft, 900, seed=30 + k, prefix=f"c{k}-"))
        assert loader.close().written == 3 * (900 + len(_special_points()[0]))
        stores.append(ds)
    _assert_same(*stores)


def test_store_persist_round_trip_both_ways(tmp_path):
    from geomesa_tpu.storage import persist as jp
    from geomesa_tpu_torch.storage import persist as tp

    jd, td = _pair()
    jp.save(jd, str(tmp_path / "j"))
    tp.save(td, str(tmp_path / "t"))
    cross = [
        (jp.load(str(tmp_path / "t")), tp.load(str(tmp_path / "j"), device="cpu")),
        (jp.load(str(tmp_path / "j")), tp.load(str(tmp_path / "t"), device="cpu")),
    ]
    for a, b in cross:
        assert [i.name for i in b.indexes("s2t")] == ["s3", "s2"]
        _assert_same(a, b)
        # the live store holds the same rows (rows whose keys tie, as the
        # clamped +-180 / +-90 points do, may order otherwise after a load)
        for q in QUERIES:
            assert sorted(b.query("s2t", q).ids.tolist()) == sorted(jd.query("s2t", q).ids.tolist())


def test_s3_open_ended_time_clamps_to_bin_range():
    jd, td = _pair("s3")
    js, ts = jd.indexes("s2t")[0], td.indexes("s2t")[0]
    assert ts.bin_range is not None and ts.bin_range == js.bin_range
    q = "dtg AFTER 2024-01-02T00:00:00Z"
    cj = jd.planner.plan("s2t", q).config
    ct = td.planner.plan("s2t", q).config
    assert ct.n_ranges == cj.n_ranges
    assert np.array_equal(ct.windows, cj.windows)
    assert len(np.unique(ct.range_bins)) <= ts.bin_range[1] - ts.bin_range[0] + 1


def test_port_modules_import_nothing_of_the_jax_package():
    import subprocess
    import sys

    code = ("import sys, geomesa_tpu_torch.index.s2, geomesa_tpu_torch.curve.s2\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('geomesa_tpu.')"
            " or m == 'geomesa_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=geomesa_tpu_torch.__path__[0] + "/..")
    assert out.stdout.strip() == "[]", out.stderr[-2000:]
    assert geomesa_tpu.__name__ == "geomesa_tpu"
