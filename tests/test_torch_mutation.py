"""The port's mutation surface against the JAX DataStore, both on the CPU.

The same seeded operation sequence runs on a JAX ``geomesa_tpu.DataStore``
and a port ``geomesa_tpu_torch.DataStore`` (device="cpu"): a write, a
write kept in the delta tier, ``delete_features``, ``upsert``,
``modify_features`` (dates, point and extent geometries, a string wider
than the stored width, None on a float), ``age_off`` with an explicit
TTL and both ``geomesa.feature.expiry`` forms, and ``fold_upsert`` as an
append with no replaced id, monolithic, sliced with a small
``slice_rows`` and presorted. Cells: points on Z3 + Z2 with packed time
off and on, and extents on XZ3 + XZ2. After every operation both stores
must hold the same rows in the same order (ids and every column), each
index table the same sort state (``perm``, ``bins``, ``zs``, ``ubins``,
``bin_starts``), the same ``cols3`` and the same delta tier, and queries
(box, window, polygon, id lists) the same ids in order.

``merged_table`` and ``folded_table`` are also called directly on both
packages' tables of the same keys, with the device fold plan
(``geomesa.stream.fold.device``) on and off in both: sort state,
``cols3``, ``rows_uploaded`` and ``rows_sorted`` must agree. ``warmup()``
must issue the JAX package's number of kernel calls; the upsert rollback,
the refused lossy cast, ``parse_expiry_ms`` and ``delete_schema`` /
``type_names`` are held to the JAX package's too. The JAX package's C++
host helpers are off, so both take the same numpy ranges and sorts, and
both packages plan at most 100 covering ranges a query
(``geomesa.scan.ranges.target``), which keeps host planning short; the
results are exact either way. Tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu_torch import native as tnative
from geomesa_tpu import conf as jconf
from geomesa_tpu.storage import table as jtable
from geomesa_tpu_torch import conf as tconf
from geomesa_tpu_torch.storage import table as ttable

# one intra-op thread per test process (the suite runs several side by side)
torch.set_num_threads(1)

N0, N1 = 16_000, 2_000  # the first write, then one kept in the delta tier
TILE = 4096
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
POINT_SPEC = "age:Integer,name:String,score:Double,dtg:Date,*geom:Point:srid=4326"
EXTENT_SPEC = "age:Integer,name:String,score:Double,dtg:Date,*geom:Polygon:srid=4326"
CELLS = {
    "z3": (POINT_SPEC, {}),
    "z3-packed": (POINT_SPEC, {"geomesa.z3.packed-time": "true"}),
    "xz": (EXTENT_SPEC, {}),
}


@pytest.fixture(scope="module", autouse=True)
def _planning():
    from geomesa_tpu import native

    jconf.SCAN_RANGES_TARGET.set(100)
    tconf.SCAN_RANGES_TARGET.set(100)
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        yield
    jconf.SCAN_RANGES_TARGET.clear()
    tconf.SCAN_RANGES_TARGET.clear()


def _dur(d0, d1):
    lo = np.datetime64(T0 + d0 * DAY, "ms")
    hi = np.datetime64(T0 + d1 * DAY, "ms")
    return f"dtg DURING {lo}Z/{hi}Z"


POLY = "POLYGON ((-20 -20, 25 -15, 20 25, -15 20, -20 -20))"
QUERIES = [
    f"bbox(geom, -40, -30, 30, 40) AND {_dur(2, 9)}",
    "bbox(geom, 60, -45, 120, 10)",
    _dur(3, 6),
    f"INTERSECTS(geom, {POLY}) AND {_dur(5, 12)}",
    "IN ('5', '17', '40', '2000', '15999', '16500', '17999', '30001', '30333')",
]


class Rows:
    """Seeded rows of one cell: ids, positions, times and attributes."""

    def __init__(self, seed, n, id0, t_lo=0, t_hi=28):
        rng = np.random.default_rng(seed)
        self.ids = np.arange(id0, id0 + n)
        self.x = rng.uniform(-180, 180, n)
        self.y = rng.uniform(-85, 85, n)
        self.w = rng.uniform(1e-3, 2.0, n)
        self.h = rng.uniform(1e-3, 2.0, n)
        self.t = T0 + rng.integers(t_lo * DAY, t_hi * DAY, n)
        self.age = rng.integers(0, 100, n).astype(np.int32)
        self.name = np.array([f"n{i % 97}" for i in range(n)])
        self.score = rng.normal(0, 10, n)

    def take(self, ids):
        """These rows under other ids (a replacement batch)."""
        out = Rows.__new__(Rows)
        out.__dict__.update({k: v[: len(ids)] for k, v in self.__dict__.items()})
        out.ids = np.asarray(ids)
        return out

    def fc(self, pkg, sft):
        cols = {"age": self.age, "name": self.name, "score": self.score, "dtg": self.t}
        if sft.is_points:
            cols["geom"] = (self.x, self.y)
        else:
            x1 = np.minimum(self.x + self.w, 180.0)
            y1 = np.minimum(self.y + self.h, 90.0)
            cols["geom"] = pkg.geometry.PackedGeometryColumn.from_boxes(
                self.x, self.y, x1, y1)
        return pkg.FeatureCollection.from_columns(sft, self.ids, cols)


def _store(pkg, cell, **kw):
    spec, ud = CELLS[cell]
    sft = pkg.FeatureType.from_spec("t", spec)
    sft.user_data.update(ud)
    ds = pkg.DataStore(tile=TILE, **kw)
    ds.create_schema(sft)
    return ds


def _col_state(col) -> list:
    if hasattr(col, "bboxes"):
        return [col.coords, col.ring_offsets, col.part_ring_offsets,
                col.geom_part_offsets, col.types, col.bboxes]
    if hasattr(col, "x"):
        return [col.x, col.y]
    return [np.asarray(col)]


def _table_state(t) -> dict:
    main = getattr(t, "main", t)
    out = {k: np.asarray(getattr(main, k)) for k in ("perm", "bins", "zs", "ubins", "bin_starts")}
    out.update({f"cols3.{k}": np.asarray(v) for k, v in main.cols3.items()})
    if main is not t:  # the delta tier
        out.update({"delta.bins": t.delta.bins, "delta.zs": t.delta.zs,
                    "delta.base": np.asarray(t.base)})
        out.update({f"delta.{k}": v for k, v in t.delta.device_cols.items()})
    return out


def _snapshot(ds) -> dict:
    fc = ds.features("t")
    snap = {"ids": np.asarray(fc.ids), "rows": np.asarray(ds.row_count("t"))}
    for name, col in fc.columns.items():
        for i, a in enumerate(_col_state(col)):
            snap[f"col.{name}.{i}"] = a
    for idx in ds.indexes("t"):
        for k, v in _table_state(ds.table("t", idx.name)).items():
            snap[f"{idx.name}.{k}"] = v
    for i, q in enumerate(QUERIES):
        snap[f"query{i}"] = np.asarray(ds.query("t", q).ids)
    snap["query0.limit5"] = np.asarray(ds.query("t", QUERIES[0], limit=5).ids)
    return snap


def _assert_same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), k


def _point(pkg, cell, x, y, d=1.0):
    g = pkg.geometry
    if CELLS[cell][0] == POINT_SPEC:
        return g.Point(x, y)
    return g.Polygon(np.array([[x, y], [x + d, y], [x + d, y + d], [x, y + d], [x, y]]))


def _presorted(ds, fc):
    """index name -> the batch's stable (bin, z) argsort (a flusher's
    shard-sort stage)."""
    out = {}
    for idx in ds.indexes("t"):
        k = idx.write_keys(fc)
        out[idx.name] = np.lexsort((k.zs, k.bins))
    return out


def _ops(cell):
    """(step name, op(pkg, ds)) of the sequence; each op returns what the
    store's method returned."""
    base = Rows(1, N0 + N1, 0)
    first, second = base.take(base.ids[:N0]), Rows(1, N0 + N1, 0)
    for k, v in list(second.__dict__.items()):
        setattr(second, k, v[N0:])
    rng = np.random.default_rng(9)
    old = rng.choice(N0 + N1, 5_000, replace=False)  # live ids to replace

    def batch(seed, n_old, n_new, id_new, sel):
        ids = np.concatenate([old[sel][:n_old], id_new + np.arange(n_new)])
        return Rows(seed, len(ids), 0, t_lo=14, t_hi=28).take(ids)

    ups = batch(11, 300, 100, 30_000, slice(0, 300))
    fold_new = Rows(12, 800, 40_000, t_lo=20, t_hi=28)
    mono = batch(13, 600, 200, 50_000, slice(300, 900))
    sliced = batch(14, 900, 300, 60_000, slice(900, 1800))
    pre = batch(15, 700, 300, 70_000, slice(1800, 2500))

    def sft(ds):
        return ds.get_schema("t")

    def expiry(spec):
        def op(pkg, ds):
            sft(ds).user_data["geomesa.feature.expiry"] = spec
            return ds.age_off("t", now_ms=T0 + 28 * DAY)
        return op

    return [
        ("write", lambda pkg, ds: ds.write("t", first.fc(pkg, sft(ds)))),
        ("delta-write", lambda pkg, ds: ds.write("t", second.fc(pkg, sft(ds)))),
        ("delete", lambda pkg, ds: ds.delete_features("t", "bbox(geom, -30, -20, 30, 25)")),
        ("upsert", lambda pkg, ds: ds.upsert("t", ups.fc(pkg, sft(ds)))),
        ("modify-date", lambda pkg, ds: ds.modify_features(
            "t", {"dtg": T0 + 3 * DAY}, f"bbox(geom, 60, -50, 120, 10) AND {_dur(10, 20)}")),
        ("modify-geometry", lambda pkg, ds: ds.modify_features(
            "t", {"geom": _point(pkg, cell, 12.5, -7.25)}, "bbox(geom, -150, 30, -110, 60)")),
        ("modify-string-and-null", lambda pkg, ds: ds.modify_features(
            "t", {"name": "a-name-wider-than-stored", "score": None}, _dur(6, 7))),
        ("age-off-ttl", lambda pkg, ds: ds.age_off("t", ttl_ms=26 * DAY, now_ms=T0 + 28 * DAY)),
        ("age-off-plain-spec", expiry("25 days")),
        ("age-off-dtg-spec", expiry("dtg(24 days)")),
        ("fold-append", lambda pkg, ds: ds.fold_upsert("t", fold_new.fc(pkg, sft(ds)))),
        ("fold-monolithic", lambda pkg, ds: ds.fold_upsert(
            "t", mono.fc(pkg, sft(ds)), slice_rows=0)),
        ("fold-sliced", lambda pkg, ds: ds.fold_upsert(
            "t", sliced.fc(pkg, sft(ds)), slice_rows=250)),
        ("fold-presorted", lambda pkg, ds: ds.fold_upsert(
            "t", pre.fc(pkg, sft(ds)), slice_rows=300,
            keys={i.name: i.write_keys(pre.fc(pkg, sft(ds))) for i in ds.indexes("t")},
            presorted=_presorted(ds, pre.fc(pkg, sft(ds))))),
    ]


STEPS = [name for name, _ in _ops("z3")]


@pytest.fixture(scope="module")
def runs():
    """cell -> [(step, JAX result, port result, JAX snapshot, port
    snapshot, JAX fold report, port fold report)] of the whole
    sequence."""
    from geomesa_tpu import native

    out = {}
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        for cell in CELLS:
            jds = _store(geomesa_tpu, cell)
            tds = _store(geomesa_tpu_torch, cell, device="cpu")
            steps = []
            for name, op in _ops(cell):
                jr, tr = op(geomesa_tpu, jds), op(geomesa_tpu_torch, tds)
                steps.append((name, jr, tr, _snapshot(jds), _snapshot(tds),
                              jds.last_fold_report, tds.last_fold_report))
            out[cell] = (steps, jds, tds)
        yield out


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("step", range(len(STEPS)), ids=STEPS)
def test_operation_leaves_the_store_equal_to_jax(runs, cell, step):
    name, jr, tr, js, ts, jrep, trep = runs[cell][0][step]
    assert jr == tr, name
    _assert_same(js, ts)
    if name.startswith("fold") and name != "fold-append":
        assert trep["rows"] == jrep["rows"] and trep["slices"] == jrep["slices"]
        assert len(trep["slice_s"]) == trep["slices"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_sequence_really_mutates(runs, cell):
    """Each step changed what it names: rows removed, rows added, the
    delta tier kept and merged, the folds sliced as asked."""
    steps = {s[0]: s for s in runs[cell][0]}
    rows = {k: int(s[4]["rows"]) for k, s in steps.items()}
    assert rows["delta-write"] == N0 + N1
    assert "z2.delta.base" in steps["delta-write"][4] or "xz2.delta.base" in steps[
        "delta-write"][4]
    assert steps["delete"][2] > 0 and rows["delete"] == N0 + N1 - steps["delete"][2]
    assert rows["upsert"] >= rows["delete"] + 100  # 100 new ids, some old ones deleted
    for k in ("modify-date", "modify-geometry", "modify-string-and-null"):
        assert steps[k][2] > 0, k
    for k in ("age-off-ttl", "age-off-plain-spec", "age-off-dtg-spec"):
        assert steps[k][2] > 0, k
    assert steps["fold-sliced"][6]["slices"] == 5
    assert steps["fold-presorted"][6]["slices"] == 4
    assert steps["fold-monolithic"][6]["slices"] == 1
    assert rows["fold-presorted"] >= rows["fold-sliced"] + 300


def test_sliced_fold_callbacks_and_progress_equal_jax():
    """``on_slice`` gets each published slice's ids, ``pacer`` runs between
    slices, and a query run there sees the applied prefix (its explain
    names the slice) in both packages."""
    rows = Rows(51, 8_000, 0)
    batch = Rows(52, 1_000, 0, t_lo=20).take(np.concatenate(
        [np.arange(0, 6_000, 10), 9_000 + np.arange(400)]))
    q = QUERIES[0]
    seen = []
    for pkg, kw in ((geomesa_tpu, {}), (geomesa_tpu_torch, {"device": "cpu"})):
        ds = _store(pkg, "z3", **kw)
        ds.write("t", rows.fc(pkg, ds.get_schema("t")))
        slices, paced = [], []

        def pacer(ds=ds, paced=paced):
            exp = pkg.planning.explain.Explainer()
            ids = np.asarray(ds.query("t", q, explain=exp).ids)
            line = next(ln for ln in exp.render().splitlines() if "fold in progress" in ln)
            paced.append((line.strip(), ids.tolist(), ds.row_count("t")))

        ds.fold_upsert("t", batch.fc(pkg, ds.get_schema("t")), slice_rows=300,
                       pacer=pacer, on_slice=slices.append)
        seen.append((slices, paced, _snapshot(ds)))
    (jsl, jpa, js), (tsl, tpa, ts) = seen
    assert tsl == jsl and len(tsl) == 4 and sum(map(len, tsl)) == 1_000
    assert tpa == jpa and len(tpa) == 3
    assert [p[0] for p in tpa] == [f"Streaming fold in progress: slice {k}/4" for k in (1, 2, 3)]
    _assert_same(js, ts)


def test_warmup_issues_the_jax_call_count(runs):
    for cell in CELLS:
        _, jds, tds = runs[cell]
        assert tds.warmup("t") == jds.warmup("t") > 0


@pytest.mark.parametrize("cell", ["z3", "xz"])
def test_upsert_rolls_back_when_the_write_fails(cell):
    from geomesa_tpu import native

    rows = Rows(21, 6_000, 0)
    ups = Rows(22, 50, 0).take(np.arange(100, 150))
    snaps = []
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        for pkg, kw in ((geomesa_tpu, {}), (geomesa_tpu_torch, {"device": "cpu"})):
            ds = _store(pkg, cell, **kw)
            ds.write("t", rows.fc(pkg, ds.get_schema("t")))
            write, calls = ds.write, []

            def failing(*a, write=write, calls=calls, **k):
                calls.append(1)
                if len(calls) == 1:
                    raise RuntimeError("write failed")
                return write(*a, **k)

            mp.setattr(ds, "write", failing)
            with pytest.raises(RuntimeError, match="write failed"):
                ds.upsert("t", ups.fc(pkg, ds.get_schema("t")))
            assert len(calls) == 2  # the failed write, then the rollback
            assert ds.row_count("t") == 6_000
            assert np.array_equal(np.sort(np.asarray(ds.features("t").ids)), np.arange(6_000))
            snaps.append(_snapshot(ds))
    _assert_same(*snaps)


@pytest.mark.parametrize("cell", ["z3", "xz"])
def test_refused_modifications_leave_the_store_untouched(cell):
    from geomesa_tpu import native

    rows = Rows(23, 5_000, 0)
    snaps = []
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        for pkg, kw in ((geomesa_tpu, {}), (geomesa_tpu_torch, {"device": "cpu"})):
            ds = _store(pkg, cell, **kw)
            ds.write("t", rows.fc(pkg, ds.get_schema("t")))
            before = _snapshot(ds)
            with pytest.raises(TypeError, match="does not fit"):
                ds.modify_features("t", {"dtg": T0, "age": 3.5}, "bbox(geom, 0, 0, 90, 90)")
            if cell == "z3":
                with pytest.raises(TypeError, match="stores points"):
                    ds.modify_features("t", {"geom": _point(pkg, "xz", 1, 1)}, "bbox(geom, 0, 0, 9, 9)")
            with pytest.raises(KeyError):
                ds.modify_features("t", {"nope": 1}, "bbox(geom, 0, 0, 90, 90)")
            with pytest.raises(ValueError, match="duplicate"):
                ds.upsert("t", rows.take(np.array([3, 3])).fc(pkg, ds.get_schema("t")))
            after = _snapshot(ds)
            _assert_same(before, after)
            snaps.append(after)
    _assert_same(*snaps)


@pytest.mark.parametrize("spec", [
    "7 days", "24 hours", "30 minutes", "90 seconds", "500 ms", "1000", "dtg(7 days)",
    "2 weeks", "3 m", "5 h", "1 d", "90 s", "30 min", "1 week", " 12  hours ",
])
def test_parse_expiry_ms_equals_jax(spec):
    from geomesa_tpu.datastore import parse_expiry_ms as jparse

    from geomesa_tpu_torch.datastore import parse_expiry_ms as tparse

    assert tparse(spec, dtg_field="dtg") == jparse(spec, dtg_field="dtg") > 0


@pytest.mark.parametrize("spec", ["other(7 days)", "seven days", "7 fortnights", ""])
def test_parse_expiry_ms_refuses_what_jax_refuses(spec):
    from geomesa_tpu.datastore import parse_expiry_ms as jparse

    from geomesa_tpu_torch.datastore import parse_expiry_ms as tparse

    for parse in (jparse, tparse):
        with pytest.raises(ValueError):
            parse(spec, dtg_field="dtg")


def test_age_off_needs_a_ttl_and_a_time_attribute():
    for pkg, kw in ((geomesa_tpu, {}), (geomesa_tpu_torch, {"device": "cpu"})):
        ds = pkg.DataStore(tile=TILE, **kw)
        ds.create_schema("p", "*geom:Point:srid=4326")
        ds.create_schema("q", "dtg:Date,*geom:Point:srid=4326")
        with pytest.raises(ValueError, match="no ttl_ms"):
            ds.age_off("q")
        with pytest.raises(ValueError, match="no time attribute"):
            ds.age_off("p", ttl_ms=1000)


def test_delete_schema_and_type_names_equal_jax():
    from geomesa_tpu import native

    rows = Rows(31, 3_000, 0)
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        pair = []
        for pkg, kw in ((geomesa_tpu, {}), (geomesa_tpu_torch, {"device": "cpu"})):
            ds = _store(pkg, "z3", **kw)
            ds.create_schema("other", "dtg:Date,*geom:Point:srid=4326")
            ds.create_schema("b", "*geom:Point:srid=4326")
            ds.write("t", rows.fc(pkg, ds.get_schema("t")))
            assert ds.type_names() == ["b", "other", "t"]
            ds.delete_schema("other")
            ds.delete_schema("t")
            assert ds.type_names() == ["b"]
            with pytest.raises(KeyError):
                ds.query("t", "bbox(geom, 0, 0, 10, 10)")
            # the name is free again, and the new schema starts empty
            ds2 = ds.create_schema("t", POINT_SPEC)
            assert ds.row_count("t") == 0 and ds2.name == "t"
            ds.write("t", rows.fc(pkg, ds.get_schema("t")))
            pair.append(ds)
        _assert_same(*(_snapshot(ds) for ds in pair))


# -- the compaction paths on both packages' tables -------------------------


def _keys(pkg, cell, rows):
    ds = _store(pkg, cell, **({} if pkg is geomesa_tpu else {"device": "cpu"}))
    fc = rows.fc(pkg, ds.get_schema("t"))
    return ds.indexes("t"), fc


def _concat(pkg, parts):
    return pkg.storage.delta.concat_keys(parts)


def _masked(pkg, keys, keep):
    return pkg.index.api.WriteKeys(
        bins=keys.bins[keep], zs=keys.zs[keep],
        device_cols={k: v[keep] for k, v in keys.device_cols.items()})


def _assert_tables_equal(jt, tt):
    for k in ("perm", "bins", "zs", "ubins", "bin_starts"):
        a, b = np.asarray(getattr(jt, k)), np.asarray(getattr(tt, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert sorted(jt.cols3) == sorted(tt.cols3)
    for k in jt.cols3:
        assert np.array_equal(np.asarray(jt.cols3[k]), tt.cols3[k].numpy()), k
    assert jt.rows_uploaded == tt.rows_uploaded
    assert jt.rows_sorted == tt.rows_sorted


def _tables(cell, old_rows, new_rows, keep):
    """Per index and package: (old table, merged keys, delta keys,
    keep mask, ordinal map) over the same seeded rows."""
    out = {}
    for pkg, tbl in ((geomesa_tpu, jtable), (geomesa_tpu_torch, ttable)):
        indexes, old_fc = _keys(pkg, cell, old_rows)
        _, new_fc = _keys(pkg, cell, new_rows)
        for idx in indexes:
            ok, dk = idx.write_keys(old_fc), idx.write_keys(new_fc)
            kw = {} if pkg is geomesa_tpu else {"device": "cpu"}
            old = tbl.IndexTable(idx, ok, tile=TILE, **kw)
            survivors = ok if keep is None else _masked(pkg, ok, keep)
            out.setdefault(idx.name, []).append((old, _concat(pkg, [survivors, dk]), dk))
    return out


@pytest.mark.parametrize("cell", list(CELLS))
def test_merged_table_equals_jax(cell):
    from geomesa_tpu import native

    old_rows = Rows(41, 14_000, 0)
    # recent rows: they merge into the last bins, so a prefix is reused
    new_rows = Rows(42, 3_000, 14_000, t_lo=24, t_hi=28)
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        for name, pair in _tables(cell, old_rows, new_rows, None).items():
            (jold, jm, jd), (told, tm, td) = pair
            jt = jtable.merged_table(jold, jm, jd, tile=TILE)
            tt = ttable.merged_table(told, tm, td, tile=TILE)
            _assert_tables_equal(jt, tt)
            assert tt.rows_sorted == 3_000 and tt.perm.dtype == np.uint32
            if name in ("z3", "xz3"):
                # new rows only in the last days: the prefix blocks stay the old table's
                assert tt.rows_uploaded < tt.n_pad, name
            first = (tt.n_pad - tt.rows_uploaded) // tt.block
            for k in tt.cols3:
                assert torch.equal(tt.cols3[k][:first], told.cols3[k][:first])


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("mode", ["off", "on"])
def test_folded_table_equals_jax(cell, mode):
    from geomesa_tpu import native

    old_rows = Rows(43, 14_000, 0)
    new_rows = Rows(44, 2_500, 14_000, t_lo=22, t_hi=28)
    rng = np.random.default_rng(45)
    keep = np.ones(14_000, bool)
    keep[rng.choice(14_000, 1_500, replace=False)] = False
    ordinal_map = np.cumsum(keep, dtype=np.int64) - 1
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        jconf.STREAM_FOLD_DEVICE.set(mode)
        tconf.STREAM_FOLD_DEVICE.set(mode)
        try:
            for name, pair in _tables(cell, old_rows, new_rows, keep).items():
                (jold, jm, jd), (told, tm, td) = pair
                for delta_perm in (None, np.lexsort((td.zs, td.bins))):
                    jt = jtable.folded_table(jold, jm, keep, ordinal_map, jd,
                                             delta_perm=delta_perm, tile=TILE)
                    tt = ttable.folded_table(told, tm, keep, ordinal_map, td,
                                             delta_perm=delta_perm, tile=TILE)
                    _assert_tables_equal(jt, tt)
                    assert tt.rows_sorted == 2_500 and tt.perm.dtype == np.uint32
                    if mode == "on":  # only the batch crosses to the device
                        assert tt.rows_uploaded == 2_500
                    else:
                        assert tt.rows_uploaded == tt.n_pad  # deletes start in block 0
                # the two builds agree bit for bit
                tconf.STREAM_FOLD_DEVICE.set("off" if mode == "on" else "on")
                other = ttable.folded_table(told, tm, keep, ordinal_map, td, tile=TILE)
                tconf.STREAM_FOLD_DEVICE.set(mode)
                for k in tt.cols3:
                    assert torch.equal(other.cols3[k], tt.cols3[k])
        finally:
            jconf.STREAM_FOLD_DEVICE.clear()
            tconf.STREAM_FOLD_DEVICE.clear()


def test_folded_table_without_deletes_reuses_the_prefix():
    """A fold that only inserts (keep_ordinal None) and a CPU table under
    the default 'auto' (the host gather): blocks before the first
    insertion are the old table's, and the rest equals a full build."""
    from geomesa_tpu import native

    old_rows = Rows(46, 14_000, 0)
    new_rows = Rows(47, 1_000, 14_000, t_lo=26, t_hi=28)
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        for name, pair in _tables("z3", old_rows, new_rows, None).items():
            (jold, jm, jd), (told, tm, td) = pair
            jt = jtable.folded_table(jold, jm, None, None, jd, tile=TILE)
            tt = ttable.folded_table(told, tm, None, None, td, tile=TILE)
            _assert_tables_equal(jt, tt)
            if name == "z3":
                assert tt.rows_uploaded < tt.n_pad
            full = ttable.IndexTable(told.keyspace, tm, tile=TILE, device="cpu")
            for k in tt.cols3:
                assert torch.equal(full.cols3[k], tt.cols3[k])
