"""The port's write-ahead log and its small dependencies against the JAX
package's, on the CPU.

Inputs are made from a seed with numpy and go through both packages:

- ``utils.spatial_index.BucketIndex`` (insert, bulk point insert,
  remove, query in order), ``io.varint``, ``ingest.sort`` (``sort_chunk``,
  ``shard_runs``, ``distinct_bins``, ``merge_runs``) and the WKB codec
  (``geometry.to_wkb`` / ``from_wkb``) give equal values and bytes;
- ``streaming.wal``: the value codec and ``pack_upsert``, the frame bytes
  and ``_parse_frames``; the same record sequence gives byte-identical
  segment files under each sync policy and across rotation and
  retirement; a log written by either package replays in the other;
  torn tails truncate to the same bytes, checksum damage quarantines the
  same tail with the same ``report.json`` record, and later segments are
  orphaned whole; a crash at each ``stream.wal.*`` fault point leaves
  the same bytes on disk and the same replay; the interval thread ends
  with ``close()``.

No test waits on a wall-clock race: crashes are driven through the fault
points. Tolerance: exact (ids in order, values, bytes).
"""

import json
import os
import shutil
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import fault as jfault
from geomesa_tpu import geometry as jgeo
from geomesa_tpu.ingest import sort as jsort
from geomesa_tpu.io import varint as jvarint
from geomesa_tpu.streaming import wal as jwal
from geomesa_tpu.utils import spatial_index as jsi
from geomesa_tpu_torch import fault as tfault
from geomesa_tpu_torch import geometry as tgeo
from geomesa_tpu_torch.ingest import sort as tsort
from geomesa_tpu_torch.io import varint as tvarint
from geomesa_tpu_torch.streaming import wal as twal
from geomesa_tpu_torch.utils import spatial_index as tsi
from test_torch_native import ensure_jax_native

JAX = SimpleNamespace(name="jax", pkg=geomesa_tpu, geo=jgeo, wal=jwal, fault=jfault,
                      si=jsi, sort=jsort, varint=jvarint)
PORT = SimpleNamespace(name="port", pkg=geomesa_tpu_torch, geo=tgeo, wal=twal, fault=tfault,
                       si=tsi, sort=tsort, varint=tvarint)
BOTH = (JAX, PORT)
WAL_POINTS = ("stream.wal.append", "stream.wal.sync", "stream.wal.rotate",
              "stream.wal.truncate", "stream.wal.replay")


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    # ingest.sort calls both packages' native radix sorts
    ensure_jax_native()


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.setenv("GEOMESA_TPU_IO_BACKOFF_S", "0.0001")
    yield
    jfault.injector().reset()
    tfault.injector().reset()


# ------------------------------------------------------------ small modules


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_index_equal(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    xs, ys = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    keys = [f"k{i}" for i in rng.integers(0, 2000, n)]  # duplicates: later wins
    boxes = [tuple(sorted(rng.uniform(-180, 180, 2))) + tuple(sorted(rng.uniform(-90, 90, 2)))
             for _ in range(40)]
    boxes = [(b[0], b[2], b[1], b[3]) for b in boxes]
    outs = []
    for P in BOTH:
        idx = P.si.BucketIndex(72, 36)
        idx.bulk_insert_points(keys[: n // 2], xs[: n // 2], ys[: n // 2])
        for k, x, y in zip(keys[n // 2 :], xs[n // 2 :], ys[n // 2 :]):
            idx.insert(k, (float(x), float(y), float(x), float(y)))
        for b in boxes[:10]:  # extents over several buckets
            idx.insert(f"e{b[0]:.3f}", b)
        for k in keys[::7]:
            idx.remove(k)
        outs.append(([idx.query(b) for b in boxes], len(idx), sorted(map(str, idx.keys()))))
    assert outs[0] == outs[1]  # ids in the same (bucket) order


def test_varint_equal():
    rng = np.random.default_rng(3)
    vals = [0, 1, 127, 128, 2**31, 2**64 - 1, 2**64 + 5] + rng.integers(0, 2**62, 200).tolist()
    for v in vals:
        jo, to = bytearray(), bytearray()
        jvarint.append_uvarint(jo, v)
        tvarint.append_uvarint(to, v)
        assert bytes(jo) == bytes(to)
        assert tvarint.read_uvarint(bytes(to) + b"x", 0) == jvarint.read_uvarint(bytes(jo) + b"x", 0)
        assert tvarint.read_uvarint(bytes(to), 0)[0] == v & (2**64 - 1)


@pytest.mark.parametrize("shard", [1, 97, 1000, 5000])
def test_ingest_sort_equal(shard):
    rng = np.random.default_rng(shard)
    n = 4000
    bins = rng.integers(0, 6, n).astype(np.int32)
    zs = rng.integers(0, 500, n).astype(np.uint64)  # many ties
    assert np.array_equal(tsort.sort_chunk(bins, zs), jsort.sort_chunk(bins, zs))
    truns = tsort.shard_runs(bins, zs, 10, shard)
    jruns = jsort.shard_runs(bins, zs, 10, shard)
    assert len(truns) == len(jruns)
    for a, b in zip(truns, jruns):
        assert np.array_equal(a.bins, b.bins) and np.array_equal(a.zs, b.zs)
        assert np.array_equal(a.gperm, b.gperm)
    assert np.array_equal(tsort.distinct_bins(truns), jsort.distinct_bins(jruns))
    merged = tsort.merge_runs(truns)
    assert np.array_equal(merged, jsort.merge_runs(jruns))
    # the stable whole-batch sort, offset by the base
    assert np.array_equal(merged, 10 + np.lexsort((zs, bins)))


def _geoms(P, rng):
    g = P.geo
    ring = [(0, 0), (4, 0), (4, 3), (0, 3)]
    hole = [(1, 1), (2, 1), (2, 2), (1, 2)]
    return [
        g.Point(float(rng.uniform(-180, 180)), float(rng.uniform(-90, 90))),
        g.LineString([(0.1, 0.2), (1.5, -2.25), (3.0, 4.0)]),
        g.Polygon(ring, [hole]),
        g.MultiPoint([g.Point(1, 2), g.Point(-3, 4.5)]),
        g.MultiLineString([g.LineString([(0, 0), (1, 1)]), g.LineString([(2, 2), (3, 5)])]),
        g.MultiPolygon([g.Polygon(ring), g.Polygon([(10, 10), (11, 10), (11, 12)])]),
    ]


@pytest.mark.parametrize("k", range(6))
def test_wkb_codec_equal(k):
    jg = _geoms(JAX, np.random.default_rng(k))[k]
    tg = _geoms(PORT, np.random.default_rng(k))[k]
    blob = tgeo.to_wkb(tg)
    assert blob == jgeo.to_wkb(jg)
    back = tgeo.from_wkb(blob)
    assert back.geom_type == jgeo.from_wkb(blob).geom_type
    assert tgeo.to_wkb(back) == blob and tgeo.to_wkt(back) == jgeo.to_wkt(jgeo.from_wkb(blob))


def test_wkb_ewkb_and_big_endian_equal():
    import struct

    srid = struct.pack("<BI", 1, 1 | 0x20000000) + struct.pack("<I", 4326) + struct.pack(
        "<dd", 1.5, -2.5)
    big = struct.pack(">BI", 0, 2) + struct.pack(">I", 2) + struct.pack(">dddd", 0, 1, 2, 3)
    for blob in (srid, big):
        assert tgeo.to_wkt(tgeo.from_wkb(blob)) == jgeo.to_wkt(jgeo.from_wkb(blob))
    bad = struct.pack("<BI", 1, 1001) + struct.pack("<ddd", 1, 2, 3)
    for g in (tgeo, jgeo):
        with pytest.raises(ValueError):
            g.from_wkb(bad)


# --------------------------------------------------------------- the codec


def _rows(P, rng, n, kinds="uniform"):
    g = P.geo
    xs, ys = rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)
    rows = []
    for j in range(n):
        r = {"name": f"n{j % 7}", "dtg": int(1_717_200_000_000 + j),
             "geom": g.Point(float(xs[j]), float(ys[j]))}
        if kinds == "mixed":
            r["extra"] = [None, np.int64(j), np.float32(0.5), b"\x00\xff", True,
                          np.datetime64(1_717_200_000_000 + j, "ms"),
                          g.LineString([(0, 0), (float(xs[j]), float(ys[j]))])][j % 7]
            if j % 5 == 0:
                del r["name"]  # a ragged batch: per-row dicts
        rows.append(r)
    return rows


@pytest.mark.parametrize("kinds", ["uniform", "mixed"])
def test_value_codec_and_pack_upsert_equal(kinds):
    jrows = _rows(JAX, np.random.default_rng(5), 60, kinds)
    trows = _rows(PORT, np.random.default_rng(5), 60, kinds)
    jb = json.dumps(jwal.pack_upsert(jrows), separators=(",", ":"), default=jwal._enc_json)
    tb = json.dumps(twal.pack_upsert(trows), separators=(",", ":"), default=twal._enc_json)
    assert tb == jb
    rec = json.loads(tb)
    back_t, xy_t = twal.unpack_upsert_xy(rec, "geom")
    back_j, xy_j = jwal.unpack_upsert_xy(json.loads(jb), "geom")
    assert (xy_t is None) == (xy_j is None)
    if xy_t is not None:
        assert np.array_equal(xy_t, xy_j)
    assert len(back_t) == len(back_j) == 60
    for a, b in zip(back_t, back_j):
        assert sorted(a) == sorted(b)
        for k in a:
            va, vb = a[k], b[k]
            if isinstance(va, tgeo.Geometry):
                assert tgeo.to_wkb(va) == jgeo.to_wkb(vb)
            elif isinstance(va, np.datetime64):
                assert va == vb
            else:
                assert va == vb and type(va) is type(vb), (k, va, vb)


def test_unencodable_value_raises_before_any_byte(tmp_path):
    for P in BOTH:
        d = tmp_path / P.name
        w = P.wal.WriteAheadLog(str(d), P.wal.WalConfig(sync="off"))
        with pytest.raises(P.wal.WalError):
            w.log_upsert(["a"], [{"v": object()}], 1)
        w.close()
        assert os.path.getsize(d / "wal-00000000000000000000.log") == 0


def test_frames_and_parse_equal():
    rng = np.random.default_rng(6)
    payloads = [json.dumps({"s": i, "k": "d", "ids": [str(v) for v in rng.integers(0, 99, i)]},
                           separators=(",", ":")).encode() for i in range(20)]
    data = b"".join(twal._frame(p) for p in payloads)
    assert data == b"".join(jwal._frame(p) for p in payloads)
    assert twal._parse_frames(data) == jwal._parse_frames(data)
    torn = data[:-3]
    assert twal._parse_frames(torn) == jwal._parse_frames(torn)
    flipped = bytearray(data)
    flipped[len(data) // 2] ^= 0x10
    assert twal._parse_frames(bytes(flipped)) == jwal._parse_frames(bytes(flipped))
    huge = bytearray()
    tvarint.append_uvarint(huge, 1 << 40)
    assert twal._parse_frames(bytes(huge) + b"x") == jwal._parse_frames(bytes(huge) + b"x")
    assert twal._parse_frames(bytes(huge))[1][1] == "checksum"


# ------------------------------------------------------------- the segments


def _drive(P, d, sync, seg_bytes, n_batches=12, checkpoint=True):
    """One seeded record sequence through a log: upserts (uniform and
    ragged), deletes, expiry sweeps, watermarks, a subscription and its
    removal, a term bump and a checkpoint watermark."""
    rng = np.random.default_rng(11)
    w = P.wal.WriteAheadLog(str(d), P.wal.WalConfig(sync=sync, segment_bytes=seg_bytes))
    nid = 0
    for b in range(n_batches):
        rows = _rows(P, rng, 8, "mixed" if b % 4 == 3 else "uniform")
        ids = [f"r{b}_{j}" for j in range(len(rows))]
        nid += len(rows)
        seq = w.log_upsert(ids, rows, nid)
        w.applied(seq)
        if b % 3 == 1:
            w.log_delete(ids[:2])
        if b % 4 == 2:
            w.log_expire(ids[2:3])
        if b % 2 == 0:
            w.log_watermark(ids[3:], bool(b % 4))
        if b == 5:
            w.applied(w.log_subscribe({"id": "s1", "kind": "geofence", "wkt": "POINT (1 2)"}))
        if b == 7:
            w.log_unsubscribe("s1")
            w.log_term(3)
        if checkpoint and b == 9:
            w.checkpoint(w.applied_horizon())
    state = (w.last_seq, w.applied_horizon(), w.term, w.needs_recovery)
    w.close()
    return state


def _files(d) -> dict:
    out = {}
    for base, _, names in os.walk(d):
        for name in names:
            p = os.path.join(base, name)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("sync", ["always", "interval", "off"])
@pytest.mark.parametrize("seg_bytes", [1 << 10, 64 << 20])
def test_segments_byte_identical(tmp_path, sync, seg_bytes):
    states = [_drive(P, tmp_path / P.name, sync, seg_bytes) for P in BOTH]
    assert states[0] == states[1]
    jf, tf = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(tf) == sorted(jf)
    for name in jf:
        assert tf[name] == jf[name], name
    if seg_bytes == 1 << 10:
        # rotated, and the checkpoint retired the covered sealed segments
        assert len(jf) >= 2 and "wal-00000000000000000000.log" not in jf


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_log_replays_in_the_other_package(tmp_path, writer, reader):
    d = tmp_path / "wal"
    _drive(writer, d, "off", 1 << 10)
    shutil.copytree(d, tmp_path / "copy")
    w = reader.wal.WriteAheadLog(str(d))
    got = list(w.replay())
    assert w.term == 3
    w.close()
    ref = writer.wal.WriteAheadLog(str(tmp_path / "copy"))
    want = list(ref.replay())
    ref.close()
    assert got == want and got  # every record past the checkpoint cover
    assert got[0]["s"] > 0 and {r["k"] for r in got} <= {"u", "d", "x", "w", "s"}


def test_reopen_continues_seqnos_and_needs_recovery(tmp_path):
    for P in BOTH:
        d = tmp_path / P.name
        _drive(P, d, "off", 1 << 10, checkpoint=False)
        w = P.wal.WriteAheadLog(str(d))
        assert w.needs_recovery
        seq = w.log_delete(["x"])
        w.close()
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")


def test_torn_tail_truncates_alike(tmp_path):
    for P in BOTH:
        d = tmp_path / P.name
        _drive(P, d, "off", 64 << 20, checkpoint=False)
        seg = d / "wal-00000000000000000000.log"
        data = seg.read_bytes()
        seg.write_bytes(data[:-5])  # a frame cut mid-write
        w = P.wal.WriteAheadLog(str(d))
        w.close()
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")


def _report(root) -> list:
    p = os.path.join(root, "_quarantine", "report.json")
    recs = json.load(open(p))["damage"]
    for r in recs:
        r.pop("time")
    return recs


def test_checksum_damage_quarantines_and_orphans_alike(tmp_path):
    outs = []
    for P in BOTH:
        root = tmp_path / P.name
        d = root / "_wal"
        _drive(P, d, "off", 1 << 10, checkpoint=False)
        segs = sorted(os.listdir(d))
        assert len(segs) >= 4
        p = d / segs[1]
        data = bytearray(p.read_bytes())
        data[len(data) // 2] ^= 0x20
        p.write_bytes(bytes(data))
        w = P.wal.WriteAheadLog(str(d))
        recs = list(w.replay())
        damage = [(r.type_name, r.file, r.reason, r.quarantined_to) for r in w.damage]
        w.close()
        outs.append((recs, damage, _report(root), _files(root)))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1]
    reasons = [r[2] for r in outs[1][1]]
    assert reasons[0] == "checksum" and set(reasons[1:]) == {"orphaned"}
    assert outs[0][2] == outs[1][2]  # report.json, record for record
    files = {k: v for k, v in outs[1][3].items() if not k.endswith("report.json")}
    assert files == {k: v for k, v in outs[0][3].items() if not k.endswith("report.json")}


@pytest.mark.parametrize("point", WAL_POINTS)
def test_crash_at_each_wal_point_alike(tmp_path, point):
    """A crash at the point (its first hit past the opening records) in both
    packages: the same bytes on disk, the same replay afterwards."""
    outs = []
    for P in BOTH:
        d = tmp_path / P.name
        _drive(P, d, "always", 1 << 10, n_batches=6, checkpoint=False)
        if point == "stream.wal.truncate":
            seg = sorted(os.listdir(d))[-1]
            data = (d / seg).read_bytes()
            (d / seg).write_bytes(data[:-3])
        raised, w = False, None
        with P.fault.inject(point, kind="crash", times=1):
            try:
                w = P.wal.WriteAheadLog(str(d), P.wal.WalConfig(sync="always",
                                                                segment_bytes=1 << 10))
                rng = np.random.default_rng(4)
                for b in range(6):
                    w.applied(w.log_upsert([f"z{b}_{j}" for j in range(8)],
                                           _rows(P, rng, 8), 100 + b))
                list(w.replay())
            except P.fault.InjectedCrash:
                raised = True
        if w is not None:
            w.crash()
        w2 = P.wal.WriteAheadLog(str(d))
        recs = list(w2.replay())
        w2.close()
        outs.append((raised, recs, _files(d)))
    assert outs[0][0] and outs[1][0]
    assert outs[0][1] == outs[1][1]
    assert outs[0][2] == outs[1][2]


def test_failed_append_does_not_pin_horizon(tmp_path):
    for P in BOTH:
        w = P.wal.WriteAheadLog(str(tmp_path / P.name), P.wal.WalConfig(sync="always"))
        with P.fault.inject("stream.wal.sync", kind="io_error", times=None):
            with pytest.raises(OSError):
                w.log_upsert(["a"], [{"v": 1}], 1)
        assert w.applied_horizon() == w.last_seq == 0
        w.close()


def test_interval_thread_ends_with_close_and_terms_are_monotonic(tmp_path):
    for P in BOTH:
        before = set(threading.enumerate())
        w = P.wal.WriteAheadLog(str(tmp_path / P.name),
                                P.wal.WalConfig(sync="interval", sync_interval_ms=1e6))
        mine = [t for t in threading.enumerate() if t not in before]
        assert [t.name for t in mine] == ["geomesa-wal-sync"]
        seq = w.log_delete(["a"])
        assert w.synced_seq < seq  # buffered until the interval elapses
        w.sync()
        assert w.synced_seq == seq
        w.log_term(2)
        with pytest.raises(P.wal.WalError):
            w.log_term(2)
        st = w.ship_state()
        assert st["term"] == 2 and st["horizon"] == w.last_seq
        assert [s[2] for s in st["segments"]] == [False]
        w.close()
        mine[0].join(5)
        assert not mine[0].is_alive()
        with pytest.raises(P.wal.WalError):
            w.log_delete(["b"])
