"""The port's LambdaStore (streaming/store.py, flush.py) against the JAX
package's, on the CPU.

- Two seeded 25-step sequences run through both packages' LambdaStore:
  ``write`` (updates of cold ids and new ids), ``delete``, ``expire``,
  ``flush`` (incremental, below and above ``fold_rows``, the fold sliced),
  the legacy flush and ``persist_hot``. After every step four queries
  give the same ids in order and the same values through
  ``LambdaStore.query``, and the cold tier gives the same ids under a
  ``limit``; the hot and cold row counts agree. Each sequence runs
  without and with a write-ahead log; with one, the store is crashed at
  the end and recovered, and the recovered store answers as the live
  one in both packages.
- A fault at ``streaming.persist`` (and at ``stream.flush.parse``, the
  flusher's first stage) leaves the cold tier intact and the hot rows
  resident, and at ``streaming.evict`` leaves rows in both tiers,
  returned once; the next flush converges, alike in both packages.
- ``checkpoint`` -> crash -> ``recover`` equals the never-crashed store
  for roots and logs written by either package and recovered by either,
  a subscription record's body surviving the port's next checkpoint.
- ``HealthMonitor(lam=)``, ``ops_report(lam=)`` and ``serve_ops()`` give
  the JAX package's verdicts (``hot.occupancy`` raised and cleared,
  ``wal.needs_recovery``), the constructor refuses an unreplayed log,
  ``serve(port=)`` raises ``NotImplementedError`` naming its ROADMAP
  item while ``standing``/``subscribe``/``unsubscribe`` work (held to
  the JAX package in ``tests/test_torch_standing.py``), and ``close()``
  ends every thread the tier started.

Tolerance: exact.
"""

import json
import os
import threading
import time
import urllib.request
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import fault as jfault
from geomesa_tpu import geometry as jgeo
from geomesa_tpu import streaming as jstream
from geomesa_tpu.obs import ops as jops
from geomesa_tpu.storage import persist as jpersist
from geomesa_tpu_torch import fault as tfault
from geomesa_tpu_torch import geometry as tgeo
from geomesa_tpu_torch import streaming as tstream
from geomesa_tpu_torch.obs import ops as tops
from geomesa_tpu_torch.storage import persist as tpersist
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
N_COLD = 3000
QUERIES = (
    "bbox(geom, -40, -40, 10, 30)",
    "bbox(geom, -60, -60, 60, 60) AND dtg DURING 2024-01-02T00:00:00Z/2024-01-06T00:00:00Z",
    "bbox(geom, 0, 0, 50, 50) AND name = 'n3'",
    "INTERSECTS(geom, POLYGON((-30 -30, 40 -30, 40 40, -30 -30)))",
)
LIMIT = 7

JAX = SimpleNamespace(name="jax", pkg=geomesa_tpu, geo=jgeo, st=jstream, fault=jfault,
                      persist=jpersist, ops=jops, kw={})
PORT = SimpleNamespace(name="port", pkg=geomesa_tpu_torch, geo=tgeo, st=tstream, fault=tfault,
                       persist=tpersist, ops=tops, kw={"device": "cpu"})
BOTH = (JAX, PORT)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.setenv("GEOMESA_TPU_IO_BACKOFF_S", "0.0001")
    yield
    jfault.injector().reset()
    tfault.injector().reset()


def _cold(P, n=N_COLD, seed=0, **kw):
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds = P.pkg.DataStore(**P.kw, **kw)
    ds.create_schema(sft)
    rng = np.random.default_rng(seed)
    ds.write("t", P.pkg.FeatureCollection.from_columns(sft, [f"c{i}" for i in range(n)], {
        "name": np.array([f"n{i % 6}" for i in range(n)]),
        "dtg": T0 + rng.integers(0, 8 * DAY, n),
        "geom": (rng.uniform(-60, 60, n), rng.uniform(-60, 60, n))}), check_ids=False)
    ds.compact("t")
    return ds


def _config(P, fold_rows=120):
    return P.st.StreamConfig(workers=2, chunk_rows=64, fold_rows=fold_rows, slice_rows=100)


def _ops(seed, n_steps=25, expiring=False):
    """A package-neutral op sequence: writes of 50-500 rows (about half
    updates of cold ids, some re-updates of hot ids, the rest new), deletes,
    expiry sweeps, incremental and legacy flushes and full persists."""
    rng = np.random.default_rng(seed)
    kinds = ["write", "flush", "write", "delete", "write", "flush", "legacy", "write",
             "expire", "write", "flush", "persist", "write", "write", "flush", "delete",
             "write", "legacy", "write", "expire", "flush", "write", "persist", "write", "flush"]
    ops, new, hot = [], 0, []
    for k in kinds[:n_steps]:
        if k == "write":
            m = int(rng.integers(50, 500))
            ids = []
            for _ in range(m):
                r = rng.random()
                if r < 0.5:
                    ids.append(f"c{int(rng.integers(0, N_COLD))}")
                elif r < 0.6 and hot:
                    ids.append(hot[int(rng.integers(0, len(hot)))])
                else:
                    ids.append(f"s{seed}_{new}")
                    new += 1
            ids = list(dict.fromkeys(ids))
            hot += ids
            ops.append(("write", {
                "ids": ids, "names": [f"n{int(v)}" for v in rng.integers(0, 6, len(ids))],
                "x": rng.uniform(-60, 60, len(ids)).tolist(),
                "y": rng.uniform(-60, 60, len(ids)).tolist(),
                "t": (T0 + rng.integers(0, 8 * DAY, len(ids))).tolist()}))
        elif k == "delete":
            pick = sorted({hot[int(i)] for i in rng.integers(0, len(hot), 20)})
            ops.append(("delete", {"ids": pick}))
        else:
            ops.append((k, {}))
    return ops


def _apply(P, lam, op):
    kind, p = op
    if kind == "write":
        rows = [{"name": nm, "dtg": int(t), "geom": P.geo.Point(x, y)}
                for nm, x, y, t in zip(p["names"], p["x"], p["y"], p["t"])]
        return lam.write(rows, ids=p["ids"])
    if kind == "delete":
        return lam.delete(p["ids"])
    if kind == "expire":
        # a clock past every ingest time: the sweep's decision is the same
        # in both packages (a no-op without expiry_ms)
        return lam.expire(now_ms=int(time.time() * 1000) + 10 * DAY)
    if kind == "flush":
        return lam.flush()
    if kind == "legacy":
        return lam.flush(incremental=False)
    return lam.persist_hot()


def _fc(fc) -> tuple:
    cols = {}
    for name, col in fc.columns.items():
        if hasattr(col, "x"):
            cols[name] = (np.asarray(col.x).tolist(), np.asarray(col.y).tolist())
        else:
            cols[name] = np.asarray(col).tolist()
    return [str(i) for i in np.asarray(fc.ids).tolist()], cols


def _state(lam) -> tuple:
    """Every query through the merge (ids in order, values), the cold tier
    under a limit, and the tiers' row counts."""
    merged = [_fc(lam.query(q)) for q in QUERIES]
    limited = [[str(i) for i in np.asarray(lam.cold.query("t", q, limit=LIMIT).ids).tolist()]
               for q in QUERIES]
    return merged, limited, len(lam.hot), len(lam.cold.features("t"))


def _lam(P, tmp, expiring, wal, fold_rows=120):
    kw = {}
    if wal:
        root = os.path.join(tmp, P.name)
        ds = _cold(P)
        P.persist.save(ds, root)
        kw = dict(wal_dir=os.path.join(root, "_wal"), wal_config=P.st.WalConfig(sync="off"))
    else:
        ds, root = _cold(P), None
    lam = P.st.LambdaStore(ds, "t", expiry_ms=60_000 if expiring else None,
                           config=_config(P, fold_rows), **kw)
    return lam, root


@pytest.mark.parametrize("wal", [False, True], ids=["no_wal", "wal"])
@pytest.mark.parametrize("seq", [0, 1])
def test_sequences_equal_step_by_step(tmp_path, seq, wal):
    expiring = seq == 1
    ops = _ops(100 + seq, expiring=expiring)
    lams = {P.name: _lam(P, str(tmp_path), expiring, wal) for P in BOTH}
    for i, op in enumerate(ops):
        got = []
        for P in BOTH:
            lam = lams[P.name][0]
            got.append((_apply(P, lam, op), _state(lam)))
        assert got[0] == got[1], (i, op[0])
    if not expiring:
        # the incremental flushes deferred updates below fold_rows and
        # folded them above it; the fold sliced
        assert lams["port"][0].cold.last_fold_report["rows"] > 0
    if wal:
        recovered = []
        for P in BOTH:
            lam, root = lams[P.name]
            live = _state(lam)
            lam.wal.sync()
            lam.wal.crash()
            lam.flusher.close()
            rec = P.st.LambdaStore.recover(root, expiry_ms=60_000 if expiring else None,
                                           config=_config(P), **P.kw)
            recovered.append(_state(rec))
            assert recovered[-1] == live, P.name
            rec.close()
        assert recovered[0] == recovered[1]
    else:
        for lam, _ in lams.values():
            lam.close()


@pytest.mark.parametrize("point", ["streaming.persist", "stream.flush.parse",
                                   "stream.flush.keys", "stream.flush.sort"])
def test_stage_and_commit_faults_leave_cold_intact(point):
    outs = []
    for P in BOTH:
        lam = P.st.LambdaStore(_cold(P), "t", config=_config(P, fold_rows=1))
        _apply(P, lam, _ops(7)[0])
        before = _state(lam)
        hot0 = len(lam.hot)
        with P.fault.inject(point, kind="crash"):
            with pytest.raises(P.fault.InjectedCrash):
                lam.flush()
        assert _state(lam) == before and len(lam.hot) == hot0  # cold intact, hot resident
        assert lam.flush() > 0  # the next flush converges
        outs.append(_state(lam))
        lam.close()
    assert outs[0] == outs[1]


def test_evict_fault_returns_rows_once():
    outs = []
    for P in BOTH:
        lam = P.st.LambdaStore(_cold(P), "t", config=_config(P, fold_rows=1))
        _apply(P, lam, _ops(8)[0])
        want = _state(lam)[0]
        with P.fault.inject("streaming.evict", kind="crash"):
            with pytest.raises(P.fault.InjectedCrash):
                lam.flush()
        # the publish committed, the eviction did not: rows in both tiers,
        # each returned once
        assert len(lam.hot) > 0
        assert _state(lam)[0] == want
        lam.flush()
        assert len(lam.hot) == 0
        outs.append(_state(lam))
        lam.close()
    assert outs[0] == outs[1]


def test_transient_commit_fault_retries_inside_the_flush():
    for P in BOTH:
        lam = P.st.LambdaStore(_cold(P), "t", config=_config(P, fold_rows=1))
        _apply(P, lam, _ops(9)[0])
        with P.fault.inject("streaming.persist", kind="io_error", times=1):
            assert lam.flush() > 0
        assert len(lam.hot) == 0
        lam.close()


def _subscription_body():
    return {"id": "s1", "kind": "proximity", "pts": [1.0, 2.0], "dist": 1000.0}


def _crashed_root(P, tmp, with_sub=False):
    """A store root written by one package: a saved cold store, a WAL with a
    checkpoint in the middle, and records past it; crashed. Returns the
    root and the live (never-crashed) store's state."""
    root = os.path.join(tmp, P.name)
    ds = _cold(P)
    P.persist.save(ds, root)
    lam = P.st.LambdaStore(ds, "t", config=_config(P),
                           wal_dir=os.path.join(root, "_wal"),
                           wal_config=P.st.WalConfig(sync="always"))
    ops = _ops(31)
    for op in ops[:8]:
        _apply(P, lam, op)
    if with_sub:
        if P is JAX:
            from geomesa_tpu.streaming.standing import Subscription

            lam.subscribe(Subscription.from_record(_subscription_body()))
        else:
            lam.wal.applied(lam.wal.log_subscribe(_subscription_body()))
    lam.checkpoint(root)
    for op in ops[8:16]:
        _apply(P, lam, op)
    live = _state(lam)
    lam.wal.crash()
    lam.flusher.close()
    return root, live


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX), (PORT, PORT)],
                         ids=["jax_to_port", "port_to_jax", "port_to_port"])
def test_checkpoint_crash_recover_across_packages(tmp_path, writer, reader):
    root, live = _crashed_root(writer, str(tmp_path))
    rec = reader.st.LambdaStore.recover(root, config=_config(reader), **reader.kw)
    assert _state(rec) == live
    assert rec.cold.store_health.status == "ok"
    # the port clears the flag once its replay applied every record; the
    # JAX package leaves it set
    assert rec.wal.needs_recovery is (reader is JAX)
    rec.close()


def test_subscription_record_survives_the_ports_checkpoint(tmp_path):
    """A JAX-written log holding a registration: the port's recovery keeps
    the body, its checkpoint re-logs it above the cover, and the JAX
    package recovers the registration from the port's checkpoint."""
    root, live = _crashed_root(JAX, str(tmp_path), with_sub=True)
    rec = tstream.LambdaStore.recover(root, config=_config(PORT), device="cpu")
    assert list(rec._sub_records) == ["s1"]
    assert _state(rec) == live
    rec.checkpoint(root)
    rec.wal.crash()
    rec.flusher.close()
    segs = sorted(os.listdir(os.path.join(root, "_wal")))
    kinds = []
    for s in segs:
        recs, bad = tstream.wal._parse_frames(open(os.path.join(root, "_wal", s), "rb").read())
        kinds += [r["k"] for r in recs]
    assert "s" in kinds
    back = jstream.LambdaStore.recover(root, config=_config(JAX))
    assert list(back._sub_records) == ["s1"] and back._standing is not None
    assert _state(back) == live
    back.close()
    again = tstream.LambdaStore.recover(root, config=_config(PORT), device="cpu")
    assert list(again._sub_records) == ["s1"]
    again.close()


def test_unreplayed_log_refused_and_health_alike(tmp_path):
    reports = []
    for P in BOTH:
        root, _ = _crashed_root(P, str(tmp_path))
        with pytest.raises(P.st.wal.WalError):
            P.st.LambdaStore(P.persist.load(root, **P.kw), "t",
                             wal_dir=os.path.join(root, "_wal"))
        wal = P.st.WriteAheadLog(os.path.join(root, "_wal"))
        lam = P.st.LambdaStore(P.persist.load(root, **P.kw), "t", config=_config(P), wal=wal)
        rep = P.ops.HealthMonitor(lam.cold, lam=lam).evaluate()
        reports.append((rep["status"], rep["reasons"], rep["hot"]))
        lam.close()
        rec = P.st.LambdaStore.recover(root, config=_config(P), **P.kw)
        rep = P.ops.HealthMonitor(rec.cold, lam=rec).evaluate()
        # recover clears the state in the port; the JAX package's flag
        # stays set after its replay, so its verdict stays unhealthy
        want = ["wal.needs_recovery"] if P is JAX else []
        assert [r["reason"] for r in rep["reasons"]] == want
        rec.close()
    assert reports[0] == reports[1]
    assert reports[1][0] == "unhealthy"
    assert [r["reason"] for r in reports[1][1]] == ["wal.needs_recovery"]


def test_hot_occupancy_raised_and_cleared_alike():
    outs = []
    for P in BOTH:
        ds = _cold(P)
        lam = P.st.LambdaStore(ds, "t", config=_config(P, fold_rows=40))
        mon = P.ops.HealthMonitor(ds, lam=lam)
        steps = [mon.evaluate()]
        _apply(P, lam, _ops(12)[0])  # > 2 x fold_rows pending
        steps.append(mon.evaluate())
        steps.append(P.ops.ops_report(ds, lam=lam)["health"])
        lam.persist_hot()
        steps.append(mon.evaluate())
        outs.append([(s["status"], s["reasons"], s["hot"]) for s in steps])
        lam.close()
    assert outs[0] == outs[1]
    assert [o[0] for o in outs[1]] == ["ready", "degraded", "degraded", "ready"]
    assert outs[1][1][1][0]["reason"] == "hot.occupancy"


def test_serve_ops_health_over_http_and_close_ends_threads():
    bodies = []
    for P in BOTH:
        before = set(threading.enumerate())
        ds = _cold(P)
        lam = P.st.LambdaStore(ds, "t", config=_config(P, fold_rows=40),
                               wal=None)
        lam.serve()
        ops = lam.serve_ops()
        assert ops is ds.ops and ops.lam is lam
        _apply(P, lam, _ops(13)[0])
        for q in QUERIES:
            lam.query(q)  # the cold half through the scheduler
        codes = []
        for _ in range(2):
            with urllib.request.urlopen(ops.url + "/health", timeout=30) as r:
                body = json.loads(r.read())
                codes.append((r.status, body["status"], [x["reason"] for x in body["reasons"]],
                              body["hot"]))
            lam.persist_hot()
        bodies.append(codes)
        lam.close()
        ds.close()
        for t in set(threading.enumerate()) - before:
            t.join(10)
        left = [t.name for t in set(threading.enumerate()) - before if t.is_alive()]
        assert left == [], (P.name, left)
    assert bodies[0] == bodies[1]
    assert bodies[1][0][2] == ["hot.occupancy"] and bodies[1][1][2] == []


def test_close_ends_the_interval_thread_and_the_pool(tmp_path):
    before = set(threading.enumerate())
    ds = _cold(PORT)
    lam = tstream.LambdaStore(ds, "t", config=_config(PORT),
                              wal_dir=str(tmp_path / "_wal"),
                              wal_config=tstream.WalConfig(sync="interval"))
    _apply(PORT, lam, _ops(14)[0])
    lam.flush()
    started = {t.name.split("_")[0] for t in set(threading.enumerate()) - before}
    assert {"geomesa-wal-sync", "geomesa-stream"} <= started
    lam.close()
    for t in set(threading.enumerate()) - before:
        t.join(10)
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]


def test_later_items_raise_not_implemented():
    """Only the network data plane is still a later item; the standing
    surface it once shared this test with is ported."""
    lam = tstream.LambdaStore(_cold(PORT, n=100), "t", config=_config(PORT))
    with pytest.raises(NotImplementedError, match="A12b"):
        lam.serve(port=0)
    assert lam.cold.scheduler is None  # serve(port=) attached nothing
    assert lam.unsubscribe("s1") is False  # no engine attached yet
    assert lam.standing() is lam.standing()
    assert lam.standing().device == lam.cold.device
    lam.close()


def test_flusher_stage_unstage_and_metrics_alike():
    outs = []
    for P in BOTH:
        ds = _cold(P, metrics=import_module(P.pkg.__name__ + ".metrics").MetricsRegistry())
        lam = P.st.LambdaStore(ds, "t", config=_config(P, fold_rows=10_000))
        op = _ops(15)[0]
        _apply(P, lam, op)
        lam.flush()  # appends publish, updates stay and pre-stage
        staged = len(lam.flusher._staged_rows)
        upd = [i for i in op[1]["ids"] if i.startswith("c")]
        dropped = lam.flusher.unstage(upd[:5])
        lam.delete(upd[5:10])
        m = lam.cold.metrics
        outs.append((staged, dropped, len(lam.flusher._staged_rows),
                     m.counter_value("geomesa.stream.fold.prestaged"),
                     m.counter_value("geomesa.stream.flushes"), _state(lam)))
        lam.persist_hot()
        outs[-1] += (_state(lam),)
        lam.close()
    assert outs[0] == outs[1]
    assert outs[1][0] > 0
