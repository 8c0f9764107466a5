"""The port's WAL shipping and read replicas (streaming/replica.py) against
the JAX package's, on the CPU (after tests/test_replica.py).

- the transport SPI: pipe round trip and close, loopback sockets (port 0)
  with partial frames reassembled and a damaged frame poisoning the
  stream, the listener; the frame bytes equal the JAX package's;
- catch-up: an empty follower, a mid-log checkpoint bootstrap, a
  restarted follower resuming from its offsets, a lost chunk healed by a
  resync, a duplicate chunk, a damaged chunk quarantined on the follower
  only, the checkpoint manifest dropping retired copies; followers end
  equal to their leader, and the port's shipped messages and segment
  copies equal the JAX package's byte for byte;
- staleness: unmeasured until the first mark, the watermark's semantics,
  the histogram, the SLO objective and its knob, bounded-staleness reads;
- health: the ``replica.staleness`` and ``replica.ship.giveup`` reasons
  and the ``replica`` section, equal to the JAX package's verdicts;
- the retry budget and the shipper's give-up and recovery; replay
  progress; failover (read-only followers, zero acknowledged loss after
  a kill with an unshipped tail, stale terms refused, an apply fault
  healed);
- both directions across packages over ``PipeTransport``: a JAX leader
  feeds a port follower and a port leader a JAX follower, each ending
  equal to its leader, and a promoted follower of either package keeps
  what its leader acknowledged;
- the chaos harness (leader and two followers, a kill mid-ingest) as a
  short smoke run; the soak stays under ``slow``, as in the reference.

Every test closes its stores, shippers and transports (the ``closing``
fixture), so no thread or socket outlives it. Tolerance: exact.
"""

import base64
import os
import socket
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
DAY = 86_400_000


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
        rp=import_module(name + ".streaming.replica"),
        wal=import_module(name + ".streaming.wal"),
        ops=import_module(name + ".obs.ops"),
        slo=import_module(name + ".obs.slo"),
    )


JAX = _pkg(geomesa_tpu, {})
PORT = _pkg(geomesa_tpu_torch, {"device": "cpu"})
BOTH = (JAX, PORT)
IDS = ["jax", "port"]


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("GEOMESA_TPU_IO_BACKOFF_S", "0.0001")
    yield
    for P in BOTH:
        P.fault.injector().reset()
        P.conf.REPLICA_STALENESS_MAX_MS.clear()
        P.conf.OBS_SLO_REPLICA_STALENESS_P99_MS.clear()


@pytest.fixture
def closing():
    """Register anything with ``close()``/``stop()``; all of it closes at
    teardown, last first, and no replica thread may outlive the test."""
    held = []
    yield held.append
    for obj in reversed(held):
        for name in ("stop", "close"):
            fn = getattr(obj, name, None)
            if fn is not None:
                try:
                    fn()
                except Exception:
                    pass
    left = [t for t in threading.enumerate()
            if t.name.startswith("geomesa-replica") and t.is_alive()]
    assert not left, left


def _cold(P, n=100, seed=0):
    ds = P.pkg.DataStore(**P.kw)
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds.create_schema(sft)
    if n:
        rng = np.random.default_rng(seed)
        ds.write("t", P.pkg.FeatureCollection.from_columns(
            sft, [f"c{i}" for i in range(n)],
            {"name": np.array(["n"] * n), "dtg": T0 + rng.integers(0, 30 * DAY, n),
             "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))}))
        ds.compact("t")
    return ds


def _leader(P, root, n=100, seed=0, sync="always", seg=1 << 14, fold_rows=4096):
    ds = _cold(P, n=n, seed=seed)
    ds.metrics = P.metrics.MetricsRegistry()
    P.persist.save(ds, str(root))
    return P.st.LambdaStore(
        ds, "t", config=P.st.StreamConfig(chunk_rows=64, fold_rows=fold_rows),
        wal_dir=os.path.join(str(root), "_wal"),
        wal_config=P.st.WalConfig(sync=sync, segment_bytes=seg, sync_interval_ms=1e9))


def _follower(P, root, where, **kw):
    kw.setdefault("config", P.st.StreamConfig(chunk_rows=64, fold_rows=4096))
    a, b = P.rp.PipeTransport.pair()
    fol = P.rp.ReplicaStore(str(root), os.path.join(str(where), "_wal"), b, type_name="t",
                            **P.kw, **kw)
    return fol, a


def _rows(P, k, n=20):
    rng = np.random.default_rng(k)
    return [{"name": f"w{k}-{i}", "dtg": T0 + i,
             "geom": P.geo.Point(float(rng.uniform(-50, 50)), float(rng.uniform(-50, 50)))}
            for i in range(n)]


def _ids(k, n=20):
    return [f"w{k}-{i}" for i in range(n)]


def _names(store) -> dict:
    fc = store.query("INCLUDE")
    return dict(zip((str(i) for i in fc.ids.tolist()),
                    (str(v) for v in np.asarray(fc.columns["name"]).tolist())))


def _ordered(store, q="bbox(geom, -30, -30, 20, 40)"):
    return [str(i) for i in store.query(q).ids.tolist()]


def _reasons(report) -> set:
    return {r["reason"] for r in report["reasons"]}


def _segments(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".log")}


def alike(fn):
    """Run ``fn(P)`` for both packages; the results must be equal."""
    out = [fn(P) for P in BOTH]
    assert out[1] == out[0]
    return out[1]


def _pair(P, tmp_path, closing, tag="", **leader_kw):
    """(leader, follower, leader-side endpoint) in ``tmp_path/<pkg><tag>``."""
    base = tmp_path / f"{P.name}{tag}"
    lam = _leader(P, base / "s", **leader_kw)
    closing(lam)
    fol, end = _follower(P, base / "s", base / "f1")
    closing(fol)
    return lam, fol, end, base


# -- the transport SPI ------------------------------------------------------------


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_pipe_roundtrip_and_close(P):
    a, b = P.rp.PipeTransport.pair()
    a.send({"m": "x", "v": 1})
    assert b.recv() == {"m": "x", "v": 1} and b.recv() is None
    b.send({"m": "y"})
    assert a.recv() == {"m": "y"}
    a.close()
    with pytest.raises(OSError):
        b.send({"m": "z"})


def test_frames_equal_the_jax_package():
    for msg in ({"m": "seg", "term": 2, "name": "wal-1.log", "off": 7, "data": "QUJD",
                 "sealed": True}, {"m": "hello", "offsets": {"a": 1}}):
        assert PORT.rp._encode_msg(msg) == JAX.rp._encode_msg(msg)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_socket_roundtrip(P):
    s0, s1 = socket.socketpair()
    a, b = P.rp.SocketTransport(s0), P.rp.SocketTransport(s1)
    try:
        a.send({"m": "seg", "off": 0, "data": "QUJD"})
        assert b.recv(timeout=5.0) == {"m": "seg", "off": 0, "data": "QUJD"}
        assert b.recv(timeout=0.01) is None
    finally:
        a.close(), b.close()


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_socket_reassembles_partial_frames(P):
    s0, s1 = socket.socketpair()
    b = P.rp.SocketTransport(s1)
    try:
        wire = P.rp._encode_msg({"m": "state", "horizon": 7})
        s0.sendall(wire[:3])
        assert b.recv(timeout=0.05) is None
        s0.sendall(wire[3:] + P.rp._encode_msg({"m": "state", "horizon": 8}))
        assert b.recv(timeout=5.0) == {"m": "state", "horizon": 7}
        assert b.recv(timeout=5.0) == {"m": "state", "horizon": 8}
    finally:
        s0.close(), b.close()


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_socket_damaged_frame_poisons_stream(P):
    s0, s1 = socket.socketpair()
    b = P.rp.SocketTransport(s1)
    try:
        wire = bytearray(P.rp._encode_msg({"m": "state", "horizon": 7}))
        wire[-1] ^= 0xFF
        s0.sendall(bytes(wire))
        with pytest.raises(P.rp.ReplicaError):
            b.recv(timeout=5.0)
        assert b.recv(timeout=0.01) is None
    finally:
        s0.close(), b.close()


@pytest.mark.parametrize("leader,follower", [(JAX, PORT), (PORT, JAX), (PORT, PORT)],
                         ids=["jax_to_port", "port_to_jax", "port_to_port"])
def test_listener_accept_connect_on_loopback(leader, follower):
    srv = follower.rp.SocketTransport.listen()  # 127.0.0.1, port 0
    try:
        assert srv.port > 0
        done = []

        def follower_side():
            end = srv.accept(timeout=5.0)
            done.append(end.recv(timeout=5.0))
            end.close()

        t = threading.Thread(target=follower_side)
        t.start()
        end = leader.rp.SocketTransport.connect("127.0.0.1", srv.port)
        end.send({"m": "hello", "offsets": {}})
        t.join(10)
        end.close()
        assert done == [{"m": "hello", "offsets": {}}]
    finally:
        srv.close()


# -- catch-up -----------------------------------------------------------------------


def test_empty_follower_catches_up(tmp_path, closing):
    def case(P):
        lam, _, _, base = _pair(P, tmp_path, closing, tag="x")
        lam.write(_rows(P, 1), ids=_ids(1))
        fol, end = _follower(P, base / "s", base / "f2")
        closing(fol)
        ship = P.rp.SegmentShipper(lam, chunk_bytes=512)
        ship.attach(end)
        lam.write(_rows(P, 2), ids=_ids(2))
        sent = []
        end_send = end.send
        end.send = lambda m: (sent.append(P.rp._encode_msg(
            {k: v for k, v in m.items() if k != "wall_ms"})), end_send(m))
        ship.pump()
        fol.drain()
        assert fol.replayed == lam.wal.last_seq and _names(fol) == _names(lam)
        assert fol.staleness_ms() is not None
        assert fol.metrics.counter_value("geomesa.replica.applied.records") > 0
        return (_names(fol), _ordered(fol), fol.replayed, sent,
                _segments(os.path.join(str(base / "f2"), "_wal")))

    alike(case)


def test_midlog_checkpoint_bootstrap(tmp_path, closing):
    def case(P):
        base = tmp_path / P.name
        lam = _leader(P, base / "s", seg=2 << 10)
        closing(lam)
        lam.write(_rows(P, 1), ids=_ids(1))
        lam.checkpoint(str(base / "s"))
        lam.write(_rows(P, 2), ids=_ids(2))
        fol, end = _follower(P, base / "s", base / "f1")
        closing(fol)
        ship = P.rp.SegmentShipper(lam, chunk_bytes=512)
        ship.attach(end)
        ship.pump()
        fol.drain()
        assert _names(fol) == _names(lam) and fol.replayed == lam.wal.last_seq
        return _names(fol), _ordered(fol), fol.replayed

    alike(case)


def test_restarted_follower_resumes_from_offsets(tmp_path, closing):
    def case(P):
        lam, fol, end, base = _pair(P, tmp_path, closing)
        ship = P.rp.SegmentShipper(lam, chunk_bytes=512)
        fid = ship.attach(end)
        lam.write(_rows(P, 1), ids=_ids(1))
        ship.pump()
        fol.drain()
        fol.stop()
        fol.store.close()
        ship.detach(fid)
        fol2, end2 = _follower(P, base / "s", base / "f1")
        closing(fol2)
        ship.attach(end2)
        assert ship.pump() == 0
        fol2.drain()
        assert _names(fol2) == _names(lam)
        return _names(fol2), fol2.replayed

    alike(case)


def test_gap_triggers_resync_and_heals(tmp_path, closing):
    def case(P):
        lam, fol, end, _ = _pair(P, tmp_path, closing)
        ship = P.rp.SegmentShipper(lam, chunk_bytes=1 << 20)
        ship.attach(end)
        lam.write(_rows(P, 1), ids=_ids(1))
        ship.pump()
        dropped = fol.transport._inbox.popleft()
        lam.write(_rows(P, 2), ids=_ids(2))
        ship.pump()
        fol.drain()
        resyncs = fol.metrics.counter_value("geomesa.replica.resync")
        assert resyncs >= 1
        ship.pump()
        fol.drain()
        assert _names(fol) == _names(lam) and dropped
        return _names(fol), resyncs

    alike(case)


def test_duplicate_chunk_is_idempotent(tmp_path, closing):
    def case(P):
        lam, fol, end, _ = _pair(P, tmp_path, closing)
        ship = P.rp.SegmentShipper(lam, chunk_bytes=1 << 20)
        ship.attach(end)
        lam.write(_rows(P, 1), ids=_ids(1))
        ship.pump()
        msgs = list(fol.transport._inbox)
        fol.drain()
        before = _names(fol)
        fol.transport._inbox.extend(msgs)
        fol.drain()
        assert _names(fol) == before == _names(lam)
        return before

    alike(case)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_damaged_chunk_quarantines_follower_leader_intact(tmp_path, closing, P):
    lam, fol, end, _ = _pair(P, tmp_path, closing)
    ship = P.rp.SegmentShipper(lam, chunk_bytes=1 << 20)
    ship.attach(end)
    lam.write(_rows(P, 1), ids=_ids(1))
    ship.pump()
    fol.drain()
    state = lam.wal.ship_state()
    name = state["segments"][-1][0]
    garbage = bytearray(P.rp._encode_msg({"k": "u", "s": 10 ** 6}))
    garbage[-1] ^= 0xFF
    fol._handle({"m": "seg", "term": int(state["term"]), "name": name,
                 "off": int(fol._sizes[name]),
                 "data": base64.b64encode(bytes(garbage)).decode("ascii"), "sealed": False})
    qdir = os.path.join(fol.replica_root, "_quarantine", "_wal")
    assert os.path.isdir(qdir) and os.listdir(qdir)
    assert any(d.type_name == "_wal" and "shipped chunk" in d.detail
               for d in fol.store.cold.health.damage)
    assert fol.metrics.counter_value("geomesa.stream.wal.quarantined") >= 1
    assert lam.wal.ship_state()["segments"]
    ship.pump()
    fol.drain()
    assert _names(fol) == _names(lam)


def test_checkpoint_manifest_drops_follower_segments(tmp_path, closing):
    def case(P):
        base = tmp_path / P.name
        lam = _leader(P, base / "s", seg=2 << 10)
        closing(lam)
        fol, end = _follower(P, base / "s", base / "f1")
        closing(fol)
        ship = P.rp.SegmentShipper(lam, chunk_bytes=4096)
        ship.attach(end)
        for k in range(1, 5):
            lam.write(_rows(P, k), ids=_ids(k))
        ship.pump()
        fol.drain()
        before = set(fol._sizes)
        assert len(before) > 1
        lam.checkpoint(str(base / "s"))
        ship.pump()
        fol.drain()
        live = {n for n, _, _ in lam.wal.ship_state()["segments"]}
        retired = before - live
        after = set(fol._sizes)
        assert retired and after <= live and not (after & retired)
        assert sorted(os.listdir(fol.wal_dir)) == sorted(after)
        return sorted(before), sorted(after), _names(fol)

    alike(case)


# -- staleness ----------------------------------------------------------------------


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_unmeasured_until_first_mark(tmp_path, closing, P):
    lam, fol, end, _ = _pair(P, tmp_path, closing)
    assert fol.staleness_ms() is None
    ship = P.rp.SegmentShipper(lam)
    ship.attach(end)
    ship.pump()
    fol.drain()
    st = fol.staleness_ms()
    assert st is not None and st < 60_000


def test_watermark_semantics_deterministic(tmp_path, closing):
    def case(P):
        lam, fol, _, _ = _pair(P, tmp_path, closing)
        r = fol.replayed
        for h, w in ((r, 1_000.0), (r, 2_000.0), (r + 10, 3_000.0)):
            fol._handle({"m": "state", "term": 0, "horizon": h, "wall_ms": w, "segments": []})
        a = fol.staleness_ms(now_ms=2_500.0)
        with fol._apply_lock:
            fol._marks.clear()
            fol._marks.append((r + 10, 4_000.0))
        b = fol.staleness_ms(now_ms=5_000.0)
        assert (a, b) == (500.0, 1_000.0)
        return a, b

    alike(case)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_staleness_histogram_observed(tmp_path, closing, P):
    lam, fol, end, _ = _pair(P, tmp_path, closing)
    ship = P.rp.SegmentShipper(lam)
    ship.attach(end)
    lam.write(_rows(P, 1), ids=_ids(1))
    ship.pump()
    fol.drain()
    h = fol.metrics.histograms.get("geomesa.replica.staleness.ms")
    assert h is not None and h.count >= 1


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_slo_default_objective_follows_knob(P):
    obj = next(o for o in P.slo.default_objectives() if o.name == "replica_staleness_p99")
    assert obj.metric == "geomesa.replica.staleness.ms"
    P.conf.OBS_SLO_REPLICA_STALENESS_P99_MS.set(0)
    assert "replica_staleness_p99" not in {o.name for o in P.slo.default_objectives()}


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_bounded_staleness_read(tmp_path, closing, P):
    lam, fol, end, _ = _pair(P, tmp_path, closing)
    with pytest.raises(P.rp.StaleRead):
        fol.query("INCLUDE", max_staleness_ms=60_000)
    ship = P.rp.SegmentShipper(lam)
    ship.attach(end)
    ship.pump()
    fol.drain()
    assert len(fol.query("INCLUDE", max_staleness_ms=60_000)) == 100
    with fol._apply_lock:
        fol._marks.clear()
        fol._marks.append((0, time.time() * 1e3 - 50_000.0))
    with pytest.raises(P.rp.StaleRead):
        fol.query("INCLUDE", max_staleness_ms=10_000)


def test_replica_knobs_equal_the_jax_package():
    for k in ("REPLICA_SHIP_CHUNK_BYTES", "REPLICA_SHIP_INTERVAL_MS",
              "REPLICA_STALENESS_MAX_MS", "REPLICA_GIVEUP_S"):
        a, b = getattr(JAX.conf, k), getattr(PORT.conf, k)
        assert (b.name, b.default) == (a.name, a.default) and b.get() == a.get()


# -- /health ------------------------------------------------------------------------


def _untimed(report):
    """A health verdict without its measured parts: the staleness value
    and the reasons' details that quote it."""
    out = dict(report)
    out["reasons"] = sorted((r["reason"], r["severity"]) for r in report["reasons"])
    if "replica" in out:
        out["replica"] = {k: v for k, v in out["replica"].items() if k != "staleness_ms"}
    out.pop("slo", None)
    return out


def test_staleness_health_reason(tmp_path, closing):
    def case(P):
        lam, fol, end, _ = _pair(P, tmp_path, closing)
        mon = P.ops.HealthMonitor(fol.store.cold, lam=fol.store)
        steps = []
        report = mon.evaluate()
        assert "replica.staleness" in _reasons(report) and report["status"] == "degraded"
        assert "unmeasured" in next(r for r in report["reasons"]
                                    if r["reason"] == "replica.staleness")["detail"]
        steps.append(_untimed(report))
        ship = P.rp.SegmentShipper(lam)
        ship.attach(end)
        lam.write(_rows(P, 1), ids=_ids(1))
        ship.pump()
        fol.drain()
        report = mon.evaluate()
        assert "replica.staleness" not in _reasons(report)
        assert report["replica"]["replayed"] == fol.replayed
        assert report["replica"]["term"] == fol.term
        assert report["replica"]["staleness_ms"] is not None
        steps.append(_untimed(report))
        with fol._apply_lock:
            fol._marks.clear()
            fol._marks.append((0, time.time() * 1e3 - 60_000.0))
        report = mon.evaluate()
        assert "replica.staleness" in _reasons(report)
        assert any("geomesa.replica.staleness.max.ms" in r["detail"] for r in report["reasons"])
        steps.append(_untimed(report))
        P.conf.REPLICA_STALENESS_MAX_MS.set(0)
        steps.append(_untimed(mon.evaluate()))
        assert "replica.staleness" not in set(r for r, _ in steps[-1]["reasons"])
        return steps

    alike(case)


def test_ship_giveup_health_reason(tmp_path, closing):
    def case(P):
        lam, fol, end, _ = _pair(P, tmp_path, closing)
        ship = P.rp.SegmentShipper(lam, giveup_s=0.0)
        fid = ship.attach(end)
        mon = P.ops.HealthMonitor(lam.cold, lam=lam)
        steps = [_untimed(mon.evaluate())]
        fol.transport.close()
        lam.write(_rows(P, 1), ids=_ids(1))
        ship.pump()
        assert fid in ship.gave_up_report()
        assert lam.cold.metrics.counter_value("geomesa.replica.ship.giveup") >= 1
        report = mon.evaluate()
        assert "replica.ship.giveup" in _reasons(report)
        assert any("geomesa.replica.giveup.s" in r["detail"] for r in report["reasons"])
        steps.append(_untimed(report))
        ship.detach(fid)
        steps.append(_untimed(mon.evaluate()))
        assert ("replica.ship.giveup", "degraded") not in steps[-1]["reasons"]
        return steps

    alike(case)


def test_ops_plane_of_a_follower(tmp_path, closing):
    """``ReplicaStore.serve_ops()``: ``/health`` carries the ``replica``
    section, ``close()`` ends the ops threads (the JAX package's leaves
    them to the cold store's own ``close()``), and ``serve(port=)`` names
    ROADMAP A12b."""
    import json
    import urllib.request

    lam, fol, end, _ = _pair(PORT, tmp_path, closing)
    ship = PORT.rp.SegmentShipper(lam)
    ship.attach(end)
    ship.pump()
    fol.drain()
    with pytest.raises(NotImplementedError, match="A12b"):
        fol.serve(port=0)
    srv = fol.serve_ops()
    with urllib.request.urlopen(srv.url + "/health", timeout=10) as r:
        health = json.loads(r.read().decode())
    with urllib.request.urlopen(srv.url + "/stats", timeout=10) as r:
        stats = json.loads(r.read().decode())
    assert health["replica"]["replayed"] == fol.replayed and "t" in stats
    fol.close()
    assert srv.closed  # the port's close() ends the follower's services too
    # the JAX package's close() leaves them running (a deliberate difference)
    jlam, jfol, _, _ = _pair(JAX, tmp_path, closing)
    jsrv = jfol.serve_ops()
    jfol.close()
    assert not jsrv.closed
    jfol.store.cold.close()
    assert jsrv.closed
    assert not [t for t in threading.enumerate()
                if t.name in ("geomesa-ops", "geomesa-telemetry", "geomesa-serving")
                and getattr(getattr(t, "_target", None), "__self__", None)
                in (fol.store.cold.scheduler, srv.recorder)]


# -- the retry budget ---------------------------------------------------------------


def test_retry_budgets_equal_the_jax_package():
    def case(P):
        out = []
        for attempts, elapsed, fail_first in ((50, 0.0, None), (3, None, None), (5, 30.0, 1)):
            m = P.metrics.MetricsRegistry()
            calls = [0]

            def fn():
                calls[0] += 1
                if fail_first is None or calls[0] <= fail_first:
                    raise OSError("transient")
                return "ok"

            try:
                res = P.fault.with_retries(fn, attempts=attempts, backoff_s=0.0, metrics=m,
                                           sleep=lambda s: None, max_elapsed_s=elapsed)
            except OSError:
                res = "raised"
            h = m.histograms.get("geomesa.fault.retry.giveup.ms")
            out.append((res, calls[0], m.counter_value("geomesa.fault.retry"),
                        m.counter_value("geomesa.fault.retries_exhausted"),
                        None if h is None else h.count))
        assert out[0][:2] == ("raised", 1) and out[2][0] == "ok"
        return out

    alike(case)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_shipper_transient_fault_absorbed(tmp_path, closing, P):
    lam, fol, end, _ = _pair(P, tmp_path, closing)
    ship = P.rp.SegmentShipper(lam, chunk_bytes=512)
    ship.attach(end)
    lam.write(_rows(P, 1), ids=_ids(1))
    with P.fault.inject("replica.ship.segment", kind="io_error", times=1):
        ship.pump()
    fol.drain()
    assert not ship.gave_up_report() and _names(fol) == _names(lam)
    assert lam.cold.metrics.counter_value("geomesa.fault.retry") >= 1


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_shipper_bounded_giveup_then_recovers(tmp_path, closing, P):
    lam, fol, end, _ = _pair(P, tmp_path, closing)
    ship = P.rp.SegmentShipper(lam, chunk_bytes=512, giveup_s=0.0)
    fid = ship.attach(end)
    lam.write(_rows(P, 1), ids=_ids(1))
    with P.fault.inject("replica.ship.segment", kind="io_error", times=None):
        ship.pump()
        assert fid in ship.gave_up_report()
    ship.pump()
    fol.drain()
    assert not ship.gave_up_report() and _names(fol) == _names(lam)


def test_threads_end_at_stop_and_close(tmp_path, closing):
    """The shipper's pump and the follower's apply loop run as named
    threads; stop() and close() join them, and the follower converges."""
    lam, fol, end, _ = _pair(PORT, tmp_path, closing)
    ship = PORT.rp.SegmentShipper(lam, interval_ms=2.0)
    closing(ship)
    ship.attach(end)
    before = {t.name for t in threading.enumerate()}
    ship.start()
    fol.start()
    names = {t.name for t in threading.enumerate()} - before
    assert names == {"geomesa-replica-ship", "geomesa-replica-apply"}
    lam.write(_rows(PORT, 1), ids=_ids(1))
    deadline = time.monotonic() + 10
    while fol.replayed < lam.wal.last_seq and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _names(fol) == _names(lam)
    ship.stop()
    fol.close()
    assert not [t for t in threading.enumerate() if t.name in names and t.is_alive()]


# -- replay progress ----------------------------------------------------------------


def test_recover_reports_progress_and_gauge(tmp_path, closing):
    def case(P):
        reg = P.metrics.MetricsRegistry()
        root = tmp_path / P.name / "s"
        lam = _leader(P, root, seg=2 << 10)
        for k in range(1, 5):
            lam.write(_rows(P, k), ids=_ids(k))
        last = lam.wal.last_seq
        lam.wal.crash()
        lam.flusher.close()
        events = []
        rec = P.st.LambdaStore.recover(str(root), metrics=reg, **P.kw,
                                       on_progress=lambda s, seg, b: events.append((s, seg, b)))
        closing(rec)
        assert len(events) >= 2 and [e[0] for e in events][-1] == last
        assert reg.gauges["geomesa.replica.replay.progress"] == last
        assert rec.count() == 180
        return events, _names(rec)

    alike(case)


# -- failover -----------------------------------------------------------------------


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_follower_is_read_only(tmp_path, closing, P):
    lam, fol, _, _ = _pair(P, tmp_path, closing)
    with pytest.raises(P.rp.ReplicaError):
        fol.write(_rows(P, 9), ids=_ids(9))


def test_kill_leader_promote_zero_acked_loss(tmp_path, closing):
    def case(P):
        lam, fol, end, base = _pair(P, tmp_path, closing)
        ship = P.rp.SegmentShipper(lam, chunk_bytes=4096)
        ship.attach(end)
        lam.write(_rows(P, 1), ids=_ids(1))
        ship.pump()
        fol.drain()
        lam.write(_rows(P, 2), ids=_ids(2))
        acked = _names(lam)
        lam.wal.crash()
        lam.flusher.close()
        leader_wal = str(base / "s" / "_wal")
        with P.fault.inject("replica.promote", kind="io_error", times=1):
            with pytest.raises(OSError):
                fol.promote(leader_wal_dir=leader_wal)
        term = fol.promote(leader_wal_dir=leader_wal)
        assert term == 1 and fol.term == 1 and _names(fol) == acked
        assert fol.metrics.counter_value("geomesa.replica.promotions") == 1
        fol.write(_rows(P, 3), ids=_ids(3))
        assert len(fol.query("INCLUDE")) == len(acked) + 20
        fol.store.wal.close()
        rec = P.st.LambdaStore.recover(str(base / "s"), type_name="t", wal_dir=fol.wal_dir,
                                       **P.kw)
        closing(rec)
        assert rec.wal.term == 1 and len(rec.query("INCLUDE")) == len(acked) + 20
        return _names(rec), _ordered(rec), _segments(fol.wal_dir)

    alike(case)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_stale_term_shipment_refused(tmp_path, closing, P):
    lam, fol, end, _ = _pair(P, tmp_path, closing)
    ship = P.rp.SegmentShipper(lam, chunk_bytes=4096)
    ship.attach(end)
    lam.write(_rows(P, 1), ids=_ids(1))
    ship.pump()
    fol.drain()
    fol.promote()
    assert fol.term == 1
    before, sizes = _names(fol), dict(fol._sizes)
    stale_seg = {"m": "seg", "term": 0, "name": "wal-" + "0" * 20, "off": 0, "data": "QUJD",
                 "sealed": False}
    fol._handle(stale_seg)
    fol._handle({"m": "state", "term": 0, "horizon": 10 ** 6, "wall_ms": 0.0, "segments": []})
    assert fol.metrics.counter_value("geomesa.replica.fenced") == 2
    assert _names(fol) == before and dict(fol._sizes) == sizes
    with P.fault.inject("replica.fence", kind="io_error", times=1):
        with pytest.raises(OSError):
            fol._handle(stale_seg)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_apply_fault_then_resync_converges(tmp_path, closing, P):
    lam, fol, end, _ = _pair(P, tmp_path, closing)
    ship = P.rp.SegmentShipper(lam, chunk_bytes=1 << 20)
    ship.attach(end)
    lam.write(_rows(P, 1), ids=_ids(1))
    ship.pump()
    with P.fault.inject("replica.apply", kind="io_error", times=1):
        with pytest.raises(OSError):
            fol.drain()
    lam.write(_rows(P, 2), ids=_ids(2))
    ship.pump()
    fol.drain()
    ship.pump()
    fol.drain()
    assert _names(fol) == _names(lam)


# -- across packages ----------------------------------------------------------------


@pytest.mark.parametrize("leader,follower", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_leader_port_follower", "port_leader_jax_follower"])
def test_follower_of_the_other_package_tracks_its_leader(tmp_path, closing, leader, follower):
    """A leader of one package ships to a follower of the other over
    ``PipeTransport``: the follower bootstraps from the leader's root,
    applies every shipped record (upserts, updates, deletes, flushes, a
    checkpoint, a subscription) and answers as its leader, ids in order;
    its segment copies equal the leader's bytes; promoted, it keeps every
    acknowledged row."""
    root = tmp_path / "s"
    lam = _leader(leader, root, seg=4 << 10, fold_rows=30)
    closing(lam)
    fol, end = _follower(follower, root, tmp_path / "f1")
    closing(fol)
    ship = leader.rp.SegmentShipper(lam, chunk_bytes=1500)
    ship.attach(end)
    for k in range(1, 7):
        lam.write(_rows(leader, k), ids=_ids(k))
        if k == 2:
            lam.write(_rows(leader, 10, n=5), ids=[f"c{i}" for i in range(5)])  # updates
        if k == 3:
            lam.delete(_ids(1)[:7])
            lam.flush()
        if k == 4:
            lam.checkpoint(str(root))
            lam.subscribe(leader.st.Subscription("g", "geofence", geom=leader.geo.Polygon(
                [(-10, -10), (10, -10), (10, 10), (-10, 10), (-10, -10)])))
        ship.pump()
        fol.drain()
        assert _names(fol) == _names(lam) and _ordered(fol) == _ordered(lam), k
    assert fol.replayed == lam.wal.last_seq
    assert fol.store.standing().index.subscription_ids() == ["g"]
    leader_segs = _segments(str(root / "_wal"))
    for name, data in _segments(fol.wal_dir).items():
        assert leader_segs[name].startswith(data)
    lam.write(_rows(leader, 20), ids=_ids(20))
    acked = _names(lam)
    lam.wal.crash()
    lam.flusher.close()
    fol.promote(leader_wal_dir=str(root / "_wal"))
    assert _names(fol) == acked


# -- chaos --------------------------------------------------------------------------


def _replica_chaos_round(P, base, closing, seconds, seed, rate=0.02):
    lam = _leader(P, base / "s", n=200, seed=3, seg=8 << 10)
    closing(lam)
    fols, ends = [], []
    for name in ("f1", "f2"):
        fol, end = _follower(P, base / "s", base / name)
        closing(fol)
        fols.append(fol), ends.append(end)
    ship = P.rp.SegmentShipper(lam, chunk_bytes=4096, giveup_s=0.2)
    for end in ends:
        ship.attach(end)
    test_lock = threading.Lock()
    oracle, attempted = {}, {}
    base_fc = lam.cold.features("t")
    for i, fid in enumerate(base_fc.ids.tolist()):
        oracle[str(fid)] = str(np.asarray(base_fc.columns["name"])[i])
    stop = threading.Event()
    errors = []
    counter = [0]
    rng = np.random.default_rng(seed)

    def writer():
        known = list(oracle)
        while not stop.is_set():
            ids, rows, vals = [], [], []
            for _ in range(int(rng.integers(1, 10))):
                if rng.random() < 0.4:
                    fid = known[int(rng.integers(0, len(known)))]
                else:
                    counter[0] += 1
                    fid = f"w{counter[0]}"
                    known.append(fid)
                counter[0] += 1
                v = f"v{counter[0]}"
                ids.append(fid), vals.append(v)
                rows.append({"name": v, "dtg": T0, "geom": P.geo.Point(
                    float(rng.uniform(-50, 50)), float(rng.uniform(-50, 50)))})
            with test_lock:
                try:
                    lam.write(rows, ids=ids)
                except (P.fault.InjectedCrash, OSError, P.wal.WalError):
                    for fid, v in zip(ids, vals):
                        attempted.setdefault(fid, set()).add(v)
                    continue
                for fid, v in zip(ids, vals):
                    oracle[fid] = v
            time.sleep(0.001)

    def pumper():
        while not stop.is_set():
            try:
                ship.pump()
            except (P.fault.InjectedCrash, OSError, P.rp.ReplicaError, P.wal.WalError):
                pass
            time.sleep(0.004)

    def applier(fol):
        def run():
            while not stop.is_set():
                try:
                    if not fol.poll():
                        time.sleep(0.002)
                except (P.fault.InjectedCrash, OSError, P.rp.ReplicaError):
                    continue
        return run

    def reader():
        while not stop.is_set():
            for fol in fols:
                try:
                    fol.query("INCLUDE", max_staleness_ms=30_000)
                except (P.rp.StaleRead, P.fault.InjectedCrash, OSError):
                    continue
                except Exception as e:
                    errors.append(("reader", repr(e)))
                    stop.set()
                    return
            time.sleep(0.005)

    threads = [threading.Thread(target=f) for f in
               (writer, pumper, applier(fols[0]), applier(fols[1]), reader)]
    with P.fault.chaos(seed=seed, rate=rate, points="replica.*,stream.wal.*",
                       kinds=("io_error", "latency", "crash"), delay_s=0.002) as spec:
        for t in threads:
            t.start()
        time.sleep(seconds * 0.7)
        lam.wal.crash()
        time.sleep(seconds * 0.3)
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors[:3]
    assert spec.fired > 0
    assert fols[0].promote(leader_wal_dir=str(base / "s" / "_wal")) >= 1
    return oracle, attempted, fols[0], fols[1], spec


def _assert_replica_invariants(oracle, attempted, promoted, lagging):
    got = _names(promoted)
    assert not [fid for fid in oracle if fid not in got]
    for fid, v in oracle.items():
        assert got[fid] == v or got[fid] in attempted.get(fid, ()), fid
    for fid, v in got.items():
        if fid not in oracle:
            assert v in attempted.get(fid, ()), fid
    for fid, v in _names(lagging).items():
        assert oracle.get(fid) == v or v in attempted.get(fid, ()) or fid in oracle, fid


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_replica_chaos_smoke(tmp_path, closing, P):
    oracle, attempted, promoted, lagging, _ = _replica_chaos_round(
        P, tmp_path, closing, seconds=1.5, seed=47211)
    _assert_replica_invariants(oracle, attempted, promoted, lagging)


@pytest.mark.slow
def test_replica_chaos_soak(tmp_path, closing):
    budget = float(os.environ.get("GEOMESA_TPU_CHAOS_SECONDS", 60.0))
    seed = int(os.environ.get("GEOMESA_TPU_CHAOS_SEED", 60042))
    t0 = time.monotonic()
    kills = 0
    while time.monotonic() - t0 < budget or kills < 2:
        oracle, attempted, promoted, lagging, spec = _replica_chaos_round(
            PORT, tmp_path / f"r{kills}", closing, seconds=6.0, seed=seed + kills)
        _assert_replica_invariants(oracle, attempted, promoted, lagging)
        assert spec.hits > 0
        kills += 1
    assert kills >= 2
