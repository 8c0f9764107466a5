"""The port's lock witness (geomesa_tpu_torch.lockwitness) against the
JAX package's, on the CPU.

The runtime's contract, in both packages alike: disarmed, ``witness``
returns the lock it was given; armed, nested acquisitions record
edges, a re-entrant acquisition records nothing, two instances under one
name record an ``aliased`` event, a two-thread inversion is reported as
a cycle, a Condition's wait releases its held frame, and a fault point
reached under a witnessed lock records a ``blocking`` event.

The workload checks hold the two runtimes against each other: both
witnesses armed, the same seeded workload (write, query,
``query_many``, a sliced ``fold_upsert`` with a pacer, ``serve()`` with a
few submits, a pipelined ``BulkLoader`` load of a second type, tracing
and a metrics registry on) runs through each package, and the observed edge sets and blocking events must be equal,
both graphs acyclic, and each of the port's five locks witnessed. The
graphs are dumped into ``tmp_path``. A second workload on a cached store
(result hits, tile compositions, single-flight threads, a delete and a
modify under the write lock, a fold, ``serve()``) witnesses the cache
tier's three locks and the estimate accounting's lock under the JAX
package's names, with the same edges and blocking events. A third
workload drives the serving tier and the ops plane: tenant-tagged
scheduler traffic on a cached store with an SLO tracker (misses through
the dispatcher, hits served at admission, a staged flood shed at its
tenant quota), then ``/metrics``, ``/health``, ``/stats`` and
``/debug/vars`` scrapes and ``DataStore.close``; the tenant registry's,
the SLO trackers' and the telemetry recorder's locks are witnessed, and
the edges and blocking events equal the JAX package's. A fourth
workload drives the streaming tier: a LambdaStore with a write-ahead log
over a served store, a sliced fold flush racing a writer thread and a
query thread, then a delete, a checkpoint and a health scrape; the WAL's,
the hot tier's, the flusher's and the LambdaStore's locks are witnessed
under the JAX package's names, with the same edges and blocking points.
A fifth workload drives standing queries and replication: geofence,
proximity and window subscriptions on a WAL-backed LambdaStore (fused and
host matches, alerts drained, an unsubscribe, a checkpoint), then a
segment shipper feeding a follower that catches up, answers a query and
is promoted; the match gate's, the subscription index's, the window
aggregator's, the alert queue's, the shipper's and the replica's locks
are witnessed under the JAX package's names, with the same edges and
blocking points. A sixth workload drives the tile pyramid: a cached
store with a ``TilePyramid`` attached, pyramid fetches on two threads
racing a LambdaStore's sliced fold flush, then a schema-drop sweep; the
pyramid's lock (``TilePyramid._lock``, the JAX package's rank 54) is
witnessed with the cache tier's, and the edges equal the JAX package's.
A seventh workload arms the tuning tier (a pulse every query) behind the
scheduler and the ops plane: ``TuningManager._lock`` is witnessed under
the JAX package's name as a strict leaf, and the edges equal the JAX
package's. Last, the port's workloads run together (the streaming one
under a chaos schedule armed at rate 0) and are held against the port's
own static lock model (``geomesa_tpu_torch/analysis/lockmodel.py``), as
the JAX package's witness test holds its workload against its model:
every ``LOCKS`` entry witnessed, the union graph acyclic and within the
predicted edges, no fault point under a hot lock but the declared ones.
"""

import importlib
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import conf as jconf
from geomesa_tpu import fault as jfault
from geomesa_tpu import ingest as jingest
from geomesa_tpu import lockwitness as jlw
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu.obs import trace as jtrace
from geomesa_tpu_torch import conf as tconf
from geomesa_tpu_torch import fault as tfault
from geomesa_tpu_torch import ingest as tingest
from geomesa_tpu_torch import lockwitness as tlw
from geomesa_tpu_torch import metrics as tmetrics
from geomesa_tpu_torch.obs import trace as ttrace

torch.set_num_threads(1)

JAX = SimpleNamespace(name="jax", pkg=geomesa_tpu, lw=jlw, fault=jfault, conf=jconf,
                      metrics=jmetrics, trace=jtrace, ingest=jingest, kw={})
PORT = SimpleNamespace(name="port", pkg=geomesa_tpu_torch, lw=tlw, fault=tfault, conf=tconf,
                       metrics=tmetrics, trace=ttrace, ingest=tingest, kw={"device": "cpu"})
BOTH = (JAX, PORT)
PORT_LOCKS = {"DataStore._write_lock", "DataStore._id_lock", "MetricsRegistry._lock",
              "Tracer._lock", "QueryScheduler._cond"}


@pytest.fixture(autouse=True)
def _disarm():
    """Every test leaves both witnesses disarmed, both injectors clean and
    fresh tracers installed (objects built while armed keep their
    wrappers; they only feed the report, which enable() resets)."""
    yield
    for P in BOTH:
        P.lw.disable()
        P.fault.injector().reset()
        P.conf.OBS_TRACE_SAMPLE.clear()
        P.trace.install(P.trace.Tracer())


@pytest.mark.parametrize("ctor", [threading.Lock, threading.RLock, threading.Condition])
def test_disarmed_witness_is_passthrough(ctor):
    for P in BOTH:
        P.lw.disable()
        lock = ctor()
        assert P.lw.witness(lock, "X._lock") is lock


def test_armed_witness_wraps_and_delegates():
    tlw.enable()
    lock = tlw.witness(threading.Lock(), "X._lock")
    assert lock is not None and not lock.locked()
    assert lock.acquire(timeout=1.0)
    assert lock.locked() and tlw.held_locks() == ("X._lock",)
    lock.release()
    assert tlw.held_locks() == ()
    assert "X._lock" in tlw.REPORT.snapshot()["seen"]


def _nesting(lw):
    a = lw.witness(threading.Lock(), "Fix._a")
    b = lw.witness(threading.RLock(), "Fix._b")
    b2 = lw.witness(threading.RLock(), "Fix._b")
    held = []
    with a:
        held.append(lw.held_locks())
        with b:
            with b:  # re-entrant, same instance: no edge, not aliased
                pass
            with b2:  # another instance, same name: aliased, not an edge
                held.append(lw.held_locks())
    held.append(lw.held_locks())
    return held


def test_edges_reentrancy_and_aliasing():
    snaps = []
    for P in BOTH:
        P.lw.enable()
        held = _nesting(P.lw)
        snap = P.lw.REPORT.snapshot()
        assert held[0] == ("Fix._a",) and held[-1] == ()
        assert ("Fix._a", "Fix._b") in P.lw.REPORT.edges
        assert ("Fix._b", "Fix._b") not in P.lw.REPORT.edges
        assert snap["aliased"] == {"Fix._b ~ Fix._b": 1}
        assert P.lw.REPORT.cycle() is None
        snaps.append((held, snap))
        P.lw.disable()
    assert snaps[0] == snaps[1]


def test_two_thread_inversion_reports_cycle(tmp_path):
    """Thread one nests A -> B, thread two (strictly after) B -> A: the
    witness reports the cycle though the run never deadlocked."""
    payloads = []
    for P in BOTH:
        P.lw.enable()
        a = P.lw.witness(threading.Lock(), "Inv._a")
        b = P.lw.witness(threading.Lock(), "Inv._b")
        first_done = threading.Event()

        def t1():
            with a:
                with b:
                    pass
            first_done.set()

        def t2():
            first_done.wait()
            with b:
                with a:
                    pass

        threads = [threading.Thread(target=t) for t in (t1, t2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        cyc = P.lw.REPORT.cycle()
        assert cyc is not None and set(cyc) == {"Inv._a", "Inv._b"}
        out = P.lw.dump(str(tmp_path / f"{P.name}.json"))
        payload = json.load(open(out))
        assert payload["cycle"] is not None
        assert "Inv._a -> Inv._b" in payload["edge_counts"]
        payloads.append(payload)
        P.lw.disable()
    assert payloads[0] == payloads[1]


def test_dump_defaults_to_the_artifact_knob(tmp_path):
    tlw.enable()
    with tlw.witness(threading.Lock(), "K._a"):
        with tlw.witness(threading.Lock(), "K._b"):
            pass
    tconf.LOCK_WITNESS_ARTIFACT.set(str(tmp_path / "w.json"))
    try:
        path = tlw.dump()
    finally:
        tconf.LOCK_WITNESS_ARTIFACT.clear()
    assert path == str(tmp_path / "w.json")
    assert json.load(open(path))["edges"] == [["K._a", "K._b"]]


def test_condition_wait_releases_held_frame():
    for P in BOTH:
        P.lw.enable()
        cond = P.lw.witness(threading.Condition(), "Fix._cond")
        during = []

        def waker():
            with cond:
                cond.notify_all()

        with cond:
            assert P.lw.held_locks() == ("Fix._cond",)
            t = threading.Thread(target=waker)
            t.start()
            cond.wait(timeout=5.0)
            during.append(P.lw.held_locks())
            t.join()
            assert cond.wait_for(lambda: True, timeout=1.0)
        assert during == [("Fix._cond",)]
        assert P.lw.held_locks() == ()
        P.lw.disable()


def test_fault_points_record_blocking_events():
    snaps = []
    for P in BOTH:
        P.lw.enable()
        lock = P.lw.witness(threading.Lock(), "Fix._hot")
        P.fault.fault_point("persist.gc")  # no lock held: no event
        with lock:
            P.fault.fault_point("persist.gc")
        snaps.append(P.lw.REPORT.snapshot()["blocking"])
        P.lw.disable()
    assert snaps[0] == snaps[1] == {"Fix._hot @ persist.gc": 1}


def test_witness_knob_arms_at_import():
    """``geomesa.tpu.lock.witness`` (env GEOMESA_TPU_LOCK_WITNESS) arms
    the witness when the module loads, as the JAX package's does."""
    import os
    import subprocess
    import sys

    code = ("from geomesa_tpu_torch import lockwitness as w, metrics as m; "
            "print(w.ENABLED, type(m.MetricsRegistry()._lock).__name__)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, GEOMESA_TPU_LOCK_WITNESS="1", PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "_WitnessedLock"]


# -- the workload, held against the JAX package's ------------------------------

SPEC = "name:String,age:Integer,dtg:Date,*geom:Point:srid=4326"
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
QUERIES = [
    "bbox(geom, -30, -20, 10, 10)",
    "bbox(geom, 0, 0, 40, 30) AND dtg DURING 2024-01-02T00:00:00Z/2024-01-09T00:00:00Z",
    "name = 'b'",
]


def _workload(P):
    """Arm, build and drive one store; return the witness snapshot and
    the query answers (the workload's own correctness check)."""
    P.lw.enable()
    P.conf.OBS_TRACE_SAMPLE.set(1)
    P.trace.install(P.trace.Tracer())  # constructed armed: its lock is wrapped
    reg = P.metrics.MetricsRegistry()
    rng = np.random.default_rng(21)
    n = 2_000
    cols = {"name": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
            "age": rng.integers(0, 50, n).astype(np.int32),
            "dtg": T0 + rng.integers(0, 10 * DAY, n),
            "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))}
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds = P.pkg.DataStore(tile=1024, metrics=reg, **P.kw)
    ds.create_schema(sft)
    head = {k: (v[0][:1500], v[1][:1500]) if k == "geom" else v[:1500] for k, v in cols.items()}
    ds.write("t", P.pkg.FeatureCollection.from_columns(sft, np.arange(1500), head))
    answers = [np.asarray(ds.query("t", q).ids).tolist() for q in QUERIES]
    answers += [np.asarray(r.ids).tolist() for r in ds.query_many("t", QUERIES)]
    # a pipelined bulk load of a second type: the loader's condition and
    # stage lock, then its publish under the write lock
    ds.create_schema(P.pkg.FeatureType.from_spec("b", SPEC))
    loader = P.ingest.BulkLoader(ds, "b", config=P.ingest.PipelineConfig(workers=2, queue_depth=1))
    for s in range(0, n, 500):
        part = {k: (v[0][s:s + 500], v[1][s:s + 500]) if k == "geom" else v[s:s + 500]
                for k, v in cols.items()}
        loader.put(P.pkg.FeatureCollection.from_columns(ds.get_schema("b"), np.arange(s, s + 500), part))
    answers.append(loader.close().written)
    answers += [np.asarray(ds.query("b", q).ids).tolist() for q in QUERIES]
    tail = {k: (v[0][1000:], v[1][1000:]) if k == "geom" else v[1000:] for k, v in cols.items()}
    paced = []
    ds.fold_upsert("t", P.pkg.FeatureCollection.from_columns(sft, np.arange(1000, n), tail),
                   slice_rows=300, pacer=lambda: paced.append(1))
    sched = ds.serve()
    futs = [sched.submit("t", q) for q in QUERIES * 2]
    answers += [np.asarray(f.result(timeout=60).ids).tolist() for f in futs]
    ds.close()
    snap = P.lw.REPORT.snapshot()
    cycle = P.lw.REPORT.cycle()
    P.lw.disable()
    P.conf.OBS_TRACE_SAMPLE.clear()
    return snap, cycle, answers, len(paced)


def test_workload_edges_equal_the_jax_package(tmp_path):
    runs = {P.name: _workload(P) for P in BOTH}
    (jsnap, jcyc, jans, jpaced), (tsnap, tcyc, tans, tpaced) = runs["jax"], runs["port"]
    assert tans == jans and tpaced == jpaced == 3
    assert jcyc is None and tcyc is None  # both graphs acyclic
    assert tsnap["edges"] == jsnap["edges"]
    assert tsnap["blocking"] == jsnap["blocking"]
    assert PORT_LOCKS <= set(tsnap["seen"])  # each of the five locks witnessed
    assert set(tsnap["seen"]) <= set(jsnap["seen"])
    assert tsnap["aliased"] == jsnap["aliased"] == {}
    # the fold's points under the write lock, and the table builds
    assert tsnap["blocking"]["DataStore._write_lock @ stream.fold.publish"] == 4
    assert tsnap["blocking"]["DataStore._write_lock @ stream.fold.slice"] == 4
    assert ("DataStore._write_lock", "QueryScheduler._cond") in tsnap["edges"]
    # the pipelined load's locks
    assert {"BulkLoader._cv", "BulkLoader._stage_lock"} <= set(tsnap["seen"])
    PORT.lw.REPORT.reset()
    PORT.lw.REPORT.edges.update({e: 1 for e in tsnap["edges"]})
    out = json.load(open(PORT.lw.dump(str(tmp_path / "port.json"))))
    assert out["cycle"] is None and out["edges"] == [list(e) for e in tsnap["edges"]]


CACHE_LOCKS = {"EstimateAccuracy._lock", "GenerationTracker._lock", "ResultCache._lock",
               "TileAggregateCache._lock"}


def _cached_workload(P):
    """Arm, build and drive one store with the cache tier: repeated
    queries (result hits), bbox counts and bounds (tile compositions),
    single-flight under threads, a delete and a modify (maintenance scans
    recorded under the write lock), a fold and serve(). Returns the
    witness snapshot and the answers."""
    P.lw.enable()
    reg = P.metrics.MetricsRegistry()
    rng = np.random.default_rng(22)
    n = 2_000
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds = P.pkg.DataStore(tile=1024, metrics=reg, cache=True, **P.kw)
    ds.create_schema(sft)
    cols = {"name": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
            "age": rng.integers(0, 50, n).astype(np.int32),
            "dtg": T0 + rng.integers(0, 10 * DAY, n),
            "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))}
    ds.write("t", P.pkg.FeatureCollection.from_columns(sft, np.arange(n), cols))
    answers = []
    for _ in range(2):
        answers += [np.asarray(ds.query("t", q).ids).tolist() for q in QUERIES]
        answers += [ds.count("t", "bbox(geom, -40, -40, 40, 40)"),
                    ds.bounds("t", "bbox(geom, -40, -40, 40, 40)")]
    box = "bbox(geom, -20, -30, 30, 20)"
    threads = [threading.Thread(target=lambda: answers.append(len(ds.query("t", box))))
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    answers.append(ds.delete_features("t", "bbox(geom, 0, 0, 10, 10)"))
    answers.append(ds.modify_features("t", {"age": 3}, "name = 'b'"))
    tail = {k: (v[0][:300], v[1][:300]) if k == "geom" else v[:300] for k, v in cols.items()}
    ds.fold_upsert("t", P.pkg.FeatureCollection.from_columns(sft, np.arange(1700, 2000), tail))
    sched = ds.serve()
    futs = [sched.submit("t", q) for q in QUERIES]
    answers += [np.asarray(f.result(timeout=60).ids).tolist() for f in futs]
    ds.close()
    answers.append(ds.estimate_count("t", QUERIES[1]))
    snap = P.lw.REPORT.snapshot()
    cycle = P.lw.REPORT.cycle()
    P.lw.disable()
    return snap, cycle, answers


def test_cached_workload_edges_equal_the_jax_package():
    """The cache tier's three locks and the accuracy lock, witnessed under
    the JAX package's names: the same edges and blocking events."""
    (jsnap, jcyc, jans), (tsnap, tcyc, tans) = (_cached_workload(P) for P in BOTH)
    assert sorted(map(str, tans)) == sorted(map(str, jans))  # threads append in any order
    assert jcyc is None and tcyc is None
    assert CACHE_LOCKS <= set(tsnap["seen"]) and CACHE_LOCKS <= set(jsnap["seen"])
    assert tsnap["edges"] == jsnap["edges"]
    assert tsnap["blocking"] == jsnap["blocking"]
    assert set(tsnap["seen"]) <= set(jsnap["seen"])
    assert tsnap["aliased"] == jsnap["aliased"] == {}
    # the accuracy lock is taken under the store's write lock (the
    # maintenance scans record their plans), and the result cache's lock
    # reaches the generation tracker's
    assert ("DataStore._write_lock", "EstimateAccuracy._lock") in tsnap["edges"]
    assert ("ResultCache._lock", "GenerationTracker._lock") in tsnap["edges"]


SERVING_LOCKS = {"QueryScheduler._cond", "TenantRegistry._lock", "SloTracker._lock",
                 "TelemetryRecorder._lock", "ResultCache._lock", "MetricsRegistry._lock"}


def _serving_workload(P):
    """Arm, build and drive the serving tier and the ops plane on a cached
    store; return the witness snapshot, the cycle and the answers."""
    import urllib.request

    from importlib import import_module

    serving = import_module(P.pkg.__name__ + ".serving")
    P.lw.enable()
    reg = P.metrics.MetricsRegistry()
    rng = np.random.default_rng(23)
    n = 2_000
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds = P.pkg.DataStore(tile=1024, metrics=reg, cache=True, **P.kw)
    ds.create_schema(sft)
    ds.write("t", P.pkg.FeatureCollection.from_columns(sft, np.arange(n), {
        "name": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "age": rng.integers(0, 50, n).astype(np.int32),
        "dtg": T0 + rng.integers(0, 10 * DAY, n),
        "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))}))
    ds.attach_slo()
    tenants = serving.TenantRegistry(metrics=reg)
    tenants.configure("gold", weight=8.0)
    tenants.configure("bronze", weight=1.0, queue_max=2)
    sched = ds.serve()
    sched.tenants = tenants
    answers = []
    for _ in range(2):  # misses through the dispatcher, then hits at admission
        for q in QUERIES:
            answers.append(np.asarray(sched.submit("t", q, tenant="gold").result(60).ids).tolist())
    staged = serving.QueryScheduler(ds, serving.ServingConfig(queue_max=16), metrics=reg,
                                    tenants=tenants)
    boxes = [f"bbox(geom, {k}, -10, {k + 20}, 10)" for k in range(4)]
    futs = [staged.submit("t", b, block=False, tenant="bronze") for b in boxes]
    futs += [staged.submit("t", b, block=False, tenant="gold") for b in boxes[:2]]
    staged.start()
    for f in futs:
        try:
            answers.append(np.asarray(f.result(60).ids).tolist())
        except serving.ServingRejected as e:
            answers.append(str(e))
    staged.close()
    ops = ds.serve_ops()
    for path in ("/metrics", "/health", "/stats", "/debug/vars"):
        with urllib.request.urlopen(ops.url + path, timeout=30) as r:
            answers.append((path, r.status))
    ops.recorder.sample()
    answers.append(tenants.report()["tenants"][0]["shed"])
    ds.close()
    snap = P.lw.REPORT.snapshot()
    cycle = P.lw.REPORT.cycle()
    P.lw.disable()
    return snap, cycle, answers


def test_serving_and_ops_workload_edges_equal_the_jax_package():
    """Tenant-tagged scheduler traffic, cache hits at admission, a quota
    shed and ops scrapes: the same edges and blocking events as the JAX
    package's, acyclic, with the serving tier's and ops plane's locks
    witnessed under the JAX package's names; no lock nests under the
    scheduler's condition or the tenant registry's lock."""
    (jsnap, jcyc, jans), (tsnap, tcyc, tans) = (_serving_workload(P) for P in BOTH)
    assert tans == jans
    assert jcyc is None and tcyc is None
    assert SERVING_LOCKS <= set(tsnap["seen"]) and SERVING_LOCKS <= set(jsnap["seen"])
    assert tsnap["edges"] == jsnap["edges"]
    assert tsnap["blocking"] == jsnap["blocking"]
    assert set(tsnap["seen"]) <= set(jsnap["seen"])
    assert tsnap["aliased"] == jsnap["aliased"]
    outers = {a for a, _ in tsnap["edges"]}
    assert "TenantRegistry._lock" not in outers and "SloTracker._lock" not in outers
    assert "TelemetryRecorder._lock" not in outers
    assert not any(b in ("TenantRegistry._lock", "SloTracker._lock")
                   for a, b in tsnap["edges"] if a == "QueryScheduler._cond")


STREAM_LOCKS = {"WriteAheadLog._lock", "WriteAheadLog._sync_lock", "StreamingFeatureCache._lock",
                "StreamFlusher._pool_lock", "StreamFlusher._stage_lock", "LambdaStore._sub_lock",
                "DataStore._write_lock", "QueryScheduler._cond"}


def _streaming_workload(P, tmp):
    """Arm, build and drive the streaming tier: a LambdaStore with a
    write-ahead log (``sync=always``, small segments, so appends rotate)
    over a served store; a writer thread and a query thread race a sliced
    fold flush (its pacer waits on the scheduler), then a delete, a
    checkpoint and a health scrape. Returns the witness snapshot, the
    cycle and the answers."""
    import os
    import urllib.request

    from importlib import import_module

    st = import_module(P.pkg.__name__ + ".streaming")
    geo = import_module(P.pkg.__name__ + ".geometry")
    P.lw.enable()
    reg = P.metrics.MetricsRegistry()
    rng = np.random.default_rng(29)
    n = 2_000
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds = P.pkg.DataStore(tile=1024, metrics=reg, **P.kw)
    ds.create_schema(sft)
    ds.write("t", P.pkg.FeatureCollection.from_columns(sft, [str(i) for i in range(n)], {
        "name": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "age": rng.integers(0, 50, n).astype(np.int32),
        "dtg": T0 + rng.integers(0, 10 * DAY, n),
        "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))}))
    ds.compact("t")
    root = os.path.join(tmp, P.name)
    lam = st.LambdaStore(
        ds, "t", config=st.StreamConfig(workers=2, chunk_rows=64, fold_rows=200,
                                        slice_rows=100, fold_yield_ms=1.0),
        wal_dir=os.path.join(root, "_wal"),
        wal_config=st.WalConfig(sync="always", segment_bytes=1 << 14))
    lam.serve()

    def rows(seed, k):
        r = np.random.default_rng(seed)
        return [{"name": "u", "age": 1, "dtg": int(T0 + j),
                 "geom": geo.Point(float(x), float(y))}
                for j, (x, y) in enumerate(zip(r.uniform(-50, 50, k), r.uniform(-50, 50, k)))]

    lam.write(rows(1, 300), ids=[str(i) for i in range(300)])  # updates: deferred, staged
    lam.flush()
    answers = []
    start = threading.Event()

    def writer():
        start.wait()
        for b in range(4):
            lam.write(rows(10 + b, 50), ids=[f"w{b}_{j}" for j in range(50)])

    def reader():
        start.wait()
        for q in QUERIES:
            lam.query(q)

    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    start.set()
    lam.persist_hot()  # the sliced fold, racing the writer and the reader
    for t in threads:
        t.join(60)
    lam.delete(["w0_0", "w0_1"])
    lam.checkpoint(root)
    answers += [sorted(map(str, np.asarray(lam.query(q).ids).tolist())) for q in QUERIES]
    ops = lam.serve_ops()
    with urllib.request.urlopen(ops.url + "/health", timeout=30) as r:
        answers.append(json.loads(r.read())["status"])
    lam.close()
    ds.close()
    snap = P.lw.REPORT.snapshot()
    cycle = P.lw.REPORT.cycle()
    P.lw.disable()
    return snap, cycle, answers


def test_streaming_workload_edges_equal_the_jax_package(tmp_path):
    """A flush racing writes and queries through the streaming tier: the
    write-ahead log's, the hot tier's, the flusher's and the LambdaStore's
    locks witnessed under the JAX package's names, the same edges (and
    blocking points) as the JAX package's, acyclic. The fold publishes
    under the write lock and its pacer waits on the scheduler; the WAL's
    locks nest under the write lock (the per-slice watermark) and the hot
    tier's (the delete's record); only the metrics registry's lock nests
    under the WAL's append lock."""
    (jsnap, jcyc, jans), (tsnap, tcyc, tans) = (_streaming_workload(P, str(tmp_path))
                                                for P in BOTH)
    assert tans == jans
    assert jcyc is None and tcyc is None
    assert STREAM_LOCKS <= set(tsnap["seen"]) and STREAM_LOCKS <= set(jsnap["seen"])
    assert tsnap["edges"] == jsnap["edges"]
    # counts of fault points under a lock follow the race (group commits)
    assert set(tsnap["blocking"]) == set(jsnap["blocking"])
    assert tsnap["aliased"] == jsnap["aliased"]
    edges = set(map(tuple, tsnap["edges"]))
    assert ("DataStore._write_lock", "QueryScheduler._cond") in edges
    assert ("DataStore._write_lock", "WriteAheadLog._lock") in edges
    assert ("StreamingFeatureCache._lock", "WriteAheadLog._lock") in edges
    assert ("StreamingFeatureCache._lock", "StreamFlusher._stage_lock") in edges
    assert ("WriteAheadLog._sync_lock", "WriteAheadLog._lock") in edges
    # under the WAL's append lock only the registry's (the bytes gauge)
    assert {b for a, b in edges if a == "WriteAheadLog._lock"} == {"MetricsRegistry._lock"}


STANDING_LOCKS = {"_MatchGate._lock", "SubscriptionIndex._lock", "WindowedAggregator._lock",
                  "AlertQueue._lock", "SegmentShipper._lock", "ReplicaStore._apply_lock"}


def _standing_replica_workload(P, tmp):
    """Arm, then drive standing queries and replication with no racing
    thread: subscriptions on a WAL-backed LambdaStore, batches matched
    fused (K2's plain version on the port) and on the host, alerts
    drained, a window fed, an unsubscribe and a checkpoint; a shipper
    pumps to a follower that drains, answers and is promoted. Returns the
    witness snapshot, the cycle and the answers."""
    import os

    from importlib import import_module

    st = import_module(P.pkg.__name__ + ".streaming")
    geo = import_module(P.pkg.__name__ + ".geometry")
    P.lw.enable()
    reg = P.metrics.MetricsRegistry()
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds = P.pkg.DataStore(metrics=reg, **P.kw)
    ds.create_schema(sft)
    root = os.path.join(tmp, P.name)
    P.pkg.storage.persist.save(ds, root)
    lam = st.LambdaStore(ds, "t", config=st.StreamConfig(workers=2, chunk_rows=64),
                         wal_dir=os.path.join(root, "_wal"),
                         wal_config=st.WalConfig(sync="always", segment_bytes=1 << 14))
    eng = lam.standing(st.StandingConfig(fused_min_points=4, fused_gate=False))
    window = eng.add_window("n", st.WindowSpec(size_ms=1000, agg="count"))
    a = np.linspace(0, 2 * np.pi, 41)[:-1]
    lam.subscribe(st.Subscription("star", "geofence", geom=geo.Polygon(
        [(10 * np.cos(t) * (1 + k % 2), 10 * np.sin(t) * (1 + k % 2))
         for k, t in enumerate(a)])))
    lam.subscribe(st.Subscription("sq", "geofence", geom=geo.Polygon(
        [(-5, -5), (5, -5), (5, 5), (-5, 5), (-5, -5)]), attrs={"k": 1}))
    lam.subscribe(st.Subscription("near", "proximity", points=[(0.0, 0.0)],
                                  distance_m=200_000))
    rng = np.random.default_rng(31)
    answers = []
    for b in range(3):
        xs, ys = rng.uniform(-25, 25, 200), rng.uniform(-25, 25, 200)
        lam.write([{"name": "u", "age": 1, "dtg": int(T0 + j), "geom": geo.Point(float(x), float(y))}
                   for j, (x, y) in enumerate(zip(xs, ys))], ids=[f"b{b}_{j}" for j in range(200)])
        answers.append(sorted((x["sub"], x["id"]) for x in eng.alerts.drain()))
    lam.unsubscribe("near")
    lam.flush()
    lam.checkpoint(root)
    answers.append(window.value(T0 + 1000))
    a_end, b_end = st.PipeTransport.pair()
    fol = st.ReplicaStore(root, os.path.join(tmp, P.name + "_f", "_wal"), b_end, type_name="t",
                          **P.kw)
    ship = st.SegmentShipper(lam, chunk_bytes=2048)
    ship.attach(a_end, name="f")
    lam.write([{"name": "v", "age": 2, "dtg": int(T0), "geom": geo.Point(1.0, 1.0)}],
              ids=["late"])
    ship.pump()
    fol.drain()
    answers.append(sorted(map(str, np.asarray(fol.query("INCLUDE").ids).tolist())))
    answers.append((fol.replayed == lam.wal.last_seq, ship.gave_up_report()))
    lam.wal.crash()
    lam.flusher.close()
    answers.append(fol.promote(leader_wal_dir=os.path.join(root, "_wal")))
    fol.close()
    ds.close()
    snap = P.lw.REPORT.snapshot()
    cycle = P.lw.REPORT.cycle()
    P.lw.disable()
    return snap, cycle, answers


def test_standing_and_replica_workload_edges_equal_the_jax_package(tmp_path):
    """Standing queries and replication under both witnesses: the six
    locks of the two modules seen under the JAX package's names, the same
    edges and blocking points, acyclic, the same answers. The JAX
    package's global registry (its follower's promotion) is left as it
    was found."""
    from test_torch_replica import jax_global_metrics_kept

    with jax_global_metrics_kept():
        _standing_replica_edges(tmp_path)


def _standing_replica_edges(tmp_path):
    (jsnap, jcyc, jans), (tsnap, tcyc, tans) = (_standing_replica_workload(P, str(tmp_path))
                                                for P in BOTH)
    assert tans == jans and len(tans[0]) > 0
    assert jcyc is None and tcyc is None
    assert STANDING_LOCKS <= set(tsnap["seen"]) and STANDING_LOCKS <= set(jsnap["seen"])
    assert tsnap["edges"] == jsnap["edges"]
    assert set(tsnap["blocking"]) == set(jsnap["blocking"])
    assert tsnap["aliased"] == jsnap["aliased"]
    edges = set(map(tuple, tsnap["edges"]))
    # a subscribe holds the store's subscription lock over the WAL append
    assert ("LambdaStore._sub_lock", "WriteAheadLog._lock") in edges


PYRAMID_LOCKS = {"TilePyramid._lock", "ResultCache._lock", "GenerationTracker._lock",
                 "DataStore._write_lock", "StreamingFeatureCache._lock"}


def _pyramid_workload(P):
    """Arm, then race pyramid fetches (two threads, every tile at every
    zoom, twice) against a LambdaStore's sliced fold flush on a cached
    store; then fetch again and drop the schema's grids. Returns the
    witness snapshot, the cycle and the final grids."""
    from importlib import import_module

    st = import_module(P.pkg.__name__ + ".streaming")
    geo = import_module(P.pkg.__name__ + ".geometry")
    cache = import_module(P.pkg.__name__ + ".cache")
    tiles = import_module(P.pkg.__name__ + ".tiles")
    P.lw.enable()
    rng = np.random.default_rng(31)
    n = 2_000
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds = P.pkg.DataStore(tile=1024, metrics=P.metrics.MetricsRegistry(),
                         cache=cache.CacheConfig(max_bytes=1 << 22), **P.kw)
    ds.create_schema(sft)
    ds.write("t", P.pkg.FeatureCollection.from_columns(sft, [str(i) for i in range(n)], {
        "name": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "age": rng.integers(0, 50, n).astype(np.int32),
        "dtg": T0 + rng.integers(0, 10 * DAY, n),
        "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))}))
    ds.compact("t")
    pyramid = tiles.TilePyramid(ds, tiles.TilesConfig(leaf_zoom=2, px=16))
    lam = st.LambdaStore(ds, "t", config=st.StreamConfig(workers=2, chunk_rows=64,
                                                          fold_rows=200, slice_rows=100))
    r = np.random.default_rng(5)
    lam.write([{"name": "u", "age": 1, "dtg": int(T0 + j), "geom": geo.Point(float(x), float(y))}
               for j, (x, y) in enumerate(zip(r.uniform(-50, 50, 400), r.uniform(-50, 50, 400)))],
              ids=[f"h{j}" for j in range(400)])
    start = threading.Event()

    def fetcher():
        start.wait()
        for _ in range(2):
            for z in range(3):
                nx, ny = pyramid.lattice.n_tiles(z)
                for x in range(nx):
                    for y in range(ny):
                        pyramid.fetch("t", z, x, y)

    threads = [threading.Thread(target=fetcher) for _ in range(2)]
    for t in threads:
        t.start()
    start.set()
    lam.flush()  # the sliced fold, racing the fetches
    for t in threads:
        t.join(60)
    grids = [pyramid.fetch("t", z, x, y).grid.tobytes() for z in range(3)
             for x in range(pyramid.lattice.n_tiles(z)[0])
             for y in range(pyramid.lattice.n_tiles(z)[1])]
    stats = pyramid.stats()
    ds.cache.on_schema_dropped("t")
    lam.close()
    ds.close()
    snap = P.lw.REPORT.snapshot()
    cycle = P.lw.REPORT.cycle()
    P.lw.disable()
    return snap, cycle, (grids, stats["tile_deltas"] > 0)


def test_pyramid_workload_edges_equal_the_jax_package():
    """Pyramid fetches racing a sliced fold flush: the pyramid's lock is
    witnessed beside the cache tier's and the write lock, the same edges
    and blocking points as the JAX package's, acyclic. The pyramid's
    delta accounting runs under the write lock (the fold's per-slice
    mutation hook), and nothing nests under the pyramid's lock but the
    metrics registry's."""
    (jsnap, jcyc, jans), (tsnap, tcyc, tans) = (_pyramid_workload(P) for P in BOTH)
    assert tans == jans and tans[1]
    assert jcyc is None and tcyc is None
    assert PYRAMID_LOCKS <= set(tsnap["seen"]) and PYRAMID_LOCKS <= set(jsnap["seen"])
    assert tsnap["edges"] == jsnap["edges"]
    assert set(tsnap["blocking"]) == set(jsnap["blocking"])
    assert tsnap["aliased"] == jsnap["aliased"]
    edges = set(map(tuple, tsnap["edges"]))
    assert ("DataStore._write_lock", "TilePyramid._lock") in edges
    assert {b for a, b in edges if a == "TilePyramid._lock"} <= {"MetricsRegistry._lock"}


def _tuning_workload(P):
    """Arm the witness, attach an armed tuning tier (a pulse every query)
    behind the serving tier and the ops plane, and drive queries, pulses,
    the burn gate and a ``/debug/tuning`` scrape; return the snapshot,
    the cycle and the answers."""
    import urllib.request

    P.lw.enable()
    reg = P.metrics.MetricsRegistry()
    rng = np.random.default_rng(29)
    n = 2_000
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds = P.pkg.DataStore(tile=1024, metrics=reg, cache=True, **P.kw)
    ds.create_schema(sft)
    ds.write("t", P.pkg.FeatureCollection.from_columns(sft, np.arange(n), {
        "name": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "age": rng.integers(0, 50, n).astype(np.int32),
        "dtg": T0 + rng.integers(0, 10 * DAY, n),
        "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))}))
    ds.attach_slo()
    mgr = ds.attach_tuning(enabled=True, interval=1)
    sched = ds.serve()
    answers = []
    for q in QUERIES:
        answers.append(np.asarray(sched.submit("t", q, tenant="gold").result(60).ids).tolist())
        answers.append(np.asarray(ds.query("t", q).ids).tolist())
    mgr.pulse()
    ops = ds.serve_ops()
    with urllib.request.urlopen(ops.url + "/debug/tuning", timeout=30) as r:
        answers.append(r.status)
    answers.append(mgr.report()["queries"])
    ds.close()
    snap = P.lw.REPORT.snapshot()
    cycle = P.lw.REPORT.cycle()
    P.lw.disable()
    return snap, cycle, answers


def test_tuning_workload_edges_equal_the_jax_package():
    """``TuningManager._lock`` is witnessed under the JAX package's name,
    and it is a strict leaf: no lock is taken while it is held. The edges
    and blocking events equal the JAX package's, acyclic."""
    (jsnap, jcyc, jans), (tsnap, tcyc, tans) = (_tuning_workload(P) for P in BOTH)
    assert tans == jans
    assert jcyc is None and tcyc is None
    assert "TuningManager._lock" in tsnap["seen"] and "TuningManager._lock" in jsnap["seen"]
    assert tsnap["edges"] == jsnap["edges"]
    assert tsnap["blocking"] == jsnap["blocking"]
    assert not any(a == "TuningManager._lock" for a, _ in tsnap["edges"])


POD_LOCKS = {"HostGroup._probe_lock", "PodStore._route_lock"}


def _pod_workload(P):
    """Arm the witness, build a sim host group and a PodStore (both
    constructed armed), install a per-host link profile, and drive id-less
    routed writes, a query and a count; return the snapshot, the cycle and
    the answers."""
    P.lw.enable()
    pod_pkg = importlib.import_module(f"{P.pkg.__name__}.pod")
    geo = importlib.import_module(f"{P.pkg.__name__}.geometry")
    kw = {"devices": ["cpu"] * 2} if P is PORT else {}
    group = pod_pkg.make_host_group(hosts=2, devices_per_host=1, driver="sim", **kw)
    caps = group.set_link_profile([10.0, 40.0])
    pod = pod_pkg.PodStore(P.pkg.FeatureType.from_spec("p", SPEC), group)
    try:
        wrote = pod.write([{"name": "p", "age": i, "dtg": np.datetime64(T0, "ms"),
                            "geom": geo.Point(float(i), float(i))} for i in range(8)])
        answers = [caps, wrote, sorted(np.asarray(pod.query().ids).astype(str).tolist()),
                   pod.count(), [group.slot_cap(h) for h in range(2)]]
    finally:
        pod.close()
    snap = P.lw.REPORT.snapshot()
    cycle = P.lw.REPORT.cycle()
    P.lw.disable()
    return snap, cycle, answers


def test_pod_workload_edges_equal_the_jax_package():
    """``HostGroup._probe_lock`` (the link-profile install and the
    per-host cap reads) and ``PodStore._route_lock`` (the auto-id counter
    of id-less writes) are witnessed under the JAX package's names; both
    are leaves, and the edges and blocking events equal the JAX
    package's, acyclic."""
    (jsnap, jcyc, jans), (tsnap, tcyc, tans) = (_pod_workload(P) for P in BOTH)
    assert tans == jans and tans[1] == 8 and tans[3] == 8
    assert jcyc is None and tcyc is None
    assert POD_LOCKS <= set(tsnap["seen"]) and POD_LOCKS <= set(jsnap["seen"])
    assert tsnap["edges"] == jsnap["edges"]
    assert set(tsnap["blocking"]) == set(jsnap["blocking"])
    assert not any(a in POD_LOCKS for a, _ in tsnap["edges"])


def test_port_workloads_close_over_the_port_s_lock_model(tmp_path):
    """The model-vs-reality gate of the JAX package's witness test, held
    against the port's own static model (geomesa_tpu_torch/analysis/
    lockmodel.py): over the port's armed workloads together, every
    ``LOCKS`` entry is witnessed, the observed graph is acyclic and lies
    within the model's predicted edges, and no fault point fires under a
    hot lock but the declared ``DECLARED_BLOCKING`` pairs. The union graph
    is dumped into ``tmp_path``."""
    import fnmatch
    import os

    from geomesa_tpu_torch.analysis.core import Project
    from geomesa_tpu_torch.analysis.lockmodel import DECLARED_BLOCKING, LOCKS, LockModel

    # the streaming workload runs under a chaos schedule armed at rate 0
    # (constructed armed), so its fault points consult the schedule's lock
    # without firing
    PORT.lw.enable()
    with tfault.chaos(seed=3, rate=0.0, points="stream.*,streaming.*,standing.*,replica.*"):
        streaming = _streaming_workload(PORT, str(tmp_path / "stream"))[0]
    snaps = [_workload(PORT)[0], _cached_workload(PORT)[0], _serving_workload(PORT)[0], streaming,
             _standing_replica_workload(PORT, str(tmp_path / "standing"))[0],
             _pyramid_workload(PORT)[0], _tuning_workload(PORT)[0], _pod_workload(PORT)[0]]
    for prop in (tconf.CACHE_MIN_COST, tconf.SCAN_FUSED_SLOTS,
                 tconf.STREAM_FOLD_SLICE_ROWS, tconf.STREAM_CHUNK_ROWS):
        prop.clear()  # the armed controllers write through the global knobs
    seen = set().union(*(s["seen"] for s in snaps))
    edges = set().union(*(map(tuple, s["edges"]) for s in snaps))
    blocking = set().union(*(s["blocking"] for s in snaps))

    # (a) every registry lock witnessed
    assert set(LOCKS) - seen == set(), sorted(set(LOCKS) - seen)
    # (b) the union graph is acyclic
    PORT.lw.REPORT.reset()
    PORT.lw.REPORT.edges.update({e: 1 for e in edges})
    artifact = PORT.lw.dump(str(tmp_path / "port_union.json"))
    assert PORT.lw.REPORT.cycle() is None, artifact
    # (c) every observed edge is predicted by the static model
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    model = LockModel.of(Project.load(root))
    assert sorted(edges - model.predicted_edges()) == []
    # (d) no fault point under a hot lock but the declared ones
    hot = [k for k in sorted(blocking)
           if model.is_hot(k.split(" @ ")[0])
           and not any(k.split(" @ ")[0] == lock and fnmatch.fnmatch(k.split(" @ ")[1], pat)
                       for lock, pat, _ in DECLARED_BLOCKING)]
    assert hot == []
    # the load-bearing nesting was observed, not vacuously absent
    assert ("WriteAheadLog._sync_lock", "WriteAheadLog._lock") in edges
    assert ("StreamingFeatureCache._lock", "WriteAheadLog._lock") in edges
