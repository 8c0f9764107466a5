"""The serving path's stage clock (``timing.PhaseClock``) on the CPU.

- Thread safety: twelve threads record ``host``, ``add`` and ``count``
  into one clock while another settles it; the totals are exact. The
  benchmark's ``recorders.shared_phase_clock()`` (a subclass that holds a
  lock of its own around ``settle()``) settles the same way, with no
  deadlock and no lost update.
- A served store with four client threads, its clock armed after
  ``serve()`` has started, records the serving stages (``queue``,
  ``dispatch``, ``batch.wait``, ``dispatcher``), ``post``, ``plan.cpu``
  and the tallies; ``n.rows.matched`` equals the answers' rows and
  ``n.launch.*`` the scan kernels' calls.
- ``NULL_CLOCK`` reads no CPU clock and installs no collector callback;
  an armed clock times the collector and its callback goes with it.
- The ten per-layer readers of ``geobench/metrics`` over a synthetic
  context.
- The Chrome export's ``ts`` lies on the profiler's clock.
"""

import gc
import json
import statistics
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType, conf
from geomesa_tpu_torch.metrics import MetricsRegistry
from geomesa_tpu_torch.obs import trace as otrace
from geomesa_tpu_torch.scan import block_kernels as bk
from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

torch.set_num_threads(1)

DAY = 86_400_000
# more recording threads than a test host usually has cores
THREADS, ROUNDS = 12, 400
QUERIES = [
    "bbox(geom, -10, -10, 10, 10)",
    "bbox(geom, 5, 5, 40, 30) AND dtg DURING 2024-01-03T00:00:00Z/2024-01-09T00:00:00Z",
    "bbox(geom, -50, -40, -20, 0) AND dtg DURING 2024-01-05T00:00:00Z/2024-01-06T12:00:00Z",
    "bbox(geom, 20, -30, 25, -25)",
    "bbox(geom, -60, -45, 60, 45)",
    "bbox(geom, 170, 80, 175, 85)",  # empty result
]


@pytest.fixture(scope="module")
def store():
    sft = FeatureType.from_spec("ev", "kind:String,dtg:Date,*geom:Point:srid=4326")
    ds = DataStore(device="cpu", tile=4096, metrics=MetricsRegistry())
    ds.create_schema(sft)
    rng = np.random.default_rng(11)
    n = 30_000
    t0 = np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64)
    ds.write("ev", FeatureCollection.from_columns(
        sft, np.arange(n),
        {
            "kind": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
            "dtg": t0 + rng.integers(0, 20 * DAY, n),
            "geom": (rng.uniform(-60, 60, n), rng.uniform(-45, 45, n)),
        },
    ))
    yield ds
    ds.clock = NULL_CLOCK
    ds.close()


@pytest.fixture
def clocked(store):
    """The store with a fresh armed clock; NULL_CLOCK again afterwards."""
    store.clock = clock = PhaseClock()
    try:
        yield clock
    finally:
        store.clock = NULL_CLOCK


def _record_from_threads(clock, n_threads=THREADS, rounds=ROUNDS):
    """n_threads threads record into ``clock`` while another settles it
    over and over, with the interpreter switching threads as often as it
    can; returns the final settle."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        return _record(clock, n_threads, rounds)
    finally:
        sys.setswitchinterval(old)


def _record(clock, n_threads, rounds):
    start = threading.Barrier(n_threads + 1)
    done = threading.Event()

    def recorder(i):
        start.wait()
        for _ in range(rounds):
            with clock.host("h"):
                pass
            clock.add("a", 0.25)
            clock.count("n.c")
            clock.count("n.k", 3)

    def settler():
        start.wait()
        while not done.is_set():
            clock.settle()

    s = threading.Thread(target=settler)
    s.start()
    with ThreadPoolExecutor(n_threads) as ex:
        list(ex.map(recorder, range(n_threads)))
    done.set()
    s.join(30)
    assert not s.is_alive()
    return clock.settle()


def test_threads_record_into_one_clock_with_no_update_lost():
    out = _record_from_threads(PhaseClock())
    assert out["a"] == THREADS * ROUNDS * 0.25
    assert out["n.c"] == THREADS * ROUNDS and out["n.k"] == THREADS * ROUNDS * 3
    assert isinstance(out["n.c"], int)
    assert out["h"] > 0 and out["cpu"] > 0 and out["gc"] >= 0


def test_shared_phase_clock_settles_with_no_deadlock_and_no_lost_update():
    from geobench import recorders

    clock = recorders.shared_phase_clock()
    result: list = []
    t = threading.Thread(target=lambda: result.append(_record_from_threads(clock)), daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), "the subclass deadlocked on the clock"
    out = result[0]
    assert out["a"] == THREADS * ROUNDS * 0.25
    assert out["n.c"] == THREADS * ROUNDS and out["n.k"] == THREADS * ROUNDS * 3
    assert {"h", "cpu", "gc"} <= set(out)


def _ids(fc) -> np.ndarray:
    return np.sort(np.asarray(fc.ids, np.int64))


def _shifted(c: int) -> list:
    """QUERIES with every bbox moved east by c / 8 degree."""
    out = []
    for q in QUERIES:
        head, rest = q.split("(", 1)
        args, tail = rest.split(")", 1)
        geom, *xy = args.split(",")
        xy = [float(v) + (c / 8 if i % 2 == 0 else 0) for i, v in enumerate(xy)]
        out.append(f"{head}({geom}, {', '.join(map(str, xy))}){tail}")
    return out


def test_served_store_records_the_serving_stages(store):
    sched = store.serve()
    try:
        sched.submit("ev", QUERIES[0]).result(120)  # the dispatcher is running
        store.clock = clock = PhaseClock()

        def client(c):
            # distinct per client, so no two submissions coalesce
            return [sched.submit("ev", q).result(120) for q in _shifted(c)]

        with ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(client, range(4)))
        store.clock = NULL_CLOCK
    finally:
        sched.close()
    s = clock.settle()
    for name in ("queue", "dispatch", "batch.wait", "dispatcher", "post", "plan", "plan.cpu",
                 "decode"):
        assert s.get(name, 0) > 0, name
    assert s["n.memo.hit"] + s["n.memo.miss"] >= 4 * len(QUERIES)
    assert s.get("n.launch.single", 0) + s.get("n.launch.fused", 0) >= 1
    assert s["n.rows.scanned"] > 0
    assert s["n.rows.matched"] == sum(len(fc) for fcs in outs for fc in fcs)
    # the dispatcher's busy time holds each batch's dispatch
    assert s["dispatcher"] >= s["dispatch"]
    # equal answers to sequential queries
    for c, fcs in enumerate(outs):
        for q, fc in zip(_shifted(c), fcs):
            assert np.array_equal(_ids(fc), _ids(store.query("ev", q)))


def test_rows_matched_equals_the_answers_rows(store, clocked):
    outs = [store.query("ev", q) for q in QUERIES] + store.query_many("ev", QUERIES)
    assert clocked.settle()["n.rows.matched"] == sum(len(fc) for fc in outs)


def test_memo_tallies_a_miss_then_a_hit(store, clocked):
    q = "bbox(geom, 1.25, 2.5, 3.75, 5) AND dtg DURING 2024-01-02T00:00:00Z/2024-01-03T00:00:00Z"
    store.query("ev", q)
    first = clocked.settle()
    store.query("ev", q)
    second = clocked.settle()
    assert first["n.memo.miss"] >= 1
    assert second.get("n.memo.hit", 0) - first.get("n.memo.hit", 0) >= 1
    assert second["n.memo.miss"] == first["n.memo.miss"]


def test_launch_tallies_equal_the_scan_kernel_calls(store, clocked, monkeypatch):
    calls = {"single": 0, "fused": 0}
    k1, k2 = bk.scan_planes, bk.scan_planes_multi

    def single(*a, **kw):
        calls["single"] += 1
        return k1(*a, **kw)

    def fused(*a, **kw):
        calls["fused"] += 1
        return k2(*a, **kw)

    monkeypatch.setattr(bk, "scan_planes", single)
    monkeypatch.setattr(bk, "scan_planes_multi", fused)
    for q in QUERIES:
        store.query("ev", q)
    # a batch wide enough to fill fused chunks, and one small enough to
    # take the single-query route
    wide = [f"bbox(geom, {x}, -40, {x + 25}, 40)" for x in range(-60, 35, 5)]
    store.query_many("ev", wide)
    store.query_many("ev", QUERIES[:2])
    s = clocked.settle()
    assert calls["fused"] >= 1 and calls["single"] >= 1
    assert s.get("n.launch.single", 0) == calls["single"]
    assert s.get("n.launch.fused", 0) == calls["fused"]
    assert s["n.rows.scanned"] % store.table("ev", "z2").block == 0


def test_null_clock_reads_no_cpu_clock_and_installs_no_gc_callback(store, monkeypatch):
    assert store.clock is NULL_CLOCK
    callbacks = list(gc.callbacks)

    def forbidden():
        raise AssertionError("a CPU clock was read with the clock off")

    monkeypatch.setattr(time, "thread_time", forbidden)
    monkeypatch.setattr(time, "process_time", forbidden)
    outs = [store.query("ev", q) for q in QUERIES]
    outs += store.query_many("ev", QUERIES)
    sched = store.serve()
    try:
        outs += [f.result(120) for f in [sched.submit("ev", q) for q in QUERIES]]
    finally:
        sched.close()
    monkeypatch.undo()
    # nothing added (a clock dropped meanwhile may have taken its own away)
    assert all(any(cb is c for c in callbacks) for cb in gc.callbacks)
    assert sum(len(fc) for fc in outs) > 0


def test_armed_clock_times_the_collector_and_its_callback_goes_with_it():
    before = list(gc.callbacks)
    clock = PhaseClock()
    mine = [cb for cb in gc.callbacks if not any(cb is c for c in before)]
    assert len(mine) == 1
    junk = []
    for _ in range(2000):
        a, b = [], []
        a.append(b)
        b.append(a)
        junk.append(a)
    del junk, a, b
    gc.collect()
    assert clock.settle()["gc"] > 0
    del clock
    assert not any(cb is mine[0] for cb in gc.callbacks)


def test_null_clock_has_every_method_as_a_no_op():
    assert not NULL_CLOCK.armed and PhaseClock.armed
    with NULL_CLOCK.host("x"), NULL_CLOCK.launching("w"), \
            NULL_CLOCK.device("y", torch.device("cpu")), NULL_CLOCK.thread_cpu("z"):
        pass
    NULL_CLOCK.add("a", 1.0)
    NULL_CLOCK.count("n.a")


def test_host_phases_are_operator_ranges_while_a_profiler_records(tmp_path):
    clock = PhaseClock()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with clock.host("plan"):
            time.sleep(0.001)
        with clock.launching("dispatch"):
            torch.ones(4).add_(1)
        clock.add("queue", 0.5)
        gc.collect()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        cats = {e["name"]: e.get("cat") for e in json.load(fh)["traceEvents"]}
    # operator ranges: the profiler mirrors no user annotation of them
    # onto a device's timeline
    assert {cats.get(f"phase.{n}") for n in ("plan", "dispatch", "gc")} == {"cpu_op"}
    assert "phase.queue" not in cats
    with clock.host("plan"):  # no profiler: no range, the time still counts
        pass
    out = clock.settle()
    assert out["plan"] > 0.001 and out["dispatch"] > 0


def test_launching_stays_the_base_host_under_a_subclass():
    class Annotating(PhaseClock):
        def host(self, name):
            raise AssertionError("a subclass's host wrapped device launches")

    clock = Annotating()
    with clock.launching("dispatch"):
        pass
    assert clock.settle()["dispatch"] >= 0
    with NULL_CLOCK.launching("dispatch"):
        pass


# ------------------------------------------------------------- readers

READERS = {
    "plan_cpu_ms.query": ({"plan.cpu": 0.5}, 5.0),
    "plan_memo_hit.query": ({"n.memo.hit": 3, "n.memo.miss": 1}, 75.0),
    "queue_ms.query": ({"queue": 2.0}, 20.0),
    "batch_wait_ms.query": ({"batch.wait": 0.3}, 3.0),
    "dispatcher_ms.query": ({"dispatcher": 1.0}, 10.0),
    "post_ms.query": ({"post": 0.1}, 1.0),
    "rows_per_hit.query": ({"n.rows.scanned": 8192, "n.rows.matched": 64}, 128.0),
    "launches_per_query.query": ({"n.launch.single": 60, "n.launch.fused": 40}, 1.0),
    "gc_ms.query": ({"gc": 0.05}, 0.5),
    "cpu_ms.query": ({"cpu": 4.0}, 40.0),
}


def _reader(name):
    from geobench.run import metric_reader

    return metric_reader(name)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_its_number(name):
    phase_s, want = READERS[name]
    ctx = {"phase_s": {"plan": 1.0, **phase_s}, "n_queries": 100}
    assert _reader(name)(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_none_without_its_inputs(name):
    read = _reader(name)
    phase_s, _ = READERS[name]
    assert read({"n_queries": 100}) is None  # an untraced run
    assert read({"phase_s": {"plan": 1.0}, "n_queries": 100}) is None
    if name not in ("plan_memo_hit.query", "rows_per_hit.query"):
        assert read({"phase_s": {"plan": 1.0, **phase_s}, "n_queries": 0}) is None
    zero = {k: 0 for k in phase_s}
    if name in ("plan_memo_hit.query", "rows_per_hit.query", "launches_per_query.query"):
        # a ratio of tallies with a zero denominator
        zero_ctx = {"phase_s": zero, "n_queries": 0}
        assert read(zero_ctx) is None


# -------------------------------------------------------- chrome export


def test_chrome_export_lies_on_the_profiler_clock(store):
    conf.OBS_TRACE_SAMPLE.set(1)
    old = otrace.tracer()
    tr = otrace.install(otrace.Tracer())
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("outer"):
                store.query("ev", QUERIES[1])
        events = tr.chrome_payload()["traceEvents"]
    finally:
        conf.OBS_TRACE_SAMPLE.clear()
        otrace.install(old)
    outer = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer"]
    assert len(outer) == 1
    o0 = outer[0].start_ns() / 1e3
    o1 = o0 + outer[0].duration_ns() / 1e3
    roots = [e for e in events if e["tid"] == 0]
    assert len(roots) == 1
    root = roots[0]
    assert o0 - 1e3 <= root["ts"] and root["ts"] + root["dur"] <= o1 + 1e3
    me = threading.get_ident()
    assert all(e["args"]["tid"] == me for e in events)
    # every child lies within its root
    assert statistics.fmean(e["ts"] >= root["ts"] - 1 for e in events) == 1.0
