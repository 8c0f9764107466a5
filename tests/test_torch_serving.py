"""The port's serving tier: QueryScheduler against sequential ``query``.

On a port ``DataStore(device="cpu")``: threaded submissions equal
sequential queries per plan kind (fused index scans, a full-table host
scan, an empty result, INCLUDE); a full queue sheds ``block=False``
callers with ServingRejected; ``geomesa.serving.batch.max`` caps the
batch; ``close`` drains what is queued. The scheduler's counters are read
from the metrics registry it counts into (leaders in
``batched_queries``, identical queries of one window in ``coalesced``).
Equality is exact (sorted ids).
"""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType, conf
from geomesa_tpu_torch.metrics import MetricsRegistry
from geomesa_tpu_torch.serving import QueryScheduler, ServingConfig, ServingRejected

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

DAY = 86_400_000


@pytest.fixture(scope="module")
def store():
    sft = FeatureType.from_spec("ev", "kind:String,dtg:Date,*geom:Point:srid=4326")
    ds = DataStore(device="cpu", tile=4096, metrics=MetricsRegistry())
    ds.create_schema(sft)
    rng = np.random.default_rng(5)
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
    return ds


QUERIES = [
    "bbox(geom, -10, -10, 10, 10)",
    "bbox(geom, 5, 5, 40, 30) AND dtg DURING 2024-01-03T00:00:00Z/2024-01-09T00:00:00Z",
    "bbox(geom, -50, -40, -20, 0) AND dtg DURING 2024-01-05T00:00:00Z/2024-01-06T12:00:00Z",
    "bbox(geom, 20, -30, 25, -25)",
    "kind = 'b'",                      # full-table host scan
    "bbox(geom, 170, 80, 175, 85)",    # empty result
    "INCLUDE",
]


def _ids(fc) -> np.ndarray:
    return np.sort(np.asarray(fc.ids, np.int64))


SERVING = ("submitted", "shed", "coalesced", "batches", "batched_queries")


def _counts(reg) -> dict:
    return {k: reg.counter_value(f"geomesa.serving.{k}") for k in SERVING}


def test_scheduler_threaded_equals_sequential(store):
    seq = [store.query("ev", q) for q in QUERIES]
    c0 = _counts(store.metrics)
    sched = store.serve()
    assert sched.metrics is store.metrics
    assert store.serve() is sched  # one scheduler while it is open
    try:
        def worker(_):
            futs = [sched.submit("ev", q) for q in QUERIES]
            return [f.result(120) for f in futs]

        with ThreadPoolExecutor(4) as ex:
            all_outs = list(ex.map(worker, range(4)))
    finally:
        sched.close()
    assert sched.closed and store.serve() is not sched
    store.close()
    assert store.scheduler.closed
    for outs in all_outs:
        for a, b in zip(seq, outs):
            assert np.array_equal(_ids(a), _ids(b))
    assert sum(len(a) for a in seq) > 0
    c = {k: v - c0[k] for k, v in _counts(store.metrics).items()}
    assert c["submitted"] == c["batched_queries"] + c["coalesced"] == 4 * len(QUERIES)
    assert 1 <= c["batches"] <= 4 * len(QUERIES) and c["shed"] == 0


def test_full_queue_sheds_non_blocking_callers(store):
    reg = MetricsRegistry()
    sched = QueryScheduler(store, ServingConfig(queue_max=2), metrics=reg)  # not started
    queued = [sched.submit("ev", q) for q in QUERIES[:2]]
    shed = sched.submit("ev", QUERIES[2], block=False)
    with pytest.raises(ServingRejected):
        shed.result(0)
    assert _counts(reg)["shed"] == 1 and sched.queue_depth == 2
    sched.start()
    sched.close()
    for q, f in zip(QUERIES, queued):
        assert np.array_equal(_ids(f.result(0)), _ids(store.query("ev", q)))


def test_batch_max_caps_the_batch(store):
    conf.SERVING_BATCH_MAX.set(3)
    try:
        reg = MetricsRegistry()
        sched = QueryScheduler(store, metrics=reg)
        assert sched.conf.batch_max == 3
        futs = [sched.submit("ev", q) for q in QUERIES]
        sched.start()
        outs = [f.result(120) for f in futs]
        sched.close()
    finally:
        conf.SERVING_BATCH_MAX.clear()
    c = _counts(reg)
    assert c["batches"] == 3 and c["batched_queries"] == len(QUERIES)  # 3 + 3 + 1
    assert c["coalesced"] == 0
    for q, out in zip(QUERIES, outs):
        assert np.array_equal(_ids(out), _ids(store.query("ev", q)))


def test_close_drains_the_queue(store):
    sched = QueryScheduler(store)
    futs = [sched.submit("ev", q) for q in QUERIES]
    sched.start()
    sched.close()  # the dispatcher drains every queued query before it exits
    assert all(f.done() for f in futs)
    for q, f in zip(QUERIES, futs):
        assert np.array_equal(_ids(f.result(0)), _ids(store.query("ev", q)))
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit("ev", QUERIES[0])
    never_started = QueryScheduler(store)
    fut = never_started.submit("ev", QUERIES[0])
    never_started.close()
    with pytest.raises(RuntimeError, match="scheduler closed"):
        fut.result(0)


def test_window_adapts_to_load(store):
    sched = QueryScheduler(store, ServingConfig(window_ms=8.0))
    sched._adapt(5)
    assert sched.window_s == pytest.approx(0.001)  # cap / 8 on the first fused drain
    for _ in range(5):
        sched._adapt(5)
    assert sched.window_s == pytest.approx(0.008)  # doubled up to the cap
    sched._adapt(1)
    assert sched.window_s == pytest.approx(0.004)  # a singular drain halves it
    for _ in range(5):
        sched._adapt(1)
    assert sched.window_s == 0.0  # idle: no window at all


def test_counters_survive_many_racing_submitters(store):
    """More threads than cores with a short switch interval: a lost
    update of ``submitted``, ``batched_queries`` or ``coalesced`` would
    break the totals."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    reg = MetricsRegistry()
    sched = QueryScheduler(store, ServingConfig(window_ms=1.0), metrics=reg).start()
    try:
        def worker(k):
            return [sched.submit("ev", QUERIES[(k + i) % 4]) for i in range(2)]

        threads = 12
        with ThreadPoolExecutor(threads) as ex:
            futs = [f for fs in ex.map(worker, range(threads)) for f in fs]
        outs = [f.result(120) for f in futs]
    finally:
        sched.close(timeout=120)
        sys.setswitchinterval(old)
    assert not sched._thread.is_alive()
    c = _counts(reg)
    assert c["submitted"] == c["batched_queries"] + c["coalesced"] == threads * 2 == len(outs)
    assert threading.active_count() < 50
