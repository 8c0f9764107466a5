"""The port's SLO tracker (obs/slo.py) and ops plane (obs/ops.py) against
the JAX package's, on the CPU (after tests/test_obs.py's SLO layer and
tests/test_ops.py's cases that need no streaming store, CLI or tuning
tier).

- SLO windows: windowed quantiles, violation fractions and burn rates
  under the same observations at the same virtual times, slices ageing
  out, two trackers fanned out on one registry, unmatched metrics
  ignored, the default objectives following their knobs, and
  ``attach_slo`` / ``slo_report`` on real queries (a replaced tracker
  detached): reports equal the JAX package's apart from measured times;
- the ops plane: a real HTTP scrape of ``/metrics`` under serving load
  parses strictly with the same families and serving counter values;
  ``/health`` walks ready -> degraded (``scheduler.queue``) ->
  unhealthy (``scheduler.saturated`` + ``scheduler.shedding``) -> ready
  on a staged scheduler, reports ``slo.breach`` and ``stats.stale``
  (cleared by ``analyze_stats``), and ignores counters from before the
  monitor existed; the telemetry rings' window and bound, and a restart
  after stop; the debug surfaces (slow-ring filter, the audit / slow /
  Chrome cross-reference on one trace id, ``/stats``, a 404); and the
  ``DataStore.close`` lifecycle (no ops or serving thread left, the port
  rebinding at once, close idempotent);
- fault C8: the lifecycle census counts every ops, telemetry, serving and
  data-plane (``geomesa-serve``) thread in the process, and the JAX
  package's data-plane tests
  (tests/test_serve_http.py: ``serve(port=)`` starts a scheduler its
  ``DataServer.close`` leaves running) leave JAX schedulers alive in
  their xdist worker. ``close_jax_services_left_open`` closes the JAX
  package's leftover schedulers, ops planes and telemetry samplers before
  every test here (never the port's, which the census must still catch);
  a subprocess run puts a leaking file ahead of the census test, as
  ``--dist loadfile`` did;
- payloads: ``/health``, ``/stats`` and ``ops_report`` on the same seeded
  store equal the JAX package's apart from measured times.

Both packages take their native host helpers. Tolerance: exact, apart
from fields that hold a measured time.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_native import ensure_jax_native
from test_metrics import _parse_openmetrics
from test_torch_serving_tier import BOTH, JAX, PORT

torch.set_num_threads(1)

SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
Q = "BBOX(geom, -20, -20, 20, 20)"
KNOBS = ("OBS_TRACE_SAMPLE", "OBS_SLOW_MS", "OBS_SLOW_MAX", "PLAN_ESTIMATE",
         "PLAN_ESTIMATE_STALE_P90", "PLAN_ESTIMATE_MIN_COUNT", "PLAN_ESTIMATE_AUTO_ANALYZE",
         "OBS_OPS_SAMPLE_MS", "OBS_OPS_HISTORY", "OBS_SLO_QUERY_P99_MS",
         "OBS_SLO_WAL_P99_MS", "OBS_SLO_STANDING_P99_MS",
         "OBS_SLO_REPLICA_STALENESS_P99_MS", "OBS_SLO_TILES_P99_MS")


CENSUS = ("geomesa-ops", "geomesa-telemetry", "geomesa-serving", "geomesa-serve")


def census() -> list:
    """Every live ops, telemetry, serving or data-plane thread in the
    process."""
    return [t for t in threading.enumerate() if t.name in CENSUS and t.is_alive()]


def close_jax_services_left_open(timeout: float = 5.0) -> list:
    """Close the JAX package's schedulers, ops planes and telemetry
    samplers that earlier test files in this process left running, and
    join their threads; returns the names of the threads ended. A census
    thread's owner is its target's object; only owners from the JAX
    package (module ``geomesa_tpu.*``) are closed, so a port service left
    open still fails the census."""
    ended = []
    for t in census():
        owner = getattr(getattr(t, "_target", None), "__self__", None)
        if owner is None or not type(owner).__module__.startswith("geomesa_tpu."):
            continue
        if hasattr(owner, "shutdown") and hasattr(owner, "server_close"):
            owner.shutdown()  # the ops plane's HTTP server
            owner.server_close()
        elif hasattr(owner, "close"):
            owner.close()  # a QueryScheduler
        else:
            owner.stop()  # a TelemetryRecorder
        t.join(timeout)
        ended.append(t.name)
    return ended


@pytest.fixture(autouse=True)
def _fresh():
    """Both packages' native helpers, a fresh tracer, restored knobs; no
    JAX service an earlier file left open (fault C8)."""
    close_jax_services_left_open()
    ensure_jax_native()
    for P in BOTH:
        P.obs.install(P.obs.Tracer())
    yield
    for P in BOTH:
        for k in KNOBS:
            getattr(P.conf, k).clear()
        P.obs.install(P.obs.Tracer())


def _set(name, value):
    for P in BOTH:
        getattr(P.conf, name).set(value)


def _fc(P, sft, n, seed=0, prefix="r", lo=-50.0, hi=50.0):
    rng = np.random.default_rng(seed)
    return P.pkg.FeatureCollection.from_columns(
        sft, [f"{prefix}{i}" for i in range(n)],
        {"name": np.array(["n"] * n),
         "dtg": T0 + rng.integers(0, 30 * DAY, n),
         "geom": (rng.uniform(lo, hi, n), rng.uniform(lo, hi, n))},
    )


def _store(P, n=3000, metrics=True, audit=False):
    ds = P.pkg.DataStore(metrics=P.metrics.MetricsRegistry() if metrics else None,
                         audit=P.audit.AuditWriter() if audit else None, **P.kw)
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds.create_schema(sft)
    if n:
        ds.write("t", _fc(P, sft, n))
    return ds


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:  # a non-2xx answer still has a body
        with e:
            return e.code, e.read().decode()


def _reasons(report):
    return {r["reason"] for r in report["reasons"]}


# the payload fields that hold a measured time (windowed quantiles, slow
# walls, tenants' waits); a reason's detail that quotes a measured
# quantile is cut to its objective
_TIMED = {"value_ms", "wall_ms", "wall_ms_mean", "queue_wait_ms_mean", "queue_wait_ms_max"}


def _untimed(obj):
    """A payload with its measured times blanked (and reason details that
    quote one reduced to their objective)."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in _TIMED:
                out[k] = None
            elif k == "detail" and isinstance(v, str) and "ms >" in v:
                out[k] = v.split(":")[0]
            else:
                out[k] = _untimed(v)
        return out
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


# -- SLO windows --------------------------------------------------------------------


def test_slo_objective_windows_and_burn_rate():
    """Observations feed sliding windows; the report carries windowed
    quantiles, violation fractions and burn rates; old slices age out."""
    out = []
    for P in BOTH:
        o = P.obs.SloObjective("q99", "geomesa.query.scan", 0.99, 0.1, budget=0.02)
        slo = P.obs.SloTracker([o], window_s=10.0, slices=5)
        now = 1_000_000.0
        for _ in range(96):
            slo.observe("geomesa.query.scan", 0.01, now=now)
        for _ in range(4):
            slo.observe("geomesa.query.scan", 0.5, now=now)
        rep = slo.report(now=now)
        later = now + 30.0
        for _ in range(50):
            slo.observe("geomesa.query.scan", 0.01, now=later)
        rep2 = slo.report(now=later)
        # a clock that steps backwards restarts the window
        slo.observe("geomesa.query.scan", 0.3, now=now)
        rep3 = slo.report(now=now)
        out.append((rep, rep2, rep3))
    assert out[1] == out[0]
    rep, rep2, rep3 = out[1]
    row = rep["objectives"][0]
    assert (row["count"], row["violations"]) == (100, 4)
    assert row["burn_rate"] == pytest.approx(0.04 / 0.02, rel=1e-6)
    assert not row["ok"] and rep["status"] == "breach"
    row2 = rep2["objectives"][0]
    assert (row2["count"], row2["violations"], row2["ok"]) == (50, 0, True)
    assert rep2["status"] == "ok" and row2["value_ms"] <= 100.0
    assert rep3["objectives"][0]["count"] == 1


def test_two_trackers_on_one_registry_fan_out():
    """A second attach fans observations out to BOTH trackers; re-attaching
    the same tracker stays idempotent (no double counting)."""
    out = []
    for P in BOTH:
        reg = P.metrics.MetricsRegistry()
        a = P.obs.SloTracker([P.obs.SloObjective("q99", "geomesa.query.scan", 0.99, 0.1)])
        a.attach(reg)
        a.attach(reg)  # idempotent re-attach
        b = P.obs.SloTracker([P.obs.SloObjective("q99", "geomesa.query.scan", 0.99, 0.1)])
        b.attach(reg)
        reg.observe("geomesa.query.scan", 0.01)
        out.append((a.report()["objectives"][0]["count"], b.report()["objectives"][0]["count"]))
    assert out[0] == out[1] == (1, 1)


def test_slo_ignores_unmatched_metrics():
    out = []
    for P in BOTH:
        slo = P.obs.SloTracker([P.obs.SloObjective("q99", "geomesa.query.scan", 0.99, 0.1)])
        slo.observe("geomesa.stream.wal.fsync", 9.0)
        out.append(slo.report()["objectives"][0]["count"])
    assert out == [0, 0]


def test_default_objectives_follow_knobs():
    out = [[(o.name, o.metric, o.quantile, o.threshold_s, o.budget)
            for o in P.obs.default_objectives()] for P in BOTH]
    assert out[1] == out[0]
    assert {o[0] for o in out[1]} == {
        "query_p99", "fold_slice_p99", "wal_fsync_p99",
        "standing_alert_p99", "replica_staleness_p99", "tiles_p99",
    }
    for k in ("OBS_SLO_WAL_P99_MS", "OBS_SLO_STANDING_P99_MS",
              "OBS_SLO_REPLICA_STALENESS_P99_MS", "OBS_SLO_TILES_P99_MS"):
        _set(k, 0)
    _set("OBS_SLO_QUERY_P99_MS", 12.5)
    out = [[(o.name, o.threshold_s) for o in P.obs.default_objectives()] for P in BOTH]
    assert out[1] == out[0] == [("query_p99", 0.0125), ("fold_slice_p99", 0.15)]


def test_datastore_slo_report_end_to_end():
    """attach_slo wires the registry observer: real queries move the
    query_p99 objective; the report is plain JSON; an unattached store
    reports ok and empty; a store without a registry gets one; a
    re-attach replaces and detaches the old tracker. (The objective's
    threshold is set past any query's time here, so the verdict does not
    depend on the host: the JAX package's first query compiles.)"""
    _set("OBS_SLO_QUERY_P99_MS", 60_000.0)
    out = []
    for P in BOTH:
        ds0 = _store(P, n=200)
        empty = ds0.slo_report()
        ds = _store(P)
        tracker = ds.attach_slo()
        assert ds.slo is tracker
        for _ in range(5):
            ds.query("t", Q)
        rep = ds.slo_report()
        row = next(r for r in rep["objectives"] if r["objective"] == "query_p99")
        assert row["count"] == 5 and row["value_ms"] > 0
        json.dumps(rep)  # strictly serializable
        ds2 = _store(P, metrics=False)
        assert ds2.metrics is None
        ds2.attach_slo()
        assert ds2.metrics is not None
        ds2.query("t", Q)
        first = ds2.slo_report()["objectives"][0]["count"]
        old = ds2.slo
        new = ds2.attach_slo()
        assert new is not old and ds2.metrics.observer == new.observe
        ds2.query("t", Q)
        out.append((empty, _untimed(rep), first, new.report()["objectives"][0]["count"],
                    old.report()["objectives"][0]["count"]))
    assert out[1] == out[0]
    assert out[1][0] == {"status": "ok", "window_s": 0.0, "objectives": []}
    assert out[1][2:] == (1, 1, 1)  # the detached tracker is frozen


# -- the /metrics scrape ---------------------------------------------------------------


def test_metrics_scrape_parses_strict_under_serving_load():
    """A real HTTP scrape of /metrics, taken while scheduler-admitted
    queries run, parses strictly, carries the histogram families, and its
    serving counters equal the registry's once the load stops."""
    out = []
    for P in BOTH:
        ds = _store(P)
        ds.query("t", Q)
        sched = ds.serve()
        srv = ds.serve_ops()
        try:
            stop = threading.Event()
            errs = []

            def load():
                k = 0
                while not stop.is_set():
                    try:
                        sched.submit("t", f"BBOX(geom, -20, -20, {k % 7 + 1}, 20)").result(30)
                    except BaseException as e:  # pragma: no cover
                        errs.append(e)
                        return
                    k += 1

            t = threading.Thread(target=load)
            t.start()
            try:
                bodies = []
                for _ in range(3):
                    code, text = _get(srv.url + "/metrics")
                    assert code == 200
                    bodies.append(text)
            finally:
                stop.set()
                t.join()
            assert errs == []
            fams = _parse_openmetrics(bodies[-1])
            assert fams["geomesa_query_scan_seconds"][0] == "histogram"
            assert fams["geomesa_plan_estimate_error_seconds"][0] == "histogram"
            assert fams["geomesa_query_count"][0] == "counter"
            assert ds.metrics.counter_value("geomesa.obs.ops.scrapes") >= 3
            # after the load: the scrape's serving counters are the registry's
            fams = _parse_openmetrics(_get(srv.url + "/metrics")[1])
            for name in ("submitted", "batches", "batched_queries"):
                [(_, _, v)] = fams[f"geomesa_serving_{name}"][1]
                assert v == ds.metrics.counter_value(f"geomesa.serving.{name}") > 0
            kinds = {f: k for f, (k, _) in fams.items()}
        finally:
            ds.close()
        assert ds.ops.closed and sched.closed
        out.append({f: k for f, k in kinds.items()
                    if f.startswith(("geomesa_serving", "geomesa_query_scan"))})
    assert out[1] == out[0]
    assert out[1]["geomesa_serving_queue_wait_seconds"] == "histogram"


# -- the health state machine ---------------------------------------------------------


def test_health_shed_storm_and_saturated_queue():
    """Shed-counter movement since the previous evaluation is degraded; a
    FULL queue is unhealthy; a half-full queue is degraded; draining
    restores ready — with the same reports in both packages."""
    out = []
    for P in BOTH:
        ds = _store(P, n=400)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(queue_max=4))
        ds.scheduler = sched  # unstarted: a deterministic queue
        mon = P.ops.HealthMonitor(ds)
        reports = [mon.evaluate()]
        futs = [sched.submit("t", Q) for _ in range(2)]  # half full
        reports.append(mon.evaluate())
        futs += [sched.submit("t", Q) for _ in range(2)]  # full
        shed = sched.submit("t", Q, block=False)
        with pytest.raises(P.serving.ServingRejected):
            shed.result(1)
        reports.append(mon.evaluate())
        reports.append(mon.evaluate())  # the shed delta was consumed
        sched.close()  # fails the staged futures
        for f in futs:
            with pytest.raises(RuntimeError):
                f.result(1)
        ds.scheduler = None
        reports.append(mon.evaluate())
        out.append(reports)
    assert out[1] == out[0]
    r = out[1]
    assert [x["status"] for x in r] == ["ready", "degraded", "unhealthy", "unhealthy", "ready"]
    assert _reasons(r[1]) == {"scheduler.queue"}
    assert r[1]["scheduler"] == {"queue_depth": 2, "queue_max": 4}
    assert _reasons(r[2]) == {"scheduler.saturated", "scheduler.shedding"}
    assert _reasons(r[3]) == {"scheduler.saturated"}


def test_health_slo_breach_reason():
    _set("OBS_SLO_QUERY_P99_MS", 0.0001)  # everything breaches
    out = []
    for P in BOTH:
        ds = _store(P, n=500)
        ds.attach_slo()
        for _ in range(3):
            ds.query("t", Q)
        report = P.ops.HealthMonitor(ds).evaluate()
        assert report["status"] == "degraded"
        assert _reasons(report) == {"slo.breach"}
        assert "query_p99" in report["reasons"][0]["detail"]
        out.append(_untimed(report))
    assert out[1] == out[0]


def test_stale_stats_flag_health_and_manual_reanalyze():
    """Mutate without re-analyzing (the fold's sketches only accumulate),
    query the emptied region, and the health surface says "stats stale —
    re-analyze"; analyze_stats + reset clears it."""
    _set("PLAN_ESTIMATE_MIN_COUNT", 8)
    out = []
    for P in BOTH:
        ds = _store(P, n=2000)
        sft = ds.get_schema("t")
        ds.fold_upsert("t", _fc(P, sft, 2000, seed=1, lo=100.0, hi=140.0))
        mon = P.ops.HealthMonitor(ds)
        for _ in range(10):
            ds.query("t", Q)
        stale = ds.accuracy.stale()
        assert stale and stale[0][0] == "t"
        report = mon.evaluate()
        assert "stats.stale" in _reasons(report)
        detail = next(r["detail"] for r in report["reasons"] if r["reason"] == "stats.stale")
        assert "stats stale" in detail and "analyze_stats" in detail
        ds.analyze_stats("t")
        ds.accuracy.reset("t")
        for _ in range(10):
            ds.query("t", Q)
        assert ds.accuracy.stale() == []
        after = mon.evaluate()
        assert "stats.stale" not in _reasons(after)
        out.append((_untimed(report), _untimed(after)))
    assert out[1] == out[0]


def test_health_first_evaluation_ignores_preexisting_counters():
    out = []
    for P in BOTH:
        ds = _store(P, n=0)
        ds.metrics.counter("geomesa.serving.shed", 5)
        ds.metrics.counter("geomesa.standing.dropped", 3)
        mon = P.ops.HealthMonitor(ds)
        first = mon.evaluate()
        ds.metrics.counter("geomesa.serving.shed", 1)
        ds.metrics.counter("geomesa.standing.dropped", 7)
        second = mon.evaluate()
        out.append((first, second, mon.evaluate()))
    assert out[1] == out[0]
    first, second, third = out[1]
    assert first["status"] == "ready" and first["reasons"] == []
    assert _reasons(second) == {"scheduler.shedding", "standing.drops"}
    assert third["status"] == "ready"


# -- the telemetry rings ---------------------------------------------------------------


def test_telemetry_recorder_restarts_after_stop():
    for P in BOTH:
        reg = P.metrics.MetricsRegistry()
        reg.gauge("geomesa.stream.hot_rows", 1.0)
        rec = P.ops.TelemetryRecorder(reg, interval_ms=10.0, history=64)
        rec.start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not rec.series()["series"]:
            time.sleep(0.01)
        rec.stop()
        n0 = len(rec.series()["series"]["geomesa.stream.hot_rows"]["v"])
        assert n0 >= 1
        rec.start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if len(rec.series()["series"]["geomesa.stream.hot_rows"]["v"]) > n0:
                break
            time.sleep(0.01)
        rec.stop()
        assert len(rec.series()["series"]["geomesa.stream.hot_rows"]["v"]) > n0
        assert not any(t.name == "geomesa-telemetry" and t.is_alive()
                       for t in threading.enumerate() if t is rec._thread)


def test_telemetry_recorder_rings_window_and_bound():
    out = []
    for P in BOTH:
        reg = P.metrics.MetricsRegistry()
        reg.gauge("geomesa.stream.hot_rows", 10.0)
        reg.counter("geomesa.query.count", 3)
        reg.observe("geomesa.query.scan", 0.02)
        rec = P.ops.TelemetryRecorder(reg, interval_ms=1000.0, history=4)
        touched = []
        for k in range(8):
            reg.gauge("geomesa.stream.hot_rows", 10.0 + k)
            touched.append(rec.sample(now=1000.0 + k))
        out.append((touched, rec.series(), rec.series(window_s=2.5, now=1007.0)))
    assert out[1] == out[0]
    touched, whole, win = out[1]
    ring = whole["series"]["geomesa.stream.hot_rows"]
    assert len(ring["v"]) == 4 and ring["v"][-1] == 17.0  # bounded: oldest evicted
    assert whole["series"]["geomesa.query.count"]["v"][-1] == 3.0
    assert whole["series"]["geomesa.query.scan.p99"]["v"][-1] > 0
    assert len(win["series"]["geomesa.stream.hot_rows"]["v"]) == 3


# -- the debug surfaces and the payloads -----------------------------------------------


def test_debug_surfaces_slow_filter_audit_trace_crossref():
    """/debug/slow filters by type; /debug/audit rows carry the trace id
    that cross-references the slow capture and the Chrome export; /stats
    serves the sketches; /debug/vars and /debug/tuning answer; unknown
    paths 404."""
    _set("OBS_SLOW_MS", 0.0001)  # everything is slow
    out = []
    for P in BOTH:
        ds = _store(P, n=500, audit=True)
        sft2 = P.pkg.FeatureType.from_spec("u", SPEC)
        ds.create_schema(sft2)
        ds.write("u", _fc(P, sft2, 200, prefix="u"))
        ds.query("t", Q)
        ds.query("u", Q)
        srv = ds.serve_ops()
        try:
            only_u = json.loads(_get(srv.url + "/debug/slow?type=u")[1])
            assert only_u and all(e["fingerprint"]["type"] == "u" for e in only_u)
            both = json.loads(_get(srv.url + "/debug/slow")[1])
            assert {e["fingerprint"]["type"] for e in both} == {"t", "u"}
            last = json.loads(_get(srv.url + "/debug/slow?n=1")[1])
            assert len(last) == 1 and last[0]["fingerprint"]["type"] == "u"
            audits = json.loads(_get(srv.url + "/debug/audit")[1])
            assert len(audits) == 2
            trace_ids = {e["traceId"] for e in audits}
            assert None not in trace_ids
            assert trace_ids == {e["trace"]["trace_id"] for e in both}
            chrome = json.loads(_get(srv.url + "/debug/trace")[1])
            assert trace_ids <= {ev["pid"] for ev in chrome["traceEvents"]}
            stats = json.loads(_get(srv.url + "/stats")[1])
            assert set(stats) == {"t", "u"} and stats["t"]["count"]["count"] == 500
            code, body = _get(srv.url + "/debug/vars?window=60")
            assert code == 200 and "series" in json.loads(body)
            tuning = json.loads(_get(srv.url + "/debug/tuning")[1])
            code, body = _get(srv.url + "/nope")
            assert code == 404 and "unknown path" in body
        finally:
            ds.close()
        out.append((stats, [e["fingerprint"] for e in both],
                    [{k: v for k, v in e.items() if k not in ("traceId", "planTimeMillis",
                                                                "scanTimeMillis", "date")}
                     for e in audits], tuning["enabled"]))
    assert out[1] == out[0]


def _payload_store(P):
    """The same seeded store in both packages, with a scheduler staged
    half full, an SLO tracker fed by real queries, and one stale window."""
    ds = _store(P, n=2500)
    ds.attach_slo()
    for k in range(6):
        ds.query("t", f"BBOX(geom, -{10 + k}, -20, 20, 20)")
    sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(queue_max=6))
    ds.scheduler = sched
    for _ in range(3):
        sched.submit("t", Q)
    for _ in range(P.conf.PLAN_ESTIMATE_MIN_COUNT.get()):
        ds.accuracy.record("t", "z3", 1000.0, 1.0)
    return ds


def test_health_stats_and_ops_report_payloads_equal_the_jax_package():
    """Every query is slow (so the slow ring holds all six) and the query
    objective's threshold is past any query's time (so its verdict does
    not depend on the host)."""
    _set("OBS_SLOW_MS", 0.0001)
    _set("OBS_SLO_QUERY_P99_MS", 60_000.0)
    out = []
    for P in BOTH:
        ds = _payload_store(P)
        srv = ds.serve_ops()
        try:
            code, health = _get(srv.url + "/health")
            stats = json.loads(_get(srv.url + "/stats")[1])
            rep = P.ops.ops_report(ds, slow_n=10)
        finally:
            ds.scheduler.close()
            ds.close()
        health = json.loads(health)
        assert code == 200 and health["status"] == "degraded"
        assert _reasons(health) == {"scheduler.queue", "stats.stale"}
        slow = rep["slow_queries"]
        assert len(slow) == 6 and all(e["trace_id"] is not None and e["wall_ms"] > 0 for e in slow)
        assert [e["wall_ms"] for e in slow] == sorted((e["wall_ms"] for e in slow), reverse=True)
        # slowest first: the order is measured, the set is not
        rep["slow_queries"] = sorted(e["fingerprint"]["filter"] for e in slow)
        out.append((code, _untimed(health), stats, _untimed(rep)))
    assert out[1] == out[0]


# -- the lifecycle -----------------------------------------------------------------------


def test_close_joins_threads_and_port_rebinds_immediately():
    """After close, no ops, telemetry or serving thread survives and the
    SAME port rebinds at once — three open/close cycles back to back."""
    for P in BOTH:
        ds = _store(P, n=200)
        srv = ds.serve_ops()
        sched = ds.serve()
        port = srv.port
        _get(srv.url + "/health")
        ds.close()
        assert srv.closed and sched.closed
        for _ in range(2):
            srv2 = ds.serve_ops(port=port)  # the closed one is replaced
            assert srv2 is ds.ops and srv2.port == port
            assert ds.serve() is not sched
            _get(srv2.url + "/health")
            ds.close()
            assert srv2.closed and ds.scheduler.closed
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            leaked = [t for t in threading.enumerate() if t.name in CENSUS and t.is_alive()]
            if not leaked:
                break
            time.sleep(0.02)
        assert leaked == [], leaked
        assert len(ds.query("t", Q)) > 0  # the store stays queryable


def test_jax_services_left_open_are_closed_and_port_ones_still_counted():
    """The repair's scope: a JAX scheduler left running the way the JAX
    data-plane tests leave one (``serve(port=)`` then the server's
    close) and a JAX ops plane left open are ended; a port scheduler left
    open is not, so the census still sees it."""
    jax_ds = _store(JAX, n=50)
    JAX.pkg.DataStore.serve(jax_ds, port=0).close()
    jax_ds.serve_ops()
    port_ds = _store(PORT, n=50)
    port_sched = port_ds.serve()
    try:
        owners = {type(t._target.__self__).__module__.split(".")[0] for t in census()}
        assert owners >= {"geomesa_tpu", "geomesa_tpu_torch"}
        ended = close_jax_services_left_open()
        assert sorted(ended) == ["geomesa-ops", "geomesa-serving", "geomesa-telemetry"]
        left = census()
        assert [t.name for t in left] == ["geomesa-serving"]
        assert left[0]._target.__self__ is port_sched
    finally:
        port_ds.close()
        jax_ds.close()
    assert census() == []


def test_jax_data_servers_left_open_are_closed_and_port_ones_still_counted():
    """The census takes in the data plane's ``geomesa-serve`` thread: a
    JAX ``DataServer`` left open (as tests/test_serve_http.py's module
    fixture leaves one until its file ends) is ended with its scheduler
    and sampler; a port ``DataServer`` left open is not, so the census
    sees its serve thread, scheduler and sampler."""
    jax_ds = _store(JAX, n=50)
    jax_srv = jax_ds.serve(port=0)
    port_ds = _store(PORT, n=50)
    port_srv = port_ds.serve(port=0)
    try:
        ended = close_jax_services_left_open()
        assert sorted(ended) == ["geomesa-serve", "geomesa-serving", "geomesa-telemetry"]
        assert not jax_srv._thread.is_alive()
        left = census()
        assert sorted(t.name for t in left) == ["geomesa-serve", "geomesa-serving",
                                                "geomesa-telemetry"]
        assert {type(t._target.__self__).__module__.split(".")[0] for t in left} == \
            {"geomesa_tpu_torch"}
        assert port_srv._thread in left
    finally:
        port_ds.close()
        jax_ds.close()
    assert census() == []


def test_census_after_a_file_that_leaks_jax_schedulers(tmp_path):
    """Fault C8 as a full xdist run met it: under ``--dist loadfile`` a worker ran
    a file that leaves JAX schedulers running, then this file; the
    lifecycle census failed on the leaked ``geomesa-serving`` threads. A
    separate pytest process runs such a file and then the census test, in
    that order."""
    leaky = tmp_path / "test_a_leaky_file.py"
    leaky.write_text(
        "from geomesa_tpu.datastore import DataStore\n"
        "from geomesa_tpu.sft import FeatureType\n\n"
        "def test_leaves_a_scheduler():\n"
        "    ds = DataStore()\n"
        "    ds.create_schema(FeatureType.from_spec('t', 'name:String,*geom:Point:srid=4326'))\n"
        "    ds.serve(port=0).close()  # the data plane's close leaves the scheduler\n"
    )
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "no:xdist", "--rootdir", str(tmp_path), "-c", os.devnull, str(leaky),
         os.path.join(here, "test_torch_slo_ops.py")
         + "::test_close_joins_threads_and_port_rebinds_immediately"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "2 passed" in r.stdout, r.stdout[-3000:]


def test_serve_ops_idempotent_and_close_covers_scheduler():
    for P in BOTH:
        ds = _store(P, n=200)
        srv = ds.serve_ops()
        assert ds.serve_ops() is srv  # idempotent while open
        assert srv.host == "127.0.0.1" and srv.url == f"http://127.0.0.1:{srv.port}"
        sched = ds.serve()
        ds.close()
        assert srv.closed and sched.closed
        ds.close()  # idempotent
