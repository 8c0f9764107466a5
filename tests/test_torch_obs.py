"""The observability core of the port against the JAX package, on the CPU.

- ``MetricsRegistry``: the same counters, gauges, timers and histogram
  observations go into both packages' registries; snapshots,
  ``Histogram.quantile`` and ``render_prometheus`` must be equal.
- ``AuditWriter``: the same queries (row queries, ``query_many``, hints,
  a union, the aggregation fast paths) on two stores with an audit sink
  write the same ``AuditedEvent`` JSON, timings excluded.
- Tracing: with ``geomesa.obs.trace.sample`` 1 one query on each package
  gives the same span names and nesting (``query`` > ``plan`` >
  ``plan.probe`` / ``plan.decompose``, ``dispatch``, ``scan``,
  ``decode``); ``dump_trace`` writes the same Chrome trace-event schema;
  under a low ``geomesa.obs.slow.ms`` the slow-query ring holds the same
  fingerprints; the explain trail gains the phase breakdown.
- The fold: a sliced ``fold_upsert`` sets the
  ``geomesa.stream.fold.progress`` gauge, counts
  ``geomesa.stream.fold.slices``, observes the ``geomesa.stream.fold.slice``
  histogram once a slice, and opens one ``fold.slice`` span a slice, as
  in the JAX package.

Tolerance: exact (timings excluded, since they are measured).
"""

import json

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import audit as jaudit
from geomesa_tpu import conf as jconf
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu.obs import trace as jtrace
from geomesa_tpu.planning.hints import QueryHints as JHints
from geomesa_tpu_torch import audit as taudit
from geomesa_tpu_torch import conf as tconf
from geomesa_tpu_torch import metrics as tmetrics
from geomesa_tpu_torch.obs import trace as ttrace
from geomesa_tpu_torch.planning.explain import Explainer
from geomesa_tpu_torch.planning.hints import QueryHints as THints
from test_torch_hints import FILTERS, dur, point_data, point_store
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

PKGS = {
    "jax": (geomesa_tpu, jconf, jmetrics, jaudit, jtrace, JHints, {}),
    "port": (geomesa_tpu_torch, tconf, tmetrics, taudit, ttrace, THints, {"device": "cpu"}),
}


# ------------------------------------------------------------- metrics

OBSERVATIONS = [0.0, 1e-7, 1e-6, 1.5e-6, 2e-6, 3.3e-5, 1e-3, 0.0123, 0.5, 0.5, 0.7071, 2.0,
                1e4, 5e5]


def _fill(m, seed):
    rng = np.random.default_rng(seed)
    for v in OBSERVATIONS:
        m.observe("geomesa.query.scan", v)
    for v in rng.lognormal(-6, 2, 500):
        m.observe("geomesa.stream.fold.slice", float(v))
    for k in range(7):
        m.counter("geomesa.query.count")
        m.counter("geomesa.query.hits", 3 * k)
        m.timer_update("geomesa.query.plan", 0.001 * k)
    m.gauge("geomesa.stream.fold.progress", 0.375)
    m.counter("geomesa.join-strategy.x", 2)


def test_registry_snapshot_and_exposition_equal_the_jax_registry():
    jm, tm = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    _fill(jm, 3)
    _fill(tm, 3)
    assert tm.snapshot() == jm.snapshot()
    assert tm.render_prometheus() == jm.render_prometheus()
    for name in ("geomesa.query.scan", "geomesa.stream.fold.slice", "never"):
        for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0, 1.5, -1.0):
            assert tm.histogram_quantile(name, q) == jm.histogram_quantile(name, q)
    assert tm.counter_value("geomesa.query.hits") == jm.counter_value("geomesa.query.hits") == 63
    assert tmetrics.HIST_EDGES == jmetrics.HIST_EDGES


@pytest.mark.parametrize("seed", range(4))
def test_histogram_quantile_equals_the_jax_histogram(seed):
    rng = np.random.default_rng(seed)
    jh, th = jmetrics.Histogram(), tmetrics.Histogram()
    for v in rng.exponential(10.0 ** rng.uniform(-6, 1), 200 * (seed + 1)):
        jh.record(float(v))
        th.record(float(v))
    assert th.counts == jh.counts and th.count == jh.count
    for q in np.linspace(0, 1, 41):
        assert th.quantile(float(q)) == jh.quantile(float(q))
    assert th.mean_s == jh.mean_s


def test_empty_registry_renders_as_jax_does():
    assert tmetrics.MetricsRegistry().render_prometheus() == jmetrics.MetricsRegistry().render_prometheus()
    assert tmetrics.resolve(None) is tmetrics.global_registry()


# --------------------------------------------------------------- audit

TIMING_KEYS = {"planTimeMillis", "scanTimeMillis", "date", "traceId"}


def _audited(name):
    pkg, _, mm, am, _, H, kw = PKGS[name]
    writer, metrics = am.AuditWriter(), mm.MetricsRegistry()
    ds = point_store(pkg, point_data(), audit=writer, metrics=metrics, **kw)
    for q in FILTERS["pts"]:
        ds.query("pts", q)
        ds.query("pts", q, limit=3, hints=H(sort_by="-dtg"))
    ds.query_many("pts", FILTERS["pts"], hints=H(loose=True))
    box = f"bbox(geom, -30, -25, 10, 15) AND {dur(2, 12)}"
    ds.count("pts", box)
    ds.count("pts", FILTERS["pts"][1])
    ds.density("pts", box, width=32, height=16)
    ds.bounds("pts", box)
    ds.stats_query("pts", "Count()", box, estimate=True)
    events = writer.drain()
    return [{k: v for k, v in e.items() if k not in TIMING_KEYS} for e in events], metrics


def test_audit_events_equal_the_jax_events():
    ensure_jax_native()
    want, jm = _audited("jax")
    got, tm = _audited("port")
    assert len(got) == len(want) > 2 * len(FILTERS["pts"])
    assert got == want
    for k in ("geomesa.query.count", "geomesa.query.hits"):
        assert tm.counter_value(k) == jm.counter_value(k) > 0
    assert tm.snapshot()["histograms"]["geomesa.query.scan"]["count"] == len(got)


def test_audit_writer_ring_peek_and_drain():
    w = taudit.AuditWriter(capacity=3)
    for i in range(5):
        w.write(taudit.AuditedEvent(f"t{i % 2}", "INCLUDE", "z3", i, i, 0.5, 1.25))
    assert [e["hits"] for e in w.peek()] == [2, 3, 4]
    assert [e["hits"] for e in w.peek("t0")] == [2, 4]
    ref = jaudit.AuditedEvent("t0", "INCLUDE", "z3", 4, 4, 0.5, 1.25, timestamp=7.0).to_json()
    got = taudit.AuditedEvent("t0", "INCLUDE", "z3", 4, 4, 0.5, 1.25, timestamp=7.0).to_json()
    assert got == ref
    assert len(w.drain()) == 3 and w.peek() == []


# --------------------------------------------------------------- traces


@pytest.fixture
def armed():
    """Both packages' tracing armed (sample 1), on fresh tracers; the
    knobs and the default tracers come back afterwards."""
    olds = {}
    for name, (_, conf, _, _, tr, _, _) in PKGS.items():
        conf.OBS_TRACE_SAMPLE.set(1)
        olds[name] = tr.tracer()
        tr.install(tr.Tracer())
    yield
    for name, (_, conf, _, _, tr, _, _) in PKGS.items():
        conf.OBS_TRACE_SAMPLE.clear()
        conf.OBS_SLOW_MS.clear()
        tr.install(olds[name])


def _tree(td: dict) -> list:
    """(depth, name) per span in start order, from a trace dict."""
    by_id = {s["span_id"]: s for s in td["spans"]}

    def depth(s):
        d = 0
        while s["parent_id"] is not None:
            s = by_id[s["parent_id"]]
            d += 1
        return d

    return [(depth(s), s["name"]) for s in td["spans"]]


QUERY = f"bbox(geom, -30, -25, 10, 15) AND {dur(2, 12)}"


@pytest.mark.parametrize("q", [QUERY, FILTERS["pts"][2], "age > 20", "IN ('7', '70')"],
                         ids=["z3", "union", "full-scan", "ids"])
def test_span_tree_equals_the_jax_span_tree(armed, q):
    ensure_jax_native()
    trees = {}
    for name, (pkg, _, _, _, tr, _, kw) in PKGS.items():
        ds = point_store(pkg, point_data(), **kw)  # a cold planner: no memo hit
        exp = Explainer() if name == "port" else None
        ds.query("pts", q, explain=exp)
        traces = tr.tracer().traces()
        assert len(traces) == 1
        trees[name] = _tree(traces[0].to_dict())
        if exp is not None:
            assert exp.trace is traces[0]
            assert exp.render().splitlines()[-1].strip().startswith("trace: wall ")
    assert trees["port"] == trees["jax"]
    names = {n for _, n in trees["port"]}
    assert {"query", "plan"} <= names
    if q == QUERY:
        assert trees["port"] == [(0, "query"), (1, "plan"), (2, "plan.probe"),
                                 (2, "plan.decompose"), (2, "plan.probe"), (2, "plan.decompose"),
                                 (1, "dispatch"), (1, "scan"), (1, "decode")]


def test_chrome_export_schema_equals_the_jax_export(armed, tmp_path):
    ensure_jax_native()
    payloads = {}
    for name, (pkg, _, _, _, tr, _, kw) in PKGS.items():
        ds = point_store(pkg, point_data(), **kw)
        for q in (QUERY, FILTERS["pts"][1]):
            ds.query("pts", q)
        path = ds.dump_trace(str(tmp_path / f"{name}.json"))
        with open(path) as fh:
            payloads[name] = json.load(fh)
    for p in payloads.values():
        assert set(p) == {"traceEvents"}
        for ev in p["traceEvents"]:
            assert set(ev) == {"name", "ph", "pid", "tid", "ts", "dur", "args"}
            assert ev["ph"] == "X" and ev["dur"] >= 0 and ev["ts"] >= 0
    names = [sorted(e["name"] for e in payloads[k]["traceEvents"]) for k in ("jax", "port")]
    assert names[0] == names[1]
    assert len({e["pid"] for e in payloads["port"]["traceEvents"]}) == 2


def test_slow_ring_holds_the_same_fingerprints(armed):
    ensure_jax_native()
    rings = {}
    for name, (pkg, conf, _, _, tr, _, kw) in PKGS.items():
        conf.OBS_TRACE_SAMPLE.set(0)
        conf.OBS_SLOW_MS.set(1e-6)
        ds = point_store(pkg, point_data(), **kw)
        for q in FILTERS["pts"]:
            ds.query("pts", q)
        assert tr.tracer().traces() == []  # sampled out: only the slow ring keeps them
        rings[name] = ds.slow_queries()
        assert ds.slow_queries("other") == []
    assert len(rings["port"]) == len(rings["jax"]) == len(FILTERS["pts"])
    assert [e["fingerprint"] for e in rings["port"]] == [e["fingerprint"] for e in rings["jax"]]
    for e in rings["port"]:
        assert e["wall_ms"] > 0 and e["trace"]["spans"]


def test_tracing_is_disarmed_by_sample_zero_and_no_slow_log():
    tr = ttrace.Tracer()
    tconf.OBS_SLOW_MS.set(0)
    try:
        assert not tr.armed and tr.begin("query") is None
        assert ttrace.span("scan") is ttrace.NULL_SPAN
    finally:
        tconf.OBS_SLOW_MS.clear()
    assert tconf.OBS_TRACE_SAMPLE.get() == jconf.OBS_TRACE_SAMPLE.get() == 0
    assert tconf.OBS_SLOW_MS.get() == jconf.OBS_SLOW_MS.get()
    assert tconf.OBS_TRACE_BUFFER.get() == jconf.OBS_TRACE_BUFFER.get()
    assert tconf.OBS_SLOW_MAX.get() == jconf.OBS_SLOW_MAX.get()


def test_phase_breakdown_lines():
    tr = ttrace.Tracer()
    tconf.OBS_TRACE_SAMPLE.set(1)
    try:
        with tr.trace("query") as t:
            with ttrace._SpanCtx(ttrace.Span(t, "scan", t.root.span_id)):
                pass
        lines = ttrace.phase_breakdown(t)
    finally:
        tconf.OBS_TRACE_SAMPLE.clear()
    assert lines[0].startswith("trace: scan ") and lines[-1].startswith("trace: wall ")
    assert ttrace.phase_breakdown(None) == []


# ----------------------------------------------------------------- fold


def _folded(name, n_rows=1_200, n_fold=300, slice_rows=64):
    pkg, conf, mm, _, tr, _, kw = PKGS[name]
    metrics = mm.MetricsRegistry()
    data = point_data(n=n_rows)
    ds = point_store(pkg, data, writes=(n_rows,), metrics=metrics, **kw)
    sft = ds.get_schema("pts")
    x, y, t, age, score, names = data
    rng = np.random.default_rng(4)
    ids = np.concatenate([rng.choice(n_rows, n_fold // 2, replace=False),
                          np.arange(n_rows, n_rows + n_fold - n_fold // 2)])
    src = ids % n_rows
    cols = {"geom": (x[src] + 0.5, y[src]), "dtg": t[src], "age": age[src],
            "score": score[src], "name": names[src]}
    fc = pkg.FeatureCollection.from_columns(sft, ids.astype(str), cols)
    with tr.tracer().trace("fold") as trace:
        ds.fold_upsert("pts", fc, slice_rows=slice_rows)
    spans = [(s["name"], s.get("attrs")) for s in trace.to_dict()["spans"]]
    snap = metrics.snapshot()
    hist = snap["histograms"]["geomesa.stream.fold.slice"]
    return (snap["gauges"], snap["counters"], hist["count"], spans,
            np.asarray(ds.query("pts", QUERY).ids).tolist())


def test_fold_instrumentation_equals_the_jax_fold(armed):
    ensure_jax_native()
    want = _folded("jax")
    got = _folded("port")
    n_slices = -(-300 // 64)
    assert got[0] == want[0] == {"geomesa.stream.fold.progress": 0.0}
    assert got[1] == want[1]
    assert got[1]["geomesa.stream.fold.slices"] == n_slices
    assert got[2] == want[2] == n_slices
    assert got[3] == want[3]
    assert [s for s, _ in got[3]].count("fold.slice") == n_slices
    assert got[4] == want[4]


def test_fold_progress_gauge_moves_during_the_fold():
    """The gauge reads each published slice's share while the fold runs
    (``on_slice`` fires after the gauge is set)."""
    metrics = tmetrics.MetricsRegistry()
    data = point_data(n=600)
    ds = point_store(geomesa_tpu_torch, data, writes=(600,), metrics=metrics, device="cpu")
    sft = ds.get_schema("pts")
    x, y, t, age, score, names = data
    ids = np.arange(0, 200)
    cols = {"geom": (x[ids], y[ids]), "dtg": t[ids], "age": age[ids], "score": score[ids],
            "name": names[ids]}
    seen = []
    ds.fold_upsert("pts", geomesa_tpu_torch.FeatureCollection.from_columns(sft, ids.astype(str), cols),
                   slice_rows=50,
                   on_slice=lambda _: seen.append(metrics.snapshot()["gauges"]["geomesa.stream.fold.progress"]))
    assert seen == [0.25, 0.5, 0.75, 1.0]
    assert metrics.snapshot()["gauges"]["geomesa.stream.fold.progress"] == 0.0
