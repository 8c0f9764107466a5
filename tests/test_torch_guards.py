"""Query guards, interceptors and deadlines in the port against the JAX
package, both on the CPU.

The same seeded rows go into a JAX ``geomesa_tpu.DataStore`` and a port
``geomesa_tpu_torch.DataStore(device="cpu")`` configured with the same
guards: ``block_full_table_scans``, a ``FullTableScanGuard``, a
``TemporalQueryGuard``, a ``GraduatedQueryGuard`` with three size
bounds, and an ``AgeOffInterceptor`` on a fixed clock. The same filters
are planned by both: each is accepted (with the same strategy and, for
the interceptor, the same ids) or rejected with the same exception type
and message. Deadlines: a deadline that has already passed raises
QueryTimeout at the same stage name in both packages for every plan kind
(index scan, full scan, id lookup, union, empty store; the table's own
scan), through ``execute``, ``submit_many`` and ``query_many``; the
timeout counter counts each raise; and one deadline bounds every branch
of a union (each branch gets what remains of it). Tolerance: exact.
"""

import re
import time

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu.planning import errors as jerrors
from geomesa_tpu.planning import guards as jguards
from geomesa_tpu.planning.hints import QueryHints as JHints
from geomesa_tpu_torch import metrics as tmetrics
from geomesa_tpu_torch.planning import errors as terrors
from geomesa_tpu_torch.planning import guards as tguards
from geomesa_tpu_torch.planning.hints import QueryHints as THints
from test_torch_hints import DAY, T0, dur, point_data, point_store
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

NOW = T0 + 21 * DAY  # the interceptor's fixed clock


def _guards(mod, name):
    """The guard configuration ``name`` for the package whose guards
    module is ``mod`` (DataStore keyword arguments)."""
    if name == "block-full":
        return {"block_full_table_scans": True}
    if name == "full-scan":
        return {"guards": [mod.FullTableScanGuard()]}
    if name == "temporal":
        return {"guards": [mod.TemporalQueryGuard(max_ms=5 * DAY)]}
    if name == "graduated":
        return {"guards": [mod.GraduatedQueryGuard([
            mod.SizeBound(area_deg2=100.0, max_duration_ms=None),
            mod.SizeBound(area_deg2=2_000.0, max_duration_ms=4 * DAY),
            mod.SizeBound(area_deg2=None, max_duration_ms=DAY),
        ])]}
    if name == "age-off":
        return {"interceptors": [mod.AgeOffInterceptor(ttl_ms=6 * DAY, now_ms=NOW)]}
    raise KeyError(name)


CONFIGS = ["block-full", "full-scan", "temporal", "graduated", "age-off"]
FILTERS = [
    "INCLUDE",
    "age > 20",
    "bbox(geom, -5, -5, 4, 4)",
    f"bbox(geom, -5, -5, 4, 4) AND {dur(1, 3)}",
    f"bbox(geom, -30, -25, 10, 15) AND {dur(2, 12)}",
    f"bbox(geom, -30, -25, 10, 15) AND {dur(2, 5)}",
    f"bbox(geom, -60, -40, 60, 40) AND {dur(2, 3)}",
    f"bbox(geom, -60, -40, 60, 40) AND {dur(2, 9)}",
    f"bbox(geom, -50, -30, -20, 0) OR {dur(15, 16)}",
    f"{dur(0, 20)}",
    f"dtg >= {np.datetime64(T0 + 17 * DAY, 'ms')}Z",
    "IN ('7', '70', '700')",
    "age > 20 AND age < 10",
    "bbox(geom, -5, -5, 4, 4) AND bbox(geom, 10, 10, 12, 12)",
]


@pytest.fixture(scope="module")
def stores():
    ensure_jax_native()
    data = point_data()
    return {
        name: (point_store(geomesa_tpu, data, **_guards(jguards, name)),
               point_store(geomesa_tpu_torch, data, device="cpu", **_guards(tguards, name)))
        for name in CONFIGS
    }


def _masked(exc) -> str:
    """An exception's message with long numbers as one token: an open
    interval's span runs to the wall clock, which the two packages read a
    moment apart."""
    return re.sub(r"\d{10,}", "<span>", str(exc))


def _outcome(ds, q):
    """("ok", strategy, ids) or ("raise", type name, message)."""
    try:
        plan = ds.planner.plan("pts", q)
    except Exception as e:  # the outcome under test
        return ("raise", type(e).__name__, _masked(e))
    return ("ok", plan.strategy, np.asarray(ds.planner.execute(plan).ids).tolist())


@pytest.mark.parametrize("config", CONFIGS)
def test_guards_accept_and_reject_as_jax_does(stores, config):
    jds, tds = stores[config]
    outcomes = {"ok": 0, "raise": 0}
    for q in FILTERS:
        want = _outcome(jds, q)
        got = _outcome(tds, q)
        assert got == want, q
        outcomes[want[0]] += 1
    if config != "age-off":
        assert outcomes["ok"] and outcomes["raise"], outcomes


@pytest.mark.parametrize("config", CONFIGS)
def test_guarded_query_raises_the_same_exception_type(stores, config):
    """Through ``query`` too: a rejected plan raises QueryGuardError (the
    port's own class), and the exception hierarchy matches."""
    jds, tds = stores[config]
    for q in FILTERS:
        try:
            jds.query("pts", q)
            want = None
        except jerrors.QueryGuardError as e:
            want = _masked(e)
        if want is None:
            tds.query("pts", q)
        else:
            with pytest.raises(terrors.QueryGuardError) as got:
                tds.query("pts", q)
            assert _masked(got.value) == want


def test_maintenance_scans_skip_guards_and_interceptors(stores):
    """delete_features plans its raw filter: no guard rejects it and no
    interceptor rewrites it, in both packages."""
    data = point_data()
    for name in ("block-full", "age-off"):
        j = point_store(geomesa_tpu, data, **_guards(jguards, name))
        t = point_store(geomesa_tpu_torch, data, device="cpu", **_guards(tguards, name))
        assert t.delete_features("pts", "age > 25") == j.delete_features("pts", "age > 25") > 0
        assert t.count("pts") == j.count("pts")


def test_count_of_include_goes_through_the_interceptor(stores):
    jds, tds = stores["age-off"]
    assert tds.count("pts") == jds.count("pts") < len(tds.features("pts"))


def test_temporal_guard_reads_its_property():
    from geomesa_tpu_torch import conf

    assert tguards.TemporalQueryGuard().max_ms == jguards.TemporalQueryGuard().max_ms == 7 * DAY
    conf.GUARD_TEMPORAL_MAX.set(3 * DAY)
    try:
        assert tguards.TemporalQueryGuard.from_properties().max_ms == 3 * DAY
    finally:
        conf.GUARD_TEMPORAL_MAX.clear()


# ------------------------------------------------------------- deadlines


def _passed(errors_mod):
    now = time.monotonic()
    return errors_mod.Deadline(start=now - 10.0, budget_s=1.0, cutoff=now - 9.0)


def _stage(exc) -> str:
    m = re.match(r"query deadline exceeded during (.*) \(elapsed", str(exc))
    assert m, str(exc)
    return m.group(1)


DEADLINE_FILTERS = {
    "index": f"bbox(geom, -30, -25, 10, 15) AND {dur(2, 12)}",
    "polygon": "INTERSECTS(geom, POLYGON ((0 -10, 30 -10, 25 20, 5 15, 0 -10)))",
    "full": "age > 20",
    "ids": "IN ('7', '70', '700')",
    "union": f"bbox(geom, -50, -30, -20, 0) OR {dur(15, 16)}",
    "include": "INCLUDE",
}


@pytest.fixture(scope="module")
def plain():
    ensure_jax_native()
    data = point_data()
    jm, tm = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    return (point_store(geomesa_tpu, data, metrics=jm),
            point_store(geomesa_tpu_torch, data, device="cpu", metrics=tm), jm, tm)


@pytest.mark.parametrize("kind", list(DEADLINE_FILTERS))
def test_passed_deadline_raises_at_the_same_stage(plain, kind):
    jds, tds, jm, tm = plain
    q = DEADLINE_FILTERS[kind]
    j0, t0 = jm.counter_value("geomesa.query.timeout"), tm.counter_value("geomesa.query.timeout")
    with pytest.raises(jerrors.QueryTimeout) as want:
        jds.planner.execute(jds.planner.plan("pts", q), deadline=_passed(jerrors))
    with pytest.raises(terrors.QueryTimeout) as got:
        tds.planner.execute(tds.planner.plan("pts", q), deadline=_passed(terrors))
    assert _stage(got.value) == _stage(want.value)
    assert got.value.budget_s == want.value.budget_s == 1.0
    assert got.value.elapsed_s > 9.0
    assert tm.counter_value("geomesa.query.timeout") - t0 == \
        jm.counter_value("geomesa.query.timeout") - j0 == 1


def test_passed_deadline_in_the_table_raises_at_range_pruning(plain):
    jds, tds, _, _ = plain
    q = DEADLINE_FILTERS["index"]
    for ds, errs in ((jds, jerrors), (tds, terrors)):
        plan = ds.planner.plan("pts", q)
        table = ds.table("pts", plan.index)
        with pytest.raises(errs.QueryTimeout) as e:
            table.scan_submit(plan.config, deadline=_passed(errs))
        assert _stage(e.value) == "range pruning"
        with pytest.raises(errs.QueryTimeout) as e:
            table.scan_submit_many([plan.config, plan.config], deadline=_passed(errs))
        assert _stage(e.value) == "range pruning"


def test_passed_deadlines_through_submit_many(plain):
    jds, tds, jm, tm = plain
    qs = [DEADLINE_FILTERS[k] for k in ("index", "polygon", "ids", "union")] + [
        f"bbox(geom, -10, -10, 0, 0) AND {dur(1, 9)}"]
    stages = []
    for ds, errs in ((jds, jerrors), (tds, terrors)):
        plans = [ds.planner.plan("pts", q) for q in qs]
        fins = ds.planner.submit_many(plans, deadlines=[_passed(errs)] * len(plans))
        got = []
        for fin in fins:
            with pytest.raises(errs.QueryTimeout) as e:
                fin()
            got.append(_stage(e.value))
        stages.append(got)
    assert stages[0] == stages[1]


def test_timeout_hint_raises_on_query_query_many_and_union(plain):
    jds, tds, jm, tm = plain
    j0, t0 = jm.counter_value("geomesa.query.timeout"), tm.counter_value("geomesa.query.timeout")
    for ds, errs, H in ((jds, jerrors, JHints), (tds, terrors, THints)):
        with pytest.raises(errs.QueryTimeout):
            ds.query("pts", DEADLINE_FILTERS["index"], hints=H(timeout=1e-9))
        with pytest.raises(errs.QueryTimeout):
            ds.query_many("pts", [DEADLINE_FILTERS["index"], DEADLINE_FILTERS["polygon"]],
                          hints=H(timeout=1e-9))
        with pytest.raises(errs.QueryTimeout):
            ds.query("pts", DEADLINE_FILTERS["union"], hints=H(timeout=1e-9))
    assert tm.counter_value("geomesa.query.timeout") - t0 == \
        jm.counter_value("geomesa.query.timeout") - j0 == 3
    # the next query after a timeout is exact
    q = DEADLINE_FILTERS["index"]
    assert np.asarray(tds.query("pts", q).ids).tolist() == np.asarray(jds.query("pts", q).ids).tolist()


def test_store_timeout_applies_and_a_generous_one_answers():
    data = point_data(n=1_200)
    q = DEADLINE_FILTERS["index"]
    for pkg, errs, kw in ((geomesa_tpu, jerrors, {}), (geomesa_tpu_torch, terrors, {"device": "cpu"})):
        tight = point_store(pkg, data, writes=(1_200,), query_timeout=1e-9, **kw)
        with pytest.raises(errs.QueryTimeout):
            tight.query("pts", q)
        with pytest.raises(errs.QueryTimeout):
            tight.count("pts", q)
        with pytest.raises(errs.QueryTimeout):
            tight.density("pts", q)
        roomy = point_store(pkg, data, writes=(1_200,), query_timeout=600.0, **kw)
        assert len(roomy.query("pts", q)) == len(point_store(pkg, data, writes=(1_200,), **kw).query("pts", q))


def test_store_timeout_reads_its_property():
    from geomesa_tpu_torch import conf

    assert tds_timeout() is None
    conf.QUERY_TIMEOUT.set(12.5)
    try:
        assert tds_timeout() == 12.5
    finally:
        conf.QUERY_TIMEOUT.clear()


def tds_timeout():
    return geomesa_tpu_torch.DataStore(device="cpu").query_timeout


def test_one_deadline_bounds_every_union_branch(plain, monkeypatch):
    """A union's branches each run under what remains of the query's one
    budget, never a fresh one, in both packages."""
    jds, tds, _, _ = plain
    q = DEADLINE_FILTERS["union"]
    budgets = {}
    for name, ds, H in (("jax", jds, JHints), ("port", tds, THints)):
        seen = []
        inner = ds.planner._execute

        def spy(plan, *a, seen=seen, inner=inner, **kw):
            h = kw.get("hints")
            if plan.union is None and h is not None:
                seen.append(h.timeout)
            return inner(plan, *a, **kw)

        monkeypatch.setattr(ds.planner, "_execute", spy)
        out = ds.query("pts", q, hints=H(timeout=30.0))
        budgets[name] = (seen, np.asarray(out.ids).tolist())
    (js, jids), (ts, tids) = budgets["jax"], budgets["port"]
    assert tids == jids and len(ts) == len(js) == 2
    assert 0 < ts[1] <= ts[0] <= 30.0


def test_passed_deadline_on_an_empty_store_raises_at_the_same_stage():
    stages = []
    for pkg, errs, kw in ((geomesa_tpu, jerrors, {}), (geomesa_tpu_torch, terrors, {"device": "cpu"})):
        ds = point_store(pkg, point_data(n=200), writes=(), **kw)
        plan = ds.planner.plan("pts", DEADLINE_FILTERS["index"])
        with pytest.raises(errs.QueryTimeout) as e:
            ds.planner.execute(plan, deadline=_passed(errs))
        stages.append(_stage(e.value))
    assert stages[0] == stages[1]
