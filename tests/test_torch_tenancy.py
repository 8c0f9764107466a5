"""The port's multi-tenant fairness state (serving/tenancy.py) and the
scheduler's tenant queues against the JAX package's, on the CPU.

- ``TenantRegistry``: identity (``tenant_of``), configuration, quotas,
  weights, and the report after the same seeded ``note_*`` sequence
  (walls and waits fed by the test, ``now`` passed in) equal the JAX
  package's payload for payload, each tenant's SLO window included;
- the deficit-round-robin drain: on staged, unstarted schedulers with
  2-4 backlogged tenants (the default pool among them in some cases) of
  seeded weights, seeded arrival orders and batch caps, every drained
  batch equals the JAX package's item for item, credit carried across
  drains included;
- tenant quotas: a flooding tenant sheds at its own quota with the same
  message and counters while the other tenants' queues stay open, and
  the served answers equal the sequential queries'.

Both packages take their native host helpers. Tolerance: exact.
"""

import time

import numpy as np
import pytest
import torch

from test_torch_native import ensure_jax_native
from test_torch_serving_tier import BOTH, JAX, PORT

torch.set_num_threads(1)

DAY = 86_400_000
SPEC = "kind:String,dtg:Date,*geom:Point:srid=4326"


@pytest.fixture(autouse=True)
def _native():
    ensure_jax_native()


@pytest.fixture(scope="module")
def stores():
    """One small store per package (the staged schedulers only plan)."""
    ensure_jax_native()
    out = {}
    for P in BOTH:
        sft = P.pkg.FeatureType.from_spec("ev", SPEC)
        ds = P.pkg.DataStore(tile=64, metrics=P.metrics.MetricsRegistry(), **P.kw)
        ds.create_schema(sft)
        rng = np.random.default_rng(3)
        n = 600
        t0 = np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64)
        ds.write("ev", P.pkg.FeatureCollection.from_columns(
            sft, [str(i) for i in range(n)],
            {"kind": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
             "dtg": t0 + rng.integers(0, 20 * DAY, n),
             "geom": (rng.uniform(-60, 60, n), rng.uniform(-45, 45, n))},
        ))
        out[P.name] = ds
    return out


def _box(i) -> str:
    """A distinct filter per submission, so no two items coalesce."""
    x = -50 + (i % 90)
    return f"bbox(geom, {x}, -40, {x + 8}, {-40 + 1 + i // 90})"


# -- the registry ---------------------------------------------------------------


def test_tenant_identity_and_configuration():
    out = []
    for P in BOTH:
        R = P.serving.TenantRegistry
        ids = [R.tenant_of(None), R.tenant_of([]), R.tenant_of(["b", "a"]),
               R.tenant_of(["a"], explicit="team-x"), R.tenant_of(("z", 3))]
        reg = R(metrics=P.metrics.MetricsRegistry(), default_weight=2.0, queue_max=5,
                slo_p99_ms=0.0)
        reg.configure("gold", weight=8.0, queue_max=64)
        reg.configure("bronze", weight=0.0, queue_max=-3)  # clamped
        reg.configure("silver")  # materializes with the defaults
        out.append((ids, reg.weights(), reg.queue_cap("gold"), reg.queue_cap("bronze"),
                    reg.queue_cap("new"), P.tenancy.PUBLIC_TENANT, P.tenancy.TENANT_WALL_METRIC,
                    reg.report()))
    assert out[1] == out[0]
    ids, weights = out[1][0], out[1][1]
    assert ids == ["public", "public", "a,b", "team-x", "3,z"]
    assert weights == {"gold": 8.0, "bronze": 1e-3, "silver": 2.0}
    assert out[1][2:5] == (64, 0, 5)


def test_knob_defaults_equal_the_jax_package():
    for name in ("TENANT_QUEUE_MAX", "TENANT_DEFAULT_WEIGHT", "TENANT_SLO_P99_MS"):
        getattr(PORT.conf, name).set({"TENANT_QUEUE_MAX": 9}.get(name, 3.5))
        getattr(JAX.conf, name).set({"TENANT_QUEUE_MAX": 9}.get(name, 3.5))
    try:
        reps = [P.serving.TenantRegistry().report() for P in BOTH]
    finally:
        for P in BOTH:
            for name in ("TENANT_QUEUE_MAX", "TENANT_DEFAULT_WEIGHT", "TENANT_SLO_P99_MS"):
                getattr(P.conf, name).clear()
    assert reps[0] == reps[1] == {"default_weight": 3.5, "default_queue_max": 9,
                                  "slo_p99_ms": 3.5, "tenants": []}
    reps = [P.serving.TenantRegistry().report() for P in BOTH]
    assert reps[0] == reps[1] == {"default_weight": 1.0, "default_queue_max": 256,
                                  "slo_p99_ms": 500.0, "tenants": []}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_report_after_the_same_note_sequence(seed):
    """The same seeded sequence of note_* calls (served walls straddling
    the 500 ms objective, queue waits, sheds, hits, errors) gives equal
    reports and equal registry series in both packages."""
    rng = np.random.default_rng(seed)
    tenants = ["gold", "bronze", "public", "a,b"][: 2 + seed]
    ops = []
    for _ in range(200):
        t = tenants[rng.integers(len(tenants))]
        kind = rng.choice(["submitted", "shed", "cache_hit", "error", "wait", "served"])
        ops.append((kind, t, float(rng.lognormal(-2.0, 1.5))))
    now = time.time()
    out = []
    for P in BOTH:
        m = P.metrics.MetricsRegistry()
        reg = P.serving.TenantRegistry(metrics=m)
        reg.configure("gold", weight=8.0, queue_max=64)
        for kind, t, v in ops:
            if kind == "wait":
                reg.note_wait(t, v)
            elif kind == "served":
                reg.note_served(t, v, now=now)
            else:
                getattr(reg, f"note_{kind}")(t)
        snap = m.snapshot()
        out.append((reg.report(), snap["counters"], snap["histograms"]))
    assert out[1] == out[0]
    rows = out[1][0]["tenants"]
    assert [r["tenant"] for r in rows] == sorted(tenants)
    assert sum(r["slo"]["objectives"][0]["count"] for r in rows) == \
        sum(1 for k, _, _ in ops if k == "served")
    assert any(r["slo"]["status"] == "breach" for r in rows)


# -- the deficit-round-robin drain ---------------------------------------------------


def _staged_orders(P, ds, tenants, weights, arrivals, batch_max):
    """Stage ``arrivals`` (tenant per submission) on an unstarted
    scheduler and drain it batch by batch through the scheduler's own
    ``_take_locked``; returns each batch's (tenant, submission) labels."""
    reg = P.serving.TenantRegistry(metrics=P.metrics.MetricsRegistry())
    for t, w in zip(tenants, weights):
        if t is not None:
            reg.configure(t, weight=w, queue_max=10_000)
    sched = P.serving.QueryScheduler(
        ds, P.serving.ServingConfig(batch_max=batch_max, queue_max=10_000),
        metrics=P.metrics.MetricsRegistry(), tenants=reg,
    )
    label = {}
    for i, t in enumerate(arrivals):
        label[id(sched.submit("ev", _box(i), tenant=t))] = (t, i)
    batches = []
    while sched.queue_depth:
        with sched._cond:
            batch = sched._take_locked(reg.weights())
        batches.append([label[id(it.future)] for it in batch])
    sched.close()
    return batches


CASES = [  # (tenants, weights, submissions, batch cap, seed)
    (["gold", "bronze"], (8.0, 1.0), 60, 16, 0),
    (["a", "b"], (1.0, 1.0), 30, 5, 1),
    (["gold", "silver", "bronze"], (4.0, 2.5, 1.0), 80, 8, 2),
    (["x", None, "y"], (3.0, 1.0, 0.5), 50, 7, 3),
    (["t1", "t2", "t3", "t4"], None, 120, 16, 4),
    (["t1", "t2", "t3", None], None, 90, 3, 5),
]


@pytest.mark.parametrize("tenants,weights,n,batch_max,seed", CASES)
def test_drr_batch_orders_equal_the_jax_package(stores, tenants, weights, n, batch_max, seed):
    rng = np.random.default_rng(seed)
    if weights is None:  # seeded weights
        weights = tuple(float(w) for w in rng.choice([0.5, 1.0, 2.0, 3.0, 8.0], len(tenants)))
    # bursty seeded arrivals: each tenant's share skewed by its own draw
    p = rng.dirichlet(np.ones(len(tenants)))
    arrivals = [tenants[k] for k in rng.choice(len(tenants), n, p=p)]
    orders = [_staged_orders(P, stores[P.name], tenants, weights, arrivals, batch_max)
              for P in BOTH]
    assert orders[1] == orders[0]
    drained = [lab for batch in orders[1] for lab in batch]
    assert sorted(i for _, i in drained) == list(range(n))
    assert all(len(b) <= batch_max for b in orders[1])
    # each tenant's own items leave in arrival order (per-tenant FIFO)
    for t in set(arrivals):
        mine = [i for tt, i in drained if tt == t]
        assert mine == sorted(mine)


def test_one_backlogged_tenant_drains_plain_fifo(stores):
    arrivals = ["solo"] * 20
    orders = [_staged_orders(P, stores[P.name], ["solo"], (5.0,), arrivals, 6) for P in BOTH]
    assert orders[1] == orders[0]
    assert [len(b) for b in orders[1]] == [6, 6, 6, 2]
    assert [i for b in orders[1] for _, i in b] == list(range(20))


# -- quotas ---------------------------------------------------------------------------


def test_tenant_quota_sheds_the_flooder_alike(stores):
    """``bronze`` (quota 3) floods with non-blocking submits: it sheds at
    its own quota with the reference's message while ``gold`` keeps
    admitting; once started, everything admitted is served, equal to the
    sequential queries."""
    out = []
    for P in BOTH:
        ds = stores[P.name]
        m = P.metrics.MetricsRegistry()
        reg = P.serving.TenantRegistry(metrics=m)
        reg.configure("gold", weight=8.0, queue_max=64)
        reg.configure("bronze", weight=1.0, queue_max=3)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(queue_max=32), metrics=m,
                                         tenants=reg)
        futs, errors = [], []
        for i in range(8):
            futs.append(("bronze", i, sched.submit("ev", _box(i), block=False, tenant="bronze")))
        for i in range(8, 12):
            futs.append(("gold", i, sched.submit("ev", _box(i), block=False, tenant="gold")))
        depth = sched.queue_depth
        sched.start()
        served = {}
        for t, i, f in futs:
            try:
                served[i] = np.asarray(f.result(30).ids).tolist()
            except P.serving.ServingRejected as e:
                errors.append((t, i, str(e)))
        sched.close()
        for i, ids in served.items():
            assert ids == np.asarray(ds.query("ev", _box(i)).ids).tolist()
        rep = reg.report()
        for row in rep["tenants"]:
            for k in ("queue_wait_ms_mean", "queue_wait_ms_max", "wall_ms_mean", "slo"):
                row[k] = None  # measured times
        out.append((depth, errors, served, rep, m.counter_value("geomesa.serving.shed"),
                    m.counter_value("geomesa.tenant.shed"),
                    m.counter_value("geomesa.tenant.submitted")))
    assert out[1] == out[0]
    depth, errors, served, rep = out[1][:4]
    assert depth == 7 and len(errors) == 5 and len(served) == 7
    assert {e[0] for e in errors} == {"bronze"}
    assert errors[0][2] == "tenant 'bronze' admission quota full (3)"
    rows = {r["tenant"]: r for r in rep["tenants"]}
    for t in ("gold", "bronze"):
        assert rows[t]["served"] + rows[t]["shed"] == rows[t]["submitted"]
    assert rows["gold"]["shed"] == 0 and rows["bronze"]["shed"] == 5
    assert out[1][4:] == (5, 5, 12)
