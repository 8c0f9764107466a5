"""The port's many-query path against the JAX DataStore, both on the CPU.

``query_many`` (fused chunks through ``block_scan_multi``),
``density_many`` and ``stats_query`` (the count estimate through
``block_pops``, and the exact Stat DSL path) on the same features, made
from a seed with numpy, in a JAX ``geomesa_tpu.DataStore`` and a port
``geomesa_tpu_torch.DataStore`` (device="cpu"). Cells: Z3 with packed
time off and on, and Z2. The JAX package's C++ host helpers are off for
the module, as in tests/test_torch_store.py, so both packages take the
same numpy range decomposition. Tolerance is exact equality throughout:
ids, the fused chunks' block and query ids, grids and counts.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu_torch import native as tnative
from geomesa_tpu.scan import block_kernels as jbk
from geomesa_tpu_torch.scan import block_kernels as tbk
from test_torch_store import SPATIAL_QUERIES, TIME_QUERIES, _build, _data, _dur

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)


def _random_queries(seed: int, n: int, with_time: bool) -> list:
    """Small BBOX (+ DURING) queries: many members per fused chunk."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = float(rng.choice([2.0, 5.0, 10.0, 30.0]))
        x0 = rng.uniform(-170, 160)
        y0 = rng.uniform(-80, 70)
        q = f"bbox(geom, {x0:.3f}, {y0:.3f}, {x0 + w:.3f}, {y0 + w / 2:.3f})"
        if with_time:
            d0 = int(rng.integers(0, 20))
            q += f" AND {_dur(d0, d0 + int(rng.integers(1, 8)), ms=int(rng.integers(0, 999)))}"
        out.append(q)
    return out


BATCHES = {
    "z3": TIME_QUERIES + SPATIAL_QUERIES[:1] + _random_queries(1, 14, True),
    "z3-packed": TIME_QUERIES + _random_queries(2, 14, True),
    "z2": SPATIAL_QUERIES + _random_queries(3, 28, False),
}
CELLS = list(BATCHES)


@pytest.fixture(scope="module")
def stores():
    from geomesa_tpu import native

    data = _data()
    with pytest.MonkeyPatch.context() as mp, tnative.disabled():
        mp.setattr(native, "_lib", False)
        yield {
            cell: (_build(geomesa_tpu, cell, data),
                   _build(geomesa_tpu_torch, cell, data, device="cpu"))
            for cell in CELLS
        }


def _ids(fc) -> np.ndarray:
    return np.sort(np.asarray(fc.ids, np.int64))


def _capture(monkeypatch, module, name):
    """Record (bids, qids) of every call of ``module.name``."""
    calls = []
    fn = getattr(module, name)

    def spy(cols3, bids, qids, *args, **kw):
        calls.append((np.asarray(bids).copy(), np.asarray(qids).copy(), kw))
        return fn(cols3, bids, qids, *args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("cell", CELLS)
def test_query_many_equals_jax_and_sequential(stores, cell, monkeypatch):
    jds, tds = stores[cell]
    queries = BATCHES[cell]
    jcalls = _capture(monkeypatch, jbk, "block_scan_multi")
    tcalls = _capture(monkeypatch, tbk, "scan_planes_multi")
    got = tds.query_many("pts", queries)
    ref = jds.query_many("pts", queries)
    assert len(got) == len(ref) == len(queries)
    for q, g, r in zip(queries, got, ref):
        assert np.array_equal(_ids(g), _ids(r)), q
        assert np.array_equal(_ids(g), _ids(tds.query("pts", q))), q
    assert sum(len(g) for g in got) > 0
    # the chunks the port packs are the JAX table's (box chunks: the JAX
    # package also fuses polygon members, which the port scans on host)
    jbox = [(b, q) for b, q, kw in jcalls if not kw.get("n_edges") and not kw.get("n_rints")]
    assert len(tcalls) >= 2  # the batch really fused, into several chunks
    assert len(tcalls) == len(jbox)
    for (tb, tq, _), (jb, jq) in zip(tcalls, jbox):
        assert np.array_equal(tb, jb) and np.array_equal(tq, jq)


def test_query_many_with_limit_and_empty(stores):
    jds, tds = stores["z3"]
    queries = [TIME_QUERIES[0], "bbox(geom, 170, 80, 175, 85) AND " + _dur(40, 41),
               TIME_QUERIES[2], TIME_QUERIES[3]]
    got = tds.query_many("pts", queries, limit=5)
    ref = jds.query_many("pts", queries, limit=5)
    assert [len(g) for g in got] == [len(r) for r in ref]
    assert [len(g) for g in got] == [5, 0, 5, 5]


@pytest.mark.parametrize("cell", CELLS)
def test_density_many_equals_jax(stores, cell):
    jds, tds = stores[cell]
    queries = BATCHES[cell][:12]
    envs = [None, (-45.5, -30.25, 45, 30), (-180, -90, 0, 0), (0, -60, 120, 60)]
    requests = [(q, envs[i % len(envs)]) for i, q in enumerate(queries)]
    got = tds.density_many("pts", requests, width=40, height=24)
    ref = jds.density_many("pts", requests, width=40, height=24)
    for (q, _), g, r in zip(requests, got, ref):
        assert g.dtype == np.float32 and g.shape == (24, 40)
        assert np.array_equal(g, r), q
    assert sum(float(g.sum()) for g in got) > 0
    # density delegates to density_many
    q, env = requests[1]
    assert np.array_equal(tds.density("pts", q, envelope=env, width=40, height=24), got[1])
