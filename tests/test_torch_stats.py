"""The port's count estimate and Stat DSL against the JAX DataStore, on
the CPU.

``stats_query`` with ``estimate=True`` (``Count()`` through the
``block_pops`` count push-down: contained spans by length, straddling
blocks decoded) and ``estimate=False`` (the Stat DSL over the refined
rows) on the stores and queries of tests/test_torch_batch.py. Tolerance
is exact equality of every sketch's JSON form.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu_torch import native as tnative
from test_torch_batch import BATCHES, CELLS
from test_torch_store import _build, _data

# the suite runs in several test processes side by side: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)


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


SPECS = ["Count()", "MinMax(age)", "Count();MinMax(age)", "MinMax(dtg)"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("estimate", [True, False], ids=["estimate", "exact"])
def test_stats_query_equals_jax(stores, cell, estimate):
    jds, tds = stores[cell]
    specs = SPECS if cell != "z2" else SPECS[:3]
    for i, q in enumerate(BATCHES[cell][:8]):
        for spec in (specs[i % len(specs)], specs[(i + 1) % len(specs)]):
            got = tds.stats_query("pts", spec, q, estimate=estimate)
            ref = jds.stats_query("pts", spec, q, estimate=estimate)
            assert [type(s).__name__ for s in got] == [type(s).__name__ for s in ref]
            assert [s.to_json() for s in got] == [s.to_json() for s in ref], (q, spec)


@pytest.mark.parametrize("cell", CELLS)
def test_count_estimate_is_a_superset_of_the_exact_count(stores, cell):
    _, tds = stores[cell]
    for q in BATCHES[cell][8:16]:
        n_est = tds.stats_query("pts", "Count()", q, estimate=True)[0].count
        n_exact = tds.stats_query("pts", "Count()", q)[0].count
        assert n_est >= n_exact == len(tds.query("pts", q))


def test_count_estimate_decodes_straddling_blocks(stores):
    """Queries with contained spans: blocks straddling a contained span
    decode through the scan kernel instead of counting twice."""
    jds, tds = stores["z3"]
    seen = 0
    for q in BATCHES["z3"]:
        plan = tds.planner.plan("pts", q)
        if plan.index is None:
            continue
        table = tds.table("pts", plan.index)
        _, contained = table.candidate_spans_split(plan.config)
        if contained:
            seen += 1
            jt = jds.table("pts", plan.index)
            jcfg = jds.planner.plan("pts", q).config
            assert table.count(plan.config) == jt.count(jcfg), q
    assert seen
