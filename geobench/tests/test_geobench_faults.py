"""A run with the timed path broken underneath comes out not correct.

Each case drives ``run_cell`` (the harness without its look for a card) on
the CPU at a small size with one fault planted in the program's timed
path, where the answer is produced: the scheduler's fused dispatch
(``QueryPlanner.submit_many``). The faults a served store can have: an
answer altered (a row left out, or a value changed); half of a batch left
out (answered empty); a step that returns its state unchanged (the
previous answer served again). One chip holds the table, so no exchange
between chips can be left out. A sound run of the same size comes out
correct.
"""

import numpy as np
import pytest

from geobench import check
from geobench.run import load_spec, run_cell

SEED = 2**31 + 99


def small(cell):
    spec = load_spec(*cell.split(".", 1))
    spec["config"]["rows"] = 60_000
    spec["config"]["ingest"]["chunk_rows"] = 16384
    spec["traffic"]["clients"] = 4
    spec["traffic"]["warmup_requests"] = 2
    spec["traffic"]["sample_every"] = 1
    spec["traffic"]["request"]["window_hours"] = [24 * 30]
    return spec


def run(spec):
    out = run_cell(spec, SEED, 1.0, False, "cpu")
    return check.verdict(out["judged"]), out["judged"]


def query_fault(kind):
    from geomesa_tpu_torch.planning.planner import QueryPlanner

    real = QueryPlanner.submit_many
    served = []

    def broken(self, plans, **kw):
        finishes = real(self, plans, **kw)

        def wrap(k, fin):
            def finish():
                fc = fin()
                if kind == "altered" and len(fc):
                    return fc.take(np.arange(len(fc) - 1))
                if kind == "value" and len(fc):
                    fc.columns["dtg"] = fc.columns["dtg"].copy()
                    fc.columns["dtg"][0] += 1
                    return fc
                if kind == "half" and k >= (len(finishes) + 1) // 2:
                    return fc.take(np.arange(0))
                if kind == "unchanged":
                    prev = served[-1] if served else fc
                    served.append(fc)
                    return prev
                return fc
            return finish

        return [wrap(k, f) for k, f in enumerate(finishes)]

    return QueryPlanner, "submit_many", broken


@pytest.mark.parametrize("cell", ["gdelt-z3.dashboard"])
def test_sound_run_is_correct(cell):
    ok, judged = run(small(cell))
    assert ok, judged


@pytest.mark.parametrize("kind", ["altered", "value", "half", "unchanged"])
@pytest.mark.parametrize("cell", ["gdelt-z3.dashboard"])
def test_fault_is_not_correct(cell, kind, monkeypatch):
    spec = small(cell)
    monkeypatch.setattr(*query_fault(kind))
    ok, judged = run(spec)
    assert not ok, judged
