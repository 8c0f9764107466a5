"""The port's static analysis (geomesa_tpu_torch/analysis/) against the JAX
package's, on the CPU.

Two layers, as in tests/test_static_analysis.py:

- **the port is clean**: every rule of the port over geomesa_tpu_torch/
  and its documents gives zero findings with an empty baseline, the
  checked-in baseline holds no key, no line of the port carries an inline
  suppression, and the run stays under a CPU-time budget (CPU time, not
  wall clock, so a loaded host does not fail it);
- **the rules have the reference's teeth**: the 23 fixtures of
  tests/fixtures/analysis/ are read from disk and staged twice, into the
  JAX package's project at the reference test's paths and into the
  port's at the same paths under geomesa_tpu_torch/. For every rule the
  port keeps, both report the same findings (rule id, line, symbol, and
  the message up to the package prefix), and each of the reference's
  "is caught" checks holds for the port's findings.

Each tree loads once per module.
"""

from __future__ import annotations

import os
import re
import time

import pytest

from geomesa_tpu import analysis as jax_analysis
from geomesa_tpu.analysis.core import Project as JaxProject
from geomesa_tpu.analysis.core import run_rules as jax_run_rules
from geomesa_tpu_torch import analysis
from geomesa_tpu_torch.analysis.core import (
    Project,
    default_baseline_path,
    load_baseline,
    run_rules,
)
from test_static_analysis import _SYNTHETIC_PATHS

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXDIR = "tests/fixtures/analysis"
FIXTURES = sorted(f for f in os.listdir(os.path.join(ROOT, FIXDIR)) if f.endswith(".py"))
#: the JAX package's rules that look only inside jax.jit functions
NO_COUNTERPART = {"kernel-traced-coercion", "kernel-dynamic-shape"}


def _render(findings):
    return "\n".join(f.render() for f in findings)


def _jax_path(name: str) -> str:
    return _SYNTHETIC_PATHS.get(name, f"{FIXDIR}/{name}")


def _port_path(name: str) -> str:
    return _jax_path(name).replace("geomesa_tpu/", "geomesa_tpu_torch/", 1)


@pytest.fixture(scope="module")
def clean_run():
    """(project, result, CPU seconds) of the port's rules over the port,
    no baseline help."""
    t0 = time.process_time()
    project = Project.load(ROOT)
    result = run_rules(project, analysis.ALL_RULES, baseline=set())
    return project, result, time.process_time() - t0


@pytest.fixture(scope="module")
def staged():
    """(JAX project, JAX result, port result): each package's rules over
    its own tree plus every fixture, staged at the mirrored paths."""
    jp, tp = JaxProject.load(ROOT), Project.load(ROOT)
    for name in FIXTURES:
        with open(os.path.join(ROOT, FIXDIR, name), encoding="utf-8") as fh:
            src = fh.read()
        jp.add_file(_jax_path(name), text=src)
        tp.add_file(_port_path(name), text=src)
    return (jp, jax_run_rules(jp, jax_analysis.ALL_RULES, baseline=set()),
            run_rules(tp, analysis.ALL_RULES, baseline=set()))


# -- the port is clean ------------------------------------------------------------


def test_port_is_lint_clean_within_its_cpu_budget(clean_run):
    _, result, cpu_s = clean_run
    assert result.clean, f"new lint findings:\n{_render(result.findings)}"
    assert not result.suppressed, _render(result.suppressed)
    assert cpu_s < 10.0, f"analysis took {cpu_s:.1f} s of CPU (budget 10 s)"


def test_checked_in_baseline_is_empty_and_nothing_is_ignored_inline(clean_run):
    assert load_baseline(default_baseline_path(ROOT)) == set()
    # (core.py's docstring shows the syntax with a placeholder id)
    ids = {r.id for r in analysis.ALL_RULES} | {"*", "parse-error"}
    ignored = {rel: sf.ignores for rel, sf in clean_run[0].files.items()
               if any(i & ids for i in sf.ignores.values())}
    assert ignored == {}, ignored


def test_rule_ids_unique_and_well_formed():
    ids = [r.id for r in analysis.ALL_RULES]
    assert len(ids) == len(set(ids)) == 17, ids
    for r in analysis.ALL_RULES:
        assert r.id and r.id == r.id.lower() and " " not in r.id, r.id
        assert r.description and r.fix_hint, r.id
    # the reference's order, less the two jit rules
    assert ids == [r.id for r in jax_analysis.ALL_RULES if r.id not in NO_COUNTERPART]


# -- the rules have the reference's teeth ----------------------------------------


def _key(f):
    """A finding up to the package prefix (the port's messages drop one
    reference to the JAX package's change history)."""
    msg = re.sub(r"PR \d+ ", "", f.message.replace("geomesa_tpu_torch", "geomesa_tpu"))
    return f.rule_id, f.line, f.symbol, msg


def test_fixtures_perturb_no_other_file(staged):
    _, jres, tres = staged
    assert [f for f in jres.findings if f.path not in {_jax_path(n) for n in FIXTURES}] == []
    assert [f for f in tres.findings if f.path not in {_port_path(n) for n in FIXTURES}] == []


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_findings_equal_the_jax_package(staged, name):
    _, jres, tres = staged
    ref = sorted(_key(f) for f in jres.findings
                 if f.path == _jax_path(name) and f.rule_id not in NO_COUNTERPART)
    got = sorted(_key(f) for f in tres.findings if f.path == _port_path(name))
    assert got == ref, name


def test_jit_rules_have_no_counterpart(staged):
    """kernel_bad.py gives the reference its two jit findings and the port
    none."""
    _, jres, tres = staged
    assert sorted(f.rule_id for f in jres.findings
                  if f.path == _jax_path("kernel_bad.py")) == sorted(NO_COUNTERPART)
    assert [f for f in tres.findings if f.path == _port_path("kernel_bad.py")] == []
    assert not NO_COUNTERPART & {r.id for r in analysis.ALL_RULES}


# the reference's "is caught" checks, each on the port's findings:
# (fixture, rule, symbol prefix, count, substrings every finding holds,
# exact symbol set or None)
CAUGHT = {
    "e-bucket-grouping-key": ("fused_bad_pr5.py", "fused-key-dimension", "", 1,
                              ("fused_e_bucket", "scan_submit_many"), None),
    "fused-good": ("fused_good.py", None, "", 0, (), None),
    "fold-ladder": ("fold_bad_ladder.py", "fused-key-dimension", "", 1, ("fold_s_bucket",), None),
    "unlocked-registry": ("locks_bad_registry.py", "lock-guarded-mutation", "", 1,
                          ("counters", "counter()", "inferred"), None),
    "inherited-annotation": ("locks_bad_inherited.py", "lock-guarded-mutation", "", 1,
                             ("_items", "add"), None),
    "scheduler-guarded-by": ("locks_bad_scheduler.py", "lock-guarded-mutation", "", 1,
                             ("_queue", "submit", "guarded-by"), None),
    "locks-good": ("locks_good.py", None, "", 0, (), None),
    "order-cycle": ("race_bad_order.py", "lock-order-cycle", "cycle:", 1,
                    ("RaceyLedger._hot_lock", "RaceyLedger._audit_lock", "deadlock"), None),
    "order-rank": ("race_bad_order.py", "lock-order-cycle", "rank:", 1,
                   ("rank 19", "rank 11"), None),
    "unregistered-lock": ("race_bad_unregistered.py", "lock-order-cycle", "", 1,
                          ("UnrankedBuffer._buf_lock", "no LOCKS registry entry"), None),
    "checkpoint-cover": ("race_bad_pr9_checkpoint.py", "atomicity-check-then-act", "", 1,
                         ("_pending", "checkpoint", "without re-reading"), None),
    "take-staged": ("race_bad_pr11_takestaged.py", "atomicity-check-then-act", "", 1,
                    ("_staged", "take"), None),
    "blocking-under-hot-lock": ("race_bad_blocking.py", "blocking-under-lock", "", 2,
                                ("HotTier._lock",), None),
    "guarded-escape": ("race_bad_escape.py", "guarded-escape", "", 2, (),
                       {"LeakyCache.rows._rows:return", "LeakyCache.publish._rows:store"}),
    "race-good": ("race_good.py", None, "", 0, (), None),
    "undeclared-knob": ("knob_bad.py", "knob-undeclared", "", 1, ("geomesa.scan.rangs.target",), None),
    "metric-convention": ("metric_bad.py", "metric-convention", "", 1,
                          ("geomesa.Fixture-Area.hits",), None),
    "metric-type-conflict": ("metric_bad.py", "metric-type-conflict", "", 1,
                             ("geomesa.fixture.depth", "counter", "gauge"), None),
    "histogram-convention": ("hist_bad.py", "metric-convention", "", 2,
                             ("geomesa.Fixture-Hist.latency",), None),
    "histogram-type-conflict": ("hist_bad.py", "metric-type-conflict", "", 1,
                                ("geomesa.fixture.wait", "histogram", "counter"), None),
    "unregistered-fault-point": ("fault_bad.py", "fault-point-unknown", "", 1,
                                 ("streem.wal.append",), None),
    "fault-good": ("fault_good.py", None, "", 0, (), None),
    "unregistered-controller": ("controller_bad.py", "controller-registry", "", 4,
                                ("bogus_controller",),
                                {"bogus_controller", "knob:bogus_controller",
                                 "bounds:bogus_controller", "objective:bogus_controller"}),
    "fstring-once": ("knob_fstring.py", "knob-undeclared", "", 1, ("geomesa.bogus",), None),
    "warmup-ladder-gap": ("warmup_bad.py", "warmup-coverage", "", 1, ("FUSED_R_BUCKETS",), None),
}


@pytest.mark.parametrize("case", list(CAUGHT))
def test_defect_is_caught_by_the_port(staged, case):
    name, rule, prefix, n, subs, symbols = CAUGHT[case]
    got = [f for f in staged[2].findings
           if f.path == _port_path(name) and (rule is None or f.rule_id == rule)
           and f.symbol.startswith(prefix)]
    assert len(got) == n, _render(got)
    for f in got:
        assert all(s in f.message for s in subs), f.render()
        assert str(f.line) not in f.key, f.key  # baseline keys stay line-free
    if symbols is not None:
        assert {f.symbol for f in got} == symbols, _render(got)
    if case == "blocking-under-hot-lock":
        assert {f.message.split(" call ")[0] for f in got} == {"fsync", "Future.result"}


# -- registries and the lock model ------------------------------------------------


def test_registries_hold_what_the_jax_package_declares():
    """The user-data keys, fault points and controllers are the reference's,
    and the port's controller specs back every registered controller."""
    from geomesa_tpu.analysis import registries as jreg
    from geomesa_tpu_torch.analysis import registries as treg
    from geomesa_tpu_torch.tuning.controllers import CONTROLLER_SPECS

    assert treg.USER_DATA_KEYS == jreg.USER_DATA_KEYS
    assert treg.FAULT_POINTS == jreg.FAULT_POINTS
    assert treg.CONTROLLERS == jreg.CONTROLLERS
    assert {s.name for s in CONTROLLER_SPECS} == set(treg.CONTROLLERS)


def test_lock_model_is_the_reference_s_over_the_port(clean_run, staged):
    """The port's LOCKS registry names the reference's locks at the port's
    paths, with unique ranks; every entry is constructed through the
    witness under its own name; the static graph is acyclic, ranked, and
    has the reference's edges and one declared edge more."""
    from geomesa_tpu.analysis import lockmodel as jlm
    from geomesa_tpu_torch.analysis.lockmodel import DECLARED_EDGES, LOCKS, LockModel

    assert {n: (d.path.replace("geomesa_tpu_torch/", "geomesa_tpu/", 1), d.rank, d.hot, d.fields)
            for n, d in LOCKS.items()} == {
        n: (d.path, d.rank, d.hot, d.fields) for n, d in jlm.LOCKS.items()}
    assert len({d.rank for d in LOCKS.values()}) == len(LOCKS)
    model = LockModel.of(clean_run[0])
    for name, d in LOCKS.items():
        assert model.sites[name].witness_name == name and model.sites[name].path == d.path
    for a, b, why in DECLARED_EDGES:
        assert LOCKS[a].rank < LOCKS[b].rank and why, (a, b)
    assert model.cycles() == []
    edges = model.predicted_edges()
    # the reference's edges between locks of its own tree (the staged
    # fixtures add locks of their own), plus the one declared edge the
    # port adds (a follower's promotion, which both runtimes take)
    jmodel = jlm.LockModel.of(staged[0])
    fixture_paths = {_jax_path(n) for n in FIXTURES}
    ref = {(a, b) for a, b in jmodel.predicted_edges()
           if not {jmodel.sites[a].path, jmodel.sites[b].path} & fixture_paths}
    assert edges - ref == {("ReplicaStore._apply_lock", "WriteAheadLog._lock")} and ref <= edges
    assert ("WriteAheadLog._sync_lock", "WriteAheadLog._lock") in edges
    for a, b in edges:
        ra, rb = model.rank_of(a), model.rank_of(b)
        assert ra is None or rb is None or ra < rb, (a, b)


def test_baseline_and_inline_suppression(tmp_path):
    """A baselined key suppresses its finding (the key carries the symbol,
    not the line), and so does an inline ignore on the flagged line."""
    rules = [r for r in analysis.ALL_RULES if r.id == "knob-undeclared"]
    with open(os.path.join(ROOT, FIXDIR, "knob_bad.py"), encoding="utf-8") as fh:
        src = fh.read()
    (tmp_path / "geomesa_tpu_torch").mkdir()
    with open(os.path.join(ROOT, "geomesa_tpu_torch", "conf.py"), encoding="utf-8") as fh:
        (tmp_path / "geomesa_tpu_torch" / "conf.py").write_text(fh.read())

    def run(text, baseline):
        (tmp_path / "geomesa_tpu_torch" / "knob_bad.py").write_text(text)
        res = run_rules(Project.load(str(tmp_path)), rules, baseline=baseline)
        return ([f for f in res.findings if f.path.endswith("knob_bad.py")],
                [f for f in res.suppressed if f.path.endswith("knob_bad.py")])

    bad, _ = run(src, set())
    assert len(bad) == 1 and str(bad[0].line) not in bad[0].key
    assert run(src, {bad[0].key}) == ([], bad)
    lines = src.splitlines()
    lines[bad[0].line - 1] += "  # lint: ignore[knob-undeclared]"
    found, suppressed = run("\n".join(lines) + "\n", set())
    assert not found and len(suppressed) == 1


def test_fault_coverage_reads_only_the_port_s_tests(tmp_path):
    """A fault point counts as exercised only when a test of the port arms
    it: the JAX package's test files and the fixtures are not read."""
    (tmp_path / "tests" / "fixtures").mkdir(parents=True)
    for rel in ("tests/test_torch_x.py", "tests/test_other.py", "tests/fixtures/test_torch_y.py"):
        (tmp_path / rel).write_text("X = 1\n")
    assert list(Project.load(str(tmp_path)).tests) == ["tests/test_torch_x.py"]
