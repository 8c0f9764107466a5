"""Fault-point registry rule: the crash harness can't drift from code.

The port of geomesa_tpu/analysis/rules/faults.py. The store's
durability claims rest on deterministic fault injection: a crash
test arms a NAMED point and asserts the recovery invariant. Names are
plain strings, so three silent failure modes exist — a typo'd or
renamed point the tests still arm (the fault never fires, the test
passes vacuously), a point the code fires that no registry documents,
and a registered point no test ever exercises (an untested crash
window). This rule machine-checks all three against
``registries.FAULT_POINTS`` — the knob and metric registries' move,
applied to the fault-injection namespace.

The coverage direction reads the port's TEST files (``tests/
test_torch_*.py``, raw text, never linted): a
point counts as exercised when any test string names it exactly, arms
an ``fnmatch`` pattern matching it (``persist.*``), or embeds it in a
``GEOMESA_TPU_FAULTS``-style ``point:kind`` entry.
"""

from __future__ import annotations

import fnmatch

from geomesa_tpu_torch.analysis.core import Project, Rule
from geomesa_tpu_torch.analysis.registries import (
    FAULT_POINTS,
    fault_point_uses,
    test_string_tokens,
)

_REGS_PATH = "geomesa_tpu_torch/analysis/registries.py"


def _registry_line(project: Project, name: str) -> int:
    """The FAULT_POINTS declaration line of one registered name (for
    registry-side findings), falling back to 1."""
    sf = project.files.get(_REGS_PATH)
    if sf is not None:
        needle = f'"{name}"'
        for i, line in enumerate(sf.lines, start=1):
            if needle in line:
                return i
    return 1


def _exercised(name: str, tokens: set[str]) -> bool:
    for tok in tokens:
        if tok == name:
            return True
        if ":" in tok and tok.split(":", 1)[0] == name:
            return True  # GEOMESA_TPU_FAULTS "point:kind[:...]" entry
        if "*" in tok and fnmatch.fnmatch(name, tok.split(":", 1)[0]):
            return True
    return False


class FaultPointRule(Rule):
    id = "fault-point-unknown"
    description = (
        "every fault_point()/atomic_write(point=) literal must be "
        "registered in registries.FAULT_POINTS, every registered point "
        "must have a code use site, and every registered point must be "
        "exercised by at least one test"
    )
    fix_hint = (
        "register the point in analysis/registries.py FAULT_POINTS (or "
        "fix the typo), and arm it from a test (fault.inject / "
        "fault.chaos / GEOMESA_TPU_FAULTS)"
    )

    def check(self, project: Project):
        if _REGS_PATH not in project.files:
            return  # staged mini-repos without the registry are exempt
        uses = fault_point_uses(project)
        used_names = {u.name for u in uses}
        for u in uses:
            if u.name not in FAULT_POINTS:
                yield self.finding(
                    u.path, u.line,
                    f"fault point {u.name!r} is not registered in "
                    "registries.FAULT_POINTS",
                    symbol=u.name,
                )
        for name in FAULT_POINTS:
            if name not in used_names:
                yield self.finding(
                    _REGS_PATH, _registry_line(project, name),
                    f"fault point {name!r} is registered but never "
                    "fired by any fault_point()/atomic_write() site",
                    symbol=f"unreached:{name}",
                )
        tokens = test_string_tokens(project)
        if not tokens:
            return  # no test tree in scope (mini repos)
        for name in sorted(FAULT_POINTS):
            if name in used_names and not _exercised(name, tokens):
                yield self.finding(
                    _REGS_PATH, _registry_line(project, name),
                    f"fault point {name!r} is never exercised by any "
                    "test (no literal, pattern, or env entry matches)",
                    symbol=f"unexercised:{name}",
                )
