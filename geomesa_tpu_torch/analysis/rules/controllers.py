"""Controller-registry rule: every feedback controller is declared.

The port of geomesa_tpu/analysis/rules/controllers.py. The tuning tier
(``tuning/``) closes feedback loops around knobs, so
a bad controller is worse than a bad knob default — it keeps RE-applying
its mistake. The failure modes this rule kills are all silent at
runtime: a ``ControllerSpec`` someone added without registering it in
``registries.CONTROLLERS`` (no review surface, no doc obligation), a
registered controller whose spec was deleted (the registry lies), a
spec steering a knob conf.py never declared (the write-through goes
nowhere), inverted or non-literal bounds (the clamp can't be
machine-checked), and an objective metric no instrument site emits
(the controller hill-climbs noise forever). The fault-point rule's
move, applied to the controller namespace.
"""

from __future__ import annotations

from geomesa_tpu_torch.analysis.core import Project, Rule
from geomesa_tpu_torch.analysis.registries import (
    CONTROLLERS,
    Registries,
    controller_spec_uses,
)

_REGS_PATH = "geomesa_tpu_torch/analysis/registries.py"


def _registry_line(project: Project, name: str) -> int:
    sf = project.files.get(_REGS_PATH)
    if sf is not None:
        needle = f'"{name}"'
        for i, line in enumerate(sf.lines, start=1):
            if needle in line:
                return i
    return 1


class ControllerRegistryRule(Rule):
    id = "controller-registry"
    description = (
        "every ControllerSpec must be registered in "
        "registries.CONTROLLERS with literal bounds lo < hi, a knob "
        "declared in conf.py, and an objective metric some instrument "
        "site emits; every registered controller must have a spec"
    )
    fix_hint = (
        "register the controller in analysis/registries.py CONTROLLERS, "
        "declare the knob in conf.py, make lo/hi literal with lo < hi, "
        "and record the objective metric somewhere (or fix the typo)"
    )

    def check(self, project: Project):
        if _REGS_PATH not in project.files:
            return  # staged mini-repos without the registry are exempt
        regs = Registries.of(project)
        uses = controller_spec_uses(project)
        spec_names = {u.name for u in uses if u.name}
        for u in uses:
            if not u.name:
                yield self.finding(
                    u.path, u.line,
                    "ControllerSpec has no literal name= — an unnamed "
                    "spec cannot be registered or audited",
                    symbol="unnamed",
                )
                continue
            if u.name not in CONTROLLERS:
                yield self.finding(
                    u.path, u.line,
                    f"controller {u.name!r} is not registered in "
                    "registries.CONTROLLERS",
                    symbol=u.name,
                )
            if u.knob is None or not regs.knobs.resolves(u.knob):
                yield self.finding(
                    u.path, u.line,
                    f"controller {u.name!r} steers knob {u.knob!r} "
                    "which conf.py never declares — the write-through "
                    "goes nowhere",
                    symbol=f"knob:{u.name}",
                )
            if u.lo is None or u.hi is None or not u.lo < u.hi:
                yield self.finding(
                    u.path, u.line,
                    f"controller {u.name!r} bounds lo={u.lo!r} "
                    f"hi={u.hi!r} must be numeric literals with "
                    "lo < hi — non-literal or inverted bounds defeat "
                    "the clamp audit",
                    symbol=f"bounds:{u.name}",
                )
            if u.objective is None or not regs.metrics.resolves(u.objective):
                yield self.finding(
                    u.path, u.line,
                    f"controller {u.name!r} objective {u.objective!r} "
                    "is not emitted by any instrument site — it would "
                    "hill-climb noise",
                    symbol=f"objective:{u.name}",
                )
        for name in CONTROLLERS:
            if name not in spec_names:
                yield self.finding(
                    _REGS_PATH, _registry_line(project, name),
                    f"controller {name!r} is registered in CONTROLLERS "
                    "but no ControllerSpec declares it",
                    symbol=f"unbacked:{name}",
                )
