"""Script-hygiene rule: geomesa_tpu_torch/scripts/ stays navigable.

The probe and A/B scripts are the port's measurement provenance
(PERF.md cites them); a probe without a docstring stating what it
measures is noise the next session has to reverse-engineer. Knob
hygiene inside scripts is covered by the registry rules (the scripts
are inside their scan scope).
"""

from __future__ import annotations

import ast

from geomesa_tpu_torch.analysis.core import Project, Rule


class ScriptDocstringRule(Rule):
    id = "script-docstring"
    description = (
        "every geomesa_tpu_torch/scripts/*.py module carries a docstring stating what it "
        "probes/does and how to run it"
    )
    fix_hint = "add a module docstring (what it measures, how to run)"

    def check(self, project: Project):
        for sf in project.python_files("geomesa_tpu_torch/scripts/"):
            if sf.tree is None:
                continue
            doc = ast.get_docstring(sf.tree)
            if not doc or not doc.strip():
                yield self.finding(
                    sf, 1,
                    "script has no module docstring",
                    symbol="module",
                )
