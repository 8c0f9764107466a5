"""geomesa-lint for the port: project-specific static analysis.

The port of geomesa_tpu/analysis/. The reference GeoMesa enforces its
cross-cutting contracts (index metadata registration, iterator
configuration keys) through JVM typing and a plugin SPI; a Python
reproduction has neither, and pays for it at review time (a fused-chunk
grouping key that omitted the edge-bucket dimension, a metrics registry
retrofitted with a lock, ~100 ``geomesa.*`` knobs whose declarations,
read sites and docs drift independently). This package encodes those
invariants as machine-checked rules over the port's own tree, rule for
rule the JAX package's, so a small departure of the port from the
reference (a dropped user-data key, a metric observed under another
name) shows as a finding.

Layout:

- :mod:`~geomesa_tpu_torch.analysis.core` — the Rule SPI, per-file AST
  cache, :class:`~geomesa_tpu_torch.analysis.core.Finding` objects and
  the suppression baseline;
- :mod:`~geomesa_tpu_torch.analysis.registries` — the shared source of
  truth for configuration knobs (``conf.py``), metric instrument names,
  schema user-data keys, fault points and controllers, extracted from
  the AST;
- :mod:`~geomesa_tpu_torch.analysis.lockmodel` — the lock registry and
  the static acquisition graph the concurrency rules and the lock
  witness check;
- :mod:`~geomesa_tpu_torch.analysis.rules` — the rule families (knob
  registry, metrics registry, fault points, controllers, fused variant
  key, lock discipline, concurrency, warmup coverage, script hygiene).

Run it with ``python -m geomesa_tpu_torch.scripts.check`` (human or
``--json`` output) or through ``tests/test_torch_analysis.py``, which
makes a clean port a tier-1 invariant. Pure stdlib (ast/re/os): it
imports neither torch nor the analyzed code. The rule catalog is
``geomesa_tpu_torch/docs/analysis.md``.
"""

from geomesa_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    Project,
    Rule,
    load_baseline,
    run_rules,
)
from geomesa_tpu_torch.analysis.rules import ALL_RULES  # noqa: F401


def run(root=None, rule_ids=None, baseline=None):
    """Analyze the repo at ``root`` (default: this checkout) with the
    shipped rules; returns (findings, suppressed) after baseline
    filtering. The one-call surface the check script and the tests use."""
    import os

    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    project = Project.load(root)
    rules = [r for r in ALL_RULES if rule_ids is None or r.id in rule_ids]
    return run_rules(project, rules, baseline=baseline)
