"""Metrics-registry rule family.

The metrics surface is scraped by operators (``render_prometheus``) and
asserted on by benches and tests; two defects survive review easily:

- a name outside the ``geomesa.<area>.<name>`` convention (hyphens or
  uppercase break the Prometheus rename; a missing area segment lands
  the metric in nobody's dashboard);
- the same name used as two instrument kinds (a counter in one module,
  a gauge in another) — the registry would happily keep both, and the
  scrape would emit two conflicting TYPE lines.

Name collection includes one level of wrapper inference (``_count``,
``_drop_locked``-style helpers) and f-string families like
``f"geomesa.ingest.{stage}"`` — see analysis/registries.py. The port
of geomesa_tpu/analysis/rules/metrics.py.
"""

from __future__ import annotations

import re

from geomesa_tpu_torch.analysis.core import Project, Rule
from geomesa_tpu_torch.analysis.registries import Registries

# geomesa.<area>.<name...>: lowercase, digits, underscore; >= 2 segments
# after the geomesa. root so every instrument has an area
_NAME_RE = re.compile(r"^geomesa\.[a-z0-9_]+(\.[a-z0-9_]+)+$")
_PREFIX_RE = re.compile(r"^geomesa\.[a-z0-9_]+(\.[a-z0-9_]+)*\.$")


class MetricConventionRule(Rule):
    id = "metric-convention"
    description = (
        "metric names follow geomesa.<area>.<name> (lowercase, digits, "
        "underscores; at least one area segment)"
    )
    fix_hint = (
        "rename the instrument to geomesa.<area>.<name> — hyphens and "
        "uppercase break the Prometheus exposition rename"
    )

    def check(self, project: Project):
        regs = Registries.of(project)
        for use in regs.metrics.uses:
            pattern = _PREFIX_RE if use.is_prefix else _NAME_RE
            if not pattern.match(use.name):
                kind = "family prefix" if use.is_prefix else "name"
                yield self.finding(
                    use.path, use.line,
                    f"metric {kind} {use.name!r} violates the "
                    "geomesa.<area>.<name> convention",
                    symbol=use.name,
                )


class MetricTypeConflictRule(Rule):
    id = "metric-type-conflict"
    description = (
        "one metric name must map to one instrument kind (counter, "
        "gauge, or timer) across the whole tree"
    )
    fix_hint = (
        "split the name (e.g. .count vs .bytes) so each instrument owns "
        "its own family"
    )

    def check(self, project: Project):
        regs = Registries.of(project)
        for name, uses in sorted(regs.metrics.by_name().items()):
            kinds = {u.instrument for u in uses}
            if len(kinds) > 1:
                sites = ", ".join(
                    f"{u.path}:{u.line} ({u.instrument})" for u in uses
                )
                first = min(uses, key=lambda u: (u.path, u.line))
                yield self.finding(
                    first.path, first.line,
                    f"metric {name!r} used as {len(kinds)} instrument "
                    f"kinds: {sites}",
                    symbol=name,
                )
