"""Rule assembly: the shipped rule set, in deterministic order.

The port of geomesa_tpu/analysis/rules/__init__.py: the reference's
rules in the reference's order, less the two jit rules that have no
counterpart (``KernelTracedCoercionRule`` and ``KernelDynamicShapeRule``,
``rules/kernels.py``). Adding a rule: subclass
:class:`geomesa_tpu_torch.analysis.core.Rule` in one of these modules
(or a new one), give it a unique kebab-case ``id``, a one-line
``description`` and a ``fix_hint``, append an instance here, document
the id in geomesa_tpu_torch/docs/analysis.md, and hold it against the
JAX package's rule on the shared fixtures in
tests/test_torch_analysis.py.
"""

from geomesa_tpu_torch.analysis.rules.concurrency import (
    BlockingUnderLockRule,
    CheckThenActRule,
    GuardedEscapeRule,
    LockOrderRule,
)
from geomesa_tpu_torch.analysis.rules.controllers import ControllerRegistryRule
from geomesa_tpu_torch.analysis.rules.faults import FaultPointRule
from geomesa_tpu_torch.analysis.rules.fused import FusedVariantKeyRule
from geomesa_tpu_torch.analysis.rules.kernels import WarmupCoverageRule
from geomesa_tpu_torch.analysis.rules.knobs import (
    DocUnknownNameRule,
    KnobUndeclaredRule,
    KnobUndocumentedRule,
    KnobUnreadRule,
    UserDataUnusedRule,
)
from geomesa_tpu_torch.analysis.rules.locks import LockDisciplineRule
from geomesa_tpu_torch.analysis.rules.metrics import (
    MetricConventionRule,
    MetricTypeConflictRule,
)
from geomesa_tpu_torch.analysis.rules.scripts import ScriptDocstringRule

ALL_RULES = [
    KnobUndeclaredRule(),
    KnobUnreadRule(),
    KnobUndocumentedRule(),
    UserDataUnusedRule(),
    DocUnknownNameRule(),
    MetricConventionRule(),
    MetricTypeConflictRule(),
    FaultPointRule(),
    ControllerRegistryRule(),
    FusedVariantKeyRule(),
    LockDisciplineRule(),
    LockOrderRule(),
    CheckThenActRule(),
    BlockingUnderLockRule(),
    GuardedEscapeRule(),
    WarmupCoverageRule(),
    ScriptDocstringRule(),
]
