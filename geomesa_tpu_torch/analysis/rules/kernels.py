"""Kernel-variant rule: warmup walks every fused variant ladder.

The port of geomesa_tpu/analysis/rules/kernels.py. The scan tier keys
its fused dispatches on bucket ladders (one variant per (M bucket,
columns, flags, E, R)), and ``warmup()`` walks those ladders so no
production query pays a variant's first launch. If the fused grouping
key gains a dimension (an E/R-style bucket ladder) that warmup does not
walk, first queries stall. Any class shipping both ``warmup`` and
``scan_submit_many`` must reference every ``fused_<dim>_bucket`` ladder
(the function or its ``FUSED_<DIM>_BUCKETS`` constant), directly or one
call level down.

The JAX module's ``kernel-traced-coercion`` and ``kernel-dynamic-shape``
rules (``KernelTracedCoercionRule``, ``KernelDynamicShapeRule``, with
their tables ``KERNEL_SCOPES``, ``COERCIONS`` and ``DYNAMIC_SHAPE_CALLS``)
have no counterpart: both look only inside ``jax.jit`` functions
(traced-value coercion, data-dependent output shapes under a trace), and
the port has none — its kernels are CUDA sources launched through
wrappers on concrete tensors.
"""

from __future__ import annotations

import ast
import re

from geomesa_tpu_torch.analysis.core import Project, Rule, names_in

_DERIV_DEF_RE = re.compile(r"^fused_([a-z0-9]+)_bucket$")


class WarmupCoverageRule(Rule):
    id = "warmup-coverage"
    description = (
        "warmup() must walk every fused_<dim>_bucket variant-key ladder "
        "(reference the derivation fn or its FUSED_<DIM>_BUCKETS "
        "constant) so no fused dispatch compiles at query time"
    )
    fix_hint = (
        "extend warmup's fused ladder loop with the new dimension's "
        "FUSED_<DIM>_BUCKETS entries"
    )

    #: where the ladder dimensions are declared
    KERNEL_MODULE = "geomesa_tpu_torch/scan/block_kernels.py"

    def _dimensions(self, project: Project) -> list[str]:
        sf = project.files.get(self.KERNEL_MODULE)
        if sf is None or sf.tree is None:
            return []
        dims = []
        for node in sf.nodes:
            if isinstance(node, ast.FunctionDef):
                m = _DERIV_DEF_RE.match(node.name)
                if m:
                    dims.append(m.group(1))
        return sorted(dims)

    def check(self, project: Project):
        dims = self._dimensions(project)
        if not dims:
            return
        for sf in project.python_files():
            # host-only backends (no kernel dispatch) have nothing to warm
            if sf.tree is None or "block_scan_multi" not in sf.text:
                continue
            for cls in sf.nodes:
                if not isinstance(cls, ast.ClassDef):
                    continue
                methods = {
                    n.name: n for n in cls.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                }
                if "warmup" not in methods or "scan_submit_many" not in methods:
                    continue
                warm = methods["warmup"]
                names = names_in(warm)
                # one level of self-method indirection
                for callee in list(names):
                    if callee in methods and callee != "warmup":
                        names |= names_in(methods[callee])
                for dim in dims:
                    fn_name = f"fused_{dim}_bucket"
                    const = f"FUSED_{dim.upper()}_BUCKETS"
                    if fn_name not in names and const not in names:
                        yield self.finding(
                            sf, warm.lineno,
                            f"{cls.name}.warmup() never references "
                            f"{fn_name}()/{const}: the {dim.upper()} "
                            "variant-key ladder would compile at query "
                            "time",
                            symbol=f"{cls.name}.warmup:{dim}",
                        )
