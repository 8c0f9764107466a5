"""Fused-variant-key rule: the E-bucket bug class, made impossible to repeat.

The port of geomesa_tpu/analysis/rules/fused.py.

The fused multi-query scan groups eligible queries by a *variant key*
(``scan_submit_many``'s ``groups.setdefault(key, ...)``) and then builds
ONE set of kernel operands per chunk (``_chunk_edge_stack`` /
``_chunk_raster_stack`` -> ``block_scan_multi``). The operands' static
shapes are derived per chunk with the ``fused_<dim>_bucket`` ladder
functions — so every ladder dimension used on the chunk side MUST also
be derivable from the grouping key, or two queries with different
static shapes land in one chunk and the "shared" dispatch silently
recompiles per chunk (or worse, pads every member to the largest
member's shape, the E-bucket defect the JAX package once shipped: the
key omitted the edge bucket, so a 256-edge polygon member inflated
every box slot in its chunk to 256-edge PIP work).

Static check, per module that references ``block_scan_multi``:

1. find grouping functions — any function containing
   ``<dict>.setdefault(key, ...)`` where ``key`` is (or flows from) a
   tuple;
2. compute the *key flow*: every function name and constant name that
   (transitively, through same-function assignments) contributes to the
   key tuple;
3. every ``fused_<dim>_bucket`` function called elsewhere in the module
   (the chunk-operand side) must appear in some grouping function's key
   flow. Each missing dimension is one finding.

Modules with chunk-side derivations but no grouping function (e.g. a
subclass overriding only ``_submit_fused_chunk``) are skipped: the
grouping lives in the base class whose module carries the check.

The ladder pattern covers ``fold_<dim>_bucket`` as well:
the incremental fold's device plan deliberately ships NO static-bucket
shapes today (eager device ops, nothing compile-keyed), but a future
fold-side ladder shaping fold operands would recreate exactly the
E-bucket defect class — any ``fold_*_bucket`` derivation must likewise be
derivable from a grouping key the moment one appears.
"""

from __future__ import annotations

import ast
import re

from geomesa_tpu_torch.analysis.core import Project, Rule, call_name

_DERIV_RE = re.compile(r"^(fused|fold)_[a-z0-9]+_bucket$")


def _function_defs(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _setdefault_key_exprs(fn):
    """The key expressions of every ``X.setdefault(key, ...)`` call in
    one function whose key is (or flows from) a TUPLE — the variant-key
    shape. Non-tuple setdefaults (incidental per-device binning and the
    like) must not make their function a 'grouping function', which
    would exempt its fused_*_bucket calls from the check."""
    assigns: dict[str, list[ast.AST]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    assigns.setdefault(t.id, []).append(node.value)
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and call_name(node) == "setdefault"
            and node.args
        ):
            key = node.args[0]
            is_tuple = isinstance(key, ast.Tuple) or (
                isinstance(key, ast.Name)
                and any(
                    isinstance(v, ast.Tuple)
                    for v in assigns.get(key.id, [])
                )
            )
            if is_tuple:
                yield key


def _key_flow(fn, key_expr) -> set[str]:
    """Names (variables, constants, called functions) contributing to a
    grouping key, following same-function assignments transitively."""
    # name -> the expressions assigned to it within fn
    assigns: dict[str, list[ast.AST]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    assigns.setdefault(t.id, []).append(node.value)

    flow: set[str] = set()
    queue: list[ast.AST] = [key_expr]
    seen_vars: set[str] = set()
    while queue:
        expr = queue.pop()
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                flow.add(call_name(n))
            elif isinstance(n, ast.Attribute):
                flow.add(n.attr)
            elif isinstance(n, ast.Name):
                flow.add(n.id)
                if n.id not in seen_vars:
                    seen_vars.add(n.id)
                    queue.extend(assigns.get(n.id, []))
    return flow


class FusedVariantKeyRule(Rule):
    id = "fused-key-dimension"
    description = (
        "every fused_<dim>_bucket / fold_<dim>_bucket ladder dimension "
        "used to shape chunk operands must be derivable from the chunk "
        "grouping key"
    )
    fix_hint = (
        "add the missing <dim>_bucket term to the grouping-key tuple in "
        "the scan_submit_many-style grouping function"
    )

    def check(self, project: Project):
        for sf in project.python_files():
            if sf.tree is None or "block_scan_multi" not in sf.text:
                continue
            fns = list(_function_defs(sf.tree))
            grouping = [
                (fn, key)
                for fn in fns
                for key in _setdefault_key_exprs(fn)
            ]
            if not grouping:
                continue
            grouping_fns = {fn for fn, _ in grouping}
            # chunk-side derivations: fused_*_bucket calls OUTSIDE any
            # grouping function
            required: dict[str, int] = {}
            for node in sf.nodes:
                if isinstance(node, ast.Call):
                    name = call_name(node)
                    if _DERIV_RE.match(name):
                        fn = sf.enclosing_function(node)
                        if fn not in grouping_fns:
                            required.setdefault(name, node.lineno)
            if not required:
                continue
            flows = [
                (fn, key, _key_flow(fn, key)) for fn, key in grouping
            ]
            for name, lineno in sorted(required.items()):
                if any(name in flow for _, _, flow in flows):
                    continue
                fn, key, _ = flows[0]
                yield self.finding(
                    sf, key.lineno,
                    f"chunk operands derive their static shape with "
                    f"{name}() (line {lineno}) but the fused grouping "
                    f"key in {fn.name}() does not include that "
                    "dimension: members with different "
                    f"{name.split('_')[1].upper()} buckets would share "
                    "one chunk (the E-bucket defect class)",
                    symbol=f"{fn.name}:{name}",
                )
