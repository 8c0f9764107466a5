"""Lock-discipline rule: a lightweight static race detector.

The port of geomesa_tpu/analysis/rules/locks.py. The JAX package
retrofitted locking onto ``MetricsRegistry`` after review found
bare ``defaultdict`` read-modify-writes racing under concurrent
callers; the serving / cache / ingest tiers have since grown the same
shape (one lock, several guarded containers, helper methods that assume
the lock is held). This rule keeps those invariants machine-checked:

- **explicit**: an attribute assignment carrying a trailing
  ``# guarded-by: <lock>`` comment registers the attribute; every
  mutation of it must then happen inside ``with self.<lock>:`` (or in a
  method that declares ``# holds-lock: <lock>`` on its ``def`` line, or
  a ``*_locked``-suffixed method — the caller-holds-the-lock naming
  convention ``ResultCache._drop_locked`` established);
- **inferred** (``serving/``, ``cache/``, ``ingest/``, ``metrics.py``
  only): in a class that owns a ``threading.Lock/RLock/Condition``, an
  attribute mutated at least once under the lock is treated as guarded —
  mutations of it outside any lock are findings. Attributes never
  mutated under a lock are left alone (single-writer fields like the
  scheduler's adaptive window are legitimate), as are attributes
  guarded by two different locks (ambiguous; annotate explicitly).

``__init__``/``__post_init__`` are construction — exempt. Reads are
not checked (lock-free reads of monotonic state are a deliberate
pattern here; see ``QueryScheduler.window_s``).
"""

from __future__ import annotations

import ast
import re

from geomesa_tpu_torch.analysis.core import Project, Rule, call_name, self_attr

LOCK_CTORS = {"Lock", "RLock", "Condition"}
MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "popleft",
    "clear", "update", "setdefault", "add", "discard", "appendleft",
    "move_to_end", "sort", "reverse",
}
CONSTRUCTORS = {"__init__", "__post_init__", "__new__"}
INFER_SCOPES = (
    "geomesa_tpu_torch/serving/", "geomesa_tpu_torch/cache/", "geomesa_tpu_torch/ingest/",
    "geomesa_tpu_torch/metrics.py",
)

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*(?:self\.)?(\w+)")
_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*(?:self\.)?(\w+)")


def _class_methods(cls):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _lock_attrs(cls) -> set[str]:
    from geomesa_tpu_torch.analysis.lockmodel import lock_ctor

    locks = set()
    for method in _class_methods(cls):
        for node in ast.walk(method):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                # direct ctor, or wrapped as witness(threading.RLock(), ...)
                if call_name(node.value) in LOCK_CTORS or (
                    lock_ctor(node.value) is not None
                ):
                    for t in node.targets:
                        attr = self_attr(t)
                        if attr is not None:
                            locks.add(attr)
    return locks


def _annotations(sf, cls) -> dict[str, tuple[str, int]]:
    """attr -> (lock, line) from trailing ``# guarded-by:`` comments on
    ``self.attr`` assignments anywhere in the class."""
    out: dict[str, tuple[str, int]] = {}
    for method in _class_methods(cls):
        for node in ast.walk(method):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                attr = self_attr(t)
                if attr is None:
                    continue
                m = _GUARDED_RE.search(sf.source_line(node.lineno))
                if m:
                    out[attr] = (m.group(1), node.lineno)
    return out


def _held_locks(sf, node, method, class_locks) -> set[str]:
    """Locks held at ``node``: enclosing ``with self.<lock>`` blocks,
    plus method-level holds-lock declarations and the *_locked naming
    convention (caller holds every class lock)."""
    held: set[str] = set()
    for p in sf.parents(node):
        if isinstance(p, ast.With):
            for item in p.items:
                attr = self_attr(item.context_expr)
                if attr is not None:
                    held.add(attr)
        if p is method:
            break
    if method.name.endswith("_locked"):
        held |= class_locks
    m = _HOLDS_RE.search(sf.source_line(method.lineno))
    if m:
        held.add(m.group(1))
    return held


def _mutation_targets(node):
    """(attr, is_container) mutations of self attributes in one
    statement/expression node."""
    def targets_of(t):
        attr = self_attr(t)
        if attr is not None:
            yield attr
        elif isinstance(t, ast.Subscript):
            attr = self_attr(t.value)
            if attr is not None:
                yield attr
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                yield from targets_of(e)

    if isinstance(node, ast.Assign):
        for t in node.targets:
            yield from targets_of(t)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        if not (isinstance(node, ast.AnnAssign) and node.value is None):
            yield from targets_of(node.target)
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            yield from targets_of(t)
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in MUTATORS:
            attr = self_attr(node.func.value)
            if attr is not None:
                yield attr


class LockDisciplineRule(Rule):
    id = "lock-guarded-mutation"
    description = (
        "attributes marked '# guarded-by: <lock>' (or inferred from "
        "consistent with-lock usage in serving/cache/ingest/metrics) may "
        "only be mutated while the lock is held"
    )
    fix_hint = (
        "wrap the mutation in 'with self.<lock>:', move it into a "
        "*_locked helper, or mark the method '# holds-lock: <lock>' if "
        "every caller already holds it"
    )

    def check(self, project: Project):
        for sf in project.python_files():
            if sf.tree is None:
                continue
            infer = sf.relpath.startswith(INFER_SCOPES)
            for cls in sf.nodes:
                if not isinstance(cls, ast.ClassDef):
                    continue
                locks = _lock_attrs(cls)
                annotated = _annotations(sf, cls)
                for attr, (lock, line) in annotated.items():
                    if locks and lock not in locks:
                        yield self.finding(
                            sf, line,
                            f"'# guarded-by: {lock}' on self.{attr} names "
                            f"no lock of {cls.name} (locks: "
                            f"{sorted(locks)})",
                            symbol=f"{cls.name}.{attr}:annotation",
                        )
                if not locks and not annotated:
                    continue
                # annotations stay ENFORCED even when the lock itself is
                # not declared in this class (inherited, or a dataclass
                # field): with-blocks name it, so held-ness still checks
                eff_locks = locks | {lk for lk, _ in annotated.values()}
                # site collection: attr -> [(line, held, method)]
                sites: dict[str, list] = {}
                for method in _class_methods(cls):
                    if method.name in CONSTRUCTORS:
                        continue
                    for node in ast.walk(method):
                        for attr in _mutation_targets(node):
                            if attr in eff_locks:
                                continue
                            held = _held_locks(sf, node, method, eff_locks)
                            sites.setdefault(attr, []).append(
                                (node.lineno, held, method.name)
                            )
                for attr, attr_sites in sorted(sites.items()):
                    required = annotated.get(attr, (None, 0))[0]
                    inferred = False
                    if required is None:
                        if not infer:
                            continue
                        locks_seen = {
                            lk for _, held, _ in attr_sites
                            for lk in held & locks
                        }
                        guarded = [
                            s for s in attr_sites if s[1] & locks
                        ]
                        if len(locks_seen) != 1 or not guarded:
                            continue  # unambiguous single-lock use only
                        required = next(iter(locks_seen))
                        inferred = True
                    for lineno, held, method_name in attr_sites:
                        if required in held:
                            continue
                        how = (
                            f"inferred from with-{required} usage"
                            if inferred else f"declared '# guarded-by: {required}'"
                        )
                        yield self.finding(
                            sf, lineno,
                            f"self.{attr} is mutated in {cls.name}."
                            f"{method_name}() without holding self."
                            f"{required} ({how})",
                            symbol=f"{cls.name}.{method_name}.{attr}",
                        )
