"""geomesa-race: the concurrency rule family over the lock model.

The port of geomesa_tpu/analysis/rules/concurrency.py. Four rules over
:mod:`geomesa_tpu_torch.analysis.lockmodel` — the defect classes the
JAX package's hard concurrency bugs fell into, each replayed as a
must-fail fixture under ``tests/fixtures/analysis/``:

- **lock-order-cycle** — the static acquisition graph (lock B acquired
  in a scope that statically holds lock A, plus the registry's declared
  callback edges) must be acyclic AND respect the declared rank order;
  the registry itself is checked both directions (every discovered lock
  in the concurrent tiers registered, every entry backed by a real
  construction site, guarded-field lists agreeing with the
  ``# guarded-by:`` annotations, witness names matching);
- **atomicity-check-then-act** — a guarded field read under its lock in
  one scope must not feed a write-back to the same field in a LATER
  scope of the same function unless that scope re-reads the field (the
  ``_take_staged`` write-back and ``needs_recovery`` bug shape: state
  checked, lock dropped, stale conclusion acted on);
- **blocking-under-lock** — scopes holding a registry lock marked
  ``hot`` must not fsync, sleep, wait on futures/events, fire fault
  points (latency-injectable IO markers) or dispatch torch work (the
  reader-stall class; the reference's rule names jax dispatch, the
  port's device work goes through torch);
- **guarded-escape** — a ``# guarded-by:`` CONTAINER must not escape
  its lock wholesale (returned bare, or stored into an unguarded
  attribute) without a copy; scalars and immutables are exempt, and
  the swap-and-drain idiom (``out, self._f = self._f, {}`` into a
  local) stays legal.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from geomesa_tpu_torch.analysis import lockmodel
from geomesa_tpu_torch.analysis.core import Finding, Project, Rule, self_attr
from geomesa_tpu_torch.analysis.lockmodel import (
    DECLARED_EDGES,
    ENFORCED_SCOPES,
    LOCKS,
    LockModel,
    annotated_guards,
    registry_line,
)

#: trailing call names that can block (or inject latency/IO) — illegal
#: while a hot lock is held. ``wait`` on the HELD lock itself is exempt
#: (Condition.wait releases it); ``os.write`` is deliberately absent
#: (buffered appends are the WAL's design; fsync is the stall).
BLOCKING_CALLS = {
    "fsync": "fsync",
    "sleep": "sleep",
    "result": "Future.result",
    "wait": "wait",
    "acquire": "blocking acquire",
    "admission_gap": "scheduler admission_gap",
    "fault_point": "fault_point (latency/IO-injectable)",
}

#: construction values that mark an annotated field as a MUTABLE
#: container (the guarded-escape rule's scope; scalars/immutables are
#: exempt — escaping an int is a copy by nature)
_CONTAINER_CTORS = {
    "dict", "list", "set", "OrderedDict", "defaultdict", "deque",
    "bytearray", "Counter",
}

#: copy-shaped wrappers that legitimize an escape
_COPY_CALLS = {
    "list", "dict", "set", "tuple", "sorted", "frozenset", "copy",
    "deepcopy", "bytes",
}


def _enforced(path: str) -> bool:
    return path.startswith(ENFORCED_SCOPES)


class LockOrderRule(Rule):
    id = "lock-order-cycle"
    description = (
        "the static lock-acquisition graph (incl. declared callback "
        "edges) must be acyclic and respect the LOCKS registry's rank "
        "order; every concurrent-tier lock must be registered with a "
        "rank, and registry entries must match the code"
    )
    fix_hint = (
        "register the lock (with a rank slotting into the order) in "
        "analysis/lockmodel.py LOCKS, or restructure so the inner "
        "acquisition moves outside the outer lock's scope"
    )

    def check(self, project: Project) -> Iterable[Finding]:
        model = LockModel.of(project)
        has_registry = lockmodel.MODEL_PATH in project.files

        # 1) discovery vs registry, both directions (the fault-point move)
        for name in sorted(model.sites):
            site = model.sites[name]
            if not _enforced(site.path):
                continue
            if has_registry and name not in LOCKS:
                yield self.finding(
                    site.path, site.line,
                    f"lock {name} has no LOCKS registry entry (no "
                    "declared rank): the order checker cannot place it",
                    symbol=f"unregistered:{name}",
                )
            elif name in LOCKS and site.witness_name is None:
                yield self.finding(
                    site.path, site.line,
                    f"registered lock {name} is constructed without the "
                    "lockwitness wrapper — the dynamic tier cannot "
                    "observe it",
                    symbol=f"unwitnessed:{name}",
                    fix_hint=(
                        "construct it as witness(threading.<ctor>(), "
                        f"\"{name}\")"
                    ),
                )
            elif site.witness_name is not None and site.witness_name != name:
                yield self.finding(
                    site.path, site.line,
                    f"lock {name} is witnessed under the wrong name "
                    f"{site.witness_name!r} — runtime edges would not "
                    "match the static model",
                    symbol=f"witness-name:{name}",
                )
        if has_registry:
            for name in sorted(LOCKS):
                if name not in model.sites:
                    yield self.finding(
                        lockmodel.MODEL_PATH, registry_line(project, name),
                        f"LOCKS entry {name} has no construction site in "
                        "the tree (renamed or removed lock)",
                        symbol=f"stale-entry:{name}",
                    )
            # guarded-field lists vs `# guarded-by:` annotations
            guards = annotated_guards(model)
            for name in sorted(LOCKS):
                decl = LOCKS[name]
                code_fields = guards.get(name, set())
                for f in sorted(set(decl.fields) - code_fields):
                    yield self.finding(
                        lockmodel.MODEL_PATH, registry_line(project, name),
                        f"LOCKS entry {name} declares guarded field "
                        f"{f!r} but no '# guarded-by:' annotation in the "
                        "code names it",
                        symbol=f"field-drift:{name}.{f}",
                    )
                for f in sorted(code_fields - set(decl.fields)):
                    site = model.sites.get(name)
                    yield self.finding(
                        lockmodel.MODEL_PATH, registry_line(project, name),
                        f"field {f!r} is annotated '# guarded-by:' under "
                        f"{name} but the LOCKS entry does not list it",
                        symbol=f"field-missing:{name}.{f}",
                    )

        # 2) rank order on every edge (AST-derived and declared alike)
        for edge in sorted(
            model.edges, key=lambda e: (e.path, e.line, e.src, e.dst)
        ):
            yield from self._check_edge(
                model, edge.src, edge.dst, edge.path, edge.line,
                f" (via {edge.via})" if edge.via else "",
            )
        if has_registry:
            for a, b, why in DECLARED_EDGES:
                yield from self._check_edge(
                    model, a, b, lockmodel.MODEL_PATH,
                    registry_line(project, a), f" (declared: {why})",
                )

        # 3) cycles in the predicted graph
        for cyc in model.cycles():
            anchor = model.sites.get(cyc[0])
            path = anchor.path if anchor is not None else lockmodel.MODEL_PATH
            line = anchor.line if anchor is not None else 1
            yield self.finding(
                path, line,
                "lock-order cycle: " + " -> ".join(cyc)
                + " — two threads taking these in opposite order deadlock",
                symbol="cycle:" + "|".join(sorted(set(cyc))),
            )

        # 4) re-entrant acquisition of a non-reentrant Lock
        for cname in sorted(model.classes):
            info = model.classes[cname]
            for mname in sorted(info.methods):
                method = info.methods[mname]
                yield from self._check_reentry(model, info, method)

    def _check_edge(self, model, src, dst, path, line, via):
        if src == dst:
            return
        ra, rb = model.rank_of(src), model.rank_of(dst)
        if ra is None or rb is None:
            return  # unranked locks are reported by the registry check
        if ra >= rb:
            yield self.finding(
                path, line,
                f"{dst} (rank {rb}) acquired while holding {src} "
                f"(rank {ra}){via}: violates the declared order — "
                "rank must strictly increase inward",
                symbol=f"rank:{src}->{dst}",
            )

    def _check_reentry(self, model, info, method):
        """`with self.L:` nested under itself when L is a plain Lock —
        a guaranteed self-deadlock."""
        findings: list[Finding] = []

        def on_with(stmt, held, acquired, reacquired):
            for name in sorted(reacquired):
                attr = name.split(".", 1)[1]
                if info.locks[attr].kind == "lock":
                    findings.append(self.finding(
                        info.sf.relpath, stmt.lineno,
                        f"{name} is a non-reentrant Lock acquired "
                        f"while already held in {info.name}."
                        f"{method.name}(): self-deadlock",
                        symbol=f"reentry:{name}.{method.name}",
                    ))

        lockmodel.walk_held(
            method.body, lockmodel._lock_resolver(info), on_with=on_with,
        )
        return findings


def _lock_scopes(info, method) -> list[tuple[str, ast.With]]:
    """Maximal (lock name, With node) scopes of a method, in statement
    order — nested re-acquisitions of the same lock are folded into the
    outer scope; DISTINCT scopes of the same lock are the rule's unit."""
    out: list[tuple[str, ast.With]] = []

    def on_with(stmt, held, acquired, reacquired):
        for name in sorted(acquired):
            out.append((name, stmt))

    lockmodel.walk_held(
        method.body, lockmodel._lock_resolver(info), on_with=on_with,
    )
    return out


_MUTATOR_NAMES = {
    "append", "extend", "insert", "remove", "pop", "popitem", "popleft",
    "clear", "update", "setdefault", "add", "discard", "appendleft",
    "move_to_end", "sort", "reverse",
}


def _scope_accesses(scope: ast.With):
    """(reads, mutations) of ``self.<attr>`` inside one lock scope.
    Reads exclude attribute accesses that only RECEIVE a mutating method
    call or appear as a store target — ``self.f.pop(k)`` is a mutation,
    not a re-read; ``self.f = x`` is a write."""
    reads: set[str] = set()
    mutations: set[str] = set()
    mutator_receivers: set[int] = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATOR_NAMES:
                attr = self_attr(node.func.value)
                if attr is not None:
                    mutations.add(attr)
                    mutator_receivers.add(id(node.func.value))
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                attr = self_attr(t)
                if attr is None and isinstance(t, ast.Subscript):
                    attr = self_attr(t.value)
                    if attr is not None:
                        # subscript store reads the container first
                        reads.add(attr)
                if attr is not None:
                    mutations.add(attr)
            if isinstance(node, ast.AugAssign):
                attr = self_attr(node.target)
                if attr is not None:
                    reads.add(attr)  # += reads before writing
        if isinstance(node, ast.Delete):
            for t in node.targets:
                attr = self_attr(t)
                if attr is None and isinstance(t, ast.Subscript):
                    attr = self_attr(t.value)
                    if attr is not None:
                        reads.add(attr)
                if attr is not None:
                    mutations.add(attr)
    for node in ast.walk(scope):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.ctx, ast.Load)
            and self_attr(node) is not None
            and id(node) not in mutator_receivers
        ):
            reads.add(node.attr)
    return reads, mutations


def _scope_local_taint(scope: ast.With, fields: set[str]) -> set[str]:
    """Local names a scope assigns from expressions reading any of
    ``fields`` — the values whose staleness the rule tracks."""
    tainted: set[str] = set()
    for node in ast.walk(scope):
        if not isinstance(node, ast.Assign):
            continue
        src_reads = {
            n.attr for n in ast.walk(node.value)
            if isinstance(n, ast.Attribute) and self_attr(n) is not None
        }
        if not (src_reads & fields):
            continue
        for t in node.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                    tainted.add(n.id)
    return tainted


def _propagate_taint(method, tainted: set[str]) -> set[str]:
    """Fixpoint one-function taint propagation: assignment targets,
    for-loop targets and mutated accumulators become tainted when fed
    by a tainted name."""
    tainted = set(tainted)
    for _ in range(len(tainted) + 16):
        added = False
        for node in ast.walk(method):
            names_in_value: set[str] = set()
            targets: list = []
            if isinstance(node, ast.Assign):
                names_in_value = {
                    n.id for n in ast.walk(node.value)
                    if isinstance(n, ast.Name)
                }
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                names_in_value = {
                    n.id for n in ast.walk(node.value)
                    if isinstance(n, ast.Name)
                }
                targets = [node.target]
            elif isinstance(node, ast.For):
                names_in_value = {
                    n.id for n in ast.walk(node.iter)
                    if isinstance(n, ast.Name)
                }
                targets = [node.target]
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATOR_NAMES
                and isinstance(node.func.value, ast.Name)
            ):
                arg_names = {
                    n.id
                    for a in list(node.args) + [k.value for k in node.keywords]
                    for n in ast.walk(a)
                    if isinstance(n, ast.Name)
                }
                if arg_names & tainted and node.func.value.id not in tainted:
                    tainted.add(node.func.value.id)
                    added = True
                continue
            if names_in_value & tainted:
                for t in targets:
                    for n in ast.walk(t):
                        if (
                            isinstance(n, ast.Name)
                            and isinstance(n.ctx, ast.Store)
                            and n.id not in tainted
                        ):
                            tainted.add(n.id)
                            added = True
        if not added:
            break
    return tainted


class CheckThenActRule(Rule):
    id = "atomicity-check-then-act"
    description = (
        "a guarded field read under its lock must not feed a write-back "
        "to the same field in a later lock scope of the same function "
        "unless that scope re-reads the field (stale-conclusion races: "
        "the _take_staged write-back / needs_recovery shape)"
    )
    fix_hint = (
        "merge the check and the act into ONE lock hold, or make the "
        "acting scope re-validate against the field's CURRENT value "
        "(identity/membership check) before writing back"
    )

    def check(self, project: Project) -> Iterable[Finding]:
        model = LockModel.of(project)
        for cname in sorted(model.classes):
            info = model.classes[cname]
            guarded_by_lock: dict[str, set[str]] = {}
            for fieldname, (lock, _line) in info.guarded.items():
                guarded_by_lock.setdefault(lock, set()).add(fieldname)
            if not guarded_by_lock:
                continue
            for mname in sorted(info.methods):
                if mname in ("__init__", "__post_init__", "__new__"):
                    continue
                method = info.methods[mname]
                scopes = _lock_scopes(info, method)
                for i, (lname_i, scope_i) in enumerate(scopes):
                    lock_attr = lname_i.split(".", 1)[1]
                    fields = guarded_by_lock.get(lock_attr, set())
                    if not fields:
                        continue
                    reads_i, _m = _scope_accesses(scope_i)
                    read_fields = reads_i & fields
                    if not read_fields:
                        continue
                    taint0 = _scope_local_taint(scope_i, read_fields)
                    if not taint0:
                        continue
                    tainted = _propagate_taint(method, taint0)
                    for lname_j, scope_j in scopes[i + 1:]:
                        if lname_j != lname_i or scope_j is scope_i:
                            continue
                        reads_j, mut_j = _scope_accesses(scope_j)
                        scope_names = {
                            n.id for n in ast.walk(scope_j)
                            if isinstance(n, ast.Name)
                        }
                        for f in sorted((mut_j & read_fields) - reads_j):
                            if not (scope_names & tainted):
                                continue
                            yield self.finding(
                                info.sf.relpath, scope_j.lineno,
                                f"self.{f} is written back in a later "
                                f"{lname_i} scope of {cname}.{mname}() "
                                "from state read in an earlier scope, "
                                "without re-reading the field — a "
                                "concurrent mutation between the scopes "
                                "is silently overwritten",
                                symbol=f"{cname}.{mname}.{f}",
                            )


class BlockingUnderLockRule(Rule):
    id = "blocking-under-lock"
    description = (
        "scopes holding a hot-path lock (LOCKS hot=True, or an inline "
        "'# lock-rank: N hot') must not fsync, sleep, wait on futures/"
        "events, fire fault points, or dispatch torch work"
    )
    fix_hint = (
        "capture state under the lock, release it, then do the blocking "
        "work (the WAL sync/rotate discipline); or demote the lock from "
        "hot if stalls under it are genuinely acceptable"
    )

    def check(self, project: Project) -> Iterable[Finding]:
        model = LockModel.of(project)
        for cname in sorted(model.classes):
            info = model.classes[cname]
            hot_attrs = {
                attr for attr in info.locks
                if model.is_hot(info.lock_name(attr))
            }
            if not hot_attrs:
                continue
            for mname in sorted(info.methods):
                method = info.methods[mname]
                findings: list = []

                def resolve(expr, hot_attrs=hot_attrs):
                    attr = self_attr(expr)
                    return attr if attr in hot_attrs else None

                def on_stmt(stmt, held, info=info, cname=cname,
                            mname=mname, findings=findings):
                    if held:
                        findings.extend(self._scan_block(
                            info, cname, mname, [stmt], held
                        ))
                        return True  # scanned the whole subtree already
                    return False

                # *_locked / holds-lock bodies of a hot lock run held
                held0 = frozenset(
                    a for a in self._declared_held(info, method)
                    if a in hot_attrs
                )
                lockmodel.walk_held(
                    method.body, resolve, on_stmt=on_stmt, held=held0,
                )
                yield from findings

    @staticmethod
    def _declared_held(info, method) -> set[str]:
        held = set(lockmodel.holds_lock_decls(info.sf, method))
        if held:
            return held
        if method.name.endswith("_locked") and len(info.locks) == 1:
            return set(info.locks)
        return set()

    def _scan_block(self, info, cname, mname, stmts, held):
        for stmt in stmts:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                hit = self._blocking_kind(node, held)
                if hit is None:
                    continue
                locks = ", ".join(
                    sorted(info.lock_name(a) for a in held)
                )
                yield self.finding(
                    info.sf.relpath, node.lineno,
                    f"{hit} call while holding hot lock {locks} in "
                    f"{cname}.{mname}(): every thread crossing the lock "
                    "stalls behind it",
                    symbol=f"{cname}.{mname}:{hit.split(' ')[0]}",
                )

    @staticmethod
    def _blocking_kind(node: ast.Call, held) -> Optional[str]:
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else ""
        )
        if name in BLOCKING_CALLS:
            # Condition.wait/notify on the HELD lock itself is the
            # condition-variable protocol (wait releases the lock)
            if name == "wait" and isinstance(f, ast.Attribute):
                attr = self_attr(f.value)
                if attr is not None and attr in held:
                    return None
            return BLOCKING_CALLS[name]
        # device dispatch: any call rooted at the torch namespace (the
        # reference's jax / jnp root)
        root = f
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and root.id == "torch":
            return "torch dispatch"
        return None


class GuardedEscapeRule(Rule):
    id = "guarded-escape"
    description = (
        "a '# guarded-by:' container must not escape its lock wholesale "
        "— returned bare or stored into an unguarded attribute — without "
        "a copy (aliasing lets callers mutate/iterate it unlocked)"
    )
    fix_hint = (
        "return a copy (list(...)/dict(...)), or swap-and-drain into a "
        "local under the lock and return the local"
    )

    def check(self, project: Project) -> Iterable[Finding]:
        model = LockModel.of(project)
        for cname in sorted(model.classes):
            info = model.classes[cname]
            containers = self._container_fields(info)
            if not containers:
                continue
            guarded_fields = set(info.guarded)
            for mname in sorted(info.methods):
                if mname in ("__init__", "__post_init__", "__new__"):
                    continue
                method = info.methods[mname]
                for node in ast.walk(method):
                    if isinstance(node, ast.Return) and node.value is not None:
                        attr = self_attr(node.value)
                        if attr in containers:
                            yield self.finding(
                                info.sf.relpath, node.lineno,
                                f"guarded container self.{attr} returned "
                                f"bare from {cname}.{mname}(): callers "
                                "alias it outside "
                                f"self.{info.guarded[attr][0]}",
                                symbol=f"{cname}.{mname}.{attr}:return",
                            )
                    elif isinstance(node, ast.Assign):
                        src = self_attr(node.value)
                        if src not in containers:
                            continue
                        for t in node.targets:
                            dst = self_attr(t)
                            if dst is None or dst in guarded_fields:
                                continue
                            yield self.finding(
                                info.sf.relpath, node.lineno,
                                f"guarded container self.{src} stored "
                                f"into unguarded self.{dst} in "
                                f"{cname}.{mname}(): the alias escapes "
                                f"self.{info.guarded[src][0]}",
                                symbol=f"{cname}.{mname}.{src}:store",
                            )

    @staticmethod
    def _container_fields(info) -> set[str]:
        """Guarded fields whose initializing assignment builds a mutable
        container (scalars/immutables are exempt by construction)."""
        out: set[str] = set()
        for fieldname, (_lock, line) in info.guarded.items():
            found = None
            for node in ast.walk(info.node):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                if node.lineno != line:
                    continue
                found = node.value
                break
            if found is None:
                continue
            if isinstance(found, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                                  ast.DictComp, ast.SetComp)):
                out.add(fieldname)
            elif isinstance(found, ast.Call):
                from geomesa_tpu_torch.analysis.core import call_name

                if call_name(found) in _CONTAINER_CTORS:
                    out.add(fieldname)
        return out
