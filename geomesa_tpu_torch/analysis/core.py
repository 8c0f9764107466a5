"""Lint framework core: Rule SPI, AST cache, findings, suppressions.

Deliberately stdlib-only (ast / tokenize / re / os): the analyzer must
stay importable and fast in any environment — CI, a laptop without the
accelerator toolchain, a pre-commit hook — so a full-repo run fits the
< 10 s budget with room to spare.

The moving parts:

- :class:`SourceFile` — one parsed file: source text, AST (parsed once,
  shared by every rule via :class:`Project`'s cache), parent links,
  comment map and inline ``lint: ignore[rule-id]`` suppressions;
- :class:`Project` — the file set one analysis run covers
  (``geomesa_tpu_torch/**.py``, the port's scripts included, +
  ``geomesa_tpu_torch/docs/*.md``; tests and fixtures are out of scope
  on purpose — they exercise bad patterns);
- :class:`Rule` — the SPI: subclass, set ``id``/``description``/
  ``fix_hint``, implement ``check(project) -> Iterable[Finding]``;
- :class:`Finding` — path:line + rule id + message + fix hint + a
  line-number-free ``key`` so baseline entries survive unrelated edits;
- the suppression baseline — a checked-in text file of finding keys;
  ``run_rules`` drops findings whose key is baselined (shipped EMPTY:
  every real violation in this tree is fixed, the baseline exists for
  future adopters mid-cleanup).
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

# inline suppression: `# lint: ignore[rule-id]` (comma-separated ids) on
# the flagged line silences that rule there; `ignore[*]` silences all
_IGNORE_RE = re.compile(r"#\s*lint:\s*ignore\[([\w*,\s-]+)\]")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule_id: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    fix_hint: str = ""
    # stable identity for baselines: rule + path + a rule-chosen symbol
    # (offending name, enclosing def, ...) — NOT the line number, which
    # drifts under unrelated edits
    symbol: str = ""

    @property
    def key(self) -> str:
        return f"{self.rule_id}::{self.path}::{self.symbol or self.line}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        hint = f"\n    fix: {self.fix_hint}" if self.fix_hint else ""
        return f"{loc}: [{self.rule_id}] {self.message}{hint}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule_id,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "fix_hint": self.fix_hint,
            "key": self.key,
        }


class SourceFile:
    """One analyzed Python file: text, AST (cached), parent links,
    per-line suppressions. Rules never re-parse; they share this."""

    def __init__(self, root: str, relpath: str, text: "str | None" = None):
        self.relpath = relpath
        self.abspath = os.path.join(root, relpath)
        if text is None:
            with open(self.abspath, encoding="utf-8") as fh:
                text = fh.read()
        self.text = text
        self.lines = self.text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[str] = None
        # initialized BEFORE the parse attempt: suppressed() must stay
        # callable (returning False) on files that fail to parse
        self.ignores: dict[int, set[str]] = {}
        #: every node in ``ast.walk`` order, collected once by the
        #: parent-link pass: rules iterate this list instead of walking
        #: the whole tree again, one walk a rule
        self.nodes: list[ast.AST] = []
        try:
            self.tree = ast.parse(self.text, filename=relpath)
        except SyntaxError as e:  # surfaced as its own finding
            self.parse_error = f"{e.msg} (line {e.lineno})"
            return
        # parent links let rules walk outward (enclosing With / def)
        for parent in ast.walk(self.tree):
            self.nodes.append(parent)
            for child in ast.iter_child_nodes(parent):
                child._lint_parent = parent  # type: ignore[attr-defined]
        # rule-id suppressions by line
        for i, line in enumerate(self.lines, start=1):
            m = _IGNORE_RE.search(line)
            if m:
                ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
                self.ignores[i] = ids

    # -- helpers rules lean on -------------------------------------------
    def line_of(self, node: ast.AST) -> int:
        return getattr(node, "lineno", 1)

    def source_line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def parents(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = getattr(node, "_lint_parent", None)
        while cur is not None:
            yield cur
            cur = getattr(cur, "_lint_parent", None)

    def enclosing_function(self, node: ast.AST):
        for p in self.parents(node):
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return p
        return None

    def enclosing_class(self, node: ast.AST):
        for p in self.parents(node):
            if isinstance(p, ast.ClassDef):
                return p
        return None

    def suppressed(self, rule_id: str, lineno: int) -> bool:
        ids = self.ignores.get(lineno)
        return ids is not None and (rule_id in ids or "*" in ids)


class DocFile:
    """One markdown file (geomesa_tpu_torch/docs/*.md): raw text only."""

    def __init__(self, root: str, relpath: str):
        self.relpath = relpath
        with open(os.path.join(root, relpath), encoding="utf-8") as fh:
            self.text = fh.read()


class Project:
    """The file set of one analysis run, with the shared AST cache."""

    #: scanned python trees (repo-relative); tests/ and examples/ are
    #: deliberately out of scope — they stage bad patterns on purpose.
    #: The port's scripts live in geomesa_tpu_torch/scripts/, inside it.
    PY_ROOTS = ("geomesa_tpu_torch",)
    #: the port's own documents; the repo's docs/ describe the JAX
    #: package (and cite its TPU-only knobs)
    DOC_ROOT = "geomesa_tpu_torch/docs"
    #: test tree loaded as RAW TEXT only (never linted): coverage-style
    #: rules (fault-point-unknown) check that names the production tree
    #: declares are actually exercised by some test. Only the port's
    #: test files count: a point the JAX package's tests arm is not run
    #: through the port.
    TEST_ROOT = "tests"
    TEST_FILES = "test_torch_*.py"

    def __init__(self, root: str):
        self.root = root
        self.files: dict[str, SourceFile] = {}
        self.docs: dict[str, DocFile] = {}
        self.tests: dict[str, str] = {}  # relpath -> raw text

    @classmethod
    def load(cls, root: str) -> "Project":
        p = cls(root)
        for top in cls.PY_ROOTS:
            base = os.path.join(root, top)
            if not os.path.isdir(base):
                continue
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        rel = os.path.relpath(
                            os.path.join(dirpath, fn), root
                        ).replace(os.sep, "/")
                        p.files[rel] = SourceFile(root, rel)
        docdir = os.path.join(root, cls.DOC_ROOT)
        if os.path.isdir(docdir):
            for fn in sorted(os.listdir(docdir)):
                if fn.endswith(".md"):
                    rel = f"{cls.DOC_ROOT}/{fn}"
                    p.docs[rel] = DocFile(root, rel)
        testdir = os.path.join(root, cls.TEST_ROOT)
        if os.path.isdir(testdir):
            for dirpath, dirnames, filenames in os.walk(testdir):
                # fixtures stage rule inputs that never RUN: a fault
                # point named only in a fixture must not count as
                # test-exercised (the vacuous-coverage hole the
                # fault-point-unknown rule exists to close)
                dirnames[:] = [
                    d for d in dirnames
                    if d not in ("__pycache__", "fixtures")
                ]
                for fn in sorted(filenames):
                    if fnmatch.fnmatch(fn, cls.TEST_FILES):
                        rel = os.path.relpath(
                            os.path.join(dirpath, fn), root
                        ).replace(os.sep, "/")
                        try:
                            with open(
                                os.path.join(root, rel), encoding="utf-8"
                            ) as fh:
                                p.tests[rel] = fh.read()
                        except OSError:
                            continue
        return p

    def add_file(self, relpath: str, text: "str | None" = None) -> SourceFile:
        """Register one extra file into the cache. ``text`` stages
        content under a synthetic relpath (rule fixtures analyzed as if
        they lived in a scoped tree, e.g. geomesa_tpu_torch/scan/) without a
        file existing there; None reads ``relpath`` from disk."""
        sf = SourceFile(self.root, relpath, text=text)
        self.files[relpath.replace(os.sep, "/")] = sf
        return sf

    def python_files(self, under: str | None = None) -> list[SourceFile]:
        out = [
            sf for rel, sf in sorted(self.files.items())
            if under is None or rel.startswith(under)
        ]
        return out


class Rule:
    """SPI: one named invariant. Subclasses set the class attributes and
    implement :meth:`check`; ``run_rules`` handles suppression filtering
    and ordering. Keep rules pure functions of the Project — no file
    writes, no imports of the analyzed code (AST only)."""

    id: str = ""
    description: str = ""
    fix_hint: str = ""

    def check(self, project: Project) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(
        self, sf_or_path, line: int, message: str,
        symbol: str = "", fix_hint: str | None = None,
    ) -> Finding:
        path = (
            sf_or_path.relpath
            if isinstance(sf_or_path, (SourceFile, DocFile))
            else sf_or_path
        )
        return Finding(
            rule_id=self.id,
            path=path,
            line=line,
            message=message,
            fix_hint=self.fix_hint if fix_hint is None else fix_hint,
            symbol=symbol,
        )


@dataclass
class RunResult:
    findings: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings


def load_baseline(path: str | None) -> set[str]:
    """Baseline file -> set of finding keys. Lines are ``Finding.key``
    strings; blank lines and ``#`` comments are ignored."""
    if path is None or not os.path.exists(path):
        return set()
    keys = set()
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                keys.add(line)
    return keys


def default_baseline_path(root: str) -> str:
    return os.path.join(
        root, "geomesa_tpu_torch", "analysis", "baseline.txt"
    )


def run_rules(
    project: Project,
    rules: Iterable[Rule],
    baseline: "set[str] | str | None" = None,
) -> RunResult:
    """Run every rule over the project; returns findings split into
    (new, suppressed). ``baseline`` is a key set, a path, or None (the
    checked-in default)."""
    if baseline is None:
        baseline = default_baseline_path(project.root)
    if isinstance(baseline, str):
        baseline = load_baseline(baseline)

    result = RunResult()
    # a file that does not parse fails loudly before any rule runs —
    # but still through the baseline filter, so the documented
    # --write-baseline -> rerun-exits-0 adoption loop converges even
    # on trees carrying broken files
    parse_broken = False
    for sf in project.python_files():
        if sf.parse_error is not None:
            parse_broken = True
            f = Finding(
                rule_id="parse-error", path=sf.relpath, line=1,
                message=f"file does not parse: {sf.parse_error}",
                symbol="module",
            )
            (result.suppressed if f.key in baseline
             else result.findings).append(f)
    if parse_broken:
        return result

    for rule in rules:
        for f in rule.check(project):
            sf = project.files.get(f.path)
            if sf is not None and sf.suppressed(f.rule_id, f.line):
                result.suppressed.append(f)
            elif f.key in baseline:
                result.suppressed.append(f)
            else:
                result.findings.append(f)
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    result.suppressed.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return result


# -- small AST utilities shared by the rule modules -----------------------


def call_name(node: ast.Call) -> str:
    """Trailing name of a call target: ``bk.fused_e_bucket(...)`` ->
    ``fused_e_bucket``; ``SystemProperty(...)`` -> ``SystemProperty``."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def names_in(node: ast.AST) -> set[str]:
    """Every bare Name and attribute-trailing name in a subtree."""
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def self_attr(node: ast.AST) -> Optional[str]:
    """``self.x`` -> ``x``; anything else -> None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None
