"""Knob-registry rule family: conf.py is the single source of truth.

The port of geomesa_tpu/analysis/rules/knobs.py. The ``geomesa.*``
system properties in the port's ``conf.py`` have three
failure modes this family kills (each has happened in review):

- a dotted name referenced in code/docstrings that no registry declares
  (a typo, or a knob someone removed while messages still cite it);
- a declared knob nothing reads (dead configuration — the operator sets
  it, nothing changes);
- a declared knob no doc mentions (undiscoverable configuration).

Docs are held to the same standard in reverse: every ``geomesa.*`` name
the port's documents (``geomesa_tpu_torch/docs/*.md``) cite must
resolve against the knob, metric or user-data registry — so renaming
a knob without its docs (or vice versa) fails the build.
"""

from __future__ import annotations

import ast

from geomesa_tpu_torch.analysis.core import Project, Rule, const_str
from geomesa_tpu_torch.analysis.registries import (
    USER_DATA_KEYS,
    Registries,
    extract_dotted,
)


def _tokens(text: str, tail_prefix: bool = False):
    """(name, wildcard) pairs from one string. ``tail_prefix``: the
    string is an f-string fragment, so a token the fragment ends with
    (followed by a ``.``) is a family prefix — ``f"geomesa.ingest.
    {stage}"`` names the geomesa.ingest.* family, not a literal."""
    for tok in extract_dotted(text):
        wildcard = tok.endswith(".*")
        name = tok[:-2] if wildcard else tok
        if tail_prefix and text.endswith(name + "."):
            wildcard = True
        yield name, wildcard


def _string_occurrences(sf):
    """(name, line, wildcard) for every geomesa.* dotted name inside the
    file's string constants — docstrings included (a stale knob citation
    in a docstring misleads exactly like one in an error message)."""
    if sf.tree is None:
        return
    for node in sf.nodes:
        s = const_str(node)
        if s is None and isinstance(node, ast.JoinedStr):
            # f-strings: scan the literal fragments (tail_prefix on —
            # a fragment ending at a substitution names a family)
            for v in node.values:
                frag = const_str(v)
                if frag:
                    for name, wc in _tokens(frag, tail_prefix=True):
                        yield name, node.lineno, wc
            continue
        if s is None or "geomesa." not in s:
            continue
        # fragment Constants inside an f-string were already handled by
        # the JoinedStr branch above — ast.walk visits them again here
        if isinstance(getattr(node, "_lint_parent", None), ast.JoinedStr):
            continue
        for name, wc in _tokens(s):
            yield name, node.lineno, wc


class KnobUndeclaredRule(Rule):
    id = "knob-undeclared"
    description = (
        "every geomesa.* dotted name in code or docstrings must resolve "
        "against the knob (conf.py), metric, or user-data registry"
    )
    fix_hint = (
        "declare the knob as a SystemProperty in conf.py, fix the typo, "
        "or drop the stale reference"
    )

    def check(self, project: Project):
        regs = Registries.of(project)
        for sf in project.python_files():
            for name, line, wildcard in _string_occurrences(sf):
                if not regs.resolves(name, wildcard=wildcard):
                    yield self.finding(
                        sf, line,
                        f"undeclared name {name!r}: not a conf.py knob, "
                        "not a metric instrument, not a registered "
                        "user-data key",
                        symbol=name,
                    )


class KnobUnreadRule(Rule):
    id = "knob-unread"
    description = (
        "every SystemProperty declared in conf.py must have at least one "
        "read site (its variable referenced outside conf.py)"
    )
    fix_hint = (
        "wire the knob into the code path it configures, or delete the "
        "declaration (dead configuration misleads operators)"
    )

    def check(self, project: Project):
        regs = Registries.of(project)
        if not regs.knobs.knobs:
            return
        used: set[str] = set()
        for sf in project.python_files():
            if sf.relpath == regs.knobs.path or sf.tree is None:
                continue
            for node in sf.nodes:
                if isinstance(node, ast.Name):
                    used.add(node.id)
                elif isinstance(node, ast.Attribute):
                    used.add(node.attr)
        for knob in regs.knobs.knobs.values():
            if knob.var and knob.var not in used:
                yield self.finding(
                    regs.knobs.path, knob.line,
                    f"knob {knob.name!r} ({knob.var}) is declared but "
                    "never read outside conf.py",
                    symbol=knob.name,
                )


class KnobUndocumentedRule(Rule):
    id = "knob-undocumented"
    description = (
        "every declared knob must be mentioned in at least one of the "
        "port's documents (geomesa_tpu_torch/docs/config.md is the "
        "reference table)"
    )
    fix_hint = (
        "add the knob to geomesa_tpu_torch/docs/config.md (name, "
        "default, effect)"
    )

    def check(self, project: Project):
        regs = Registries.of(project)
        doc_text = "\n".join(d.text for d in project.docs.values())
        for knob in regs.knobs.knobs.values():
            if knob.name not in doc_text:
                yield self.finding(
                    regs.knobs.path, knob.line,
                    f"knob {knob.name!r} appears in no "
                    "geomesa_tpu_torch/docs/*.md",
                    symbol=knob.name,
                )


class UserDataUnusedRule(Rule):
    id = "userdata-unused"
    description = (
        "every registered schema user-data key must have a use site in "
        "geomesa_tpu_torch/ (the registry must not outlive the feature)"
    )
    fix_hint = (
        "remove the dead entry from analysis/registries.py USER_DATA_KEYS, "
        "or restore the code that reads the key"
    )

    def check(self, project: Project):
        regs_path = "geomesa_tpu_torch/analysis/registries.py"
        if regs_path not in project.files:
            return  # staged mini-repos without the registry are exempt
        seen: set[str] = set()
        for sf in project.python_files("geomesa_tpu_torch/"):
            if sf.relpath == regs_path:
                continue
            if sf.tree is None:
                continue
            for key in USER_DATA_KEYS:
                if key in sf.text:
                    seen.add(key)
        for key in USER_DATA_KEYS:
            if key not in seen:
                yield self.finding(
                    regs_path, 1,
                    f"user-data key {key!r} is registered but never used",
                    symbol=key,
                )


class DocUnknownNameRule(Rule):
    id = "doc-unknown-name"
    description = (
        "every geomesa.* dotted name cited in the port's documents "
        "must resolve "
        "against the knob, metric, or user-data registry"
    )
    fix_hint = (
        "fix the doc to cite the real name, or (re)introduce the knob/"
        "metric the doc promises"
    )

    def check(self, project: Project):
        from geomesa_tpu_torch.analysis.registries import doc_names

        regs = Registries.of(project)
        for dn in doc_names(project):
            if not regs.resolves(dn.name, wildcard=dn.wildcard):
                yield self.finding(
                    dn.path, dn.line,
                    f"doc cites unknown name {dn.name!r}",
                    symbol=dn.name,
                )
