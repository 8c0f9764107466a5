"""geomesa-lint runner for the port: its static-analysis gate.

The port of the JAX package's scripts/check.py. Runs every rule of
geomesa_tpu_torch.analysis over geomesa_tpu_torch/ (its scripts
included) and geomesa_tpu_torch/docs/*.md, and fails loudly on new
findings, with the reference runner's exit convention:

    0 = clean (no findings beyond the suppression baseline)
    1 = findings (each printed as path:line: [rule-id] message + fix)
    2 = unusable input (bad arguments, unknown rule id, missing repo)

Usage (from the repo root; the runner imports neither torch nor the
analyzed code):
    python -m geomesa_tpu_torch.scripts.check                  # human output
    python -m geomesa_tpu_torch.scripts.check --json           # machine output
                                                   # (stable schema_version)
    python -m geomesa_tpu_torch.scripts.check --rules knob-undeclared,metric-convention
    python -m geomesa_tpu_torch.scripts.check --changed        # findings in files
                                                   # the git work tree touched
    python -m geomesa_tpu_torch.scripts.check --profile        # per-rule wall time
    python -m geomesa_tpu_torch.scripts.check --list-rules     # rule catalog
    python -m geomesa_tpu_torch.scripts.check --write-baseline # accept findings

tests/test_torch_analysis.py runs the same analysis in-process, which
makes a clean port a tier-1 invariant; this entry point exists for
humans, hooks, CI logs and chip_smoke.py's lint phase.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: machine-output contract version (--json): bump ONLY on breaking
#: shape changes so CI consumers can pin against it
SCHEMA_VERSION = 1


def _changed_paths(root: str) -> "set[str] | None":
    """Repo-relative paths the git working tree touched (staged,
    unstaged, and untracked) — the --changed scope. None when git is
    unavailable or ``root`` is not a work tree."""
    import subprocess

    try:
        proc = subprocess.run(
            # -z: NUL-separated RAW paths (no C-style quoting — quoted
            # output would make findings in non-ASCII/quoted filenames
            # silently miss the changed set, a false-clean gate)
            ["git", "-C", root, "status", "--porcelain", "-z",
             "--untracked-files=all"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    out: set[str] = set()
    fields = proc.stdout.split("\0")
    i = 0
    while i < len(fields):
        entry = fields[i]
        i += 1
        if len(entry) < 4:
            continue
        status, path = entry[:2], entry[3:]
        out.add(path.replace(os.sep, "/"))
        if status[0] in ("R", "C") and i < len(fields):
            # rename/copy records carry the ORIGINAL path as the next
            # NUL field; scope to the new name only
            i += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument(
        "--root", default=REPO,
        help="repo root to analyze (default: this checkout; exit-code "
        "tests point it at staged mini-repos)",
    )
    ap.add_argument(
        "--rules", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    ap.add_argument(
        "--baseline", default=None,
        help="suppression baseline path (default: the checked-in "
        "geomesa_tpu_torch/analysis/baseline.txt)",
    )
    ap.add_argument(
        "--write-baseline", action="store_true",
        help="write current findings into the baseline (adopt-time only; "
        "tier-1 requires the shipped baseline to stay empty)",
    )
    ap.add_argument(
        "--show-suppressed", action="store_true",
        help="also print baseline/inline-suppressed findings",
    )
    ap.add_argument(
        "--changed", action="store_true",
        help="report only findings in files the git working tree "
        "touched (fast pre-commit iteration; rules still analyze the "
        "whole repo — cross-file invariants need it)",
    )
    ap.add_argument(
        "--profile", action="store_true",
        help="print a per-rule wall-time table after the findings",
    )
    args = ap.parse_args()

    from geomesa_tpu_torch import analysis
    from geomesa_tpu_torch.analysis.core import default_baseline_path

    if args.list_rules:
        for rule in analysis.ALL_RULES:
            print(f"{rule.id:24s} {rule.description}")
        return 0

    rule_ids = None
    if args.rules:
        rule_ids = {r.strip() for r in args.rules.split(",") if r.strip()}
        known = {r.id for r in analysis.ALL_RULES}
        unknown = rule_ids - known
        if unknown:
            print(
                f"check: unknown rule id(s) {sorted(unknown)}; "
                f"known: {sorted(known)}",
                file=sys.stderr,
            )
            return 2

    baseline = args.baseline
    if (
        baseline is not None
        and not os.path.exists(baseline)
        and not args.write_baseline  # write mode creates the file
    ):
        print(f"check: baseline {baseline!r} does not exist", file=sys.stderr)
        return 2
    if not os.path.isdir(args.root):
        print(f"check: root {args.root!r} is not a directory", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    profile_rows = None
    try:
        if args.profile:
            # per-rule attribution: time each rule's check() over ONE
            # shared Project (registries/lock model memoize on it, so
            # the table charges each rule its marginal cost), then run
            # the normal suppression-filtered pass for the verdict
            from geomesa_tpu_torch.analysis.core import Project, run_rules

            project = Project.load(args.root)
            rules = [
                r for r in analysis.ALL_RULES
                if rule_ids is None or r.id in rule_ids
            ]
            profile_rows = []
            for rule in rules:
                r0 = time.perf_counter()
                raised = sum(1 for _ in rule.check(project))
                profile_rows.append(
                    (rule.id, time.perf_counter() - r0, raised)
                )
            result = run_rules(project, rules, baseline=baseline)
        else:
            result = analysis.run(
                args.root, rule_ids=rule_ids, baseline=baseline
            )
    except Exception as e:  # analyzer bug = unusable input, not "clean"
        print(f"check: analysis failed: {e!r}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0

    if args.changed:
        changed = _changed_paths(args.root)
        if changed is None:
            print(
                "check: --changed needs a git work tree at --root",
                file=sys.stderr,
            )
            return 2
        result.findings = [f for f in result.findings if f.path in changed]
        result.suppressed = [
            f for f in result.suppressed if f.path in changed
        ]

    if args.write_baseline:
        from geomesa_tpu_torch.analysis import load_baseline

        path = baseline or default_baseline_path(args.root)
        try:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            have = load_baseline(path)
            fresh = sorted(
                {f.key for f in result.findings} - have
            )
            with open(path, "a", encoding="utf-8") as fh:
                for key in fresh:
                    fh.write(key + "\n")
        except OSError as e:
            print(f"check: cannot write baseline {path!r}: {e}", file=sys.stderr)
            return 2
        print(f"check: appended {len(fresh)} new keys to {path}")
        return 0

    if args.json:
        payload = {
            "schema_version": SCHEMA_VERSION,
            "findings": [f.to_json() for f in result.findings],
            "suppressed": [f.to_json() for f in result.suppressed],
            "clean": result.clean,
            "changed_only": bool(args.changed),
            "seconds": round(dt, 3),
        }
        if profile_rows is not None:
            payload["profile"] = [
                {"rule": rid, "seconds": round(s, 4), "raised": n}
                for rid, s, n in profile_rows
            ]
        print(json.dumps(payload, indent=2))
    else:
        for f in result.findings:
            print(f.render())
        if args.show_suppressed:
            for f in result.suppressed:
                print(f"suppressed: {f.render()}")
        if profile_rows is not None:
            width = max(len(r) for r, _, _ in profile_rows)
            for rid, s, n in sorted(profile_rows, key=lambda r: -r[1]):
                print(f"  {rid:{width}s} {s * 1e3:8.1f} ms  {n} raised")
        n, s = len(result.findings), len(result.suppressed)
        scope = " (changed files only)" if args.changed else ""
        print(
            f"check: {n} finding(s), {s} suppressed, "
            f"{dt * 1e3:.0f} ms{scope}"
        )
    return 0 if result.clean else 1


if __name__ == "__main__":
    sys.exit(main())
