"""Command line: ``python -m repro_torch.lint [--root DIR] [--check SLUG ...]
[--format text|github|json]``.

Exit status 0 when clean, 1 when any violation is found (2 on usage
errors, via argparse). Purely static — runs without torch installed.

Formats: ``text`` (the default ``path:line: [check] message``), ``github``
(workflow commands — ``::error file=...,line=...::...`` — so CI violations
annotate the offending PR lines), ``json`` (one object per violation, for
tooling).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from . import CHECKERS, lint_project
from .project import Project, Violation


def _render_github(v: Violation) -> str:
    # workflow commands eat raw newlines/%%; escape per the Actions spec
    msg = (v.message.replace("%", "%25").replace("\r", "%0D")
           .replace("\n", "%0A"))
    return (f"::error file={v.path},line={v.line},"
            f"title=repro_torch.lint [{v.check}]::{msg}")


def _render_json(violations: List[Violation]) -> str:
    return json.dumps(
        [{"path": v.path, "line": v.line, "check": v.check,
          "message": v.message} for v in violations],
        indent=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="the port's static analysis: hour purity, "
                    "engine-key completeness, pytree contracts, tap "
                    "registry, units of measure, bounds invariants")
    ap.add_argument("--root", default=None,
                    help="repo root to lint (default: this checkout)")
    ap.add_argument("--check", action="append", choices=sorted(CHECKERS),
                    metavar="SLUG", dest="checks",
                    help="run only this checker (repeatable); default: all")
    ap.add_argument("--format", choices=("text", "github", "json"),
                    default="text", dest="fmt",
                    help="violation output format (default: text)")
    args = ap.parse_args(argv)

    root = args.root or Project.default_root()
    project = Project.load(root)
    if not project.sources:
        print(f"repro_torch.lint: no sources found under {root}", file=sys.stderr)
        return 2

    violations: List[Violation]
    if args.checks:
        violations = list(project.parse_violations())
        for slug in dict.fromkeys(args.checks):
            violations.extend(CHECKERS[slug](project))
        violations.extend(project.pragma_violations(include_stale=False))
        violations.sort(key=lambda v: (v.path, v.line, v.check, v.message))
    else:
        violations = lint_project(project)

    if args.fmt == "json":
        print(_render_json(violations))
    else:
        for v in violations:
            print(_render_github(v) if args.fmt == "github" else v.render())
    n_files = len(project.sources)
    if violations:
        print(f"repro_torch.lint: {len(violations)} violation(s) in {n_files} "
              "file(s) scanned", file=sys.stderr)
        return 1
    if args.fmt != "json":
        print(f"repro_torch.lint: clean ({n_files} files, "
              f"{len(args.checks or CHECKERS)} checkers)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
