"""Tap-name registry: every ``obs.tap(<name>, ...)`` literal must name a
declared tap.

The port of ``repro.lint.taps``. Tap liveness is decided when the tap is
called, by *string* match against the active tap set, so a typo'd tap name
is the quietest possible failure: the call returns at once, nothing ever
streams, and no test fails unless one specifically awaited that name. The
registry closes the loop statically:

- ``KNOWN_TAPS`` in ``repro_torch.obs.tap`` declares every tap name;
- every ``tap(<literal>, ...)`` call site must use a declared name, and
  the first argument must *be* a string literal (a computed name defeats
  the registry, and the engine keys carry tap-set tuples that assume
  names are static);
- every declared name must be emitted somewhere (a stale registry entry is
  a lie to anyone enabling that tap);
- tap *pattern* literals (``obs.taps("engine/*")``, ``enable_taps``,
  ``ExperimentSpec(taps=...)``) must match at least one declared tap — the
  same typo class, one level up.

The registry itself is parsed from the AST, never imported.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from .project import Project, Violation

TAP_MODULE = "repro_torch.obs.tap"
REGISTRY_NAME = "KNOWN_TAPS"

#: call names whose string-literal args are tap *patterns*
PATTERN_CALLS = ("taps", "enable_taps")


def declared_taps(project: Project) -> Tuple[Optional[Set[str]], Optional[int]]:
    """Parse ``KNOWN_TAPS = ("...", ...)`` out of ``repro_torch.obs.tap``.
    Returns (names, assignment line), or (None, None) if missing."""
    sf = project.module(TAP_MODULE)
    if sf is None or sf.tree is None:
        return None, None
    for node in sf.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        if not any(isinstance(t, ast.Name) and t.id == REGISTRY_NAME
                   for t in targets):
            continue
        value = node.value
        if isinstance(value, (ast.Tuple, ast.List)) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in value.elts):
            return {e.value for e in value.elts}, node.lineno
        return None, node.lineno
    return None, None


def _pattern_matches(pattern: str, names: Set[str]) -> bool:
    if pattern == "*":
        return bool(names)
    if pattern.endswith("/*"):
        prefix = pattern[:-1]          # keep the slash
        return any(n.startswith(prefix) for n in names)
    return pattern in names


def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    known, reg_line = declared_taps(project)
    tap_sf = project.module(TAP_MODULE)
    if known is None:
        rel = tap_sf.relpath if tap_sf else "src/repro_torch/obs/tap.py"
        out.append(Violation(
            rel, reg_line or 1, "taps",
            f"`{REGISTRY_NAME}` is missing from `{TAP_MODULE}` (or is not "
            "a literal tuple of strings) — the tap registry must be a "
            "statically readable declaration"))
        return out

    emitted: Set[str] = set()
    for rel, sf in project.sources.items():
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name == "tap":
                if not node.args:
                    continue   # not the obs.tap signature; leave to runtime
                first = node.args[0]
                if not (isinstance(first, ast.Constant)
                        and isinstance(first.value, str)):
                    out.append(Violation(
                        rel, node.lineno, "taps",
                        "tap name must be a string literal — a computed "
                        "name cannot be checked against the registry and "
                        "breaks the static tap-set compile keys"))
                    continue
                emitted.add(first.value)
                if first.value not in known:
                    out.append(Violation(
                        rel, node.lineno, "taps",
                        f"tap name {first.value!r} is not declared in "
                        f"`{TAP_MODULE}.{REGISTRY_NAME}` — an undeclared "
                        "tap can be typo'd into silence; declare it (known: "
                        f"{sorted(known)})"))
            elif name in PATTERN_CALLS:
                for arg in node.args:
                    if isinstance(arg, ast.Constant) and \
                            isinstance(arg.value, str) and \
                            not _pattern_matches(arg.value, known):
                        out.append(Violation(
                            rel, arg.lineno, "taps",
                            f"tap pattern {arg.value!r} matches no "
                            f"declared tap (known: {sorted(known)}) — it "
                            "would enable nothing, silently"))

    # declared but never emitted: the registry must not over-promise.
    # (tap.py itself only *declares*; emission lives at the instrumented
    # sites, so this scan covers exactly the emitting modules.)
    for name in sorted(known - emitted):
        out.append(Violation(
            tap_sf.relpath, reg_line, "taps",
            f"declared tap {name!r} is never emitted by any "
            "`tap(...)` call in the scanned tree — delete it from "
            f"{REGISTRY_NAME} or wire up the emission"))
    return out
