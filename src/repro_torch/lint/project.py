"""Shared substrate for the ``repro_torch.lint`` checkers: files, ASTs, pragmas.

The port of ``repro.lint.project``. The checkers are *static*: they parse
source, never import the modules they check (so ``python -m
repro_torch.lint`` runs without torch and cannot be fooled by import-time
state). Everything they share lives here:

- :class:`Project` — the file set under analysis. Loads ``src/repro_torch``,
  parses each file once, maps files to dotted module names so imports
  resolve across the package, and supports :meth:`Project.overlay` — swap
  one file's source for a modified string — which is how the tests seed
  regressions (delete a field from ``static_key``, typo a tap name) without
  touching the tree.
- :class:`Pragma` — the in-source suppression grammar
  ``# lint: <directive>(<reason>)``. Directives: ``host-ok`` (this line's
  host-side call from hour code is deliberate — the tap buffer's escape
  hatch), ``runtime-only`` (this ``ExperimentSpec`` field selects runtime
  inputs, not the hour's program), ``unit`` (declares the unit of the
  constant or field declared on this line, e.g. ``# lint: unit(W/kW)`` — a
  *declaration*, consumed by ``repro_torch.lint.units``), ``unit-ok`` (this
  line's unit finding is a deliberate escape). A pragma with an empty
  reason is itself a violation, and a pragma that suppresses nothing is
  reported as stale — suppressions cannot silently outlive their cause.
- :class:`Violation` — one finding: ``path:line: [checker] message``.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

PRAGMA_RE = re.compile(r"#\s*lint:\s*([a-z-]+)\s*\(([^)]*)\)")

PRAGMA_DIRECTIVES = ("host-ok", "runtime-only", "unit", "unit-ok")


class Violation(NamedTuple):
    """One lint finding, sortable into file/line order."""
    path: str       # repo-relative
    line: int
    check: str      # checker slug: purity | compile-key | pytree | taps | pragma
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


class Pragma(NamedTuple):
    directive: str
    reason: str
    line: int


class SourceFile:
    """One parsed source file: AST, dotted module name, pragma table."""

    def __init__(self, relpath: str, text: str, module: Optional[str]):
        self.relpath = relpath
        self.text = text
        self.module = module          # dotted name, None if unparseable
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(text, filename=relpath)
        except SyntaxError as e:  # surfaced as a violation by the lint run
            self.parse_error = f"syntax error: {e.msg} (line {e.lineno})"
        # pragmas live in *comment tokens* only — the same text inside a
        # string literal (docs, the lint messages themselves) is not one
        self.pragmas: Dict[int, Pragma] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = PRAGMA_RE.search(tok.string)
                if m:
                    line = tok.start[0]
                    self.pragmas[line] = Pragma(m.group(1),
                                                m.group(2).strip(), line)
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass   # unparseable files already surface via parse_error


def _module_name(relpath: str) -> Optional[str]:
    """src/repro_torch/core/game.py -> repro_torch.core.game (a file outside
    ``src`` gets a synthetic name so alias resolution has something to hang
    onto)."""
    p = Path(relpath)
    parts = list(p.with_suffix("").parts)
    if parts[0] == "src":
        parts = parts[1:]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else None


class Project:
    """The file set one lint run analyzes.

    ``sources`` maps repo-relative paths to :class:`SourceFile`;
    ``by_module`` indexes the importable ones by dotted name. ``overlay``
    returns a copy with one file's text replaced — the regression-seeding
    hook the tests use.
    """

    #: directories scanned relative to the repo root (missing ones skipped)
    SCAN_DIRS = ("src/repro_torch",)

    def __init__(self, sources: Dict[str, SourceFile], root: Optional[Path]):
        self.sources = sources
        self.root = root
        self.by_module: Dict[str, SourceFile] = {
            sf.module: sf for sf in sources.values() if sf.module
        }
        self._used_pragmas: set = set()   # (relpath, line)

    @classmethod
    def load(cls, root) -> "Project":
        root = Path(root)
        sources: Dict[str, SourceFile] = {}
        for d in cls.SCAN_DIRS:
            base = root / d
            if not base.is_dir():
                continue
            for f in sorted(base.rglob("*.py")):
                rel = str(f.relative_to(root))
                sources[rel] = SourceFile(rel, f.read_text(),
                                          _module_name(rel))
        return cls(sources, root)

    @classmethod
    def default_root(cls) -> Path:
        """The repo root, located from this package's own position
        (``src/repro_torch/lint/project.py`` -> three parents up)."""
        return Path(__file__).resolve().parents[3]

    def overlay(self, relpath: str, text: str) -> "Project":
        """A copy of the project with ``relpath``'s source replaced —
        regression seeding for the tests (the tree is untouched)."""
        sources = dict(self.sources)
        sources[relpath] = SourceFile(relpath, text,
                                      _module_name(relpath))
        return Project(sources, self.root)

    def module(self, dotted: str) -> Optional[SourceFile]:
        return self.by_module.get(dotted)

    def file(self, relpath: str) -> Optional[SourceFile]:
        return self.sources.get(relpath)

    # -- pragma bookkeeping --------------------------------------------------

    def pragma_at(self, relpath: str, line: int,
                  directive: str) -> Optional[Pragma]:
        sf = self.sources.get(relpath)
        if sf is None:
            return None
        p = sf.pragmas.get(line)
        return p if p is not None and p.directive == directive else None

    def use_pragma(self, relpath: str, line: int) -> None:
        self._used_pragmas.add((relpath, line))

    def pragma_violations(self, include_stale: bool = True) -> List[Violation]:
        """Malformed, unknown, and stale pragmas — suppressions are checked
        code too. Staleness is only meaningful after *every* checker has had
        the chance to consume its pragmas; partial runs (``--check``) pass
        ``include_stale=False``."""
        out: List[Violation] = []
        for rel, sf in self.sources.items():
            for line, p in sf.pragmas.items():
                if p.directive not in PRAGMA_DIRECTIVES:
                    out.append(Violation(
                        rel, line, "pragma",
                        f"unknown pragma directive {p.directive!r}; known: "
                        f"{PRAGMA_DIRECTIVES}"))
                elif not p.reason:
                    out.append(Violation(
                        rel, line, "pragma",
                        f"pragma {p.directive!r} needs a justification: "
                        "# lint: " + p.directive + "(why this is safe)"))
                elif include_stale and (rel, line) not in self._used_pragmas:
                    out.append(Violation(
                        rel, line, "pragma",
                        f"stale pragma {p.directive!r}: it no longer "
                        "suppresses any finding — delete it"))
        return out

    def parse_violations(self) -> List[Violation]:
        return [Violation(rel, 1, "parse", sf.parse_error)
                for rel, sf in self.sources.items() if sf.parse_error]
