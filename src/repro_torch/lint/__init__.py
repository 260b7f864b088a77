"""``repro_torch.lint`` — the port's own static-analysis pass.

The port of ``repro.lint``, pointed at ``src/repro_torch`` and taught
torch's idioms. Six static checkers over the port's load-bearing
invariants, plus runtime sanitizers:

==============  ============================================================
checker         invariant
==============  ============================================================
``purity``      nothing host-side (clocks, ``np.random``, torch's global
                RNG, ``.item()``/``.cpu()``/``.tolist()``/``.numpy()``,
                ``float()`` on a tensor, global mutation) is reachable from
                the hour roots: each would stall the card every hour and
                break CUDA-graph capture and ``torch.func.vmap``
``compile-key`` every ``ExperimentSpec`` field that changes the hour joins
                the engine key that dispatches are counted and run records
                joined under
``pytree``      ``EnvParams`` / ``FaultTrace`` / ``CapabilityBundle`` match
                their declared shape schemas; construction is total
``taps``        every ``obs.tap(<name>)`` literal is a declared tap name
``units``       units of measure propagate consistently through the
                simulator core: no ``$/kWh + kg/kWh``, no bare magic scale
                factors, ``_usd``/``_kg``/``_ms`` metric keys carry their
                suffix unit, declared signatures/field tables hold
``bounds``      divisions in hour code are guarded positive; routing
                tensors are normalized along the declared simplex axis;
                nonnegativity tables match the pytree schemas
``pragma``      suppressions are justified and still suppress something
==============  ============================================================

Run it: ``PYTHONPATH=src python -m repro_torch.lint``. The static side
never imports the modules it checks — no torch required. Suppressions:
``# lint: host-ok(reason)`` on a deliberate host call in hour code,
``# lint: runtime-only(reason)`` on a spec field that only selects
runtime inputs, ``# lint: unit(U)`` declaring a constant's or a field's
unit, ``# lint: unit-ok(reason)`` on a deliberate unit/bounds escape.

Runtime helpers (these touch torch, lazily): :func:`validate` checks a
live pytree against its schema (shape unification, float64 and
mixed-device leaves); :func:`validate_bounds` checks nonnegativity/simplex
bounds on any device; :func:`expect_compiles` pins first dispatches per
engine key in tests; :func:`trace_count` has no probe in the port and
answers ``None``.
"""
from __future__ import annotations

from typing import List, Optional

from . import bounds, compile_key, purity, pytrees, taps, units
from .bounds import validate_bounds
from .project import Pragma, Project, Violation
from .pytrees import SCHEMAS, validate
from .runtime import expect_compiles, trace_count

__all__ = [
    "CHECKERS", "Pragma", "Project", "SCHEMAS", "Violation",
    "expect_compiles", "lint_project", "lint_repo", "trace_count",
    "validate", "validate_bounds",
]

#: slug -> checker, in report order
CHECKERS = {
    "purity": purity.check,
    "compile-key": compile_key.check,
    "pytree": pytrees.check,
    "taps": taps.check,
    "units": units.check,
    "bounds": bounds.check,
}


def lint_project(project: Project) -> List[Violation]:
    """Run every checker over an already-loaded project. Pragma accounting
    (stale/malformed suppressions) runs last, once all checkers have had
    the chance to consume their pragmas."""
    out: List[Violation] = list(project.parse_violations())
    for check in CHECKERS.values():
        out.extend(check(project))
    out.extend(project.pragma_violations())
    return sorted(out, key=lambda v: (v.path, v.line, v.check, v.message))


def lint_repo(root: Optional[str] = None) -> List[Violation]:
    """Load the repo at ``root`` (default: this checkout) and lint it."""
    project = Project.load(root or Project.default_root())
    return lint_project(project)
