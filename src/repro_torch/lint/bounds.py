"""Structural invariants the solvers assume — checked, not hoped for.

The port of ``repro.lint.bounds``, taught torch's spellings (``dim=`` beside
``axis=``, positional axes, ``torch.clamp``/``clamp_min``,
``torch.maximum`` and ``dcsim.ties.maximum`` as guards).

The game-theoretic solvers and the fault executor lean on facts the type
system cannot see: routing tensors live on a probability simplex, demand
and prices are nonnegative, every division inside hour code is guarded
against zero denominators (an unguarded ``x / rho`` NaN-poisons a whole
hour, and ``torch.where`` does not save you from the NaN *gradient*). This
checker pins those facts two ways:

- **statically** (:func:`check`): every division reachable from the hour
  roots (``repro_torch.lint.purity.TRACED_ROOTS``) inside the core
  simulation modules must have a *provably positive* denominator — a
  positive literal/constant, ``torch.maximum(x, eps)`` /
  ``ties.maximum(x, eps)``, ``torch.clamp(x, min=lo)`` /
  ``x.clamp_min(lo)`` / ``clip(x, lo, ...)`` with ``lo > 0``,
  ``1.0 - clamp(x, 0, hi)`` with ``hi < 1``, or products/sums thereof.
  The declared simplex-normalization sites (``SIMPLEX_SITES``) must exist
  and normalize along the declared axis (``dim=``, ``axis=`` or the
  positional form ``x.sum(1)`` / ``torch.sum(x, 1)``) — a refactor that
  turns ``dim=-1`` into ``dim=0`` re-normalizes across the wrong dimension
  while keeping every shape legal, which is exactly the bug class this
  rules out. The nonnegativity tables below are cross-checked against
  ``repro_torch.lint.pytrees.SCHEMAS`` so they cannot drift from the real field
  sets.
- **at runtime** (:func:`validate_bounds`, opt-in): an ``EnvParams`` /
  ``FaultTrace`` instance is checked leaf-by-leaf — nonnegative where
  declared, simplex fields summing to 1 along the declared axis, over
  torch tensors on any device (or numpy arrays).

Escapes use the reasoned ``# lint: unit-ok(reason)`` pragma on the
offending line, stale-checked like every pragma.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .project import Project, Violation
from .purity import Graph, TRACED_ROOTS, UnitScan, _registered_step_roots
from .pytrees import SCHEMAS
from .units import _const_fold

#: modules whose hour arithmetic gets the division-guard treatment —
#: host-side setup (build_env, rtt_matrix, capability derivation) divides
#: by python ints with explicit branches and is out of scope by reachability
BOUNDS_MODULES = (
    "repro_torch.dcsim.env",
    "repro_torch.dcsim.latency",
    "repro_torch.faults.failover",
)

#: functions positive by construction (COP >= COP_MIN > 0, 1/(1-rho) >= 1)
POSITIVE_CALLS = {"power_cop", "cop", "queue_factor"}

#: (module, function, normalized name, required sum axis) — the simplex
#: projections every routing consumer assumes; the axis is load-bearing
SIMPLEX_SITES = (
    ("repro_torch.dcsim.env", "project_feasible", "w", 1),
    ("repro_torch.faults.failover", "_redistribute", "w", -1),
)

#: runtime nonnegativity: physical quantities that must never be negative
#: (demand, capacity, prices, intensities, fault multipliers). ``rp`` is
#: deliberately absent — renewable displacement enters ``grid_power`` as a
#: subtraction and the profile itself is clipped at source.
NONNEG_FIELDS: Dict[str, Tuple[str, ...]] = {
    "EnvParams": (
        "er", "it_idle", "it_dyn", "eff", "rp", "carbon", "eprice",
        "peak_price", "alpha", "nprice", "sizes", "nn_total", "car",
        "avail", "rtt", "sla_ms", "sla_price", "sla_weight",
    ),
    "FaultTrace": (
        "avail_mult", "rtt_extra_ms", "price_mult", "carbon_mult",
    ),
}

#: runtime simplex fields: class -> {field: axis the field sums to 1 along}
SIMPLEX_FIELDS: Dict[str, Dict[str, int]] = {
    "EnvParams": {"origin": 0},   # (S, I, 24): source mix per task-hour
}


# ---------------------------------------------------------------------------
# positivity recognizer
# ---------------------------------------------------------------------------

def _terminal(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _module_consts(graph: Graph, module: str) -> Dict[str, float]:
    """Positive top-level numeric constants visible in ``module`` — its own
    assignments plus ``from x import NAME`` re-exports, one hop."""
    out: Dict[str, float] = {}
    table = graph.tables.get(module)
    if table is None or table.sf.tree is None:
        return out

    def harvest(tree: ast.Module, into: Dict[str, float]) -> None:
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                v = _const_fold(node.value)
                if v is not None:
                    into[node.targets[0].id] = v

    harvest(table.sf.tree, out)
    for alias, (mod, name) in table.import_objects.items():
        other = graph.tables.get(mod)
        if other is None or other.sf.tree is None:
            continue
        theirs: Dict[str, float] = {}
        harvest(other.sf.tree, theirs)
        if name in theirs:
            out[alias] = theirs[name]
    return {k: v for k, v in out.items() if v > 0}


def _positive(node: ast.AST, consts: Dict[str, float],
              pos_locals: Set[str]) -> bool:
    """Conservatively: is this expression provably > 0? (A ``False`` means
    "not provable", not "negative" — this is a lint, not a proof.)"""
    v = _const_fold(node)
    if v is not None:
        return v > 0
    if isinstance(node, ast.Name):
        return node.id in pos_locals or node.id in consts
    if isinstance(node, ast.Subscript):
        return _positive(node.value, consts, pos_locals)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        return _positive(node.operand, consts, pos_locals)
    if isinstance(node, ast.Call):
        name = _terminal(node.func)
        if name in ("maximum", "fmax", "max"):
            return any(_positive(a, consts, pos_locals) for a in node.args)
        if name in ("clip", "clamp", "clamp_min"):
            lo = _clamp_bound(node, "min")
            return lo is not None and _positive(lo, consts, pos_locals)
        if name in POSITIVE_CALLS:
            return True
        return False
    if isinstance(node, ast.BinOp):
        left = _positive(node.left, consts, pos_locals)
        right = _positive(node.right, consts, pos_locals)
        if isinstance(node.op, ast.Add):
            # positive + (physically nonnegative) — the repo's 1 + rtt/scale
            return left or right
        if isinstance(node.op, (ast.Mult, ast.Div)):
            return left and right
        if isinstance(node.op, ast.Pow):
            return left
        if isinstance(node.op, ast.Sub):
            # c - clamp(x, lo, hi) is positive when the constant c > hi
            c = _const_fold(node.left)
            hi = (_clamp_bound(node.right, "max")
                  if isinstance(node.right, ast.Call)
                  and _terminal(node.right.func) in ("clip", "clamp")
                  else None)
            if c is not None and hi is not None:
                hv = _const_fold(hi)
                if hv is None and isinstance(hi, ast.Name):
                    hv = consts.get(hi.id)
                return hv is not None and c > hv
    return False


def _clamp_bound(call: ast.Call, which: str) -> Optional[ast.AST]:
    """The ``"min"`` or ``"max"`` bound of ``clip(x, lo, hi)``,
    ``torch.clamp(x, min=lo, max=hi)``, ``x.clamp(lo, hi)`` or
    ``x.clamp_min(lo)``: by keyword, else by position (the method forms
    take the tensor as receiver, so their bounds start one argument
    earlier)."""
    name = _terminal(call.func)
    if name == "clamp_min" and which == "max":
        return None
    names = ("a_min", "min") if which == "min" else ("a_max", "max")
    hit = next((kw.value for kw in call.keywords if kw.arg in names), None)
    if hit is not None:
        return hit
    pos = (1 if which == "min" else 2) - (0 if _is_function_form(call) else 1)
    return call.args[pos] if pos < len(call.args) else None


#: module aliases whose calls take the tensor first (``torch.sum(x, 1)``,
#: ``ties.clip(x, lo, hi)``), against the method form (``x.sum(1)``)
_FUNCTION_BASES = ("torch", "np", "numpy", "ties")


def _is_function_form(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return True
    return isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
        and f.value.id in _FUNCTION_BASES


def _positive_locals(fn: ast.AST, consts: Dict[str, float]) -> Set[str]:
    """Names assigned from provably-positive expressions, two propagation
    rounds — enough for ``width = SLA_SOFTNESS * ties.maximum(sla_ms, eps)``."""
    out: Set[str] = set()
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _positive(node.value, consts, out):
                out.add(node.targets[0].id)
    return out


# ---------------------------------------------------------------------------
# static checks
# ---------------------------------------------------------------------------

def _reachable(graph: Graph) -> Set[Tuple[str, str]]:
    """The hour call-graph closure, same walk as the purity checker."""
    worklist: List[Tuple[str, str]] = []
    for mod, name in TRACED_ROOTS:
        table = graph.tables.get(mod)
        if table is not None and name in table.functions:
            worklist.append((mod, name))
    worklist.extend(_registered_step_roots(graph))
    seen: Set[Tuple[str, str]] = set()
    while worklist:
        mod, name = worklist.pop()
        if (mod, name) in seen:
            continue
        seen.add((mod, name))
        table = graph.tables.get(mod)
        fn = table.functions.get(name) if table else None
        if fn is None:
            continue
        worklist.extend(UnitScan(graph, mod, name, fn).edges)
    return seen


def _check_divisions(project: Project, graph: Graph,
                     out: List[Violation]) -> None:
    reachable = _reachable(graph)
    consts_cache: Dict[str, Dict[str, float]] = {}
    for mod, name in sorted(reachable):
        if mod not in BOUNDS_MODULES:
            continue
        table = graph.tables[mod]
        fn = table.functions.get(name)
        if fn is None:
            continue
        if mod not in consts_cache:
            consts_cache[mod] = _module_consts(graph, mod)
        consts = consts_cache[mod]
        pos = _positive_locals(fn, consts)
        rel = table.sf.relpath
        for node in ast.walk(fn):
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Div)):
                continue
            if _positive(node.right, consts, pos):
                continue
            line = node.lineno
            if project.pragma_at(rel, line, "unit-ok") is not None:
                project.use_pragma(rel, line)
                continue
            out.append(Violation(
                rel, line, "bounds",
                f"division in hour code (`{mod}:{name}`) whose "
                "denominator is not provably positive — guard with "
                "ties.maximum(x, eps) (an unguarded zero NaN-poisons the "
                "hour and its gradients), or mark the line "
                "# lint: unit-ok(reason)"))


def _sum_axis(call: ast.Call) -> Optional[float]:
    """The reduced axis of ``sum(...)``: the ``dim=``/``axis=`` keyword, or
    the positional axis (``torch.sum(x, 1)``, ``x.sum(1)``)."""
    for kw in call.keywords:
        if kw.arg in ("axis", "dim"):
            return _const_fold(kw.value)
    pos = 1 if _is_function_form(call) else 0
    if pos < len(call.args):
        return _const_fold(call.args[pos])
    return None


#: guards of a simplex denominator: ``maximum(sum, eps)``, ``torch.clamp(
#: sum, min=eps)``, ``sum.clamp_min(eps)``
_SUM_GUARDS = ("maximum", "fmax", "clamp", "clamp_min", "clip")


def _guarded_sum(den: ast.AST) -> Optional[ast.Call]:
    """The ``sum(...)`` call of a simplex denominator, bare or under a
    guard (function or method form), else None."""
    if not isinstance(den, ast.Call):
        return None
    name = _terminal(den.func)
    if name == "sum":
        return den
    if name not in _SUM_GUARDS:
        return None
    if _is_function_form(den):
        inner = den.args[0] if den.args else None
    else:
        inner = den.func.value
    if isinstance(inner, ast.Call) and _terminal(inner.func) == "sum":
        return inner
    return None


def _check_simplex_sites(project: Project, graph: Graph,
                         out: List[Violation]) -> None:
    for mod, func, var, axis in SIMPLEX_SITES:
        table = graph.tables.get(mod)
        fn = table.functions.get(func) if table else None
        if fn is None:
            out.append(Violation(
                "src/repro_torch/lint/bounds.py", 1, "bounds",
                f"declared simplex site `{mod}:{func}` not found — update "
                "SIMPLEX_SITES or restore the function"))
            continue
        rel = table.sf.relpath
        found = False
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == var
                    and isinstance(node.value, ast.BinOp)
                    and isinstance(node.value.op, ast.Div)):
                continue
            found = True
            # denominator must be maximum(sum(..., dim=AXIS, keepdim), eps)
            sum_call = _guarded_sum(node.value.right)
            if sum_call is None:
                out.append(Violation(
                    rel, node.lineno, "bounds",
                    f"`{func}` normalizes `{var}` without a "
                    "ties.maximum(torch.sum(...), eps)-guarded denominator"))
                continue
            got = _sum_axis(sum_call)
            if got is not None and float(got).is_integer():
                got = int(got)
            if got != axis:
                out.append(Violation(
                    rel, node.lineno, "bounds",
                    f"`{func}` normalizes `{var}` along axis {got!r} but "
                    f"the simplex contract requires axis {axis} — every "
                    "consumer assumes rows on that axis sum to 1"))
        if not found:
            out.append(Violation(
                rel, fn.lineno, "bounds",
                f"`{func}` no longer contains the `{var} = ... / ...` "
                "simplex normalization — update SIMPLEX_SITES if the "
                "projection moved"))


def _check_field_tables(out: List[Violation]) -> None:
    """NONNEG_FIELDS / SIMPLEX_FIELDS must name real schema fields."""
    for table, per_cls in (("NONNEG_FIELDS", NONNEG_FIELDS),
                           ("SIMPLEX_FIELDS", SIMPLEX_FIELDS)):
        for cls, fields in per_cls.items():
            if cls not in SCHEMAS:
                out.append(Violation(
                    "src/repro_torch/lint/bounds.py", 1, "bounds",
                    f"{table} names unknown class `{cls}` — keep it in "
                    "sync with repro_torch.lint.pytrees.SCHEMAS"))
                continue
            known = SCHEMAS[cls][1]
            for f in fields:
                if f not in known:
                    out.append(Violation(
                        "src/repro_torch/lint/bounds.py", 1, "bounds",
                        f"{table}[{cls!r}] names unknown field `{f}` — "
                        "keep it in sync with repro_torch.lint.pytrees.SCHEMAS"))


def check(project: Project) -> List[Violation]:
    graph = Graph(project)
    out: List[Violation] = []
    _check_field_tables(out)
    _check_divisions(project, graph, out)
    _check_simplex_sites(project, graph, out)
    return out


# ---------------------------------------------------------------------------
# runtime side (opt-in, mirrors repro_torch.lint.pytrees.validate)
# ---------------------------------------------------------------------------

def _host(leaf):
    """A leaf as a numpy array of its own precision: a torch tensor on any
    device is copied to the host (half types widened to float32)."""
    import numpy as np

    if hasattr(leaf, "detach"):
        x = leaf.detach()
        if x.is_floating_point() and x.element_size() < 4:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(leaf)


def validate_bounds(tree, atol: float = 1e-5) -> None:
    """Check a live ``EnvParams``/``FaultTrace`` against the declared
    bounds: nonnegative where NONNEG_FIELDS says so, summing to 1 along
    the declared axis where SIMPLEX_FIELDS says so. Raises ``ValueError``
    listing every violated field. The leaves are torch tensors on any
    device (or numpy arrays); the check copies them to the host, so call it
    outside the hour."""
    import numpy as np

    cls = type(tree).__name__
    problems: List[str] = []
    for field in NONNEG_FIELDS.get(cls, ()):
        leaf = _host(getattr(tree, field))
        if leaf.size and float(leaf.min()) < -atol:
            problems.append(
                f"{cls}.{field}: min {float(leaf.min()):g} < 0 "
                "(declared nonnegative)")
    for field, axis in SIMPLEX_FIELDS.get(cls, {}).items():
        leaf = _host(getattr(tree, field))
        if leaf.size == 0:
            continue
        if float(leaf.min()) < -atol:
            problems.append(f"{cls}.{field}: negative mass "
                            f"({float(leaf.min()):g})")
        sums = leaf.sum(axis=axis)
        err = float(np.abs(sums - 1.0).max())
        if err > atol:
            problems.append(
                f"{cls}.{field}: sums along axis {axis} deviate from 1 "
                f"by up to {err:g} (declared simplex)")
    if problems:
        raise ValueError("bounds violations:\n  " + "\n  ".join(problems))
