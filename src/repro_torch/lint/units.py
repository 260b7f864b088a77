"""Units-of-measure abstract interpretation over the simulator core.

The port of ``repro.lint.units``: the unit algebra, the declaration tables,
the suffix contract and the magic-factor threshold are the reference's,
and the interpreter is taught torch's spellings (``torch.clamp`` /
``clamp_min`` / ``clamp_max``, ``torch.maximum`` / ``minimum`` and the
port's ``dcsim.ties.maximum`` / ``minimum`` / ``clip`` unify their
operands; ``torch.where`` unifies its branches; ``.to(...)``, ``.float()``,
``.double()`` and the view methods pass units through; ``torch.zeros`` /
``ones`` / ``full`` / ``*_like`` / ``new_*`` make literals; ``dim=`` and
``axis=`` select axes and carry no unit).

The paper's objective mixes $/kWh prices, kg CO₂/kWh grid intensity, W of
IT+CRAC power, GB payloads, tokens and tasks/h — and three of the repo's
real bugs were nothing but a scale factor applied, or dropped, in the
wrong place. This checker makes the unit/dimension bug class a lint
failure: it propagates units through the arithmetic of the core modules
(``dcsim/env.py``, ``latency.py``, ``capability.py``, ``power.py``,
``colocation.py``, ``renewables.py``, ``faults/failover.py``,
``faults/trace.py``, ``launch/roofline.py``) with a small intra-function
dataflow pass and flags:

- unit-inconsistent ``+``/``-``/comparisons (e.g. ``$/kWh + kg/kWh``);
- bare magic scale factors (``/ 1000.0``, ``* 1e9``) that are not one of
  the declared conversion constants in ``repro_torch.units``;
- emitted-metric suffix contracts: every dict key / subscript store ending
  ``_usd``/``_kg``/``_ms``/``_w`` must carry that unit;
- calls whose arguments contradict the declared parameter units, and
  returns that contradict the declared return unit.

Units are declared exactly once, in four places the checker machine-reads:

1. **Class docstring unit tables** — ``EnvParams``, ``CapabilityBundle``,
   ``FaultTrace``, ``AccelType``, ``ServingProfile`` each carry a
   ``Machine-read unit table (repro_torch.lint.units):`` block of
   ``field: unit`` lines. The table must list exactly the class's fields
   in order — doc drift is itself a lint failure.
2. **Conversion-constant pragmas** — ``W_PER_KW = 1000.0  # lint:
   unit(W/kW)`` declares the constant's unit (and sanctions its
   magnitude); see ``repro_torch.units``.
3. **Field pragmas** — a class field declared ``peak_flops: float  # lint:
   unit(FLOP/s)`` (``launch.roofline.Chip``) gives the field its unit; the
   class's constructor calls and attribute reads are then checked as a
   unit-table class's are.
4. **The SIGNATURES table below** — parameter/return units of the core
   functions, so units flow across calls without whole-program inference.

Unit grammar: ``atom ('*' atom)* ('/' atom)*`` over the atoms in
``ATOMS`` (``USD``, ``W``, ``kW``, ``kgCO2``, ``GB``, ``GiB``, ``B``,
``token``, ``task``, ``chip``, ``node``, ``ms``, ``s``, ``h``, ``month``,
``km``, ``degC``, ``FLOP``), with ``1`` for dimensionless and the
compounds ``kWh`` ≡ ``kW*h`` and ``J`` ≡ ``W*s``. ``W`` and ``kW`` are
*distinct* atoms related only through ``W_PER_KW`` — a dropped ``/1000``
is a dimensional mismatch, not a silent factor.

Abstract domain: a known ``Unit``; ``ANY`` (unknown — unifies with
everything, so the checker only fires where both sides are known); and
numeric literals, which are dimensionless under ``*``/``/`` but wildcards
under ``+``/``-``/comparison (``er * 3600.0`` keeps er's unit;
``ties.maximum(x, 1e-9)`` never false-positives). Escapes use
``# lint: unit-ok(reason)`` on the offending line, stale-checked like
every pragma.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple, Union

from .project import Project, Violation
from .purity import Graph

# ---------------------------------------------------------------------------
# the unit algebra
# ---------------------------------------------------------------------------

#: base dimensions. W/kW (and B/GB/GiB, ms/s/h) are deliberately distinct
#: atoms: conversions must go through the named constants in repro_torch.units.
ATOMS = frozenset({
    "USD", "W", "kW", "kgCO2", "GB", "GiB", "B", "token", "task", "chip",
    "node", "ms", "s", "h", "month", "km", "degC", "FLOP",
})

#: compound spellings that expand into products of atoms
COMPOUND = {"kWh": (("kW", 1), ("h", 1)), "J": (("W", 1), ("s", 1))}


class Unit:
    """An immutable map atom -> integer exponent; {} is dimensionless."""

    __slots__ = ("exps",)

    def __init__(self, exps: Dict[str, int]):
        self.exps: Tuple[Tuple[str, int], ...] = tuple(
            sorted((a, e) for a, e in exps.items() if e != 0))

    def __eq__(self, other):
        return isinstance(other, Unit) and self.exps == other.exps

    def __hash__(self):
        return hash(self.exps)

    def __mul__(self, other: "Unit") -> "Unit":
        d = dict(self.exps)
        for a, e in other.exps:
            d[a] = d.get(a, 0) + e
        return Unit(d)

    def __truediv__(self, other: "Unit") -> "Unit":
        d = dict(self.exps)
        for a, e in other.exps:
            d[a] = d.get(a, 0) - e
        return Unit(d)

    def __pow__(self, n: int) -> "Unit":
        return Unit({a: e * n for a, e in self.exps})

    @property
    def dimensionless(self) -> bool:
        return not self.exps

    def __repr__(self) -> str:
        if not self.exps:
            return "1"
        num = [a if e == 1 else f"{a}^{e}" for a, e in self.exps if e > 0]
        den = [a if e == -1 else f"{a}^{-e}" for a, e in self.exps if e < 0]
        s = "*".join(num) if num else "1"
        for a in den:
            s += "/" + a
        return s


DIMENSIONLESS = Unit({})


class _Any:
    """Unknown unit: unifies with everything, absorbs products."""

    def __repr__(self):
        return "?"


ANY = _Any()


class Literal:
    """A numeric literal: dimensionless under * and /, a wildcard under
    +, -, comparison and unification. ``value`` is the folded float when
    statically known (for the magic-factor and positivity checks)."""

    __slots__ = ("value",)

    def __init__(self, value: Optional[float] = None):
        self.value = value

    def __repr__(self):
        return f"lit({self.value})"


class ClassVal:
    """An instance of a unit-table class: attribute access yields the
    declared field unit."""

    __slots__ = ("cls",)

    def __init__(self, cls: str):
        self.cls = cls

    def __repr__(self):
        return f"<{self.cls}>"


AbstractVal = Union[Unit, _Any, Literal, ClassVal]


def parse_unit(text: str) -> Unit:
    """``atom ('*' atom)* ('/' atom)*`` -> Unit. Raises ValueError on an
    unknown atom (a typo'd declaration must fail loudly)."""
    text = text.strip()
    if text in ("1", ""):
        return DIMENSIONLESS
    out: Dict[str, int] = {}

    def add(atom: str, sign: int) -> None:
        atom = atom.strip()
        if atom == "1":
            return
        if atom in COMPOUND:
            for a, e in COMPOUND[atom]:
                out[a] = out.get(a, 0) + sign * e
            return
        if atom not in ATOMS:
            raise ValueError(
                f"unknown unit atom {atom!r} (known: "
                f"{', '.join(sorted(ATOMS | set(COMPOUND)))}, 1)")
        out[atom] = out.get(atom, 0) + sign

    parts = text.split("/")
    for a in parts[0].split("*"):
        add(a, +1)
    for p in parts[1:]:
        for a in p.split("*"):
            add(a, -1)
    return Unit(out)


def parse_unit_decl(text: str) -> Tuple[AbstractVal, ...]:
    """A declaration: one unit, ``@ClassName``, ``-`` (no unit), or a
    comma list of those (tuple returns). ``A|B`` alternation is handled
    by the caller (return checks only)."""
    out: List[AbstractVal] = []
    for part in text.split(","):
        part = part.strip()
        if part == "-":
            out.append(ANY)
        elif part.startswith("@"):
            out.append(ClassVal(part[1:]))
        else:
            out.append(parse_unit(part))
    return tuple(out)


# ---------------------------------------------------------------------------
# declared knowledge: classes, signatures, metric suffixes
# ---------------------------------------------------------------------------

#: class name -> defining module. Each class docstring carries the
#: machine-read ``field: unit`` table this checker parses (and checks
#: against the AST field list, so the docs cannot drift).
UNIT_CLASSES: Dict[str, str] = {
    "EnvParams": "repro_torch.dcsim.env",
    "CapabilityBundle": "repro_torch.dcsim.capability",
    "FaultTrace": "repro_torch.faults.trace",
    "AccelType": "repro_torch.dcsim.topology",
    "ServingProfile": "repro_torch.dcsim.capability",
}

UNIT_TABLE_MARKER = "Machine-read unit table"

#: (module, function) -> {param: decl, "return": decl}. ``@Class`` marks
#: a unit-table class; ``-`` opts a param out; ``A | B`` on a return is
#: an alternation (any branch may return either).
SIGNATURES: Dict[Tuple[str, str], Dict[str, str]] = {
    # -- dcsim.env ----------------------------------------------------------
    ("repro_torch.dcsim.env", "capacity_at"): {"env": "@EnvParams", "return": "task/h"},
    ("repro_torch.dcsim.env", "origin_at"): {"env": "@EnvParams", "return": "1"},
    ("repro_torch.dcsim.env", "source_rtt"): {"env": "@EnvParams", "return": "ms"},
    ("repro_torch.dcsim.env", "aggregate_origin"): {"env": "@EnvParams", "return": "@EnvParams"},
    ("repro_torch.dcsim.env", "crac_cap_t"): {"env": "@EnvParams", "return": "W"},
    ("repro_torch.dcsim.env", "dp_max_t"): {"env": "@EnvParams", "return": "W"},
    ("repro_torch.dcsim.env", "power_cop"): {"env": "@EnvParams", "return": "1"},
    ("repro_torch.dcsim.env", "load_share"): {"env": "@EnvParams", "ar": "task/h", "return": "1"},
    ("repro_torch.dcsim.env", "dp_est"): {"env": "@EnvParams", "ar": "task/h", "return": "W"},
    ("repro_torch.dcsim.env", "cet_est"): {"env": "@EnvParams", "ar": "task/h", "return": "kgCO2/h"},
    ("repro_torch.dcsim.env", "ce_est"): {"env": "@EnvParams", "ar": "task/h", "return": "kgCO2/h"},
    ("repro_torch.dcsim.env", "nc_est"): {"env": "@EnvParams", "ar": "task/h", "return": "USD/h"},
    ("repro_torch.dcsim.env", "grid_power"): {"env": "@EnvParams", "ar": "task/h", "return": "W"},
    ("repro_torch.dcsim.env", "peak_increase"): {
        "env": "@EnvParams", "ar": "task/h", "peak_state": "W", "return": "USD, W"},
    ("repro_torch.dcsim.env", "cct_est"): {
        "env": "@EnvParams", "ar": "task/h", "peak_state": "W", "return": "USD/h"},
    ("repro_torch.dcsim.env", "cc_est"): {
        "env": "@EnvParams", "ar": "task/h", "peak_state": "W", "return": "USD/h"},
    ("repro_torch.dcsim.env", "latency_ms"): {"env": "@EnvParams", "ar": "task/h", "return": "ms"},
    ("repro_torch.dcsim.env", "sla_cost"): {
        "env": "@EnvParams", "ar": "task/h", "lat_ms": "ms", "return": "USD/h"},
    ("repro_torch.dcsim.env", "sla_cost_est"): {"env": "@EnvParams", "ar": "task/h", "return": "USD/h"},
    ("repro_torch.dcsim.env", "latency_ms_routed"): {
        "env": "@EnvParams", "ar": "task/h", "return": "ms"},
    ("repro_torch.dcsim.env", "sla_cost_routed"): {
        "env": "@EnvParams", "ar3": "task/h", "lat_ms": "ms", "return": "USD/h"},
    ("repro_torch.dcsim.env", "sla_cost_est_routed"): {
        "env": "@EnvParams", "ar3": "task/h", "return": "USD/h"},
    ("repro_torch.dcsim.env", "player_reward"): {
        "env": "@EnvParams", "ar": "task/h", "peak_state": "W",
        "return": "kgCO2/h | USD/h"},
    ("repro_torch.dcsim.env", "feasible_violation"): {
        "env": "@EnvParams", "ar": "task/h", "return": "task/h"},
    ("repro_torch.dcsim.env", "project_feasible"): {
        "env": "@EnvParams", "fractions": "1", "return": "task/h"},
    ("repro_torch.dcsim.env", "project_feasible_routed"): {
        "env": "@EnvParams", "fractions": "1", "return": "task/h"},
    ("repro_torch.dcsim.env", "step_epoch"): {
        "env": "@EnvParams", "ar": "task/h", "peak_state": "W", "return": "W, -"},
    # -- dcsim.latency ------------------------------------------------------
    ("repro_torch.dcsim.latency", "haversine_km"): {"return": "km"},
    ("repro_torch.dcsim.latency", "rtt_matrix"): {"return": "ms"},
    ("repro_torch.dcsim.latency", "access_ms"): {"rtt": "ms", "return": "ms"},
    ("repro_torch.dcsim.latency", "service_ms"): {
        "er": "task/h", "nn_total": "node", "return": "ms"},
    ("repro_torch.dcsim.latency", "queue_factor"): {"rho": "1", "return": "1"},
    ("repro_torch.dcsim.latency", "expected_latency_ms"): {
        "er": "task/h", "nn_total": "node", "rho": "1", "rtt": "ms",
        "return": "ms"},
    ("repro_torch.dcsim.latency", "expected_latency_ms_routed"): {
        "er": "task/h", "nn_total": "node", "rho": "1", "src_rtt": "ms",
        "return": "ms"},
    ("repro_torch.dcsim.latency", "sla_miss_prob"): {
        "lat_ms": "ms", "sla_ms": "ms", "return": "1"},
    ("repro_torch.dcsim.latency", "default_sla_ms"): {
        "er": "task/h", "nn_total": "node", "margin": "1", "return": "ms"},
    # -- dcsim.power / colocation / renewables ------------------------------
    ("repro_torch.dcsim.power", "cop"): {"t_supply_c": "degC", "return": "1"},
    ("repro_torch.dcsim.power", "node_power_arrays"): {"return": "W, W"},
    ("repro_torch.dcsim.power", "compute_power"): {"rho": "1", "return": "W"},
    ("repro_torch.dcsim.power", "crac_power"): {
        "it_power_w": "W", "t_supply_c": "degC", "return": "W"},
    ("repro_torch.dcsim.power", "dp_max"): {
        "eff": "1", "t_supply_c": "degC", "rp_w": "W", "return": "W"},
    ("repro_torch.dcsim.colocation", "base_time_table"): {"return": "s"},
    ("repro_torch.dcsim.colocation", "coer_core"): {"return": "task/s"},
    ("repro_torch.dcsim.colocation", "er_table"): {"return": "task/h"},
    ("repro_torch.dcsim.renewables", "renewable_profile"): {
        "installed_w": "W", "return": "W"},
    # -- faults -------------------------------------------------------------
    ("repro_torch.faults.failover", "realized_env"): {
        "env": "@EnvParams", "trace": "@FaultTrace", "return": "@EnvParams"},
    ("repro_torch.faults.failover", "_nearness"): {
        "renv": "@EnvParams", "return": "1"},
    ("repro_torch.faults.failover", "_redistribute"): {
        "kept": "task/h", "over": "task/h", "cap": "task/h", "kern": "1",
        "return": "task/h"},
    ("repro_torch.faults.failover", "apply_failover"): {
        "renv": "@EnvParams", "ar": "task/h",
        "return": "task/h, task/h, task/h"},
    ("repro_torch.faults.failover", "execute_hour"): {
        "env": "@EnvParams", "trace": "@FaultTrace", "peak_state": "W",
        "ar": "task/h", "return": "W, -"},
    # -- launch.roofline ----------------------------------------------------
    ("repro_torch.launch.roofline", "_shape_bytes"): {"return": "B"},
}

#: metric-name suffix -> admissible units. Rates and their one-epoch
#: totals are both admitted: the engines sum per-hour values over a day,
#: and the epoch is exactly 1 h (documented in dcsim.env).
SUFFIX_UNITS: Dict[str, Tuple[Unit, ...]] = {
    "_usd": (parse_unit("USD"), parse_unit("USD/h")),
    "_kg": (parse_unit("kgCO2"), parse_unit("kgCO2/h")),
    "_ms": (parse_unit("ms"),),
    "_w": (parse_unit("W"),),
}

#: modules whose function bodies the dataflow pass interprets (and whose
#: arithmetic the magic-factor check polices)
UNIT_MODULES: Tuple[str, ...] = (
    "repro_torch.units",
    "repro_torch.dcsim.env",
    "repro_torch.dcsim.latency",
    "repro_torch.dcsim.capability",
    "repro_torch.dcsim.power",
    "repro_torch.dcsim.colocation",
    "repro_torch.dcsim.renewables",
    "repro_torch.faults.failover",
    "repro_torch.faults.trace",
    "repro_torch.launch.roofline",
)

#: |constant| at or above this, multiplying or dividing, is a scale
#: factor that must be a named, unit-declared conversion constant
MAGIC_THRESHOLD = 1000.0

# torch/np call semantics by terminal function name -------------------------

_PASSTHROUGH = {
    "asarray", "array", "float32", "float64", "abs", "absolute", "sum",
    "mean", "max", "min", "amax", "amin", "nansum", "nanmean", "squeeze",
    "reshape", "transpose", "ravel", "broadcast_to", "tile", "sort",
    "cumsum", "diag", "real", "nan_to_num", "stop_gradient", "flip",
    "roll", "atleast_1d", "atleast_2d", "stack", "concatenate", "copy",
    "ascontiguousarray",
}
_UNIFY = {"maximum", "minimum", "clip", "clamp", "clamp_min", "clamp_max",
          "fmax", "fmin", "hypot", "mod", "remainder"}
_DIMLESS = {
    "sigmoid", "exp", "log", "log1p", "expm1", "tanh", "softmax", "cos",
    "sin", "tan", "arcsin", "arccos", "arctan", "arctan2", "sign",
    "isnan", "isfinite", "isinf", "radians", "degrees", "logical_and",
    "logical_or", "logical_not",
}
_LITERAL_MAKERS = {"zeros", "ones", "full", "zeros_like", "ones_like",
                   "full_like", "eye", "arange", "linspace", "new_zeros",
                   "new_ones", "new_full", "empty", "empty_like"}
_PRODUCT = {"dot", "matmul", "outer", "multiply"}
_METHOD_PASSTHROUGH = {"sum", "mean", "max", "min", "reshape", "astype",
                       "transpose", "clip", "squeeze", "ravel", "copy",
                       "flatten", "cumsum", "to", "float", "double",
                       "unsqueeze", "expand", "view", "permute",
                       "contiguous", "detach", "clone", "index_select"}
#: the port's own elementwise helpers that unify like their torch namesakes
_PROJECT_UNIFY = {("repro_torch.dcsim.ties", "maximum"),
                  ("repro_torch.dcsim.ties", "minimum"),
                  ("repro_torch.dcsim.ties", "clip")}


def _const_fold(node: ast.AST) -> Optional[float]:
    """Fold a numeric-literal expression (constants, ``-x``, ``a ** b``,
    ``a * b``, ``a / b``) to its float value, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool):
        return float(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        v = _const_fold(node.operand)
        if v is None:
            return None
        return -v if isinstance(node.op, ast.USub) else v
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Pow, ast.Mult, ast.Div)):
        a, b = _const_fold(node.left), _const_fold(node.right)
        if a is None or b is None:
            return None
        try:
            if isinstance(node.op, ast.Pow):
                return float(a ** b)
            if isinstance(node.op, ast.Mult):
                return a * b
            return a / b
        except (OverflowError, ZeroDivisionError):
            return None
    return None


# ---------------------------------------------------------------------------
# declaration harvesting: class docstring tables + unit(...) constants
# ---------------------------------------------------------------------------

class UnitWorld:
    """Everything the interpreter knows before touching any function body:
    per-class field units, per-constant units/values, and the violations
    harvesting itself produced (bad atoms, table drift)."""

    def __init__(self, project: Project, graph: Graph):
        self.project = project
        self.graph = graph
        #: class name -> {field: AbstractVal}
        self.class_fields: Dict[str, Dict[str, AbstractVal]] = {}
        #: dotted "module.NAME" -> (AbstractVal, folded value or None)
        self.constants: Dict[str, Tuple[AbstractVal, Optional[float]]] = {}
        #: class name -> its fields in declaration order
        self.class_order: Dict[str, List[str]] = {}
        self.violations: List[Violation] = []
        self._harvest_classes()
        self._harvest_constants()
        self._harvest_field_pragmas()

    # -- class docstring unit tables ---------------------------------------

    def _harvest_classes(self) -> None:
        for cls, module in UNIT_CLASSES.items():
            sf = self.project.module(module)
            if sf is None or sf.tree is None:
                continue
            node = next((n for n in sf.tree.body
                         if isinstance(n, ast.ClassDef) and n.name == cls),
                        None)
            if node is None:
                self.violations.append(Violation(
                    sf.relpath, 1, "units",
                    f"unit-table class `{cls}` not found in {module} — "
                    "update UNIT_CLASSES or restore the class"))
                continue
            self.class_fields[cls] = self._parse_class(sf.relpath, node)

    def _parse_class(self, rel: str, node: ast.ClassDef) -> Dict[str, AbstractVal]:
        fields = [s.target.id for s in node.body
                  if isinstance(s, ast.AnnAssign)
                  and isinstance(s.target, ast.Name)]
        self.class_order[node.name] = fields
        doc = ast.get_docstring(node) or ""
        table: Dict[str, AbstractVal] = {}
        lines = doc.splitlines()
        start = next((i for i, ln in enumerate(lines)
                      if UNIT_TABLE_MARKER in ln), None)
        if start is None:
            self.violations.append(Violation(
                rel, node.lineno, "units",
                f"class `{node.name}` has no '{UNIT_TABLE_MARKER}' block in "
                "its docstring — every unit-table class declares its field "
                "units there (see EnvParams)"))
            return {f: ANY for f in fields}
        order: List[str] = []
        for ln in lines[start + 1:]:
            ln = ln.strip()
            if not ln:
                continue
            if ":" not in ln:
                break
            name, _, unit_text = ln.partition(":")
            name = name.strip()
            if not name.isidentifier():
                break
            try:
                table[name] = parse_unit_decl(unit_text)[0]
            except ValueError as e:
                self.violations.append(Violation(
                    rel, node.lineno, "units",
                    f"`{node.name}.{name}` unit declaration: {e}"))
                table[name] = ANY
            order.append(name)
        if order != fields:
            missing = [f for f in fields if f not in order]
            extra = [f for f in order if f not in fields]
            self.violations.append(Violation(
                rel, node.lineno, "units",
                f"`{node.name}` unit table drifted from the field list: "
                f"missing {missing or '[]'}, stray {extra or '[]'} "
                "(the docstring table is the machine-read source of truth "
                "— keep it exactly in field order)"))
        for f in fields:
            table.setdefault(f, ANY)
        return table

    # -- unit(...) pragma constants ----------------------------------------

    def _harvest_constants(self) -> None:
        for rel, sf in self.project.sources.items():
            if sf.tree is None or sf.module is None:
                continue
            for node in sf.tree.body:
                if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    continue
                pragma = self.project.pragma_at(rel, node.lineno, "unit")
                if pragma is None:
                    continue
                self.project.use_pragma(rel, node.lineno)
                name = node.targets[0].id
                try:
                    unit = parse_unit(pragma.reason)
                except ValueError as e:
                    self.violations.append(Violation(
                        rel, node.lineno, "units",
                        f"constant `{name}` unit declaration: {e}"))
                    continue
                self.constants[f"{sf.module}.{name}"] = (
                    unit, _const_fold(node.value))

    # -- unit(...) pragmas on class fields ----------------------------------

    def _harvest_field_pragmas(self) -> None:
        """``field: float  # lint: unit(U)`` in a class body of a unit
        module declares that field's unit; the class becomes a unit class
        whose other fields are unknown."""
        for module in UNIT_MODULES:
            sf = self.project.module(module)
            if sf is None or sf.tree is None:
                continue
            for cls in sf.tree.body:
                if not isinstance(cls, ast.ClassDef) or cls.name in UNIT_CLASSES:
                    continue
                fields = [s for s in cls.body if isinstance(s, ast.AnnAssign)
                          and isinstance(s.target, ast.Name)]
                table: Dict[str, AbstractVal] = {}
                for s in fields:
                    pragma = self.project.pragma_at(sf.relpath, s.lineno, "unit")
                    if pragma is None:
                        continue
                    self.project.use_pragma(sf.relpath, s.lineno)
                    try:
                        table[s.target.id] = parse_unit(pragma.reason)
                    except ValueError as e:
                        self.violations.append(Violation(
                            sf.relpath, s.lineno, "units",
                            f"field `{cls.name}.{s.target.id}` unit "
                            f"declaration: {e}"))
                if table:
                    order = [s.target.id for s in fields]
                    self.class_order[cls.name] = order
                    self.class_fields[cls.name] = {
                        f: table.get(f, ANY) for f in order}

    # -- lookups ------------------------------------------------------------

    def is_unit_class(self, name: Optional[str]) -> bool:
        return name in UNIT_CLASSES or name in self.class_fields

    def field_unit(self, cls: str, field: str) -> AbstractVal:
        return self.class_fields.get(cls, {}).get(field, ANY)

    def constant(self, dotted: str) -> Optional[Tuple[AbstractVal, Optional[float]]]:
        return self.constants.get(dotted)

    def signature(self, module: str, name: str) -> Optional[Dict[str, str]]:
        sig = SIGNATURES.get((module, name))
        if sig is not None:
            return sig
        tgt = self.graph.resolve_symbol(module, name)
        if tgt is not None:
            return SIGNATURES.get(tgt)
        return None


# ---------------------------------------------------------------------------
# the intra-function dataflow interpreter
# ---------------------------------------------------------------------------

def _unify(a: AbstractVal, b: AbstractVal) -> Tuple[AbstractVal, bool]:
    """Join two values as +/-/comparison/where does. Returns (result,
    mismatch): mismatch only when both are *known* units that differ."""
    if isinstance(a, Unit) and isinstance(b, Unit):
        if a == b:
            return a, False
        return a, True
    if isinstance(a, Unit):
        return a, False
    if isinstance(b, Unit):
        return b, False
    if isinstance(a, Literal) and isinstance(b, Literal):
        return Literal(), False
    return ANY, False


def _mul(a: AbstractVal, b: AbstractVal) -> AbstractVal:
    if isinstance(a, Literal):
        return b if not isinstance(b, Literal) else Literal()
    if isinstance(b, Literal):
        return a
    if isinstance(a, Unit) and isinstance(b, Unit):
        return a * b
    return ANY


def _div(a: AbstractVal, b: AbstractVal) -> AbstractVal:
    if isinstance(b, Literal):
        return a if not isinstance(a, Literal) else Literal()
    if isinstance(a, Literal):
        if isinstance(b, Unit):
            return DIMENSIONLESS / b
        return ANY
    if isinstance(a, Unit) and isinstance(b, Unit):
        return a / b
    return ANY


class FunctionScan:
    """Abstract-interpret one top-level function (plus its nested defs):
    propagate units through assignments, flag mismatches, check declared
    signatures, suffix contracts and constructor keywords."""

    def __init__(self, world: UnitWorld, module: str, qualname: str,
                 fn: ast.AST):
        self.world = world
        self.graph = world.graph
        self.table = world.graph.tables[module]
        self.module = module
        self.qualname = qualname
        self.fn = fn
        self.findings: List[Tuple[int, str]] = []
        self.env: Dict[str, AbstractVal] = {}
        self.return_decl = self._decl_of(fn)
        self._bind_params(fn)
        self._exec_body(fn.body)

    # -- declarations -------------------------------------------------------

    def _decl_of(self, fn: ast.AST) -> Optional[str]:
        sig = SIGNATURES.get((self.module, self.qualname))
        return sig.get("return") if sig else None

    def _bind_params(self, fn: ast.AST) -> None:
        sig = SIGNATURES.get((self.module, self.qualname), {})
        a = fn.args
        params = a.posonlyargs + a.args + a.kwonlyargs
        for arg in params:
            val: AbstractVal = ANY
            if arg.arg in sig:
                try:
                    val = parse_unit_decl(sig[arg.arg])[0]
                except ValueError:
                    val = ANY
            elif arg.annotation is not None:
                val = self._class_from_annotation(arg.annotation)
            self.env[arg.arg] = val
        if a.vararg:
            self.env[a.vararg.arg] = ANY
        if a.kwarg:
            self.env[a.kwarg.arg] = ANY

    def _class_from_annotation(self, ann: ast.AST) -> AbstractVal:
        """``env: EnvParams`` / ``env: E.EnvParams`` / ``acc:
        "topology.AccelType"`` -> ClassVal."""
        text = None
        if isinstance(ann, ast.Name):
            text = ann.id
        elif isinstance(ann, ast.Attribute):
            text = ann.attr
        elif isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            text = ann.value.rsplit(".", 1)[-1].strip()
        if self.world.is_unit_class(text):
            return ClassVal(text)
        return ANY

    # -- statement execution ------------------------------------------------

    def _exec_body(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self._exec(stmt)

    def _exec(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            val = self._eval(stmt.value)
            for t in stmt.targets:
                self._assign(t, val, stmt.value)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._assign(stmt.target, self._eval(stmt.value), stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            cur = (self.env.get(stmt.target.id, ANY)
                   if isinstance(stmt.target, ast.Name) else ANY)
            val = self._binop_val(stmt.op, cur, self._eval(stmt.value),
                                  stmt.lineno)
            self._assign(stmt.target, val, stmt.value)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._check_return(stmt)
        elif isinstance(stmt, (ast.If, ast.For, ast.While)):
            if isinstance(stmt, ast.For):
                self._assign(stmt.target, ANY, None)
                self._eval(stmt.iter)
            else:
                self._eval(stmt.test if isinstance(stmt, (ast.If, ast.While))
                           else stmt)
            self._exec_body(stmt.body)
            self._exec_body(stmt.orelse)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self._eval(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, ANY, None)
            self._exec_body(stmt.body)
        elif isinstance(stmt, ast.Try):
            self._exec_body(stmt.body)
            for h in stmt.handlers:
                self._exec_body(h.body)
            self._exec_body(stmt.orelse)
            self._exec_body(stmt.finalbody)
        elif isinstance(stmt, ast.Expr):
            self._eval(stmt.value)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested defs (scan bodies, closures) are interpreted in the
            # enclosing frame: closure names keep their units, params ANY
            saved = dict(self.env)
            for arg in (stmt.args.posonlyargs + stmt.args.args
                        + stmt.args.kwonlyargs):
                self.env[arg.arg] = ANY
            self._exec_body(stmt.body)
            self.env = saved
            self.env[stmt.name] = ANY
        # pass/raise/assert/import/global/delete: nothing to propagate

    def _assign(self, target: ast.AST, val: AbstractVal,
                value_node: Optional[ast.AST]) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = val
        elif isinstance(target, (ast.Tuple, ast.List)):
            parts: Optional[Tuple[AbstractVal, ...]] = None
            if isinstance(value_node, ast.Call):
                decl = self._call_return_decl(value_node)
                if decl is not None and "," in decl:
                    try:
                        parts = parse_unit_decl(decl)
                    except ValueError:
                        parts = None
            if parts is None and isinstance(value_node, (ast.Tuple, ast.List)):
                parts = tuple(self._eval(e) for e in value_node.elts)
            for i, t in enumerate(target.elts):
                self._assign(t, parts[i] if parts and i < len(parts) else ANY,
                             None)
        elif isinstance(target, ast.Subscript):
            # m["..."] = expr: the emitted-metric suffix contract
            self._check_suffix_store(target, val)
        elif isinstance(target, ast.Starred):
            self._assign(target.value, ANY, None)
        # attribute stores: nothing tracked

    def _check_return(self, stmt: ast.Return) -> None:
        decl = self.return_decl
        val_node = stmt.value
        if decl is None:
            self._eval(val_node)
            return
        # tuple returns against "A, B" declarations, element-wise
        decls = [d.strip() for d in decl.split(",")]
        if isinstance(val_node, ast.Tuple) and len(decls) == len(val_node.elts):
            for d, e in zip(decls, val_node.elts):
                self._check_one_return(d, self._eval(e), stmt.lineno)
            return
        self._check_one_return(decl, self._eval(val_node), stmt.lineno)

    def _check_one_return(self, decl: str, got: AbstractVal,
                          line: int) -> None:
        if not isinstance(got, Unit):
            return
        alts = []
        for alt in decl.split("|"):
            alt = alt.strip()
            if alt in ("-",) or alt.startswith("@") or "," in alt:
                return
            try:
                alts.append(parse_unit(alt))
            except ValueError:
                return
        if got not in alts:
            want = " | ".join(repr(a) for a in alts)
            self.findings.append((line, (
                f"`{self.qualname}` returns {got!r} but is declared to "
                f"return {want} (SIGNATURES in repro_torch.lint.units)")))

    def _check_suffix_store(self, target: ast.Subscript,
                            val: AbstractVal) -> None:
        key = target.slice
        if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
            return
        self._check_suffix(key.value, val, target.lineno)

    def _check_suffix(self, key: str, val: AbstractVal, line: int) -> None:
        if not isinstance(val, Unit):
            return
        for suffix, allowed in SUFFIX_UNITS.items():
            if key.endswith(suffix):
                if val not in allowed:
                    want = " or ".join(repr(u) for u in allowed)
                    self.findings.append((line, (
                        f"metric `{key}` carries {val!r}, but the "
                        f"`{suffix}` suffix contract requires {want}")))
                return

    # -- expression evaluation ---------------------------------------------

    def _eval(self, node: Optional[ast.AST]) -> AbstractVal:
        if node is None:
            return ANY
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float)) \
                    and not isinstance(node.value, bool):
                return Literal(float(node.value))
            return ANY
        if isinstance(node, ast.Name):
            return self._name(node.id)
        if isinstance(node, ast.Attribute):
            return self._attribute(node)
        if isinstance(node, ast.BinOp):
            return self._binop(node)
        if isinstance(node, ast.UnaryOp):
            v = self._eval(node.operand)
            if isinstance(node.op, (ast.USub, ast.UAdd)) \
                    and isinstance(v, Literal) and v.value is not None:
                return Literal(-v.value if isinstance(node.op, ast.USub)
                               else v.value)
            return v
        if isinstance(node, ast.BoolOp):
            for e in node.values:
                self._eval(e)
            return ANY
        if isinstance(node, ast.Compare):
            self._compare(node)
            return ANY
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Subscript):
            self._eval(node.slice)
            return self._eval(node.value)   # indexing preserves the unit
        if isinstance(node, ast.IfExp):
            self._eval(node.test)
            out, _ = _unify(self._eval(node.body), self._eval(node.orelse))
            return out
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                val = self._eval(v)
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    self._check_suffix(k.value, val, k.lineno)
            return ANY
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for e in node.elts:
                self._eval(e)
            return ANY
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._comprehension(node)
        if isinstance(node, ast.DictComp):
            saved = dict(self.env)
            self._bind_comp_targets(node.generators)
            self._eval(node.key)
            self._eval(node.value)
            self.env = saved
            return ANY
        if isinstance(node, ast.Lambda):
            return ANY
        if isinstance(node, ast.Starred):
            return self._eval(node.value)
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue, ast.Slice)):
            return ANY
        if isinstance(node, ast.NamedExpr):
            val = self._eval(node.value)
            self._assign(node.target, val, node.value)
            return val
        return ANY

    def _bind_comp_targets(self, generators) -> None:
        for gen in generators:
            self._eval(gen.iter)
            self._assign(gen.target, ANY, None)
            for cond in gen.ifs:
                self._eval(cond)

    def _comprehension(self, node) -> AbstractVal:
        """A list/gen comprehension evaluates to its element's unit (the
        ``np.array([...])`` construction idiom keeps its unit)."""
        saved = dict(self.env)
        self._bind_comp_targets(node.generators)
        elt = self._eval(node.elt)
        self.env = saved
        return elt if isinstance(elt, (Unit, Literal)) else ANY

    def _name(self, name: str) -> AbstractVal:
        if name in self.env:
            return self.env[name]
        hit = self.world.constant(f"{self.module}.{name}")
        if hit is not None:
            return hit[0]
        if name in self.table.import_objects:
            mod, orig = self.table.import_objects[name]
            hit = self.world.constant(f"{mod}.{orig}")
            if hit is not None:
                return hit[0]
        return ANY

    def _attribute(self, node: ast.Attribute) -> AbstractVal:
        base = self._eval(node.value)
        if isinstance(base, ClassVal):
            if node.attr in self.world.class_fields.get(base.cls, {}):
                return self.world.field_unit(base.cls, node.attr)
            return ANY
        # module-constant access through an import alias (R.PEAK_FLOPS,
        # units.W_PER_KW, topology.NETWORK_PRICE)
        dotted = self.graph.dotted_of(self.table.import_modules,
                                      self.table.import_objects, node,
                                      set(self.env))
        if dotted is not None:
            hit = self.world.constant(dotted)
            if hit is not None:
                return hit[0]
        return ANY

    def _binop(self, node: ast.BinOp) -> AbstractVal:
        left = self._eval(node.left)
        right = self._eval(node.right)
        return self._binop_val(node.op, left, right, node.lineno,
                               node=node)

    def _binop_val(self, op: ast.operator, left: AbstractVal,
                   right: AbstractVal, line: int,
                   node: Optional[ast.BinOp] = None) -> AbstractVal:
        if isinstance(op, (ast.Mult, ast.MatMult)):
            return _mul(left, right)
        if isinstance(op, (ast.Div, ast.FloorDiv)):
            return _div(left, right)
        if isinstance(op, (ast.Add, ast.Sub)):
            out, mismatch = _unify(left, right)
            if mismatch:
                opname = "+" if isinstance(op, ast.Add) else "-"
                self.findings.append((line, (
                    f"unit mismatch: {left!r} {opname} {right!r} — operands "
                    "of addition/subtraction must share a unit (convert "
                    "through a repro_torch.units constant, or mark the line "
                    "# lint: unit-ok(reason))")))
            return out
        if isinstance(op, ast.Pow):
            if isinstance(left, Unit) and node is not None:
                n = _const_fold(node.right)
                if n is not None and float(n).is_integer():
                    return left ** int(n)
                return ANY
            if isinstance(left, Literal) and node is not None:
                v = _const_fold(node)
                return Literal(v)
            return ANY
        if isinstance(op, ast.Mod):
            return left
        return ANY

    def _compare(self, node: ast.Compare) -> None:
        vals = [self._eval(node.left)] + [self._eval(c)
                                          for c in node.comparators]
        for op, a, b in zip(node.ops, vals, vals[1:]):
            if isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)):
                continue
            _, mismatch = _unify(a, b)
            if mismatch:
                self.findings.append((node.lineno, (
                    f"unit mismatch: comparing {a!r} against {b!r} — both "
                    "sides of a comparison must share a unit")))

    # -- calls --------------------------------------------------------------

    def _call_target(self, node: ast.Call) -> Optional[Tuple[str, str]]:
        """Resolve a call to a (module, function) defined in the project."""
        func = node.func
        if isinstance(func, ast.Name):
            if func.id in self.env:
                return None
            if func.id in self.table.functions:
                return (self.module, func.id)
            return self.graph.resolve_symbol(self.module, func.id)
        if isinstance(func, ast.Attribute):
            dotted = self.graph.dotted_of(self.table.import_modules,
                                          self.table.import_objects, func,
                                          set(self.env))
            if dotted and dotted.startswith("repro_torch."):
                mod, _, name = dotted.rpartition(".")
                tgt = self.graph.resolve_symbol(mod, name)
                if tgt is not None:
                    return tgt
                if (mod, name) in SIGNATURES:
                    return (mod, name)
        return None

    def _call_return_decl(self, node: ast.Call) -> Optional[str]:
        tgt = self._call_target(node)
        if tgt is not None:
            sig = SIGNATURES.get(tgt)
            if sig is not None:
                return sig.get("return")
        return None

    def _terminal_name(self, func: ast.AST) -> Optional[str]:
        if isinstance(func, ast.Attribute):
            return func.attr
        if isinstance(func, ast.Name):
            return func.id
        return None

    def _call(self, node: ast.Call) -> AbstractVal:
        func = node.func
        argvals = [self._eval(a) for a in node.args]
        kwvals = {kw.arg: self._eval(kw.value) for kw in node.keywords
                  if kw.arg is not None}
        for kw in node.keywords:
            if kw.arg is None:
                self._eval(kw.value)

        # project-defined callee with a declared signature: check args,
        # trust the declared return
        tgt = self._call_target(node)
        if tgt is not None:
            sig = SIGNATURES.get(tgt)
            if sig is not None:
                self._check_sig_args(node, tgt, sig, argvals, kwvals)
                ret = sig.get("return")
                if ret is not None and "," not in ret and "|" not in ret:
                    try:
                        return parse_unit_decl(ret)[0]
                    except ValueError:
                        return ANY
                return ANY
            # constructor of a unit-table class?
            if self.world.is_unit_class(tgt[1]):
                self._check_ctor(node, tgt[1], kwvals, argvals)
                return ClassVal(tgt[1])
            # ties.maximum & co.: the torch call's semantics, below
            if tgt not in _PROJECT_UNIFY:
                return ANY

        # constructor called by bare name (classes are not in the function
        # table, so _call_target misses them): EnvParams(...), FaultTrace(...)
        if isinstance(func, ast.Name) and self.world.is_unit_class(func.id) \
                and func.id not in self.env:
            self._check_ctor(node, func.id, kwvals, argvals)
            return ClassVal(func.id)
        if isinstance(func, ast.Attribute) and self.world.is_unit_class(func.attr):
            self._check_ctor(node, func.attr, kwvals, argvals)
            return ClassVal(func.attr)

        # ._replace(field=...) keeps the class and re-checks the fields
        if isinstance(func, ast.Attribute) and func.attr == "_replace":
            recv = self._eval(func.value)
            if isinstance(recv, ClassVal):
                self._check_ctor(node, recv.cls, kwvals)
                return recv
            return ANY

        name = self._terminal_name(func)
        if name is None:
            return ANY

        # x.clamp(min=...) / x.clamp_min(...): the receiver joins the bounds
        if isinstance(func, ast.Attribute) and name in (
                "clamp", "clamp_min", "clamp_max") and not (
                isinstance(func.value, ast.Name)
                and func.value.id in ("torch", "ties")):
            argvals = [self._eval(func.value)] + argvals

        # x.sum() / x.to(...) / x.float() / x.clip(...): unit-preserving methods
        if isinstance(func, ast.Attribute) and name in _METHOD_PASSTHROUGH \
                and not isinstance(func.value, ast.Name) or (
                isinstance(func, ast.Attribute) and name in _METHOD_PASSTHROUGH
                and isinstance(func.value, ast.Name)
                and func.value.id in self.env):
            return self._eval(func.value)

        if name == "where":
            if len(argvals) >= 3:
                out, mismatch = _unify(argvals[1], argvals[2])
                if mismatch:
                    self.findings.append((node.lineno, (
                        f"unit mismatch: where(..) branches carry "
                        f"{argvals[1]!r} vs {argvals[2]!r}")))
                return out
            return ANY
        if name == "einsum":
            out: AbstractVal = Literal()
            for v in argvals[1:]:
                out = _mul(out, v)
            return out
        if name in _PRODUCT:
            if len(argvals) >= 2:
                return _mul(argvals[0], argvals[1])
            return argvals[0] if argvals else ANY
        if name in _UNIFY:
            vals = argvals + [v for k, v in kwvals.items()
                              if k in ("a_min", "a_max", "min", "max")]
            out = ANY
            mismatch_pair = None
            for v in vals:
                new, mismatch = _unify(out, v)
                if mismatch:
                    mismatch_pair = (out, v)
                out = new
            if mismatch_pair is not None:
                self.findings.append((node.lineno, (
                    f"unit mismatch: `{name}(..)` arguments carry "
                    f"{mismatch_pair[0]!r} vs {mismatch_pair[1]!r}")))
            return out
        if name in _PASSTHROUGH:
            return argvals[0] if argvals else ANY
        if name in _DIMLESS:
            for v in argvals:
                if isinstance(v, Unit) and not v.dimensionless:
                    self.findings.append((node.lineno, (
                        f"`{name}()` applied to a dimensioned quantity "
                        f"({v!r}): transcendental/logical functions take "
                        "dimensionless arguments — normalize first")))
            return DIMENSIONLESS
        if name in _LITERAL_MAKERS:
            return Literal()
        if name in ("max", "min") and isinstance(func, ast.Name):
            out = ANY
            for v in argvals:
                out, _ = _unify(out, v)
            return out
        if name in ("float", "int", "round") and isinstance(func, ast.Name):
            return argvals[0] if argvals else ANY
        return ANY

    def _check_sig_args(self, node: ast.Call, tgt: Tuple[str, str],
                        sig: Dict[str, str], argvals: List[AbstractVal],
                        kwvals: Dict[str, AbstractVal]) -> None:
        """Declared parameter units vs what the call site passes."""
        table = self.graph.tables.get(tgt[0])
        fn = table.functions.get(tgt[1]) if table else None
        if fn is None:
            return
        a = fn.args
        params = [p.arg for p in a.posonlyargs + a.args]
        named = dict(zip(params, argvals))
        named.update({k: v for k, v in kwvals.items() if k in sig})
        for pname, got in named.items():
            decl = sig.get(pname)
            if decl is None or not isinstance(got, Unit):
                continue
            try:
                want = parse_unit_decl(decl)[0]
            except ValueError:
                continue
            if isinstance(want, Unit) and got != want:
                self.findings.append((node.lineno, (
                    f"`{tgt[1]}(..., {pname}=...)` expects {want!r} but the "
                    f"call passes {got!r}")))

    def _check_ctor(self, node: ast.Call, cls: str,
                    kwvals: Dict[str, AbstractVal],
                    argvals: Optional[List[AbstractVal]] = None) -> None:
        fields = self.world.class_fields.get(cls)
        if not fields:
            return
        bound = dict(kwvals)
        if argvals and not any(isinstance(a, ast.Starred) for a in node.args):
            bound.update(zip(self.world.class_order.get(cls, []), argvals))
        for pname, got in bound.items():
            want = fields.get(pname)
            if isinstance(want, Unit) and isinstance(got, Unit) \
                    and got != want:
                self.findings.append((node.lineno, (
                    f"`{cls}({pname}=...)` expects {want!r} (declared in "
                    f"the class unit table) but the value carries {got!r}")))


# ---------------------------------------------------------------------------
# magic-factor scan
# ---------------------------------------------------------------------------

def _magic_scan(project: Project, module: str,
                out: List[Violation]) -> None:
    """Bare numeric factors >= MAGIC_THRESHOLD in a ``*``/``/`` are unit
    conversions in disguise — they must be a named constant from
    ``repro_torch.units`` (declared with ``# lint: unit(...)``) or carry a
    reasoned ``unit-ok``/``unit`` pragma on the line."""
    sf = project.module(module)
    if sf is None or sf.tree is None:
        return
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.BinOp):
            continue
        if not isinstance(node.op, (ast.Mult, ast.Div, ast.FloorDiv)):
            continue
        for side in (node.left, node.right):
            v = _const_fold(side)
            if v is None or abs(v) < MAGIC_THRESHOLD:
                continue
            line = side.lineno
            for directive in ("unit", "unit-ok"):
                p = project.pragma_at(sf.relpath, line, directive)
                if p is not None:
                    project.use_pragma(sf.relpath, line)
                    break
            else:
                out.append(Violation(
                    sf.relpath, line, "units",
                    f"magic scale factor {v!r} in a multiplication/"
                    "division — unit conversions go through a named "
                    "constant in repro_torch.units (declared with # lint: "
                    "unit(...)), so the dimensional analysis can see "
                    "them"))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def check(project: Project) -> List[Violation]:
    """Run the units checker over every module in UNIT_MODULES."""
    graph = Graph(project)
    world = UnitWorld(project, graph)
    out: List[Violation] = list(world.violations)
    for module in UNIT_MODULES:
        sf = project.module(module)
        if sf is None or sf.tree is None:
            continue
        _magic_scan(project, module, out)
        table = graph.tables.get(module)
        if table is None:
            continue
        for qualname, fn in sorted(table.functions.items()):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            scan = FunctionScan(world, module, qualname, fn)
            for line, msg in scan.findings:
                p = project.pragma_at(sf.relpath, line, "unit-ok")
                if p is not None:
                    project.use_pragma(sf.relpath, line)
                    continue
                out.append(Violation(sf.relpath, line, "units", msg))
    return out
