"""Hour-purity checker: host syncs and host state reachable from the hour.

The port of ``repro.lint.purity``. The reference forbids host state inside
its jitted roots because a trace bakes one snapshot of it into a cached
artifact. The port traces nothing, but its hour body has two device-side
consumers with the same contract: CUDA-graph capture of the hour (a graph
replays its kernels, never the host code between them) and
``torch.func.vmap`` in the batched engine (one program over every row).
Anything that reads back to the host, draws from a global RNG or depends
on mutable module state breaks both, and on the card a read-back stalls
the stream every hour. This checker makes that a lint failure.

Mechanics: build a static call graph over the package's own source and walk
it from the *hour roots* — the functions whose bodies run every hour on
the device:

- ``repro_torch.core.experiment._hours`` (the scan, loop and month
  engines' hour loop) and ``_batched_hour`` (the batched engine's body
  under ``vmap``),
- every registered technique step (the six builtin ``solve_epoch``s, plus
  any function statically resolvable as ``step=`` or ``compute=`` at a
  ``register_technique`` call site: ``compute=`` is the ``solve_drawn``
  half that the batched engine runs under ``vmap``),
- the realized-fault execution path (``faults.failover.execute_hour``,
  ``faults.guard.guard_fractions``),
- the tap thunks (``game.tap_nash_residual``).

The ``draw=`` halves (``draw_epoch``) draw on the host from an explicit
``torch.Generator`` by design and are no roots of their own; a
``solve_epoch`` reaches them, so they are held to the same rules.

A *unit* is one top-level function or method together with everything
nested inside it (inner defs, lambdas, comprehensions) — closures passed to
``vmap`` run with their parent, so they are analyzed with it too. Edges
follow direct calls and bare references (callbacks) to functions
resolvable through this package's imports; external targets (``torch``
etc.) terminate the walk.

Flagged inside reachable units:

===============================  =========================================
pattern                          why it breaks the hour
===============================  =========================================
``time.time``/``perf_counter``   a host clock: a captured graph replays
                                 one reading forever
``np.random.*`` / ``random.*``   a host RNG outside the explicit
                                 generators
``torch.rand``/``randn``/...,    torch's global RNG: the port's rule is
``Tensor.uniform_``/... without  explicit generators (a draw on the
``generator=``,                  global state is neither reproducible
``torch.manual_seed``            nor the same on card and CPU)
``.item()`` / ``.tolist()`` /    a host sync: stalls the stream, fails
``.cpu()`` / ``.numpy()`` /      graph capture and ``vmap``
``torch.cuda.synchronize()`` /
``float()``/``int()``/``bool()``
on a possibly-tensor value
``if``/``while``/``assert``/     ``__bool__`` of a tensor: the same host
``not``/``and``/``or`` on a      sync, written implicitly
tensor
``nonzero()``/``unique()``/...,  an output sized by the data: the size is
one-argument ``torch.where``,    read back to the host
boolean-mask indexing
module-global mutation           the hour's behavior depends on host state
``print`` / ``open`` /``input``  host I/O from the hour
===============================  =========================================

A cast is exempt only when its whole argument is shape arithmetic:
``x.shape``, ``x.ndim``, ``x.dim()``, ``x.numel()``, ``x.size()``,
``len(...)``, ``np.prod`` over a shape tuple, calls of shape helpers
(``_row_shape()``), parameters annotated as Python ints or int tuples,
names bound from any of these, and arithmetic over them.
``float(peak.sum() / x.numel())`` is a sync.

A tensor is known statically only as a ``torch.*`` call, a tensor method
(``.any()``, ``.sum()``, ``.eq()``, ...), arithmetic, comparisons or items
of one, or a name bound from one in the unit; a mask as a comparison, a
mask method, or ``~``/``&``/``|`` of masks. A tensor used as a Python index
and a host-to-device copy are not seen. CUDA's sync debug mode is the
runtime witness (``chip_smoke.py``'s ``[lint]`` runs fd days' hours under
it).

Deliberate exceptions carry ``# lint: host-ok(reason)`` on the offending
line (see ``project.Pragma``); the obs tap buffer is the canonical one.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .project import Project, Violation

#: the declared hour roots: (module, top-level function) pairs. Renaming
#: one without updating this list is itself a lint failure (a silently
#: missing root would un-check everything reachable from it).
TRACED_ROOTS: Tuple[Tuple[str, str], ...] = (
    ("repro_torch.core.experiment", "_hours"),
    ("repro_torch.core.experiment", "_batched_hour"),
    ("repro_torch.core.game", "tap_nash_residual"),
    ("repro_torch.faults.failover", "execute_hour"),
    ("repro_torch.faults.guard", "guard_fractions"),
    ("repro_torch.core.force_directed", "solve_epoch"),
    ("repro_torch.core.genetic", "solve_epoch"),
    ("repro_torch.core.nash", "solve_epoch"),
    ("repro_torch.core.ddpg", "solve_epoch"),
    ("repro_torch.core.ppo_joint", "solve_epoch"),
    ("repro_torch.core.gt_drl", "solve_epoch"),
)

#: ``register_technique`` keywords whose value runs every hour
REGISTERED_STEP_KEYWORDS = ("step", "solve_epoch", "compute")

_HOST_CLOCKS = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.date.today",
}

#: torch's samplers: a draw on the global RNG unless ``generator=`` is given
_TORCH_SAMPLERS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial", "torch.poisson",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
    "torch._sample_dirichlet", "torch._standard_gamma",
}

#: in-place samplers of ``Tensor``, whatever the receiver resolves to
_TENSOR_SAMPLERS = {
    "uniform_", "normal_", "bernoulli_", "exponential_", "geometric_",
    "cauchy_", "log_normal_", "random_",
}

#: the global RNG's seeders: the hour never reseeds anything
_TORCH_SEEDERS = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all",
}

#: method calls that read a tensor back to the host
_HOST_READS = {"item", "tolist", "cpu", "numpy"}

_HOST_SYNCS = {"torch.cuda.synchronize"}

_HOST_IO = {"builtins.print", "builtins.open", "builtins.input"}

_MUTATORS = {"append", "extend", "add", "update", "pop", "popitem",
             "remove", "discard", "clear", "insert", "setdefault"}


def _impure_call(dotted: str, node: ast.Call) -> Optional[str]:
    """The violation message for a resolved dotted call name, or None."""
    if dotted in _HOST_CLOCKS:
        return (f"host clock `{dotted}` in hour code: a captured graph "
                "replays one reading forever")
    if dotted.startswith("numpy.random.") or dotted.startswith("random."):
        return (f"host RNG `{dotted}` in hour code: draw from the explicit "
                "torch.Generator the engine passes in")
    if dotted in _TORCH_SAMPLERS and not _has_generator(node):
        return (f"`{dotted}` without generator= in hour code: a draw on "
                "torch's global RNG (the port's rule is explicit "
                "generators, so card and CPU draw the same)")
    if dotted in _TORCH_SEEDERS:
        return (f"`{dotted}` in hour code: reseeds torch's global RNG "
                "(the port's rule is explicit generators)")
    if dotted in _HOST_SYNCS:
        return (f"host sync `{dotted}` in hour code: stalls the stream "
                "and breaks graph capture")
    if dotted in _HOST_IO:
        return f"host I/O `{dotted}` in hour code"
    return None


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


# ---------------------------------------------------------------------------
# per-module symbol tables
# ---------------------------------------------------------------------------

class ModuleTable:
    """What one module's names mean: imports, functions, top-level state."""

    def __init__(self, sf, package: str):
        self.sf = sf
        self.import_modules: Dict[str, str] = {}          # alias -> module fq
        self.import_objects: Dict[str, Tuple[str, str]] = {}  # alias -> (mod, name)
        self.functions: Dict[str, ast.AST] = {}           # top-level units
        self.globals: Set[str] = set()                    # module-level state
        if sf.tree is None:
            return
        for node in sf.tree.body:
            self._top_level(node, package)
        for cls in [n for n in sf.tree.body if isinstance(n, ast.ClassDef)]:
            for node in cls.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.functions[f"{cls.name}.{node.name}"] = node

    def _top_level(self, node: ast.AST, package: str) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                self.import_modules[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            base = _resolve_from(package, node.level, node.module)
            for a in node.names:
                if a.name == "*":
                    continue
                self.import_objects[a.asname or a.name] = (base, a.name)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.functions[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        self.globals.add(n.id)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(node.target, ast.Name):
                self.globals.add(node.target.id)
        elif isinstance(node, (ast.For, ast.With, ast.Try, ast.If)):
            for sub in ast.iter_child_nodes(node):
                self._top_level(sub, package)


def _resolve_from(package: str, level: int, module: Optional[str]) -> str:
    """Resolve a (possibly relative) ``from X import ...`` base module."""
    if level == 0:
        return module or ""
    parts = package.split(".")
    if level > 1:
        parts = parts[: len(parts) - (level - 1)]
    return ".".join(parts + ([module] if module else []))


class Graph:
    """Module tables + symbol resolution over one :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project
        self.tables: Dict[str, ModuleTable] = {}
        for fq, sf in project.by_module.items():
            package = fq if sf.relpath.endswith("__init__.py") else \
                fq.rsplit(".", 1)[0] if "." in fq else ""
            self.tables[fq] = ModuleTable(sf, package)

    def resolve_symbol(self, module: str, name: str,
                       _depth: int = 0) -> Optional[Tuple[str, str]]:
        """Follow re-exports to the (module, function) that defines
        ``name`` — or None when it lives outside the project."""
        if _depth > 8:
            return None
        t = self.tables.get(module)
        if t is None:
            return None
        if name in t.functions:
            return (module, name)
        if name in t.import_objects:
            mod, orig = t.import_objects[name]
            if mod in self.tables and orig not in self.tables.get(mod).functions \
                    and f"{mod}.{orig}" in self.tables:
                return None  # `from . import submod` — a module, not a func
            return self.resolve_symbol(mod, orig, _depth + 1)
        return None

    def dotted_of(self, import_modules: Dict[str, str],
                  import_objects: Dict[str, Tuple[str, str]], node: ast.AST,
                  locals_: Set[str]) -> Optional[str]:
        """Best-effort fully-qualified dotted name of a Name/Attribute
        chain, resolving the base through the given import maps (module
        imports merged with any function-level imports). External bases
        resolve to their real module path (``np.random.default_rng``
        -> ``numpy.random.default_rng``); unresolvable (locals, call
        results) -> None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = node.id
        parts.reverse()
        if base in locals_:
            return None
        if base in import_modules:
            return ".".join([import_modules[base]] + parts)
        if base in import_objects:
            mod, orig = import_objects[base]
            # `from . import game` imports a submodule; `from .game import f`
            # imports an object — both land in import_objects
            sub = f"{mod}.{orig}" if mod else orig
            if sub in self.tables or self.project.module(sub):
                return ".".join([sub] + parts)
            return ".".join([mod, orig] + parts) if mod else \
                ".".join([orig] + parts)
        if base in {"print", "open", "input", "float", "int", "bool"}:
            return ".".join(["builtins", base] + parts)
        return None


# ---------------------------------------------------------------------------
# unit analysis
# ---------------------------------------------------------------------------

def _unit_locals(fn: ast.AST) -> Set[str]:
    """Every name bound inside the unit (params, assignments, loop targets,
    comprehension vars, nested defs) — these shadow module symbols."""
    names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs
                        + ([a.vararg] if a.vararg else [])
                        + ([a.kwarg] if a.kwarg else [])):
                names.add(arg.arg)
        elif isinstance(node, ast.Lambda):
            a = node.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                names.add(arg.arg)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.comprehension,)):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    names.add(n.id)
    return names


#: attributes that hold a tensor's (or array's) static metadata
_SHAPE_ATTRS = {"shape", "ndim", "size"}

#: methods that read a tensor's static metadata
_SHAPE_METHODS = {"dim", "numel", "size"}

#: builtins that keep static arithmetic static
_STATIC_BUILTINS = {"len", "max", "min", "abs", "round", "sum", "int", "float"}

#: annotations of parameters that hold Python ints, never tensors
_STATIC_ANNOTATIONS = {"int", "Tuple[int, ...]", "Sequence[int]"}


def _cast_exempt(arg: ast.AST, shape_locals: frozenset = frozenset()) -> bool:
    """float()/int()/bool() args that need no host sync: the *whole*
    expression is shape arithmetic — literals, ``x.shape``/``x.ndim``/
    ``x.size`` and their items, ``x.dim()``/``x.numel()``/``x.size()``,
    shape helpers (``_row_shape()``, ``joint_shape()``), ``len()``,
    ``np.prod``/``math.prod`` and builtin arithmetic over any of these, and
    names bound from them. One value read anywhere in it
    (``peak.sum() / x.numel()``) makes the cast a sync."""
    if isinstance(arg, ast.Constant):
        return True
    if isinstance(arg, ast.Name):
        return arg.id in shape_locals
    if isinstance(arg, ast.Attribute):
        return arg.attr in _SHAPE_ATTRS or "shape" in arg.attr
    if isinstance(arg, ast.Subscript):
        return _cast_exempt(arg.value, shape_locals)
    if isinstance(arg, ast.BinOp):
        return (_cast_exempt(arg.left, shape_locals)
                and _cast_exempt(arg.right, shape_locals))
    if isinstance(arg, ast.UnaryOp):
        return _cast_exempt(arg.operand, shape_locals)
    if isinstance(arg, (ast.Tuple, ast.List)):
        return all(_cast_exempt(e, shape_locals) for e in arg.elts)
    if isinstance(arg, ast.IfExp):
        return all(_cast_exempt(e, shape_locals)
                   for e in (arg.test, arg.body, arg.orelse))
    if isinstance(arg, ast.Compare):
        return all(_cast_exempt(e, shape_locals)
                   for e in [arg.left] + arg.comparators)
    if isinstance(arg, ast.Call):
        func = arg.func
        if isinstance(func, ast.Name):
            if "shape" in func.id:
                return True
            if func.id == "len":
                return True
            return func.id in _STATIC_BUILTINS and all(
                _cast_exempt(a, shape_locals) for a in arg.args)
        if isinstance(func, ast.Attribute):
            if func.attr in _SHAPE_METHODS or "shape" in func.attr:
                return True
            # np.prod / math.prod over a shape tuple
            if func.attr == "prod" and isinstance(func.value, ast.Name) \
                    and func.value.id in {"np", "numpy", "math"}:
                return all(_cast_exempt(a, shape_locals) for a in arg.args)
    return False


def _bound_names(fn: ast.AST, pred, seed=()) -> frozenset:
    """Names assigned within the unit from expressions ``pred(value, names)``
    accepts, two propagation rounds over the names found so far."""
    out = set(seed)
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and pred(node.value, frozenset(out)):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                            out.add(n.id)
    return frozenset(out)


def _shape_locals(fn: ast.AST) -> frozenset:
    """Names that hold static shapes within the unit: parameters annotated
    as Python ints or int tuples (``row_shape: Tuple[int, ...]``), and names
    assigned from shape arithmetic (``shape = _row_shape(env, routed)``) —
    enough for the repo's ``int(np.prod(shape))`` idiom."""
    params = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                if arg.annotation is not None and \
                        ast.unparse(arg.annotation) in _STATIC_ANNOTATIONS:
                    params.add(arg.arg)
    return _bound_names(fn, _cast_exempt, params)


#: Tensor methods whose result is a tensor: truth-testing one is a host sync
_TENSOR_METHODS = {
    "any", "all", "sum", "mean", "max", "min", "amax", "amin", "abs",
    "prod", "norm", "eq", "ne", "gt", "ge", "lt", "le", "isnan", "isinf",
    "isfinite", "isclose", "allclose", "equal", "logical_not",
    "logical_and", "logical_or", "logical_xor", "count_nonzero", "argmax",
    "argmin", "bool",
}

#: ``torch.*`` calls that answer a Python value without reading a tensor
_TORCH_STATIC = {"torch.finfo", "torch.iinfo", "torch.device", "torch.Size",
                 "torch.dtype"}
_TORCH_STATIC_PREFIXES = ("is_", "are_", "get_", "has_")

#: calls whose output shape depends on the data: the size is read back
_DATA_SHAPED = {"nonzero", "argwhere", "masked_select", "unique",
                "unique_consecutive"}

#: calls that give a boolean mask
_MASK_CALLS = {"bool", "isnan", "isinf", "isfinite", "isclose", "eq", "ne",
               "gt", "ge", "lt", "le", "logical_not", "logical_and",
               "logical_or", "logical_xor"}


class UnitScan:
    """One unit's outgoing edges + impurity findings."""

    def __init__(self, graph: Graph, module: str, qualname: str,
                 fn: ast.AST):
        self.graph = graph
        self.table = graph.tables[module]
        self.module = module
        self.qualname = qualname
        self.fn = fn
        self.locals = _unit_locals(fn)
        self.shape_locals = _shape_locals(fn)
        # module imports merged with function-level ones (some helpers
        # import inside the function body)
        self.import_modules = dict(self.table.import_modules)
        self.import_objects = dict(self.table.import_objects)
        package = self.table.sf.module or ""
        for node in ast.walk(fn):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.import_modules[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                base = _resolve_from(package, node.level, node.module)
                for a in node.names:
                    if a.name != "*":
                        self.import_objects[a.asname or a.name] = (base, a.name)
        self.edges: Set[Tuple[str, str]] = set()
        self.findings: List[Tuple[int, str]] = []   # (line, message)
        self.tensor_locals = _bound_names(fn, self._tensor_valued)
        self.mask_locals = _bound_names(fn, self._is_mask)
        self._scan()

    def _dotted(self, node: ast.AST) -> Optional[str]:
        return self.graph.dotted_of(self.import_modules, self.import_objects,
                                    node, self.locals)

    def _edge_for(self, node: ast.AST) -> None:
        if isinstance(node, ast.Name):
            if node.id in self.locals:
                return
            if node.id in self.table.functions:
                self.edges.add((self.module, node.id))
            elif node.id in self.import_objects:
                tgt = self.graph.resolve_symbol(self.module, node.id)
                if tgt:
                    self.edges.add(tgt)
        elif isinstance(node, ast.Attribute):
            dotted = self._dotted(node)
            if dotted and dotted.startswith("repro_torch."):
                mod, _, name = dotted.rpartition(".")
                tgt = self.graph.resolve_symbol(mod, name)
                if tgt:
                    self.edges.add(tgt)

    def _tensor_valued(self, node: ast.AST,
                       names: frozenset = frozenset()) -> bool:
        """Whether ``node`` is (statically) a tensor: a ``torch.*`` call
        that answers a tensor, a tensor method (``.any()``, ``.sum()``,
        ``.eq()``...), arithmetic, comparisons, items or ``.values`` of
        one, or a name bound from one in this unit."""
        names = names or getattr(self, "tensor_locals", frozenset())
        if isinstance(node, ast.Call):
            dotted = self._dotted(node.func)
            if dotted and dotted.startswith("torch."):
                last = dotted.rsplit(".", 1)[1]
                return not (dotted in _TORCH_STATIC
                            or last.startswith(_TORCH_STATIC_PREFIXES))
            return dotted is None and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _TENSOR_METHODS
        if isinstance(node, ast.Compare):
            return any(self._tensor_valued(e, names)
                       for e in [node.left] + node.comparators)
        if isinstance(node, ast.BinOp):
            return self._tensor_valued(node.left, names) or \
                self._tensor_valued(node.right, names)
        if isinstance(node, ast.UnaryOp) and not isinstance(node.op, ast.Not):
            return self._tensor_valued(node.operand, names)
        if isinstance(node, ast.Subscript):
            return self._tensor_valued(node.value, names)
        if isinstance(node, ast.Attribute):
            return node.attr not in _SHAPE_ATTRS | {"dtype", "device"} \
                and self._tensor_valued(node.value, names)
        if isinstance(node, ast.Name):
            return node.id in names and node.id not in self.shape_locals
        return False

    def _is_mask(self, node: ast.AST, names: frozenset = frozenset()) -> bool:
        """Whether ``node`` is a boolean mask: a comparison, ``~``/``&``/
        ``|``/``^`` of masks, ``.bool()``/``isnan``/``eq``... or a name
        bound from one in this unit."""
        names = names or getattr(self, "mask_locals", frozenset())
        if isinstance(node, ast.Compare):
            return True
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._is_mask(node.operand, names)
        if isinstance(node, ast.BinOp) and \
                isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._is_mask(node.left, names) or \
                self._is_mask(node.right, names)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            dotted = self._dotted(node.func)
            return node.func.attr in _MASK_CALLS and (
                dotted is None or dotted.startswith("torch."))
        if isinstance(node, ast.Name):
            return node.id in names
        return False

    def _masked(self, sub: ast.Subscript) -> bool:
        idx = sub.slice
        elts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        return any(self._is_mask(e) for e in elts)

    def _truth_tested(self) -> List[ast.AST]:
        """Every expression whose ``__bool__`` Python calls: ``if``/
        ``while``/``assert``/conditional-expression/comprehension tests,
        ``not``'s operand, all but the last operand of ``and``/``or`` (and
        the last too when the ``and``/``or`` is itself tested)."""
        out: Dict[int, ast.AST] = {}

        def tested(e: ast.AST) -> None:
            if isinstance(e, ast.BoolOp):
                for v in e.values:
                    tested(v)
            elif isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Not):
                tested(e.operand)
            else:
                out[id(e)] = e

        for node in ast.walk(self.fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                tested(node.test)
            elif isinstance(node, ast.comprehension):
                for cond in node.ifs:
                    tested(cond)
            elif isinstance(node, ast.BoolOp):
                for v in node.values[:-1]:
                    tested(v)
            elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
                tested(node.operand)
        return list(out.values())

    def _scan(self) -> None:
        for e in self._truth_tested():
            if self._tensor_valued(e):
                self.findings.append((e.lineno, (
                    f"truth test of a tensor (`{ast.unparse(e)}`) in hour "
                    "code: `__bool__` is a host sync — keep the branch on "
                    "the device (`torch.where`) or test a static value")))
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Call):
                self._check_call(node)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and self._masked(node):
                self.findings.append((node.lineno, (
                    f"boolean-mask indexing (`{ast.unparse(node)}`) in hour "
                    "code: the result's size depends on the data, a host "
                    "sync — use `torch.where` or a multiply by the mask")))
            if isinstance(node, (ast.Name, ast.Attribute)) and \
                    isinstance(getattr(node, "ctx", None), ast.Load):
                self._edge_for(node)   # bare references: callbacks, partial()
            elif isinstance(node, ast.Global):
                self.findings.append((node.lineno, (
                    "module-global mutation (`global "
                    + ", ".join(node.names) + "`) in hour code: the "
                    "hour's behavior depends on host state")))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                self._check_store(node)

    def _check_call(self, node: ast.Call) -> None:
        func = node.func
        # nonzero() & co.: an output sized by the data is read back
        if isinstance(func, ast.Attribute) and func.attr in _DATA_SHAPED:
            dotted = self._dotted(func)
            if dotted is None or dotted.startswith("torch."):
                self.findings.append((node.lineno, (
                    f"`{dotted or '.' + func.attr}()` in hour code: its "
                    "output's size depends on the data, a host sync")))
                return
        if isinstance(func, ast.Attribute) and func.attr == "where" \
                and len(node.args) == 1 and not node.keywords \
                and self._dotted(func) == "torch.where":
            self.findings.append((node.lineno, (
                "one-argument `torch.where` in hour code: it is nonzero(), "
                "its output's size depends on the data, a host sync")))
            return
        # .item()/.tolist()/.cpu()/.numpy() read back to the host no matter
        # what the receiver resolves to
        if isinstance(func, ast.Attribute) and func.attr in _HOST_READS \
                and not node.args and not node.keywords:
            self.findings.append((node.lineno, (
                f"`.{func.attr}()` in hour code: a host sync on a device "
                "value (stalls the stream every hour, breaks graph capture "
                "and vmap)")))
            return
        # Tensor.uniform_() & co. on the global RNG
        if isinstance(func, ast.Attribute) and func.attr in _TENSOR_SAMPLERS \
                and not _has_generator(node):
            self.findings.append((node.lineno, (
                f"`.{func.attr}()` without generator= in hour code: a draw "
                "on torch's global RNG (the port's rule is explicit "
                "generators)")))
            return
        # mutation of module-level containers
        if isinstance(func, ast.Attribute) and func.attr in _MUTATORS \
                and isinstance(func.value, ast.Name) \
                and func.value.id not in self.locals \
                and func.value.id in self.table.globals:
            self.findings.append((node.lineno, (
                f"mutates module global `{func.value.id}.{func.attr}(...)` "
                "from hour code: the hour's behavior depends on host state")))
            return
        if isinstance(func, ast.Name) and func.id in {"float", "int", "bool"} \
                and func.id not in self.locals:
            if node.args and not _cast_exempt(node.args[0],
                                              self.shape_locals):
                self.findings.append((node.lineno, (
                    f"`{func.id}()` on a possibly-tensor value: a host "
                    "sync — keep it a tensor, or mark the line "
                    "# lint: host-ok(reason) if the value is static")))
            return
        dotted = self._dotted(func)
        if dotted:
            msg = _impure_call(dotted, node)
            if msg:
                self.findings.append((node.lineno, msg))

    def _check_store(self, node: ast.AST) -> None:
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            # x[mask] = tensor is index_put_ over mask.nonzero() (a scalar
            # right-hand side is masked_fill_, which stays on the device)
            if isinstance(t, ast.Subscript) and self._masked(t) and \
                    not isinstance(node.value, ast.Constant):
                self.findings.append((node.lineno, (
                    f"boolean-mask write (`{ast.unparse(t)}`) in hour code: "
                    "a tensor written through a mask indexes by nonzero(), "
                    "a host sync — use `torch.where`")))
            base = t
            while isinstance(base, (ast.Attribute, ast.Subscript)):
                base = base.value
            if isinstance(base, ast.Name) and base.id not in self.locals \
                    and base.id in self.table.globals and base is not t:
                self.findings.append((node.lineno, (
                    f"writes module global `{base.id}` from hour code: "
                    "the hour's behavior depends on host state")))


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

def _registered_step_roots(graph: Graph) -> Iterable[Tuple[str, str]]:
    """Extra roots: functions statically resolvable at
    ``register_technique(name, fn)`` / ``step=fn`` / ``compute=fn`` call
    sites, so solver registrations inside the package are walked without
    editing ``TRACED_ROOTS``."""
    for fq, table in graph.tables.items():
        if table.sf.tree is None or not fq.startswith("repro_torch."):
            continue
        for node in ast.walk(table.sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, (ast.Name, ast.Attribute))):
                continue
            name = (node.func.id if isinstance(node.func, ast.Name)
                    else node.func.attr)
            if name != "register_technique":
                continue
            cands = list(node.args[1:2]) + [
                kw.value for kw in node.keywords
                if kw.arg in REGISTERED_STEP_KEYWORDS]
            for cand in cands:
                if isinstance(cand, ast.Name):
                    tgt = graph.resolve_symbol(fq, cand.id)
                elif isinstance(cand, ast.Attribute):
                    dotted = graph.dotted_of(table.import_modules,
                                             table.import_objects, cand, set())
                    if not dotted:
                        continue
                    mod, _, nm = dotted.rpartition(".")
                    tgt = graph.resolve_symbol(mod, nm)
                else:
                    continue
                if tgt:
                    yield tgt


def check(project: Project) -> List[Violation]:
    graph = Graph(project)
    out: List[Violation] = []

    worklist: List[Tuple[str, str]] = []
    for mod, name in TRACED_ROOTS:
        table = graph.tables.get(mod)
        if table is None or name not in table.functions:
            out.append(Violation(
                "src/repro_torch/lint/purity.py", 1, "purity",
                f"declared hour root `{mod}:{name}` not found — update "
                "TRACED_ROOTS or restore the function (an unresolved root "
                "silently un-checks everything reachable from it)"))
            continue
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
        scan = UnitScan(graph, mod, name, fn)
        rel = table.sf.relpath
        for line, msg in scan.findings:
            pragma = project.pragma_at(rel, line, "host-ok")
            if pragma is not None:
                project.use_pragma(rel, line)
                continue
            out.append(Violation(rel, line, "purity",
                                 f"{msg} [reached from `{mod}:{name}`]"))
        worklist.extend(scan.edges)
    return out
