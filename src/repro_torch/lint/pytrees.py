"""Pytree contracts: declared shape/dtype schemas for the NamedTuple
pytrees that cross the engine boundary.

The port of ``repro.lint.pytrees``: the same schemas over the port's
classes, and a runtime check over torch tensors.

``EnvParams``, ``FaultTrace`` and ``CapabilityBundle`` are the repo's data
planes — every solver, engine and fault path consumes them positionally and
by leaf shape. The schemas below pin, per field, the symbolic shape
(``I`` task types × ``D`` data centers × ``S`` demand sources × literal
``24`` hours) and the leaf kind, and are enforced twice:

- **statically** (``check``): the class declaration must match the schema
  field-for-field in order (adding a field forces a schema update here,
  which is the point — the schema is the reviewable contract), and every
  construction site must be *total*: keyword construction must pass every
  field exactly once, positional construction must cover the full arity.
  A partial construction is how a new field silently picks up a wrong
  default.
- **at runtime** (``validate``, opt-in): leaf ndim/shape unification
  against the symbolic dims, plus torch's hazards: a float64 ``ARRAY``
  leaf (a numpy float64 array turned tensor runs the whole day in fp64,
  at a fraction of the card's fp32 rate), ``ARRAY`` leaves on more than
  one device (a CPU leaf among card leaves is a host-to-device copy at
  every use, and a sync), and a ``HOST`` leaf that is not a numpy array.
  Torch has no weak types: the reference's weak-type hazard (a literal
  whose dtype forks the jit cache when it meets a strongly typed operand)
  has the mixed-device leaf as its counterpart, the leaf that quietly
  changes what every use of the tree costs.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .project import Project, Violation

Dim = Union[str, int]

#: leaf kinds: float32 tensor on the engine's device | host-side numpy array
#: | opaque
ARRAY, HOST, OPAQUE = "array", "host", "opaque"


class FieldSpec:
    def __init__(self, dims: Sequence[Dim], kind: str = ARRAY):
        self.dims = tuple(dims)
        self.kind = kind

    def render(self) -> str:
        return "(" + ", ".join(str(d) for d in self.dims) + ")"


#: class name -> (defining module, ordered field schemas)
SCHEMAS: Dict[str, Tuple[str, Dict[str, FieldSpec]]] = {
    "EnvParams": ("repro_torch.dcsim.env", {
        "er":         FieldSpec(("I", "D")),
        "it_idle":    FieldSpec(("D",)),
        "it_dyn":     FieldSpec(("D",)),
        "tsupply":    FieldSpec(("D",)),
        "eff":        FieldSpec(("D",)),
        "rp":         FieldSpec(("D", 24)),
        "carbon":     FieldSpec(("D", 24)),
        "eprice":     FieldSpec(("D", 24)),
        "peak_price": FieldSpec(("D",)),
        "alpha":      FieldSpec(("D",)),
        "nprice":     FieldSpec(()),
        "sizes":      FieldSpec(("I",)),
        "nn_total":   FieldSpec(("D",)),
        "car":        FieldSpec(("I", 24)),
        "avail":      FieldSpec(("D", 24)),
        "rtt":        FieldSpec(("D", "D")),
        "sla_ms":     FieldSpec(("I",)),
        "sla_price":  FieldSpec(("I",)),
        "sla_weight": FieldSpec(()),
        "origin":     FieldSpec(("S", "I", 24)),
    }),
    "FaultTrace": ("repro_torch.faults.trace", {
        "avail_mult":   FieldSpec(("D", 24)),
        "rtt_extra_ms": FieldSpec(("D", "D", 24)),
        "price_mult":   FieldSpec(("D", 24)),
        "carbon_mult":  FieldSpec(("D", 24)),
    }),
    "CapabilityBundle": ("repro_torch.dcsim.capability", {
        "task_names": FieldSpec(("I",), OPAQUE),   # tuple of labels
        "er":         FieldSpec(("I", "D"), HOST),
        "it_idle":    FieldSpec(("D",), HOST),
        "it_dyn":     FieldSpec(("D",), HOST),
        "nn_total":   FieldSpec(("D",), HOST),
        "sizes":      FieldSpec(("I",), HOST),
        "sla_ms":     FieldSpec(("I",), HOST),
        "meta":       FieldSpec((), OPAQUE),
    }),
}


# ---------------------------------------------------------------------------
# static side
# ---------------------------------------------------------------------------

def _class_fields(tree: ast.Module, cls: str) -> Optional[List[Tuple[str, int]]]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return [(n.target.id, n.lineno) for n in node.body
                    if isinstance(n, ast.AnnAssign)
                    and isinstance(n.target, ast.Name)]
    return None


def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def check(project: Project) -> List[Violation]:
    out: List[Violation] = []

    # 1. class declarations still match the schemas (field names AND order)
    for cls, (module, schema) in SCHEMAS.items():
        sf = project.module(module)
        if sf is None or sf.tree is None:
            out.append(Violation(
                f"src/{module.replace('.', '/')}.py", 1, "pytree",
                f"module `{module}` (declares {cls}) is missing or "
                "unparseable — its pytree contract is unverifiable"))
            continue
        declared = _class_fields(sf.tree, cls)
        if declared is None:
            out.append(Violation(
                sf.relpath, 1, "pytree",
                f"class `{cls}` not found in `{module}` — update the "
                "schema in repro_torch.lint.pytrees if it moved"))
            continue
        names = [n for n, _ in declared]
        if names != list(schema):
            extra = [n for n in names if n not in schema]
            missing = [n for n in schema if n not in names]
            line = declared[0][1] if declared else 1
            detail = []
            if extra:
                detail.append(f"fields {extra} have no schema entry")
            if missing:
                detail.append(f"schema fields {missing} are gone")
            if not detail:
                detail.append(f"field order changed to {names}")
            out.append(Violation(
                sf.relpath, line, "pytree",
                f"`{cls}` drifted from its declared schema: "
                + "; ".join(detail)
                + " — update SCHEMAS in repro_torch.lint.pytrees to match "
                "(the schema is the reviewed contract)"))

    # 2. construction sites are total
    for rel, sf in project.sources.items():
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            cls = _call_name(node)
            if cls not in SCHEMAS:
                continue
            schema = SCHEMAS[cls][1]
            fields = list(schema)
            if any(isinstance(a, ast.Starred) for a in node.args) or \
                    any(kw.arg is None for kw in node.keywords):
                continue   # *splat / **kwargs: arity is not statically known
            pos = len(node.args)
            kws = [kw.arg for kw in node.keywords]
            dupes = sorted({k for k in kws if kws.count(k) > 1
                            or k in fields[:pos]})
            unknown = sorted(k for k in kws if k not in fields)
            covered = set(fields[:pos]) | set(kws)
            missing = [f for f in fields if f not in covered]
            if pos > len(fields):
                out.append(Violation(
                    rel, node.lineno, "pytree",
                    f"`{cls}` constructed with {pos} positional args but "
                    f"has {len(fields)} fields"))
            elif unknown:
                out.append(Violation(
                    rel, node.lineno, "pytree",
                    f"`{cls}` constructed with unknown fields {unknown} — "
                    "not in its schema"))
            elif dupes:
                out.append(Violation(
                    rel, node.lineno, "pytree",
                    f"`{cls}` construction binds {dupes} twice"))
            elif missing:
                out.append(Violation(
                    rel, node.lineno, "pytree",
                    f"`{cls}` construction is partial: {missing} not "
                    "passed — every field must be bound explicitly so a "
                    "new field cannot silently pick up a stale default"))
    return out


# ---------------------------------------------------------------------------
# runtime side (opt-in; the only part that touches live arrays)
# ---------------------------------------------------------------------------

def _is_tensor(leaf) -> bool:
    return hasattr(leaf, "detach") and hasattr(leaf, "device")


def validate(tree, name: Optional[str] = None) -> None:
    """Validate a live pytree instance against its declared schema.

    Checks per-leaf ndim, unification of the symbolic dims (every ``D``
    the same size, literal ``24`` exact), and torch's leaf hazards: float64
    ``ARRAY`` leaves, ``ARRAY`` leaves spread over more than one device,
    and ``HOST`` leaves that are not numpy arrays. Raises ``TypeError``
    with every failure listed; returns the tree so it can be used inline:
    ``env = lint.validate(build_env(4))``. Reads only metadata: no leaf is
    copied or synchronized.
    """
    import numpy as np

    cls = name or type(tree).__name__
    if cls not in SCHEMAS:
        raise TypeError(
            f"no pytree schema declared for {cls!r}; known: "
            f"{sorted(SCHEMAS)}")
    schema = SCHEMAS[cls][1]
    errors: List[str] = []
    bind: Dict[str, int] = {}
    devices: Dict[str, List[str]] = {}
    for field, spec in schema.items():
        leaf = getattr(tree, field, None)
        if leaf is None:
            errors.append(f"{field}: missing")
            continue
        if spec.kind == OPAQUE:
            continue
        shape = getattr(leaf, "shape", None)
        if shape is None:
            errors.append(f"{field}: expected an array, got "
                          f"{type(leaf).__name__}")
            continue
        if len(shape) != len(spec.dims):
            errors.append(f"{field}: shape {tuple(shape)} has ndim "
                          f"{len(shape)}, schema says {spec.render()}")
        else:
            for dim, got in zip(spec.dims, shape):
                if isinstance(dim, int):
                    if got != dim:
                        errors.append(
                            f"{field}: shape {tuple(shape)} != schema "
                            f"{spec.render()}")
                        break
                elif bind.setdefault(dim, got) != got:
                    errors.append(
                        f"{field}: dim {dim}={got} contradicts "
                        f"{dim}={bind[dim]} bound earlier — the pytree's "
                        "axes disagree")
                    break
        if spec.kind == HOST:
            if not isinstance(leaf, np.ndarray):
                errors.append(
                    f"{field}: {type(leaf).__name__} leaf — the schema "
                    "declares a host-side numpy array (a tensor here moves "
                    "host setup onto the device or back)")
            continue
        if not _is_tensor(leaf):
            errors.append(
                f"{field}: {type(leaf).__name__} leaf — the schema "
                "declares a tensor on the engine's device")
            continue
        if leaf.is_floating_point() and leaf.element_size() > 4:
            errors.append(
                f"{field}: dtype {leaf.dtype} — a float64 leaf runs every "
                "use of it in fp64 (a numpy float64 array turned tensor "
                "upstream)")
        devices.setdefault(str(leaf.device), []).append(field)
    if len(devices) > 1:
        errors.append(
            "leaves on more than one device ("
            + "; ".join(f"{d}: {', '.join(fs)}" for d, fs in devices.items())
            + ") — a leaf off the engine's device is a copy and a sync at "
            "every use; move the whole tree")
    if errors:
        raise TypeError(
            f"{cls} violates its pytree schema:\n  " + "\n  ".join(errors))
    return tree
