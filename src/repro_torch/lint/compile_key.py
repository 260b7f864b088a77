"""Engine-key completeness: every ``ExperimentSpec`` field that changes the
hour's program must join the engine key.

The port of ``repro.lint.compile_key``. The reference keys its jit cache by
the spec's static fields, and three of its changes each added a field that
changed the traced program but was left out of the key, so a stale artifact
kept dispatching. The port compiles nothing, but its ``_engine_key`` is the
key that ``obs.spans.dispatch`` counts hits and misses under and that run
records and the scoreboard join on: a field that changes a day's result but
is missing from the key would merge two different programs under one key
and one scoreboard row. It is also the key a cache of captured CUDA graphs
of the hour would be kept under. The checker cross-references, in source,
the four places a field can appear in ``repro_torch.core.experiment``:

1. the ``ExperimentSpec`` dataclass fields,
2. the ``self.<field>`` reads inside ``static_key``,
3. the ``spec.<field>`` reads inside the hour roots (``HOUR_ROOTS``, and
   the functions of the module they call: what actually shapes each hour),
4. the tuple ``_engine_key`` builds (the key ``run`` dispatches under).

and fails when they drift:

- a spec field read by an hour root that is not read by ``static_key`` —
  the dispatches of two programs would share one key;
- a spec field that is neither in ``static_key``, nor ``engine``/``taps``
  (keyed via ``kind``/``effective_taps``), nor explicitly annotated
  ``# lint: runtime-only(reason)`` on its declaration line — adding a new
  field forces a decision: join the key, or declare (with a reason) that
  it only selects runtime inputs. The seeded regression "delete
  ``workload`` from ``static_key``" trips here;
- a ``runtime-only`` field that *is* in ``static_key`` (contradiction);
- ``_engine_key``'s unpack of ``static_key`` drifting out of its order, or
  its return tuple drifting out of ``KEY_HEAD`` + the static fields +
  ``KEY_TAIL`` (records and the reference's key strings read it
  positionally, and ``obs.spans.dispatch`` runs the dispatch under the
  key's last element, the tap set);
- ``spec.effective_taps()`` missing from the key tuple (taps decide which
  values the hour keeps: a tapped and an untapped run would share a key).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from .project import Project, Violation

EXPERIMENT_PATH = "src/repro_torch/core/experiment.py"

#: the module-level functions whose bodies run each hour (the scan, loop
#: and month engines' hour loop; the batched engine's vmapped row)
HOUR_ROOTS = ("_hours", "_batched_hour")

#: fields keyed through a named transformation rather than static_key:
#: ``engine`` becomes the key's leading ``kind``; ``taps`` rides
#: ``spec.effective_taps()`` (the tap set the dispatch runs under).
INDIRECTLY_KEYED = {"engine", "taps"}

#: ``_engine_key``'s tuple around the static fields: the engine kind first,
#: the fault flags after, the tap set last (``dispatch`` reads ``key[-1]``)
KEY_HEAD = ("kind",)
KEY_TAIL = ("faulted", "fault_axis", "taps")


def _find(tree: ast.Module, name: str,
          cls: Optional[str] = None) -> Optional[ast.AST]:
    for node in tree.body:
        if cls is None and isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name == name:
            return node
        if cls is not None and isinstance(node, ast.ClassDef) \
                and node.name == cls:
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and sub.name == name:
                    return sub
    return None


def _self_reads(fn: ast.AST) -> List[str]:
    """``self.X`` attribute reads, in source order."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            out.append(node.attr)
    return out


def _spec_fields(cls: ast.ClassDef) -> Dict[str, int]:
    """Dataclass field name -> declaration line."""
    return {n.target.id: n.lineno for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)}


def _return_tuple(fn: ast.FunctionDef) -> Optional[Sequence[ast.expr]]:
    """The elements of the function's (last) ``return (a, b, ...)``."""
    rets = [n for n in ast.walk(fn) if isinstance(n, ast.Return)]
    for r in reversed(rets):
        if isinstance(r.value, ast.Tuple):
            return r.value.elts
    return None


def _key_element_name(e: ast.expr) -> Optional[str]:
    """Map one ``_engine_key`` return element to the spec concept it keys:
    plain names pass through; ``spec.effective_taps()`` counts as ``taps``."""
    if isinstance(e, ast.Name):
        return e.id
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
            and e.func.attr == "effective_taps":
        return "taps"
    return None


def _hour_spec_reads(tree: ast.Module) -> Dict[str, List[tuple]]:
    """``spec.<field>`` reads of the hour roots and of every module-level
    function they call, transitively: field -> [(function, line), ...]."""
    functions = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    reads: Dict[str, List[tuple]] = {}
    seen: Set[str] = set()
    work = [r for r in HOUR_ROOTS if r in functions]
    while work:
        name = work.pop()
        if name in seen:
            continue
        seen.add(name)
        for node in ast.walk(functions[name]):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and node.value.id == "spec":
                reads.setdefault(node.attr, []).append((name, node.lineno))
            elif isinstance(node, ast.Name) and node.id in functions:
                work.append(node.id)
    return reads


def check(project: Project) -> List[Violation]:
    sf = project.file(EXPERIMENT_PATH)
    if sf is None or sf.tree is None:
        return [Violation(EXPERIMENT_PATH, 1, "compile-key",
                          "cannot parse repro_torch/core/experiment.py — the "
                          "engine-key contract is unverifiable")]
    out: List[Violation] = []
    rel = sf.relpath

    spec_cls = _find(sf.tree, "ExperimentSpec")
    static_key = _find(sf.tree, "static_key", cls="ExperimentSpec")
    effective_taps = _find(sf.tree, "effective_taps", cls="ExperimentSpec")
    engine_key = _find(sf.tree, "_engine_key")
    required = [("ExperimentSpec", spec_cls),
                ("ExperimentSpec.static_key", static_key),
                ("_engine_key", engine_key)]
    required += [(r, _find(sf.tree, r)) for r in HOUR_ROOTS]
    for name, node in required:
        if node is None:
            out.append(Violation(
                rel, 1, "compile-key",
                f"`{name}` not found — the engine-key contract this "
                "checker enforces has moved; update "
                "repro_torch.lint.compile_key"))
    if any(node is None for _, node in required):
        return out

    fields = _spec_fields(spec_cls)
    key_fields = _self_reads(static_key)

    # 1. every spec field is keyed, indirectly keyed, or declared runtime-only
    for field, line in fields.items():
        if field in key_fields:
            if project.pragma_at(rel, line, "runtime-only"):
                project.use_pragma(rel, line)
                out.append(Violation(
                    rel, line, "compile-key",
                    f"spec field `{field}` is declared runtime-only but IS "
                    "read by static_key — one of the two is wrong"))
            continue
        if field in INDIRECTLY_KEYED:
            continue
        pragma = project.pragma_at(rel, line, "runtime-only")
        if pragma is not None:
            project.use_pragma(rel, line)
            continue
        out.append(Violation(
            rel, line, "compile-key",
            f"ExperimentSpec field `{field}` is in no engine key: join it "
            "to static_key() if it can change the hour's program, or "
            "annotate the field `# lint: runtime-only(reason)` if it only "
            "selects runtime inputs (two programs would otherwise share one "
            "key, one dispatch count and one scoreboard row)"))

    # 2. `taps`/`engine` indirection actually holds
    if effective_taps is None or "taps" not in _self_reads(effective_taps):
        out.append(Violation(
            rel, spec_cls.lineno, "compile-key",
            "ExperimentSpec.effective_taps() no longer reads self.taps — "
            "the taps field would fall out of the engine key"))
    eng_reads = [n.attr for n in ast.walk(engine_key)
                 if isinstance(n, ast.Attribute)
                 and isinstance(n.value, ast.Name) and n.value.id == "spec"]
    if "engine" not in eng_reads:
        out.append(Violation(
            rel, engine_key.lineno, "compile-key",
            "_engine_key no longer reads spec.engine — the engine kind "
            "would fall out of the engine key"))

    # 3. every spec field an hour root reads is keyed
    for field, sites in sorted(_hour_spec_reads(sf.tree).items()):
        if field in key_fields or field in INDIRECTLY_KEYED:
            continue
        fn, line = min(sites, key=lambda s: s[1])
        out.append(Violation(
            rel, line, "compile-key",
            f"hour code (`{fn}`) reads `spec.{field}`, which changes the "
            "hour's program, but ExperimentSpec.static_key() does not read "
            f"it — runs with different `{field}` values would dispatch "
            "under one engine key"))

    # 4. _engine_key's static_key unpack preserves static_key's field order
    unpack: Optional[List[str]] = None
    for node in ast.walk(engine_key):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Tuple) \
                and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Attribute) \
                and node.value.func.attr == "static_key":
            unpack = [e.id for e in node.targets[0].elts
                      if isinstance(e, ast.Name)]
    if unpack is None:
        out.append(Violation(
            rel, engine_key.lineno, "compile-key",
            "_engine_key no longer unpacks spec.static_key() — key "
            "construction has drifted from the declared static fields"))
    elif unpack != key_fields:
        out.append(Violation(
            rel, engine_key.lineno, "compile-key",
            f"_engine_key unpacks static_key() as {unpack} but static_key "
            f"returns {key_fields} — the unpack is positional, so order "
            "drift silently rebinds fields"))

    # 5. the key tuple has the declared layout
    ret = _return_tuple(engine_key)
    if ret is None:
        out.append(Violation(
            rel, engine_key.lineno, "compile-key",
            "_engine_key does not return a tuple literal — the key's "
            "positional layout is unverifiable"))
    else:
        key_names = [_key_element_name(e) for e in ret]
        want = list(KEY_HEAD) + key_fields + list(KEY_TAIL)
        if "taps" not in key_names:
            out.append(Violation(
                rel, engine_key.lineno, "compile-key",
                "spec.effective_taps() is missing from _engine_key's tuple "
                "— tapped and untapped runs would share one key"))
        elif key_names != want:
            out.append(Violation(
                rel, engine_key.lineno, "compile-key",
                f"_engine_key tuple {key_names} does not have the layout "
                f"{want} — records and key strings read it positionally, "
                "and dispatch runs under its last element, the tap set"))
    return out
