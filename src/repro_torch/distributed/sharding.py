"""Sharding rules: parameter path -> spec, DTensor placements, activation constraints.

The port of ``repro.distributed.sharding``. The production mesh's dims are
("data", "model") per pod, plus a leading "pod" dim in the multi-pod mesh
(``launch/mesh.py``). Tensor dims are assigned as in the reference:

  * batch                -> ("pod", "data")   (data parallel across pods and hosts)
  * attention/MLP width  -> "model"           (tensor / expert parallel)
  * parameter storage    -> optionally also "data" (FSDP), flag-gated

A *spec* is a tuple with one entry per tensor dim: a mesh dim name, a tuple
of names, or None, the port's form of a ``PartitionSpec``. The rules are pure
functions of the mesh's dim names and sizes, so they take a
``torch.distributed.device_mesh.DeviceMesh`` or any stand-in with
``mesh_dim_names`` and ``shape``: the 16 x 16 and 2 x 16 x 16 layouts are
computed without 256 processes. Every rule checks divisibility against the
mesh dim's size and replicates a dim that does not divide (whisper's 51865
vocab), as the reference does.

:func:`to_placements` turns a spec into DTensor placements (``Shard``,
``Replicate``); :func:`apply_shardings` distributes a parameter tree.
:func:`constrain` redistributes an activation DTensor to a spec of the
mesh installed by :func:`use_mesh`, and returns ``x`` itself without one, so
the model code runs un-meshed unchanged. ``use_mesh`` also lets plain
tensors (positions, constants) mix with DTensors as replicated values.

The port keeps a decoder's layers as a list ``stack/layers/<i>/<leaf>``
(``convert.py``), where the reference scans a uniform stack as
``stack/layers/<leaf>`` with a leading depth dim and unrolls a hybrid one as
``stack/blocks/<i>/<leaf>``. :func:`param_specs` translates each port leaf
to the reference's path and shape, by how the reference builds the arch
(:func:`scanned`), before the rule reads it: the rule finds the depth dim
by the ``layers/`` in the path, so a port path read as it is would shard
the wrong dim of every per-layer leaf.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import re
from typing import Any, Optional, Sequence, Tuple

import torch

from ..configs.base import ATTN
from ..tree import tree_map

_ACTIVE_MESH: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_active_mesh", default=None)

BATCH_AXES = ("pod", "data")
Spec = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# the active mesh
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` for activation constraints (None: un-meshed). Under a
    mesh, a plain tensor that meets a DTensor in an op counts as replicated."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import implicit_replication
            with implicit_replication():
                yield
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh():
    return _ACTIVE_MESH.get()


# ---------------------------------------------------------------------------
# pure rules over dim names and sizes
# ---------------------------------------------------------------------------

def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _sizes(mesh) -> dict:
    return dict(zip(_names(mesh), tuple(mesh.shape)))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def mesh_batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in _names(mesh))


def dp_axes(mesh, batch: int) -> Optional[Tuple[str, ...]]:
    """As much of the batch axes as divides ``batch`` ("pod" dropped first)."""
    axes = mesh_batch_axes(mesh)
    while axes and batch % axis_size(mesh, axes) != 0:
        axes = axes[1:]
    return axes if axes else None


def batch_spec(mesh, batch: int, extra_dims: int = 0) -> Spec:
    """Shard a leading batch dim over as much of the batch axes as divides."""
    return (dp_axes(mesh, batch),) + (None,) * extra_dims


def _maybe(mesh, axes, dim: int):
    """``axes`` for a dim of size ``dim`` only if it divides evenly."""
    if axes is None or dim % axis_size(mesh, axes) != 0:
        return None
    if isinstance(axes, (tuple, list)) and len(axes) == 1:
        return axes[0]
    return axes


def _param_spec(mesh, path: str, shape: Tuple[int, ...], fsdp: bool) -> Spec:
    """Partition rule for one parameter leaf, on the reference's path and shape.

    Scanned stacks live under ``layers/`` (or ``groups/``) with a leading
    depth dim, which is never sharded."""
    stacked = bool(re.search(r"(layers|groups)/", path)) and len(shape) >= 2
    core = shape[1:] if stacked else shape
    lead: Spec = (None,) if stacked else ()
    dp = "data" if fsdp else None

    def out(*axes) -> Spec:
        return lead + tuple(axes)

    leaf = "/".join(path.rsplit("/", 2)[-2:])
    if len(core) == 0:
        return out()
    if "embed/w" in path or "pos_embed" in path:
        # (vocab, d): shard the model dim; vocab replicated (gather-friendly)
        return out(None, _maybe(mesh, "model", core[-1]))
    if len(core) == 3 and "experts" in path:
        e, a, b = core
        if _maybe(mesh, "model", e):
            # expert parallel: experts over "model", optional fsdp inside
            if leaf.endswith("w_out/w"):
                return out("model", None, _maybe(mesh, dp, b))
            return out("model", _maybe(mesh, dp, a), None)
        # experts not divisible (qwen2-moe's 60): shard the ffn width instead
        if leaf.endswith("w_out/w"):
            return out(None, _maybe(mesh, "model", a), _maybe(mesh, dp, b))
        return out(None, _maybe(mesh, dp, a), _maybe(mesh, "model", b))
    if len(core) == 2:
        d_in, d_out = core
        if any(k in path for k in ("wo/", "w_out/", "down/")):
            return out(_maybe(mesh, "model", d_in), _maybe(mesh, dp, d_out))
        # default: output-feature sharding (wq/wk/wv/w_in/w_gate/router/head)
        return out(_maybe(mesh, dp, d_in), _maybe(mesh, "model", d_out))
    if len(core) == 1:
        # biases of model-sharded projections follow their outputs; norms and
        # small recurrence params replicate
        if any(k in path for k in ("wq/", "wk/", "wv/", "w_in/", "w_gate/")):
            return out(_maybe(mesh, "model", core[0]))
        return out(None)
    return out(*([None] * len(core)))


def _cache_spec(mesh, path: str, shape: Tuple[int, ...], batch: int) -> Spec:
    """Partition rule for a decode-cache / recurrent-state leaf, on the
    reference's path and shape: KV caches shard their sequence dim over
    "model" and batch over the batch axes."""
    dpa = dp_axes(mesh, batch)
    leaf = path.rsplit("/", 1)[-1]
    nd = len(shape)
    if nd == 0:
        return ()
    stacked = nd >= 2 and shape[0] != batch and shape[1] == batch
    lead: Spec = (None,) if stacked else ()
    core = shape[1:] if stacked else shape

    def out(*axes) -> Spec:
        return lead + tuple(_maybe(mesh, a, d) for a, d in zip(axes, core))

    if leaf in ("k", "v", "cross_k", "cross_v") and len(core) == 4:
        return out(dpa, "model", None, None)  # (B, S, KVH, hd): shard seq
    if leaf == "pos":
        return lead if len(core) == 0 else out(dpa)
    if leaf == "conv_buf" and len(core) == 3:
        return out(dpa, None, "model")
    if leaf == "h" and len(core) == 2:
        return out(dpa, "model")
    if len(core) >= 1:
        return out(dpa, *([None] * (len(core) - 1)))
    return ()


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [_map_with_path(fn, c, f"{prefix}{i}/") for i, c in enumerate(tree)]
        return type(tree)(*children) if hasattr(tree, "_fields") else type(tree)(children)
    return fn(prefix[:-1], tree)


def scanned(cfg) -> bool:
    """Whether the reference scans this arch's stack (``stack/layers`` with a
    leading depth dim) rather than unrolling it (``stack/blocks/<i>``):
    ``repro.models.transformer._uniform``."""
    return bool(cfg.scan_layers) and set(cfg.pattern()) == {ATTN}


_LAYER = re.compile(r"^stack/layers/(\d+)/(.*)$")


def _reference_path(path: str, shape: Tuple[int, ...], cfg) -> Tuple[str, Tuple[int, ...], bool]:
    """The reference's (path, shape) of a port leaf, and whether the
    reference's spec has a leading depth entry to drop."""
    m = _LAYER.match(path)
    if m is None:
        return path, shape, False
    if cfg is None:
        raise ValueError(f"{path}: the stack's layout needs the model config (cfg=...)")
    i, rest = m.groups()
    if scanned(cfg):
        return f"stack/layers/{rest}", (cfg.num_layers,) + tuple(shape), True
    return f"stack/blocks/{i}/{rest}", tuple(shape), False


def param_specs(params: Any, mesh, fsdp: bool = False, *, cfg=None):
    """A tree of specs mirroring the port's ``params`` (tensors or anything
    with ``.shape``); ``cfg`` says how the reference lays out the stack."""

    def rule(path, leaf):
        ref_path, shape, depth = _reference_path(path, tuple(leaf.shape), cfg)
        spec = _param_spec(mesh, ref_path, shape, fsdp)
        return spec[1:] if depth else spec

    return _map_with_path(rule, params)


def cache_specs_tree(cache: Any, mesh, batch: int):
    """Specs of a cache tree in the reference's layout (paths and shapes as
    the reference builds them)."""
    return _map_with_path(lambda path, leaf: _cache_spec(mesh, path, tuple(leaf.shape), batch),
                          cache)


def place_cache(cache: Any, batch: int):
    """Under the active mesh, every tensor of a decode-cache tree on the
    placements of its spec (:func:`_cache_spec`: KV caches sharded by
    sequence over "model" and by ``batch`` rows over the batch axes),
    whatever its current placement; un-meshed, ``cache`` itself. A plain
    tensor is the same on every rank (zeros), so each rank keeps its own
    slice of it without a collective."""
    mesh = active_mesh()
    if mesh is None:
        return cache
    from torch.distributed.tensor import distribute_tensor

    def put(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf  # a layer's position
        placements = to_placements(_cache_spec(mesh, path, tuple(leaf.shape), batch), mesh)
        if not is_dtensor(leaf):
            return distribute_tensor(leaf, mesh, placements, src_data_rank=None)
        if tuple(leaf.placements) == placements:
            return leaf
        return leaf.redistribute(mesh, placements)

    return _map_with_path(put, cache)


def batch_specs_tree(batch_tree: Any, mesh, batch: int):
    """Model-input specs: shard dim 0 (batch) over the batch axes."""
    return _map_with_path(lambda path, leaf: batch_spec(mesh, batch, len(leaf.shape) - 1),
                          batch_tree)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec: Sequence[Any], mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim, ``Shard(d)``
    on each mesh dim that names tensor dim ``d`` (a tuple of names is sharded
    major to minor in the mesh's dim order, as the reference's), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = _names(mesh)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes,) if isinstance(axes, str) else axes:
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"spec {spec}: mesh dim {a!r} shards two tensor dims")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def param_shardings(params: Any, mesh, fsdp: bool = False, *, cfg=None):
    """A tree of placement tuples mirroring ``params``."""
    specs = param_specs(params, mesh, fsdp, cfg=cfg)
    return tree_map(lambda p, spec: to_placements(spec, mesh), params, specs)


def apply_shardings(params: Any, mesh, fsdp: bool = False, *, cfg=None):
    """Distribute a tree of full tensors (the same on every rank) onto
    ``mesh``, leaf by leaf, by the partition rules."""
    from torch.distributed.tensor import distribute_tensor

    specs = param_specs(params, mesh, fsdp, cfg=cfg)
    return tree_map(lambda p, spec: distribute_tensor(p, mesh, to_placements(spec, mesh)),
                    params, specs)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _fixed(mesh, x, axes) -> Spec:
    """The reference's ``constrain`` spec: names absent from the mesh dropped,
    dims that do not divide replicated."""
    names = _names(mesh)
    fixed = []
    for dim, a in zip(x.shape, axes):
        if isinstance(a, tuple):
            a = tuple(n for n in a if n in names) or None
        if isinstance(a, str) and a not in names:
            a = None
        fixed.append(_maybe(mesh, a, dim))
    return tuple(fixed)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to ``axes`` (one entry per dim: a mesh dim
    name, a tuple of names or None) on the active mesh; ``x`` itself
    un-meshed, or when it is a plain tensor."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    placements = to_placements(_fixed(mesh, x, axes), mesh)
    if tuple(x.placements) == placements:
        return x
    y = x.redistribute(x.device_mesh, placements)
    local = y.to_local()
    if local.is_contiguous():
        return y
    # leaving a dim sharded unevenly (whisper's 1500 frames over 16) gives a
    # padded shard's narrowed view, which DTensor's ``view`` (inside ``@``)
    # cannot flatten
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), y.device_mesh, placements, run_check=False,
                              shape=y.shape, stride=y.stride())


def split_heads(x: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``x`` (..., heads * head_dim) as (..., heads, head_dim). A DTensor whose
    last dim is sharded over a mesh dim that does not divide ``heads`` (8 kv
    heads on a 16-wide "model" dim) is gathered there first: DTensor cannot
    split a sharded dim unevenly, and ``constrain`` replicates such heads
    anyway, as the reference's does."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        last = x.ndim - 1
        placements = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                           and heads % x.device_mesh.size(i) else p
                           for i, p in enumerate(x.placements))
        if placements != tuple(x.placements):
            x = x.redistribute(x.device_mesh, placements)
    return x.reshape(*x.shape[:-1], heads, head_dim)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., heads, head_dim) as (..., heads * head_dim). A DTensor whose
    heads and head dims are not sharded is merged on each rank's local tensor,
    so that its gradient comes back on ``x``'s own placements: DTensor's
    reshape would split the gradient as it arrives, its last dim sharded by
    the output projection, and cannot split it unevenly (56 heads over 16)."""
    merged = (*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if not is_dtensor(x) or any(getattr(p, "dim", -1) >= x.ndim - 2 for p in x.placements):
        return x.reshape(merged)
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    stride = tuple(math.prod(merged[i + 1:]) for i in range(len(merged)))
    return DTensor.from_local(local.reshape(*local.shape[:-2], -1), x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(merged), stride=stride)


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Shard dim 0 as batch, replicate the rest."""
    return constrain(x, BATCH_AXES, *([None] * (x.ndim - 1)))


def row_placements(mesh, batch: int):
    """(rows, sums, whole): the placements of a tensor whose leading dim of
    ``batch`` rows is sharded over the batch axes that divide it and whole on
    the other mesh dims; of each rank's partial sum over its rows; and of a
    tensor whole everywhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dp = dp_axes(mesh, batch) or ()
    names = _names(mesh)
    return ([Shard(0) if n in dp else Replicate() for n in names],
            [Partial() if n in dp else Replicate() for n in names],
            [Replicate()] * len(names))


def by_rows(fn, params, x, *state):
    """``fn(params, x, *state)`` on each rank's own batch rows of the DTensor
    ``x`` (B, ...) and of the trees ``state`` (a recurrence's carried state,
    leading dim B), with ``params`` whole: for plain ops that have no DTensor
    rule (the recurrences over the sequence). Every tensor of the result is
    sharded as the rows; the parameters' gradients are partial sums over the
    batch axes."""
    from torch.distributed.tensor import DTensor

    mesh = x.device_mesh
    rows, sums, whole = row_placements(mesh, x.shape[0])
    local = tree_map(lambda t: t.redistribute(mesh, whole).to_local(grad_placements=sums)
                     if is_dtensor(t) else t, params)
    own = [tree_map(lambda t: t.redistribute(mesh, rows).to_local() if is_dtensor(t) else t, s)
           for s in (x, *state)]
    return tree_map(lambda y: DTensor.from_local(y, mesh, rows, run_check=False)
                    if isinstance(y, torch.Tensor) else y, fn(local, *own))


def write_at(x, value, dim: int, index: int) -> None:
    """Set index ``index`` of ``dim`` of the DTensor ``x`` to ``value`` in
    place, each rank in its own shard: the rank whose span of ``dim`` holds
    ``index`` writes its rows of ``value`` there, the others write nothing,
    and nothing of ``x`` moves (where ``x[:, index] = value`` on a DTensor
    sharded on ``dim`` gathers all of ``x``). ``value`` is laid out as ``x``
    less ``dim``; it is redistributed to ``x``'s shards of the other dims."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    placements = [Shard(p.dim - (p.dim > dim)) if isinstance(p, Shard) and p.dim != dim
                  else Replicate() for p in x.placements]
    if is_dtensor(value):
        if tuple(value.placements) != tuple(placements):
            value = value.redistribute(mesh, placements)
        value = value.to_local()
    # this rank's span of ``dim``: DTensor's chunks (ceil-sized), mesh dim by mesh dim
    start, size = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // mesh.size(i))
            lo = mesh.get_coordinate()[i] * chunk
            start, size = start + lo, max(0, min(chunk, size - lo))
    if start <= index < start + size:
        x.to_local().select(dim, index - start).copy_(value)


def full(x):
    """A DTensor's full value on every rank (a collective); ``x`` otherwise."""
    return x.full_tensor() if is_dtensor(x) else x
