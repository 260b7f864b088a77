"""Public entry points of the attention kernels, with the dispatch seam.

``impl`` semantics:
  * ``auto``    — the CUDA kernels for a CUDA tensor (differentiable through
                  the backward kernel); their plain PyTorch version for a CPU
                  tensor (the wrapper decides from the tensor alone);
  * ``chunked`` — the streaming form with its own backward,
                  ``kernels/flash_vjp.py`` (attention only), as the
                  reference's ``impl="chunked"``;
  * ``ref``     — always the plain oracle of ``kernels/ref.py`` (of
                  ``models/layers.py`` for :func:`rope`).

The signatures are those of ``repro.kernels.ops`` less ``block_q`` /
``block_k``: the CUDA kernels' tiles are compile-time constants.

Under a mesh (``distributed/sharding.py``) ``attention`` takes DTensors and
calls the kernel once per shard on its local tensors (:func:`_per_shard`):
the kernels are autograd Functions with no DTensor sharding rule, and their
own code does not change. ``rope`` does the same on the card
(:func:`_rope_per_shard`); on the CPU its plain version takes the DTensors
as they are.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Tuple

import torch

from ..distributed.sharding import constrain, is_dtensor
from ..models.layers import apply_rope as _plain_rope
from . import ref as _ref
from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel
from .flash_vjp import flash_attention_torch as _chunked
from .rope import rope as _rope_kernel

IMPLS = ("auto", "chunked", "ref")
# the calls :func:`record_calls` collects (None: not collecting)
_CALLS: contextvars.ContextVar[Optional[List]] = contextvars.ContextVar(
    "repro_torch_attention_calls", default=None)


@contextlib.contextmanager
def record_calls():
    """Collect, into the list it yields, every attention call made inside as
    ``(kernel name, shapes)``: the shapes a rank's kernel would take (local
    shards under a mesh), as ``_build.shape_error``'s keyword arguments. The
    dry run holds them to the kernels' limits whatever ``impl`` ran."""
    calls: List = []
    token = _CALLS.set(calls)
    try:
        yield calls
    finally:
        _CALLS.reset(token)


def _note(name: str, q: torch.Tensor, k: torch.Tensor) -> None:
    """Record a call of ``name`` on q (B, [S,] H, D) and k (B, Skv, KVH, D)."""
    calls = _CALLS.get()
    if calls is not None:
        b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
        sq = q.shape[1] if q.ndim == 4 else 1
        calls.append((name, dict(b=b, sq=sq, skv=k.shape[1], h=h, d=d, dtype=q.dtype)))



def _check_impl(impl: str, impls=IMPLS) -> None:
    if impl not in impls:
        raise ValueError(f"impl {impl!r} not in {impls}")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
    softcap: float = 0.0,
    q_offset: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """Batched multi-head (GQA) attention, (B, S, H, D) layout."""
    _check_impl(impl)
    fn = {"auto": _flash_kernel, "chunked": _chunked, "ref": _ref.attention_ref}[impl]
    kw = dict(causal=causal, window=window, sm_scale=sm_scale, softcap=softcap)
    if is_dtensor(q):
        return _per_shard(fn, q, k, v, q_offset=q_offset, **kw)
    _note("flash_attention", q, k)
    return fn(q, k, v, q_offset=q_offset, **kw)


def kv_heads_of_shard(heads: int, kv_heads: int, rank: int, size: int):
    """The kv heads that the q heads ``[rank H/m, (rank + 1) H/m)`` read, as
    the list to gather from the whole k and v so that the kernel's GQA map
    ``h_local // (H_local / KVH_local)`` pairs each local q head with its own:
    one entry per local group when the shard's heads split evenly into
    groups, else one per q head."""
    local = heads // size
    group = heads // kv_heads
    idx = [(rank * local + h) // group for h in range(local)]
    uniq = sorted(set(idx))
    per = local // len(uniq)
    if local % len(uniq) == 0 and idx == [u for u in uniq for _ in range(per)]:
        return uniq
    return idx


def _per_shard(fn, q, k, v, *, q_offset: int, **kw):
    """Attention of DTensors q (B, S, H, D), k and v (B, Skv, KVH, D), the
    kernel called on each shard's local tensors.

    q's placement on "model" picks the split: ``Shard(2)`` (heads: k and v
    shard with q where their heads divide, else each shard gathers the kv
    heads its q heads read), ``Shard(1)`` (query rows: k and v whole, the
    shard's rows offset by its start) or ``Replicate`` (no split). On the
    batch dims k and v follow q. Where a shard reads only part of a whole k
    or v, its gradient there is a partial sum, reduced over "model".
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None
    split = None if mi is None else q.placements[mi]
    size = 1 if mi is None else mesh.size(mi)
    rank = 0 if mi is None else mesh.get_local_rank("model")
    heads, kv_heads = q.shape[2], k.shape[2]
    by_heads = split == Shard(2)
    if isinstance(split, Shard) and split.dim not in (1, 2):
        raise ValueError(f"attention: q sharded on dim {split.dim} over 'model'")
    kv_place, grad_place = list(q.placements), list(q.placements)
    if mi is not None:
        kv_place[mi] = Shard(2) if by_heads and kv_heads % size == 0 else Replicate()
        # a shard that reads part of a whole k or v holds a partial gradient
        partial = isinstance(split, Shard) and kv_place[mi] == Replicate()
        grad_place[mi] = Partial() if partial else kv_place[mi]

    def local(t):
        t = t.redistribute(mesh, kv_place) if tuple(t.placements) != tuple(kv_place) else t
        return t.to_local(grad_placements=grad_place)

    ql, kl, vl = q.to_local(), local(k), local(v)
    if by_heads and kv_place[mi] == Replicate():
        idx = torch.tensor(kv_heads_of_shard(heads, kv_heads, rank, size), device=kl.device)
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    elif split == Shard(1):
        q_offset = q_offset + rank * ql.shape[1]
    # the kernels take contiguous tensors: a shard's slice of heads is not
    ql, kl, vl = (t.contiguous() for t in (ql, kl, vl))
    _note("flash_attention", ql, kl)
    o = fn(ql, kl, vl, q_offset=q_offset, **kw).contiguous()
    return DTensor.from_local(o, mesh, q.placements, run_check=False)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, theta: float, *,
         impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-split RoPE of q (B, S, H, hd) and k (B, S, KVH, hd) at integer
    positions (B, S): ``auto`` the kernel of ``kernels/rope.py`` for a CUDA
    tensor (one launch for both), the plain ``models/layers.apply_rope`` for a
    CPU one; ``ref`` the plain version always."""
    _check_impl(impl, ("auto", "ref"))
    if impl == "ref":
        return _plain_rope(q, positions, theta), _plain_rope(k, positions, theta)
    if is_dtensor(q) and q.device.type != "cpu":
        return _rope_per_shard(q, k, positions, theta)
    return _rope_kernel(q, k, positions, theta)


def _rope_per_shard(q, k, positions, theta: float):
    """The kernel's wrapper on each shard's local q and k, with the positions
    of the shard's own rows.

    The rotation is per token and head dim pair, and linear, so any placement
    of q and k's batch, sequence and head dims (a partial sum too) rotates
    shard by shard; the head dim itself may not be split. q and k must split
    their rows (batch and sequence) alike; ``positions`` (a plain tensor,
    whole, or a DTensor) is cut to those rows.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def rows(t):
        return [p if isinstance(p, Shard) and p.dim < 2 else Replicate() for p in t.placements]

    mesh = q.device_mesh
    for name, t in (("q", q), ("k", k)):
        if any(isinstance(p, Shard) and p.dim == 3 for p in t.placements):
            raise ValueError(f"rope: {name} is sharded on its head dim ({t.placements})")
    if rows(k) != rows(q):
        raise ValueError(f"rope: q {q.placements} and k {k.placements} split their rows "
                         "differently")
    if not is_dtensor(positions):
        positions = DTensor.from_local(positions, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
    pl = positions.redistribute(mesh, rows(q)).to_local()
    ql, kl = _rope_kernel(q.to_local(), k.to_local(), pl, theta)
    return (DTensor.from_local(ql, mesh, q.placements, run_check=False),
            DTensor.from_local(kl, mesh, k.placements, run_check=False))


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    softcap: float = 0.0,
    impl: str = "auto",
) -> torch.Tensor:
    """Single-token decode attention over a KV cache, (B, H, D) query.

    ``impl="ref"`` under a mesh keeps the reference's distributed layout: the
    cache stays sharded by sequence over "model" and the query is replicated
    across it, so each "model" shard scores its own span of keys and the
    softmax and PV reductions combine across shards, and the whole cache is
    never gathered. Un-meshed the constraints are the identity. The kernel
    path takes no mesh (serving runs on one card)."""
    _check_impl(impl, ("auto", "ref"))
    if impl == "auto":
        _note("decode_attention", q, k_cache)
        return _decode_kernel(q, k_cache, v_cache, lengths, sm_scale=sm_scale, softcap=softcap)
    q = constrain(q, ("pod", "data"), None, None)
    k_cache = constrain(k_cache, ("pod", "data"), "model", None, None)
    v_cache = constrain(v_cache, ("pod", "data"), "model", None, None)
    _note("decode_attention", _local(q), _local(k_cache))
    out = _ref.decode_attention_ref(q, k_cache, v_cache, lengths, sm_scale=sm_scale,
                                    softcap=softcap)
    return constrain(out, ("pod", "data"), None, None)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t
