"""Decoder-only stack of mixed block kinds, and its caches.

Block kinds come from ``cfg.pattern()``: ``ATTN`` (self attention, then an
MLP or a mixture of experts), ``RECUR`` (the RG-LRU block, then an MLP),
``MLSTM`` and ``SLSTM`` (the xLSTM blocks, which carry their own up and down
projections). The JAX package scans the stacked layers of a uniform
attention stack and unrolls the others; here every stack is one list of
per-layer parameter dicts, and the cache one list of per-layer cache dicts
(a KV cache for an attention layer, ``{"h", "conv_buf"}`` for an RG-LRU one,
``{"C", "n", "m", "conv_buf"}`` for an mLSTM one, ``{"c", "n", "h", "m"}``
for an sLSTM one), walked by a Python loop beside ``cfg.pattern()``.

Under autograd, ``stack_apply`` rematerializes each block by ``cfg.remat``,
as the reference's ``jax.checkpoint`` of its scan body: ``"none"`` keeps
every activation, ``"full"`` keeps a block's inputs and recomputes the rest
in backward (``torch.utils.checkpoint``), ``"dots"`` keeps the outputs of the
plain matrix products (``aten.mm`` / ``addmm``, the counterpart of
``checkpoint_dots_with_no_batch_dims``: batched products are recomputed).
All three give the same gradients.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import obs
from ..configs.base import ATTN, MLSTM, RECUR, SLSTM
from ..distributed.sharding import by_rows, constrain, is_dtensor
from . import attention as attn
from . import moe as moe_mod
from .layers import DTYPES, Params, apply_norm, norm_init
from .mlp import mlp_apply, mlp_init
from .rglru import rglru_apply, rglru_decode, rglru_init, rglru_state_init
from .xlstm import (mlstm_apply, mlstm_decode, mlstm_init, mlstm_state_init, slstm_apply,
                    slstm_decode, slstm_init, slstm_state_init)


def _layer_window(cfg, kind: str) -> int:
    # hybrid archs use windowed local attention for their ATTN layers
    return cfg.attn_window if kind == ATTN else 0


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg, kind: str) -> Params:
    pdt = DTYPES[cfg.param_dtype]
    p: Params = {"norm1": norm_init(cfg.d_model, cfg.norm, pdt, gen.device)}
    if kind == ATTN:
        p["attn"] = attn.attn_init(gen, cfg)
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, pdt, gen.device)
        if cfg.num_experts:
            p["moe"] = moe_mod.moe_init(gen, cfg)
        elif cfg.d_ff:
            p["mlp"] = mlp_init(gen, cfg)
    elif kind == RECUR:
        p["recur"] = rglru_init(gen, cfg)
        if cfg.d_ff:
            p["norm2"] = norm_init(cfg.d_model, cfg.norm, pdt, gen.device)
            p["mlp"] = mlp_init(gen, cfg)
    elif kind == MLSTM:
        p["mlstm"] = mlstm_init(gen, cfg)
    elif kind == SLSTM:
        p["slstm"] = slstm_init(gen, cfg)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return p


def _ffn(p: Params, cfg, x: torch.Tensor,
         capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """x plus the block's MLP or MoE of norm2(x), and the MoE's aux loss."""
    if "moe" in p:
        moe_fn = moe_mod.moe_apply_ep if cfg.moe_impl == "ep" else moe_mod.moe_apply
        y, aux = moe_fn(p["moe"], cfg, apply_norm(p["norm2"], x, cfg.norm),
                        capacity_factor=capacity_factor)
        return x + y, aux
    if "mlp" in p:
        x = x + mlp_apply(p["mlp"], cfg, apply_norm(p["norm2"], x, cfg.norm))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# the recurrent block kinds: parameter key, full-sequence and one-token functions
_RECURRENT = {RECUR: ("recur", rglru_apply, rglru_decode),
              MLSTM: ("mlstm", mlstm_apply, mlstm_decode),
              SLSTM: ("slstm", slstm_apply, slstm_decode)}


def _recurrence(fn: Callable, params: Params, h, *state):
    """``fn(params, h, *state)``; over a mesh on each rank's batch rows
    (``sharding.by_rows``): the recurrences have no DTensor rules."""
    return by_rows(fn, params, h, *state) if is_dtensor(h) else fn(params, h, *state)


def block_apply(p: Params, cfg, kind: str, x: torch.Tensor, positions: torch.Tensor, *,
                impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Training / no-cache forward of one block. Returns (x, aux loss)."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if kind == ATTN:
        x = x + attn.attn_apply(p["attn"], cfg, h, positions, causal=True,
                                window=_layer_window(cfg, kind), impl=impl)
    else:
        name, fn, _ = _RECURRENT[kind]
        x = x + _recurrence(lambda lp, lh: fn(lp, cfg, lh), p[name], h)
    x, aux = _ffn(p, cfg, x)
    if cfg.act_shard == "seq":
        x = constrain(x, ("pod", "data"), "model", None)
    else:
        x = constrain(x, ("pod", "data"), None, None)
    return x, aux


# the serving spans of a block's two halves: its mixer (by kind), then its FFN
_MIXER_SPAN = {ATTN: "block.attn", RECUR: "block.recur", MLSTM: "block.mlstm",
               SLSTM: "block.slstm"}


def block_prefill(p: Params, cfg, kind: str, x, positions, cache, *, impl: str = "auto"):
    """Forward that also fills this layer's decode cache. An sLSTM layer steps
    over the prompt from its state ``cache``, as the reference's scan does."""
    with obs.span(_MIXER_SPAN[kind]):
        h = apply_norm(p["norm1"], x, cfg.norm)
        if kind == ATTN:
            y, new_cache = attn.attn_prefill(p["attn"], cfg, h, positions, cache, causal=True,
                                             window=_layer_window(cfg, kind), impl=impl)
        elif kind == SLSTM:
            y, new_cache = _recurrence(
                lambda lp, lh, c: slstm_apply(lp, cfg, lh, state0=c, return_state=True),
                p["slstm"], h, cache)
        else:
            name, fn, _ = _RECURRENT[kind]
            y, new_cache = _recurrence(lambda lp, lh: fn(lp, cfg, lh, return_state=True),
                                       p[name], h)
    with obs.span("block.ffn"):
        x, _ = _ffn(p, cfg, x + y)
    return constrain(x, ("pod", "data"), None, None), new_cache


def block_decode(p: Params, cfg, kind: str, x, positions, cache, *, impl: str = "auto"):
    """One-token step. x (B, 1, D)."""
    with obs.span(_MIXER_SPAN[kind]):
        h = apply_norm(p["norm1"], x, cfg.norm)
        if kind == ATTN:
            y, new_cache = attn.attn_decode(p["attn"], cfg, h, positions, cache,
                                            window=_layer_window(cfg, kind), impl=impl)
        else:
            name, _, fn = _RECURRENT[kind]
            y, new_cache = _recurrence(lambda lp, lh, c: fn(lp, cfg, lh, c), p[name], h,
                                       cache)
    with obs.span("block.ffn"):
        x, _ = _ffn(p, cfg, x + y, capacity_factor=2.0)
    return x, new_cache


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def stack_init(gen: torch.Generator, cfg) -> Params:
    return {"layers": [block_init(gen, cfg, kind) for kind in cfg.pattern()]}


# the products "dots" keeps: plain (unbatched) matrix products
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg) -> Callable:
    """``fn`` under ``cfg.remat`` (a no-op without autograd, as in serving)."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {cfg.remat!r} not in ('none', 'full', 'dots')")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        context = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, context_fn=context)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def stack_apply(p: Params, cfg, x, positions, *,
                impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in zip(p["layers"], cfg.pattern()):
        fn = _remat(functools.partial(block_apply, lp, cfg, kind, impl=impl), cfg)
        x, aux_i = fn(x, positions)
        aux = aux + aux_i
    return x, aux


def stack_prefill(p: Params, cfg, x, positions, caches: List[Dict[str, Any]], *,
                  impl: str = "auto") -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    new_caches = []
    for lp, kind, cache in zip(p["layers"], cfg.pattern(), caches):
        x, cache = block_prefill(lp, cfg, kind, x, positions, cache, impl=impl)
        new_caches.append(cache)
    return x, new_caches


def stack_decode(p: Params, cfg, x, positions, caches: List[Dict[str, Any]], *,
                 impl: str = "auto") -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    new_caches = []
    for lp, kind, cache in zip(p["layers"], cfg.pattern(), caches):
        x, cache = block_decode(lp, cfg, kind, x, positions, cache, impl=impl)
        new_caches.append(cache)
    return x, new_caches


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _attn_cache_init(cfg, batch: int, cache_len: int, dtype, device) -> Dict[str, Any]:
    """A zeroed KV cache; a windowed layer keeps only its window."""
    length = min(cache_len, cfg.attn_window) if cfg.attn_window else cache_len
    shape = (batch, length, cfg.num_kv_heads, cfg.hd())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "pos": 0}


def init_cache(cfg, batch: int, cache_len: int, *, device,
               dtype: Optional[torch.dtype] = None) -> List[Dict[str, Any]]:
    """One empty cache per layer, by its kind."""
    dtype = dtype or DTYPES[cfg.dtype]
    state_init = {RECUR: rglru_state_init, MLSTM: mlstm_state_init, SLSTM: slstm_state_init}
    return [_attn_cache_init(cfg, batch, cache_len, dtype, device) if kind == ATTN
            else state_init[kind](cfg, batch, dtype, device=device) for kind in cfg.pattern()]
