"""GQA self-attention (full sequence / prefill / decode) and cross attention.

The attention core goes through ``repro_torch.kernels.ops``: the CUDA kernels
for CUDA tensors, their plain versions for CPU tensors. A layer's KV cache is
a dict ``{"k": (B, L, KVH, hd), "v": (B, L, KVH, hd), "pos": int}``, where
``pos`` is the synchronized decode position of the whole batch. Where the
JAX package donates the cache and returns a new one, the port writes into
the cache tensors in place and returns a dict that holds the same tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .. import obs
from ..distributed.sharding import constrain, is_dtensor, merge_heads, split_heads, write_at
from ..kernels import ops
from .layers import DTYPES, Params, apply_mrope, dense, dense_init


def attn_init(gen: torch.Generator, cfg) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim(), cfg.kv_dim()
    dt = DTYPES[cfg.param_dtype]
    return {
        "wq": dense_init(gen, d, qd, dt, bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, kvd, dt, bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, kvd, dt, bias=cfg.qkv_bias),
        "wo": dense_init(gen, qd, d, dt, scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }


def _apply_positional(cfg, q, k, positions):
    """RoPE on positions (B, S) (``ops.rope``: q and k in one kernel launch on
    the card), M-RoPE on (B, S, 3), or nothing (``rope_mode`` ``none``:
    whisper's positions are added to its embeddings instead)."""
    with obs.span("rope"):
        if cfg.rope_mode == "rope":
            q, k = ops.rope(q, k, positions, cfg.rope_theta)
        elif cfg.rope_mode == "mrope":
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        return q, k


def _qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Project x (B, S, D) to rotated q (B, S, H, hd), rotated k and v (B, S, KVH, hd)."""
    hd = cfg.hd()
    q = split_heads(dense(p["wq"], x), cfg.num_heads, hd)
    k = split_heads(dense(p["wk"], x), cfg.num_kv_heads, hd)
    v = split_heads(dense(p["wv"], x), cfg.num_kv_heads, hd)
    q, k = _apply_positional(cfg, q, k, positions)
    return q, k, v


def attn_apply(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor, *,
               causal: bool = True, window: int = 0, impl: str = "auto") -> torch.Tensor:
    """Full-sequence self attention (training / prefill). Under a mesh, q is
    sharded by heads over "model" (k and v with it where their heads divide),
    or, under ``act_shard="seq"``, by query rows with k and v whole; each
    shard calls the kernel on its own part (``kernels/ops.py``)."""
    q, k, v = _qkv(p, cfg, x, positions)
    if cfg.act_shard == "seq":
        # sequence parallelism: q keeps its span of query rows, k and v are
        # gathered across "model" (small under GQA)
        q = constrain(q, ("pod", "data"), "model", None, None)
        k = constrain(k, ("pod", "data"), None, None, None)
        v = constrain(v, ("pod", "data"), None, None, None)
    else:
        q = constrain(q, ("pod", "data"), None, "model", None)
        k = constrain(k, ("pod", "data"), None, "model", None)
    o = ops.attention(q, k, v, causal=causal, window=window,
                      softcap=cfg.attn_logit_softcap, impl=impl)
    return dense(p["wo"], merge_heads(o))


def attn_prefill(p: Params, cfg, x, positions, cache: Dict[str, Any], *,
                 causal: bool = True, window: int = 0,
                 impl: str = "auto") -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill: as :func:`attn_apply`, and fills the layer's KV cache in place."""
    q, k, v = _qkv(p, cfg, x, positions)
    o = ops.attention(q, k, v, causal=causal, window=window,
                      softcap=cfg.attn_logit_softcap, impl=impl)
    new_cache = _cache_write_prefill(cache, k, v, x.shape[1])
    return dense(p["wo"], merge_heads(o)), new_cache


def attn_decode(p: Params, cfg, x, positions, cache: Dict[str, Any], *,
                window: int = 0, impl: str = "auto") -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode against the cache, which is updated in place.

    x: (B, 1, D); positions (B, 1), or (B, 1, 3) under M-RoPE. Without a window the slot is
    ``min(pos, L - 1)``: past the cache's end every step overwrites the last
    slot, as the JAX package's clamped ``dynamic_update_slice`` does. With a
    window the cache is a rolling buffer and the slot is ``pos % L``.
    """
    b, s1, _ = x.shape
    if s1 != 1:
        raise ValueError(f"attn_decode takes one token per sequence, got {s1}")
    q, k, v = _qkv(p, cfg, x, positions)
    cache_len = cache["k"].shape[1]
    pos = cache["pos"]
    slot = pos % cache_len if window > 0 else min(pos, cache_len - 1)
    _write_slot(cache["k"], k[:, 0], slot)
    _write_slot(cache["v"], v[:, 0], slot)
    lengths = torch.full((b,), min(pos + 1, cache_len), dtype=torch.int32, device=x.device)
    o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths,
                             softcap=cfg.attn_logit_softcap, impl=impl)  # (B, H, hd)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    return dense(p["wo"], merge_heads(o)[:, None]), new_cache


def cross_attn_apply(p: Params, cfg, x: torch.Tensor,
                     enc_kv: Tuple[torch.Tensor, torch.Tensor], *,
                     impl: str = "auto") -> torch.Tensor:
    """Encoder-decoder cross attention of x (B, S, D) over the precomputed
    encoder k, v (B, Se, KVH, hd): the flash path without a mask, at decode
    too (S = 1), as the reference's."""
    q = split_heads(dense(p["wq"], x), cfg.num_heads, cfg.hd())
    k, v = enc_kv
    o = ops.attention(q, k, v, causal=False, window=0, impl=impl)
    return dense(p["wo"], merge_heads(o))


def cross_kv(p: Params, cfg, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross attention's k, v (B, Se, KVH, hd) of the encoder output (B, Se, D)."""
    k = split_heads(dense(p["wk"], enc_out), cfg.num_kv_heads, cfg.hd())
    v = split_heads(dense(p["wv"], enc_out), cfg.num_kv_heads, cfg.hd())
    return k, v


# ---------------------------------------------------------------------------
# cache plumbing
# ---------------------------------------------------------------------------

def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """Write (B, KVH, hd) ``new`` at the batch's one synchronized slot, in
    place; under a mesh, into the shard of the sequence dim that holds it."""
    if is_dtensor(cache):
        write_at(cache, new, 1, slot)
    else:
        cache[:, slot] = new


def _cache_write_prefill(cache: Dict[str, Any], k, v, s: int) -> Dict[str, Any]:
    """Fill the cache from the prompt's k, v (B, s, KVH, hd), in place.

    A prompt shorter than the cache fills its first ``s`` slots and zeroes the
    rest. A longer one keeps its last L positions, rolled so that position p
    sits at slot p % L, where a rolling decode would write it.
    """
    cache_len = cache["k"].shape[1]
    shift = s % cache_len
    for name, new in (("k", k), ("v", v)):
        buf = cache[name]
        if s >= cache_len:
            # torch.roll by slices (DTensor has no rule for roll in every torch)
            last = new[:, -cache_len:]
            buf.copy_(torch.cat([last[:, -shift:], last[:, :-shift]], dim=1) if shift else last)
        else:
            buf[:, :s] = new
            buf[:, s:] = 0
    return {"k": cache["k"], "v": cache["v"], "pos": s}
