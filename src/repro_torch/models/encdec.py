"""Whisper-style encoder-decoder backbone, a port of ``repro.models.encdec``.

The audio conv frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (B, Se, D). Encoder: non-causal self-attention
blocks over fixed sinusoidal positions. Decoder: causal self attention, then
cross attention over the encoder output, with learned positions. LayerNorm
and GELU (``cfg.norm``, ``cfg.act``). Every attention goes through
``kernels/ops.py``: the encoder's and the cross attention's are the flash
path without a mask, the cross attention's at decode too (one query row).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from . import attention as attn
from .layers import (DTYPES, Params, apply_norm, embed, embed_init, norm_init,
                     sinusoidal_positions, unembed)
from .mlp import mlp_apply, mlp_init
from .transformer import _attn_cache_init

POS_TABLE = 4096  # rows of the decoder's learned position table; positions wrap


def enc_block_init(gen: torch.Generator, cfg) -> Params:
    dt = DTYPES[cfg.param_dtype]
    return {
        "norm1": norm_init(cfg.d_model, cfg.norm, dt, gen.device),
        "attn": attn.attn_init(gen, cfg),
        "norm2": norm_init(cfg.d_model, cfg.norm, dt, gen.device),
        "mlp": mlp_init(gen, cfg),
    }


def dec_block_init(gen: torch.Generator, cfg) -> Params:
    dt = DTYPES[cfg.param_dtype]
    return {
        "norm1": norm_init(cfg.d_model, cfg.norm, dt, gen.device),
        "self_attn": attn.attn_init(gen, cfg),
        "norm_x": norm_init(cfg.d_model, cfg.norm, dt, gen.device),
        "cross_attn": attn.attn_init(gen, cfg),
        "norm2": norm_init(cfg.d_model, cfg.norm, dt, gen.device),
        "mlp": mlp_init(gen, cfg),
    }


def encdec_init(gen: torch.Generator, cfg) -> Params:
    dt = DTYPES[cfg.param_dtype]
    pos = torch.randn((POS_TABLE, cfg.d_model), dtype=torch.float32, device=gen.device,
                      generator=gen)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "pos_embed": {"w": (pos * 0.01).to(dt)},
        "enc": {str(i): enc_block_init(gen, cfg) for i in range(cfg.num_encoder_layers)},
        "enc_norm": norm_init(cfg.d_model, cfg.norm, dt, gen.device),
        "dec": {str(i): dec_block_init(gen, cfg) for i in range(cfg.num_layers)},
        "dec_norm": norm_init(cfg.d_model, cfg.norm, dt, gen.device),
    }


def encode(p: Params, cfg, frames: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """frames: (B, Se, D) stubbed conv-frontend output. Returns (B, Se, D)."""
    b, se, _ = frames.shape
    x = frames + sinusoidal_positions(se, cfg.d_model, frames.device).to(frames.dtype)
    zeros = torch.zeros((b, se), dtype=torch.int32, device=frames.device)  # no RoPE
    for i in range(cfg.num_encoder_layers):
        bp = p["enc"][str(i)]
        h = apply_norm(bp["norm1"], x, cfg.norm)
        x = x + attn.attn_apply(bp["attn"], cfg, h, zeros, causal=False, impl=impl)
        x = x + mlp_apply(bp["mlp"], cfg, apply_norm(bp["norm2"], x, cfg.norm))
    return apply_norm(p["enc_norm"], x, cfg.norm)


def _learned_positions(p: Params, positions: torch.Tensor) -> torch.Tensor:
    table = p["pos_embed"]["w"]
    return table[torch.remainder(positions, table.shape[0])]


def decode_train(p: Params, cfg, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """Teacher-forced decoder over tokens (B, S): logits (B, S, V)."""
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = embed(p["embed"], tokens) + _learned_positions(p, pos)
    for i in range(cfg.num_layers):
        bp = p["dec"][str(i)]
        h = apply_norm(bp["norm1"], x, cfg.norm)
        x = x + attn.attn_apply(bp["self_attn"], cfg, h, pos, causal=True, impl=impl)
        hx = apply_norm(bp["norm_x"], x, cfg.norm)
        kv = attn.cross_kv(bp["cross_attn"], cfg, enc_out)
        x = x + attn.cross_attn_apply(bp["cross_attn"], cfg, hx, kv, impl=impl)
        x = x + mlp_apply(bp["mlp"], cfg, apply_norm(bp["norm2"], x, cfg.norm))
    x = apply_norm(p["dec_norm"], x, cfg.norm)
    return unembed(p["embed"], x)


def init_dec_cache(p: Params, cfg, enc_out: torch.Tensor, batch: int, cache_len: int,
                   dtype) -> List[Dict[str, Any]]:
    """Per decoder layer: an empty self-attention KV cache, and the cross
    attention's k, v of the encoder output, computed once."""
    caches = []
    for i in range(cfg.num_layers):
        k, v = attn.cross_kv(p["dec"][str(i)]["cross_attn"], cfg, enc_out)
        caches.append({"self": _attn_cache_init(cfg, batch, cache_len, dtype, enc_out.device),
                       "cross_k": k.to(dtype), "cross_v": v.to(dtype)})
    return caches


def decode_step(p: Params, cfg, token: torch.Tensor, positions: torch.Tensor,
                caches: List[Dict[str, Any]], *, impl: str = "auto"):
    """token (B, 1); positions (B, 1) absolute decoder positions. The self
    caches are updated in place; returns (logits (B, 1, V), the caches)."""
    x = embed(p["embed"], token) + _learned_positions(p, positions)
    new_caches = []
    for i in range(cfg.num_layers):
        bp = p["dec"][str(i)]
        h = apply_norm(bp["norm1"], x, cfg.norm)
        y, self_cache = attn.attn_decode(bp["self_attn"], cfg, h, positions, caches[i]["self"],
                                         impl=impl)
        x = x + y
        hx = apply_norm(bp["norm_x"], x, cfg.norm)
        x = x + attn.cross_attn_apply(bp["cross_attn"], cfg, hx,
                                      (caches[i]["cross_k"], caches[i]["cross_v"]), impl=impl)
        x = x + mlp_apply(bp["mlp"], cfg, apply_norm(bp["norm2"], x, cfg.norm))
        new_caches.append(dict(caches[i], self=self_cache))
    x = apply_norm(p["dec_norm"], x, cfg.norm)
    return unembed(p["embed"], x), new_caches
