"""Model interface: init / forward / prefill / decode for every architecture.

``batch`` dicts:

* LMs: ``{"tokens": (B, S) int32[, "positions": (B, S), or (B, S, 3) under
  M-RoPE]}``;
* vlm: also ``{"vision_embeds": (B, Sv, D)}``, patch embeddings (a stub
  frontend) that overwrite the first Sv token embeddings;
* audio (encoder-decoder): ``{"frames": (B, Se, D), "tokens": (B, S)}``,
  the stubbed conv frontend's frames and the decoder's tokens.

Decode: ``decode_step(params, cfg, token, positions, cache)`` takes one new
token per sequence against the caches that ``prefill`` returns.
``impl`` picks the attention path (see ``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import constrain_batch, place_cache
from . import encdec, transformer
from .layers import DTYPES, Params, apply_norm, embed, embed_init, norm_init, unembed


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for the card when there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' to run the plain attention path on the CPU")
    return device


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random parameters from ``seed``, drawn on ``device`` with a torch.Generator.

    The parameters live on the card unless the caller asks for the CPU. The
    draws differ from ``repro``'s ``jax.random`` ones; parity tests carry the
    JAX parameters over with ``repro_torch.convert.params_from_jax``.
    """
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    if cfg.is_encoder_decoder:
        return encdec.encdec_init(gen, cfg)
    pdt = DTYPES[cfg.param_dtype]
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pdt),
        "stack": transformer.stack_init(gen, cfg),
        "final_norm": norm_init(cfg.d_model, cfg.norm, pdt, gen.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, pdt)
    return p


def _positions(cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    tokens = batch["tokens"]
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    return pos[..., None].expand(b, s, 3) if cfg.rope_mode == "mrope" else pos


def _embed_inputs(p: Params, cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    x = embed(p["embed"], batch["tokens"]).to(DTYPES[cfg.dtype])
    if cfg.frontend == "vision_stub" and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    x = x * (cfg.d_model ** 0.5) if cfg.family == "hybrid" else x  # gemma scaling
    return constrain_batch(x)


def _logits(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(p["final_norm"], x, cfg.norm)
    return unembed(p["head"] if "head" in p else p["embed"], x)


def _encode(p: Params, cfg: ModelConfig, batch: Dict[str, Any], impl: str) -> torch.Tensor:
    return encdec.encode(p, cfg, batch["frames"].to(DTYPES[cfg.dtype]), impl=impl)


def forward(p: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B, S, V), the MoE's aux loss)."""
    if cfg.is_encoder_decoder:
        logits = encdec.decode_train(p, cfg, batch["tokens"], _encode(p, cfg, batch, impl),
                                     impl=impl)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
    x = _embed_inputs(p, cfg, batch)
    x, aux = transformer.stack_apply(p["stack"], cfg, x, _positions(cfg, batch), impl=impl)
    return _logits(p, cfg, x), aux


def hidden_forward(p: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
                   impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward returning the final normed hidden states (no unembed) and the
    MoE's aux loss: the chunked-loss training path, so that the (B, S, V)
    logits are never materialized. Decoder-only models."""
    if cfg.is_encoder_decoder:
        raise ValueError("hidden_forward: an encoder-decoder model trains through forward")
    x = _embed_inputs(p, cfg, batch)
    x, aux = transformer.stack_apply(p["stack"], cfg, x, _positions(cfg, batch), impl=impl)
    return apply_norm(p["final_norm"], x, cfg.norm), aux


def init_cache(p: Params, cfg: ModelConfig, batch_size: int, cache_len: int,
               enc_out: Optional[torch.Tensor] = None, *, device) -> List[Dict[str, Any]]:
    """Empty decode caches for ``batch_size`` sequences of up to ``cache_len``
    positions, one per layer: an encoder-decoder model's also hold the cross
    attention's k, v of ``enc_out`` (its encoder output), computed once."""
    if cfg.is_encoder_decoder:
        if enc_out is None:
            raise ValueError("init_cache: an encoder-decoder model's caches need enc_out")
        return encdec.init_dec_cache(p, cfg, enc_out, batch_size, cache_len, DTYPES[cfg.dtype])
    return transformer.init_cache(cfg, batch_size, cache_len, device=device)


def _serving_cfg(cfg: ModelConfig) -> ModelConfig:
    """Serving strips training-only layout choices, as the reference's does:
    sequence-parallel activations (``act_shard``) are for the train step. It
    changes nothing un-meshed, where the constraints are the identity."""
    return dataclasses.replace(cfg, act_shard="none") if cfg.act_shard != "none" else cfg


def prefill(p: Params, cfg: ModelConfig, batch: Dict[str, Any], cache_len: int, *,
            impl: str = "auto") -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """Run the prompt; return (last-position logits (B, 1, V), per-layer caches).

    An encoder-decoder model returns the teacher-forced decoder's last logits
    with its self-attention caches empty (``pos`` 0), as the reference does:
    the first decode step then attends to itself alone, at learned position
    ``S``. Only the cross attention's k, v are filled. Under a mesh the caches
    are placed as the decode step reads them (``sharding.place_cache``).
    """
    cfg = _serving_cfg(cfg)
    if cfg.is_encoder_decoder:
        enc_out = _encode(p, cfg, batch, impl)
        b = batch["tokens"].shape[0]
        caches = place_cache(init_cache(p, cfg, b, cache_len, enc_out, device=enc_out.device),
                             b)
        logits = encdec.decode_train(p, cfg, batch["tokens"], enc_out, impl=impl)
        return logits[:, -1:], caches
    x = _embed_inputs(p, cfg, batch)
    caches = place_cache(init_cache(p, cfg, x.shape[0], cache_len, device=x.device), x.shape[0])
    x, caches = transformer.stack_prefill(p["stack"], cfg, x, _positions(cfg, batch), caches,
                                          impl=impl)
    return _logits(p, cfg, x[:, -1:]), caches


def decode_step(p: Params, cfg: ModelConfig, token: torch.Tensor, positions: torch.Tensor,
                cache: List[Dict[str, Any]], *,
                impl: str = "auto") -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """token (B, 1) int32; positions (B, 1), or (B, 1, 3) under M-RoPE (an
    encoder-decoder model reads the first stream). The KV caches are updated
    in place; a recurrent layer's state is replaced by the one returned."""
    cfg = _serving_cfg(cfg)
    if cfg.is_encoder_decoder:
        pos = positions[..., 0] if positions.ndim == 3 else positions
        return encdec.decode_step(p, cfg, token, pos, cache, impl=impl)
    x = embed(p["embed"], token).to(DTYPES[cfg.dtype])
    if cfg.family == "hybrid":
        x = x * (cfg.d_model ** 0.5)
    x, cache = transformer.stack_decode(p["stack"], cfg, x, positions, cache, impl=impl)
    return _logits(p, cfg, x), cache
