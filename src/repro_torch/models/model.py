"""Model interface: init / forward / prefill / decode for the dense, MoE and hybrid LMs.

``batch`` dicts hold ``{"tokens": (B, S) int32[, "positions": (B, S)]}``.
Decode: ``decode_step(params, cfg, token, positions, cache)`` takes one new
token per sequence against the per-layer caches that ``prefill`` returns.
``impl`` picks the attention path (see ``kernels/ops.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..configs.base import ModelConfig
from . import transformer
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
    transformer.check_supported(cfg)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    pdt = DTYPES[cfg.param_dtype]
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pdt),
        "stack": transformer.stack_init(gen, cfg),
        "final_norm": norm_init(cfg.d_model, pdt, gen.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, pdt)
    return p


def _positions(batch: Dict[str, Any]) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    tokens = batch["tokens"]
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)


def _embed_tokens(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = embed(p["embed"], tokens).to(DTYPES[cfg.dtype])
    return x * (cfg.d_model ** 0.5) if cfg.family == "hybrid" else x  # gemma scaling


def _logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    return unembed(p["head"] if "head" in p else p["embed"], apply_norm(p["final_norm"], x))


def forward(p: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B, S, V), the MoE's aux loss)."""
    x = _embed_tokens(p, cfg, batch["tokens"])
    x, aux = transformer.stack_apply(p["stack"], cfg, x, _positions(batch), impl=impl)
    return _logits(p, x), aux


def prefill(p: Params, cfg: ModelConfig, batch: Dict[str, Any], cache_len: int, *,
            impl: str = "auto") -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """Run the prompt; return (last-position logits (B, 1, V), per-layer caches)."""
    x = _embed_tokens(p, cfg, batch["tokens"])
    caches = transformer.init_cache(cfg, x.shape[0], cache_len, device=x.device)
    x, caches = transformer.stack_prefill(p["stack"], cfg, x, _positions(batch), caches,
                                          impl=impl)
    return _logits(p, x[:, -1:]), caches


def decode_step(p: Params, cfg: ModelConfig, token: torch.Tensor, positions: torch.Tensor,
                cache: List[Dict[str, Any]], *,
                impl: str = "auto") -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """token (B, 1) int32; positions (B, 1). The KV caches are updated in place; a
    recurrent layer's state is replaced by the one returned."""
    x = _embed_tokens(p, cfg, token)
    x, cache = transformer.stack_decode(p["stack"], cfg, x, positions, cache, impl=impl)
    return _logits(p, x), cache
