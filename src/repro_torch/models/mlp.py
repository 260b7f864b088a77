"""Feed-forward blocks: gated (SwiGLU, GeGLU) and plain MLPs.

Gated: ``act(x @ w_gate) * (x @ w_in) @ w_out``; plain: ``act(x @ w_in) @ w_out``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..distributed.sharding import constrain
from .layers import DTYPES, GATED_ACTS, Params, activation, dense, dense_init


def mlp_init(gen: torch.Generator, cfg, d_ff: Optional[int] = None) -> Params:
    """``d_ff`` overrides ``cfg.d_ff`` (the MoE's shared experts)."""
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    dt = DTYPES[cfg.param_dtype]
    p: Params = {
        "w_in": dense_init(gen, d, f, dt),
        "w_out": dense_init(gen, f, d, dt, scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }
    if cfg.act in GATED_ACTS:
        p["w_gate"] = dense_init(gen, d, f, dt)
    return p


def mlp_apply(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    h = dense(p["w_in"], x)
    h = act(dense(p["w_gate"], x)) * h if "w_gate" in p else act(h)
    if cfg.act_shard == "seq" and h.ndim == 3:
        # sequence parallelism: the FFN is token-local, tokens stay sharded
        h = constrain(h, ("pod", "data"), "model", None)
    else:
        h = constrain(h, ("pod", "data"), None, "model")
    return dense(p["w_out"], h)
