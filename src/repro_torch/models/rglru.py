"""RG-LRU recurrent block (RecurrentGemma / Griffin), from ``repro.models.rglru``.

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with
a_t = exp(-c * softplus(lambda) * sigmoid(W_r x_t)), is a first-order linear
scan. Prefill runs it as a log-depth scan over (a, b) pairs, ceil(log2 S)
doubling steps of whole-tensor ops, where the reference runs
``jax.lax.associative_scan``; decode is an O(1) update. Both are plain torch,
as the reference's are plain ``jnp``.

Block layout: {gate branch: linear + GELU} * {recurrent branch: linear ->
causal conv -> RG-LRU} -> output linear. The gate weights ``w_rec_gate`` and
``lambda`` are fp32 and so is the state ``h``; ``conv_buf`` has the
activations' dtype.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import DTYPES, Params, dense, dense_init, gelu
from .xlstm import _causal_conv, _conv_step, conv_tail_buffer

A_SCALE = 8.0  # the paper's c constant


def rglru_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = DTYPES[cfg.param_dtype]
    dev = gen.device
    # lambda such that a^c spans about (0.9, 0.999), as in the paper
    u = torch.empty((w,), dtype=torch.float32, device=dev).uniform_(0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / A_SCALE))  # softplus^-1
    conv = torch.randn((cfg.conv_width, w), dtype=torch.float32, device=dev, generator=gen)
    return {
        "w_x": dense_init(gen, d, w, dt),
        "w_gate_branch": dense_init(gen, d, w, dt),
        "conv": {"w": conv.to(dt) * 0.1},
        "w_rec_gate": dense_init(gen, w, 2 * w, torch.float32, bias=True),  # r and i gates
        "lambda": lam,
        "w_out": dense_init(gen, w, d, dt, scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }


def _gates(p: Params, xw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_a, gated input) of the post-conv activations ``xw`` (..., w), in fp32."""
    xf = xw.float()
    g = dense(p["w_rec_gate"], xf)
    w = xw.shape[-1]
    r, i = g[..., :w], g[..., w:]
    log_a = -A_SCALE * F.softplus(p["lambda"]) * torch.sigmoid(r)
    gated = torch.sigmoid(i) * xf
    # the multiplier sqrt(1 - a^2), stably as sqrt(-expm1(2 log a))
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    return log_a, mult * gated


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 by a log-depth (Hillis-Steele) scan.

    log_a, b: (B, S, W) fp32; h0: optional (B, W) entering state. Step k
    combines each position with the one 2^k before it, so after
    ceil(log2 S) steps position t holds the whole prefix.
    """
    a = torch.exp(log_a)
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0
    s = a.shape[1]
    for k in range(math.ceil(math.log2(s)) if s > 1 else 0):
        off = 1 << k
        # (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2)
        b = torch.cat([b[:, :off], torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])], dim=1)
        if 2 * off < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
    return b


def rglru_final_state(log_a, binp, h: torch.Tensor) -> torch.Tensor:
    """The state after the sequence: the last h, in fp32 (from h's dtype, as the reference)."""
    return h[:, -1].float()


def rglru_apply(p: Params, cfg, x: torch.Tensor, state: Optional[Dict[str, Any]] = None,
                return_state: bool = False):
    """Full-sequence block body. x (B, S, D)."""
    gate = gelu(dense(p["w_gate_branch"], x))
    xr = dense(p["w_x"], x)
    conv = _causal_conv(xr, p["conv"]["w"])
    log_a, binp = _gates(p, conv)
    h0 = state["h"] if state is not None else None
    h = rglru_scan(log_a, binp, h0=h0).to(x.dtype)
    y = dense(p["w_out"], h * gate)
    if return_state:
        return y, {"h": rglru_final_state(log_a, binp, h),
                   "conv_buf": conv_tail_buffer(xr, p["conv"]["w"].shape[0])}
    return y


def rglru_decode(p: Params, cfg, x_t: torch.Tensor, state: Dict[str, Any]):
    """One-token step. x_t (B, 1, D); state {h (B, W) fp32, conv_buf (B, conv_width - 1, W)}."""
    xt = x_t[:, 0]
    gate = gelu(dense(p["w_gate_branch"], xt))
    xr = dense(p["w_x"], xt)
    conv_out, conv_buf = _conv_step(xr, p["conv"]["w"], state["conv_buf"])
    log_a, binp = _gates(p, conv_out)
    h_new = torch.exp(log_a) * state["h"] + binp
    y = dense(p["w_out"], h_new.to(x_t.dtype) * gate)[:, None]
    return y, {"h": h_new, "conv_buf": conv_buf}


def rglru_state_init(cfg, batch: int, dtype=torch.float32, *, device) -> Dict[str, torch.Tensor]:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv_buf": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
    }
