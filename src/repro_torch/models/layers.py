"""Core layers: initialization helpers, norms, embeddings, RoPE.

As in ``repro.models.layers``, a "module" is a pair of plain functions,
``*_init(...) -> params`` and ``apply(params, x, ...) -> y``, over nested
dicts of tensors. Dense weights keep the (d_in, d_out) layout and apply as
``x @ w``, so parameters carry over from the JAX package unchanged.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
               bias: bool = False, scale: float = 1.0) -> Params:
    """Truncated-normal fan-in init: N(0, std) cut at two std, in fp32."""
    std = scale / (d_in ** 0.5)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)
    p: Params = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    w = torch.randn((vocab, d), dtype=torch.float32, device=gen.device, generator=gen)
    return {"w": (w * d ** -0.5).to(dtype)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, p["w"])


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Project hidden states to logits with the table given: the tied
    embedding or the untied ``head``."""
    return x @ p["w"].T


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, computed in fp32 and cast back to the input's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard half-split (not interleaved) RoPE with fp32 angles.

    x: (B, S, heads, head_dim); positions: (B, S) integer ids.
    """
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * inv  # (B, S, hd/2)
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": gelu, "geglu": gelu, "relu": F.relu}[name]


GATED_ACTS = ("silu", "geglu")  # SwiGLU / GeGLU
