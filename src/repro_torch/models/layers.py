"""Core layers: initialization helpers, norms, embeddings, RoPE / M-RoPE.

As in ``repro.models.layers``, a "module" is a pair of plain functions,
``*_init(...) -> params`` and ``apply(params, x, ...) -> y``, over nested
dicts of tensors. Dense weights keep the (d_in, d_out) layout and apply as
``x @ w``, so parameters carry over from the JAX package unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .. import obs

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------

def trunc_normal_(w: torch.Tensor, std: float, gen: torch.Generator) -> torch.Tensor:
    """Fill ``w`` with N(0, std) cut at two std, in place. A fake tensor (shapes
    only, ``FakeTensorMode``: ``configs.param_specs_struct``, the dry run) is
    left as it is: it holds no values, and torch's rejection loop reads them."""
    from torch._subclasses.fake_tensor import is_fake

    if not is_fake(w):
        torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)
    return w


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
               bias: bool = False, scale: float = 1.0) -> Params:
    """Truncated-normal fan-in init: N(0, std) cut at two std, in fp32."""
    std = scale / (d_in ** 0.5)
    w = trunc_normal_(torch.empty((d_in, d_out), dtype=torch.float32, device=gen.device),
                      std, gen)
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

def norm_init(d: int, kind: str, dtype, device) -> Params:
    p: Params = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm (biased variance, the reference's eps for both),
    computed in fp32 and cast back to the input's dtype."""
    with obs.span("norm"):
        xf = x.float()
        if kind == "rmsnorm":
            var = torch.mean(xf * xf, dim=-1, keepdim=True)
            y = xf * torch.rsqrt(var + eps)
        else:  # layernorm
            mu = torch.mean(xf, dim=-1, keepdim=True)
            var = torch.var(xf, dim=-1, keepdim=True, correction=0)
            y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float()
        if "bias" in p:
            y = y + p["bias"].float()
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + multimodal M-RoPE), fixed sinusoids
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
    return _rotate(x, positions[..., None].float() * inv)  # angles (B, S, hd/2)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the half-split pairs of x (B, S, heads, hd) by ang (B, S, hd/2)."""
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): three position streams (t, h, w) rotate
    disjoint sections of the frequency pairs.

    x: (B, S, heads, head_dim); positions: (B, S, 3) integer ids. ``sections``
    are sizes in pairs summing to head_dim // 2: pair j takes its angle from
    the stream whose section holds j.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to head_dim // 2 = {hd // 2}")
    inv = rope_freqs(hd, theta, x.device)
    pos = positions.float()
    pos = torch.cat([pos[..., i:i + 1].expand(*pos.shape[:-1], n)
                     for i, n in enumerate(sections)], dim=-1)  # (B, S, hd/2)
    return _rotate(x, pos * inv)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings, shape (seq, d), fp32: sin on
    the even columns, cos on the odd."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-math.log(10000.0)
                    * torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    ang = pos * div
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": gelu, "geglu": gelu, "relu": F.relu}[name]


GATED_ACTS = ("silu", "geglu")  # SwiGLU / GeGLU
