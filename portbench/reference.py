"""The parts of the plain reference that no architecture owns, in plain
PyTorch and float32 with TF32 off: products (``Linear``), RMSNorm, rotary
embeddings over the half-split pairs, causal attention, a SwiGLU MLP, the
MoE's capacity rule, and the two lower-precision readings. An architecture
module (``archs/<arch>.py``) builds its ``forward`` from them.

A reference is teacher-forced: ``forward`` runs whole rows of token ids (a
served request's padded prompt and the tokens fed back to the decode steps)
layer by layer, and hands the logits at the positions asked for to a
callback. The weights are the benchmark's bf16 tensors, cast to float32 a
layer at a time. ``precision="fp8"`` is the control: every product's weight
and input rounded to float8 e4m3 with a per-tensor scale.
``precision="bf16"`` is a witness, not a check: float32 arithmetic with
every product's input and output, every norm, rotation and residual sum
rounded to bfloat16, as the served path rounds them; it shows how far bf16
rounding alone moves the logits (an MoE's routes flip under it).

Nothing here imports the program under test.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch

TOKEN_CHUNK = 8192  # rows of the MLP, expert and head products at a time
QUERY_CHUNK = 1024  # query rows of an attention block at a time
FP8_MAX = 448.0  # largest float8 e4m3 value


@contextlib.contextmanager
def exact_float32():
    """Float32 products in float32: TF32 off for matmul and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rnd(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` rounded to bfloat16 in the bf16 witness, as it is."""
    return t.to(torch.bfloat16).float() if precision == "bf16" else t


class Linear:
    """x @ w (+ b) in float32; in the fp8 control both operands rounded, in
    the bf16 witness the input and the output."""

    def __init__(self, p: Dict[str, torch.Tensor], precision: str):
        self.w = p["w"].float()
        self.precision = precision
        if precision == "fp8":
            self.w = fp8(self.w)
        self.b = p["b"].float() if "b" in p else None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = fp8(x) if self.precision == "fp8" else rnd(x, self.precision)
        y = rnd(x @ self.w, self.precision)
        return rnd(y + self.b, self.precision) if self.b is not None else y


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (R, T, heads, hd) at positions 0..T-1, pairs
    (i, i + hd/2) rotated by position / theta^(2i/hd)."""
    t, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv  # (T, hd/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v with a causal mask, one row at a time and
    QUERY_CHUNK queries at a time. q (R, T, H, hd); k, v (R, T, KVH, hd)."""
    r, t, h, hd = q.shape
    group = h // k.shape[2]
    out = torch.empty_like(q)
    for i in range(r):
        kr = k[i].repeat_interleave(group, dim=1).transpose(0, 1)  # (H, T, hd)
        vr = v[i].repeat_interleave(group, dim=1).transpose(0, 1)
        for a in range(0, t, QUERY_CHUNK):
            b = min(t, a + QUERY_CHUNK)
            qc = q[i, a:b].transpose(0, 1)  # (H, c, hd)
            s = qc @ kr[:, :b].transpose(1, 2) / math.sqrt(hd)  # (H, c, b)
            mask = torch.arange(b, device=q.device)[None, :] > torch.arange(
                a, b, device=q.device)[:, None]
            s = s.masked_fill(mask, float("-inf"))
            out[i, a:b] = (torch.softmax(s, dim=-1) @ vr[:, :b]).transpose(0, 1)
    return out


def swiglu(p: Dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)), TOKEN_CHUNK rows at a time."""
    up, gate, down = (Linear(p[n], precision) for n in ("w_in", "w_gate", "w_out"))
    out = torch.empty_like(x)
    for a in range(0, x.shape[0], TOKEN_CHUNK):
        xc = x[a:a + TOKEN_CHUNK]
        out[a:a + TOKEN_CHUNK] = down(rnd(torch.nn.functional.silu(gate(xc)) * up(xc),
                                          precision))
    return out


def capacity_keep(sel: torch.Tensor, experts: int, cf: float) -> torch.Tensor:
    """Which of a capacity group's (token, choice) pairs ``sel`` (Tg, k) keep
    their expert: a pair keeps it while fewer than ceil(Tg k cf / E) earlier
    pairs, in (token, choice) order, chose the same expert (E ``experts``)."""
    tg, k = sel.shape
    cap = max(int(math.ceil(tg * k * cf / experts)), 1)
    flat = sel.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, experts)
    earlier = torch.cumsum(onehot, dim=0) - onehot
    return (earlier.gather(1, flat[:, None])[:, 0] < cap).reshape(tg, k)
