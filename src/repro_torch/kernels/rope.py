"""RoPE: the wrapper of the hand-written CUDA kernel that rotates a layer's q
and k in one launch.

Replaces no TPU kernel: the JAX package's ``repro.models.layers.apply_rope``
is jnp, which XLA fuses; the port's plain version,
:func:`repro_torch.models.layers.apply_rope`, which a CPU tensor takes, runs
it as some 19 PyTorch operations each for q and for k, in fp32 temporaries.
The kernel is ``csrc/rope.cu``.

What bounds it on the H100: the bytes, each element of q and k read and
written once (1.57 GB a layer at qwen2-7b's serving prefill, 0.47 ms at 3.35
TB/s, where the plain version moves ~19 GB). What the design does about it:
one pass, 16-byte loads, the angles' sines and cosines computed once a token
and lane in registers and reused over the heads; the source's note has the
details. It gives the plain version's numbers to the bit: the inverse
frequencies come from the plain version's own torch ops, computed once per
(head dim, theta, device) and kept (:func:`inv_freqs`), and the kernel rounds
each product and sum as the plain version's separate operations do.

On a CUDA tensor that needs a gradient, :func:`rope` goes through
:class:`Rope`, whose backward is the same kernel rotating by -angle (the
transpose). A failed build or launch raises; nothing falls back to the plain
version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..models.layers import apply_rope as plain
from ..models.layers import rope_freqs
from . import _build

KERNEL = _build.CudaKernel(
    "rope.cu", "rope_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_int64] * 8 + [ctypes.c_void_p],
)
# threads the grid aims at: one wave of the H100's 132 SMs at 2,048 resident
# threads each. Past it a thread rotates all of a token's heads (the angles
# computed once); short of it (decode's few rows) the heads are split.
WAVE_THREADS = 132 * 2048
_INV: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def inv_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs(head_dim, theta, device)``, computed at the first call for
    these arguments and kept: the kernel's inverse frequencies, the plain
    version's bits on the same device."""
    key = (head_dim, float(theta), device)
    if key not in _INV:
        _INV[key] = rope_freqs(head_dim, theta, device).contiguous()
    return _INV[key]


def _vec(d: int, tensors) -> int:
    """Elements a thread loads at once: 16 bytes' worth where every address
    and stride the kernel forms is 16-byte aligned, else 1."""
    elem = tensors[0].element_size()
    wide = 16 // elem
    aligned = all(t.data_ptr() % 16 == 0 and all(st * elem % 16 == 0 for st in t.stride()[:-1])
                  for t in tensors)
    return wide if aligned and (d // 2) % wide == 0 else 1


def _check(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"rope: q {tuple(q.shape)} and k {tuple(k.shape)} are not "
                         "(B, S, H, D) and (B, S, KVH, D)")
    if q.shape[3] % 2:
        raise ValueError(f"rope: head dim {q.shape[3]} is odd")
    if (positions.shape != q.shape[:2] or positions.device != q.device
            or positions.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"rope: positions must be ({q.shape[0]}, {q.shape[1]}) int32 or int64 "
                         f"on {q.device}, got {positions.dtype} {tuple(positions.shape)} on "
                         f"{positions.device}")
    for name, t in (("q", q), ("k", k)):
        if t.stride(-1) != 1:
            raise ValueError(f"rope: {name}'s last dim is not contiguous")
        if t.dtype != q.dtype or t.dtype not in _build.DTYPE_CODES:
            raise ValueError(f"rope: {name} is {t.dtype}; the kernel takes float32 or "
                             "bfloat16, the same for q and k")
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"rope: {name} is on {t.device}; the kernel takes tensors on one "
                             "CUDA device (CPU tensors take the plain version)")


def heads_a_thread(rows: int, lanes: int, heads: int) -> int:
    """How many of a token's ``heads`` (q's and k's) one thread rotates, when a
    head takes ``lanes`` threads: all of them where ``rows`` tokens fill a
    wave (:data:`WAVE_THREADS`) with one thread a lane, else as few as make
    one wave, down to one."""
    chunks = min(heads, max(1, -(-WAVE_THREADS // (rows * lanes))))
    return -(-heads // chunks)


def rope_fwd(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, theta: float, *,
             inverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q', k'), q and k rotated at ``positions`` (by -angle with ``inverse``),
    contiguous, in one launch of the kernel. CUDA tensors only."""
    _check(q, k, positions)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    q_out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    k_out = torch.empty((b, s, kvh, d), dtype=k.dtype, device=k.device)
    if b * s == 0:
        return q_out, k_out
    vec = _vec(d, (q, k, q_out, k_out))
    chunk = heads_a_thread(b * s, d // 2 // vec, h + kvh)
    inv = inv_freqs(d, theta, q.device)
    KERNEL.launch(
        q.device, q.data_ptr(), k.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
        positions.data_ptr(), inv.data_ptr(), _build.DTYPE_CODES[q.dtype],
        int(positions.dtype == torch.int64), vec, int(inverse), b, s, h, kvh, d, chunk,
        *q.stride()[:3], *k.stride()[:3], *positions.stride(),
    )
    return q_out, k_out


class Rope(torch.autograd.Function):
    """The kernel as one differentiable op: the backward rotates the
    gradients by -angle, in one launch."""

    @staticmethod
    def forward(ctx, q, k, positions, theta):
        ctx.save_for_backward(positions)
        ctx.theta = theta
        return rope_fwd(q, k, positions, theta)

    @staticmethod
    def backward(ctx, dq, dk):
        (positions,) = ctx.saved_tensors
        return (*rope_fwd(dq.contiguous(), dk.contiguous(), positions, ctx.theta,
                          inverse=True), None, None)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE of q (B, S, H, D) and k (B, S, KVH, D) at positions (B, S): the
    CUDA kernel for a CUDA tensor (differentiable when q or k needs a
    gradient), the plain version for a CPU one."""
    if q.device.type == "cpu":
        return plain(q, positions, theta), plain(k, positions, theta)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return Rope.apply(q, k, positions, theta)
    return rope_fwd(q, k, positions, theta)
