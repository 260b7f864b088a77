"""Prefill and training attention: the wrappers of the hand-written CUDA kernels.

Replaces ``repro.kernels.flash_attention.flash_attention``
(src/repro/kernels/flash_attention.py:120, Pallas body ``_flash_kernel``)
and the backward of ``repro.kernels.flash_vjp`` (``_make`` ``bwd``,
src/repro/kernels/flash_vjp.py:101-142). The kernels are
``csrc/flash_attention.cu`` (the forward, which also writes each row's
log-sum-exp when training asks for it) and ``csrc/flash_attention_bwd.cu``
(dq, dk, dv). The plain version of the attention, which a CPU tensor takes
(autograd differentiates it there), is
:func:`repro_torch.kernels.ref.attention_ref`; the plain versions of the
forward with ``lse`` and of the backward are ``kernels/flash_vjp.py``'s
:func:`~repro_torch.kernels.flash_vjp.flash_fwd` and
:func:`~repro_torch.kernels.flash_vjp.flash_bwd`.

On a CUDA tensor that needs a gradient, :func:`flash_attention` goes through
:class:`FlashAttention`: the forward kernel with ``lse``, then the backward
kernel. Without a gradient it launches the forward alone, as serving does.
A failed build or launch raises; nothing falls back to the plain version.

What bounds them on the H100: at llama3.2-1b's serving prefill and training
shape (B=8, S=256, 32 query heads, 8 kv heads, D=64, bf16, causal) the
forward is about 2.2 GFLOP against 21 MB of q, k, v and output, so the
card's bound is the bytes (6.3 us at 3.35 TB/s, against 2.2 us at 989
TFLOP/s bf16); the backward's five products are 5.4 GFLOP against 42 MB
(12.6 us at 3.35 TB/s).
What the designs do about it: the forward's blocks (a 64-row q tile each)
load their q tile once and stream the kv head's tiles through shared memory,
skipping tiles outside the causal or window support, and never write scores
to device memory; bf16 runs both products on the tensor cores (``mma.sync``,
P rounded to bf16 for the second) with the tiles in a double-buffered
``cp.async`` ring; fp32 keeps CUDA-core FMAs so that it holds the fp32
tolerance. The backward recomputes the scores in two kernels, one that owns
a key tile (dk, dv) and one that owns a query tile (dq), so that no block
adds into another's rows: it has no atomics and gives the same bits from run
to run. In bf16 all five of its products run on the tensor cores
(``mma.sync``, P and dS rounded to bf16 as operands straight from
registers) with the Q/dO and K/V tiles in ``cp.async`` rings; fp32 keeps
CUDA-core FMAs. Where the key tiles give the card less than a wave of
blocks, :func:`_bwd_plan` splits each kv head's GQA group over several
blocks and a reduce kernel sums their fp32 partials in a fixed order. The
sources' notes have the details.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from . import flash_vjp
from .ref import attention_ref as plain

KERNEL = _build.CudaKernel(
    "flash_attention.cu", "flash_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
)
BWD_KERNEL = _build.CudaKernel(
    "flash_attention_bwd.cu", "flash_attention_bwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
)
# the H100's SMs: the dk/dv grid the backward's head split aims to fill
H100_SMS = 132
CUDA_GRID_X, CUDA_GRID_Y = 2 ** 31 - 1, _build.CUDA_GRID_Y


class BwdPlan(NamedTuple):
    """How the backward kernel splits its dk/dv work (``csrc/flash_attention_bwd.cu``)."""
    splits: int                          # blocks each kv head's GQA group is split over
    grid: Tuple[int, int]                # dk/dv grid: (batch x kv heads x splits, key tiles)
    scratch: Optional[Tuple[int, ...]]   # fp32 partial dk and dv, (2, splits, B, Skv, KVH, D)


def _bwd_key_tile(d: int, dtype: torch.dtype) -> int:
    """Keys of a dk/dv block: the kernel's ``Mma<D>::BKV`` in bf16 (32 at
    D <= 64, 64 above), ``Tile<D>::B`` in fp32 (64, 32 at D = 256)."""
    if dtype == torch.bfloat16:
        return 32 if d <= 64 else 64
    return 32 if d > 128 else 64


def _bwd_plan(b: int, sq: int, skv: int, h: int, kvh: int, d: int,
              dtype: torch.dtype) -> BwdPlan:
    """The smallest divisor of the GQA group that gives the dk/dv grid at
    least one block for each of the H100's 132 SMs, or the whole group if none
    does. A dk/dv block owns a key tile (:func:`_bwd_key_tile`), so a short
    sequence with few kv heads (MQA) has few blocks, and each would walk its
    whole group alone. With ``splits`` > 1 each split writes fp32 partials
    into ``scratch`` and a reduce kernel sums them in split order."""
    group = h // kvh
    key_tiles = -(-skv // _bwd_key_tile(d, dtype))
    splits = next((s for s in range(1, group + 1)
                   if group % s == 0 and key_tiles * b * kvh * s >= H100_SMS), group)
    scratch = (2, splits, b, skv, kvh, d) if splits > 1 else None
    return BwdPlan(splits, (b * kvh * splits, key_tiles), scratch)


def _shapes(name: str, q, k, v, **more) -> Tuple[int, ...]:
    """(b, sq, skv, h, kvh, d) of a GQA attention the kernels take; raises otherwise."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    _build.check_cuda_inputs(name, {"q": q, "k": k, "v": v, **more})
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not form a GQA attention")
    _build.check_shapes(name, b=b, sq=sq, skv=skv, h=h, d=d, dtype=q.dtype)
    return b, sq, skv, h, kvh, d


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return float(sm_scale) if sm_scale is not None else q.shape[3] ** -0.5


def flash_attention_fwd(q, k, v, *, causal: bool, window: int, sm_scale: Optional[float],
                        softcap: float, q_offset: int,
                        with_lse: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, lse (B, H, Sq) fp32 or None): the forward kernel for a CUDA
    tensor, ``flash_vjp.flash_fwd`` for a CPU one."""
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        out, lse = flash_vjp.flash_fwd(q, k, v, causal=causal, window=window, scale=scale,
                                       softcap=softcap, q_offset=q_offset,
                                       chunk=min(512, k.shape[1]))
        return out, (lse if with_lse else None)
    b, sq, skv, h, kvh, d = _shapes("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    KERNEL.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        _build.DTYPE_CODES[q.dtype], b, sq, skv, h, kvh, d,
        int(causal), int(window), int(q_offset), scale, float(softcap),
    )
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool, window: int,
                        sm_scale: Optional[float], softcap: float,
                        q_offset: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the backward kernel for CUDA tensors, ``flash_vjp.flash_bwd``
    for CPU ones. ``out`` and ``lse`` are the forward's."""
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_vjp.flash_bwd(q, k, v, out, lse, dout, causal=causal, window=window,
                                   scale=scale, softcap=softcap, q_offset=q_offset,
                                   chunk=min(512, k.shape[1]))
    b, sq, skv, h, kvh, d = _shapes("flash_attention_bwd", q, k, v, out=out, dout=dout)
    if (out.shape != q.shape or dout.shape != q.shape or lse.dtype != torch.float32
            or lse.shape != (b, h, sq) or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} and a contiguous fp32 lse ({b}, {h}, {sq}) "
                         f"on {q.device} expected; lse is {lse.dtype} {tuple(lse.shape)}")
    plan = _bwd_plan(b, sq, skv, h, kvh, d, q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    scratch = (torch.empty(plan.scratch, dtype=torch.float32, device=q.device)
               if plan.scratch else None)
    BWD_KERNEL.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        _build.DTYPE_CODES[q.dtype], b, sq, skv, h, kvh, d,
        int(causal), int(window), int(q_offset), plan.splits, scale, float(softcap),
    )
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernels as one differentiable op: the forward kernel with ``lse``,
    saved with (q, k, v, out); the backward kernel from them."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), **ctx.kw), None)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,  # (B, Skv, KVH, D)
    *,
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention: the CUDA kernels for a CUDA tensor (differentiable when
    an input needs a gradient), the plain version for a CPU one."""
    kw = dict(causal=bool(causal), window=int(window), sm_scale=sm_scale,
              softcap=float(softcap), q_offset=int(q_offset))
    if q.device.type == "cpu":
        return plain(q, k, v, **kw)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, kw)
    return flash_attention_fwd(q, k, v, **kw, with_lse=False)[0]
