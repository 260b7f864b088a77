"""Prefill attention: the wrapper of the hand-written CUDA kernel.

Replaces ``repro.kernels.flash_attention.flash_attention``
(src/repro/kernels/flash_attention.py:120, Pallas body ``_flash_kernel``).
The kernel is ``csrc/flash_attention.cu``; its plain version, which a CPU
tensor takes, is :func:`repro_torch.kernels.ref.attention_ref`.

What bounds it on the H100: at llama3.2-1b's serving prefill (B=8, S=256,
32 query heads, 8 kv heads, D=64, bf16, causal) the work is about 2.2 GFLOP
against 21 MB of q, k, v and output, so the card's bound is the bytes
(6.3 us at 3.35 TB/s, against 2.2 us at 989 TFLOP/s bf16). What the design
does about it: one block per (64-row q tile, batch x head) loads its q tile
once and streams the kv head's tiles through shared memory, skipping tiles
outside the causal or window support, and never writes scores to device
memory. bf16 runs both products on the tensor cores (``mma.sync``, P rounded
to bf16 for the second) with the tiles in a double-buffered ``cp.async``
ring; fp32 keeps CUDA-core FMAs so that it holds the fp32 tolerance. The
source's note has the details.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import attention_ref as plain

KERNEL = _build.CudaKernel(
    "flash_attention.cu", "flash_attention_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
)


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
    """GQA attention; the CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, sm_scale=sm_scale,
                     softcap=softcap, q_offset=q_offset)
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    _build.check_cuda_inputs("flash_attention", {"q": q, "k": k, "v": v}, d)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not form a GQA attention")
    if sq == 0 or b * h > 65535:
        raise ValueError(f"flash_attention: grid of {sq} query rows x {b * h} heads out of range")
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    out = torch.empty_like(q)
    KERNEL.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, sq, skv, h, kvh, d,
        int(causal), int(window), int(q_offset), scale, float(softcap),
    )
    return out
