"""Decode attention: the wrapper of the hand-written CUDA kernel.

Replaces ``repro.kernels.decode_attention.decode_attention``
(src/repro/kernels/decode_attention.py:99, Pallas body ``_decode_kernel``).
The kernel is ``csrc/decode_attention.cu``; its plain version, which a CPU
tensor takes, is :func:`repro_torch.kernels.ref.decode_attention_ref`.

What bounds it on the H100: the bytes. Each step reads every valid cached
key and value once (2 x B x length x KVH x D x 2 bytes in bf16, 4.5 MB at
llama3.2-1b's serving batch 8 and lengths near 270) for 4 FLOPs per key and
query head, far below the card's 295 FLOPs per byte. What the design does
about it: split-KV (flash-decoding). The cache is cut into splits of
``SPLIT`` keys, one block each, that score their keys against the whole
query group (4 heads for llama3.2-1b) with 16-byte loads, so the cache is
read once per group; splits past a sequence's length read nothing. A second
kernel, launched by the same C entry point, merges the splits' partial
(m, l, acc), which live in fp32 scratch this wrapper allocates. The number
of splits comes from the cache length ``S``, never from ``lengths``, so no
launch reads the device. Its plain version of the split algorithm is
:func:`repro_torch.kernels.ref.decode_attention_split_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import decode_attention_ref as plain

KERNEL = _build.CudaKernel(
    "decode_attention.cu", "decode_attention_fwd",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
)
SPLIT = 64  # keys per split: SPLIT in csrc/decode_attention.cu


def decode_attention(
    q: torch.Tensor,        # (B, H, D) one new token per sequence
    k_cache: torch.Tensor,  # (B, S, KVH, D)
    v_cache: torch.Tensor,  # (B, S, KVH, D)
    lengths: torch.Tensor,  # (B,) int32 valid positions per sequence
    *,
    sm_scale: Optional[float] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Decode attention; the CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, lengths, sm_scale=sm_scale, softcap=softcap)
    b, h, d = q.shape
    _, s_len, kvh, _ = k_cache.shape
    _build.check_cuda_inputs("decode_attention", {"q": q, "k_cache": k_cache,
                                                  "v_cache": v_cache})
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != b or k_cache.shape[3] != d
            or h % kvh):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache {tuple(v_cache.shape)} do not "
                         "form a GQA decode")
    _build.check_shapes("decode_attention", b=b, sq=1, skv=s_len, h=h, d=d, dtype=q.dtype)
    if (lengths.device != q.device or lengths.dtype != torch.int32
            or lengths.shape != (b,) or not lengths.is_contiguous()):
        raise ValueError(f"decode_attention: lengths must be a contiguous ({b},) int32 "
                         f"tensor on {q.device}, got {lengths.dtype} {tuple(lengths.shape)} "
                         f"on {lengths.device}")
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    out = torch.empty_like(q)
    # the partials of every (sequence, kv head, split, head of the group), in one
    # allocation: acc (d floats each), then m, then l
    n_part = b * kvh * -(-s_len // SPLIT) * (h // kvh)
    scratch = torch.empty(n_part * (d + 2), dtype=torch.float32, device=q.device)
    acc, m_part, l_part = scratch.split([n_part * d, n_part, n_part])
    KERNEL.launch(
        q.device, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), acc.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, s_len, h, kvh, d, scale, float(softcap),
    )
    return out
