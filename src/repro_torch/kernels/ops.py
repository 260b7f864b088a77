"""Public entry points of the attention kernels, with the dispatch seam.

``impl`` semantics:
  * ``auto``    — the CUDA kernels for a CUDA tensor (differentiable through
                  the backward kernel); their plain PyTorch version for a CPU
                  tensor (the wrapper decides from the tensor alone);
  * ``chunked`` — the streaming form with its own backward,
                  ``kernels/flash_vjp.py`` (attention only), as the
                  reference's ``impl="chunked"``;
  * ``ref``     — always the plain oracle of ``kernels/ref.py``.

The signatures are those of ``repro.kernels.ops`` less ``block_q`` /
``block_k``: the CUDA kernels' tiles are compile-time constants.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref as _ref
from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel
from .flash_vjp import flash_attention_torch as _chunked

IMPLS = ("auto", "chunked", "ref")


def _check_impl(impl: str, impls=IMPLS) -> None:
    if impl not in impls:
        raise ValueError(f"impl {impl!r} not in {impls}")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
    softcap: float = 0.0,
    q_offset: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """Batched multi-head (GQA) attention, (B, S, H, D) layout."""
    _check_impl(impl)
    fn = {"auto": _flash_kernel, "chunked": _chunked, "ref": _ref.attention_ref}[impl]
    return fn(q, k, v, causal=causal, window=window, sm_scale=sm_scale,
              softcap=softcap, q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    softcap: float = 0.0,
    impl: str = "auto",
) -> torch.Tensor:
    """Single-token decode attention over a KV cache, (B, H, D) query."""
    _check_impl(impl, ("auto", "ref"))
    fn = _decode_kernel if impl == "auto" else _ref.decode_attention_ref
    return fn(q, k_cache, v_cache, lengths, sm_scale=sm_scale, softcap=softcap)
