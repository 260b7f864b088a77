"""Plain PyTorch versions of the attention kernels.

They are the port's ground truth and its CPU path: the CUDA kernels are held
against them on the card, and a wrapper given a CPU tensor runs them. They
copy ``repro.kernels.ref`` operation for operation, including the finite
``NEG_INF`` mask value (-0.7 of the largest float32), so that a fully masked
row gives the same numbers in both packages.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _broadcast_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, H, D), each kv head repeated group-size times."""
    group = num_q_heads // k.shape[2]
    return k if group == 1 else torch.repeat_interleave(k, group, dim=2)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool, window: int) -> torch.Tensor:
    """(Sq, Skv) validity of each key position for each query position."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_ref(
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
    """Multi-head attention with GQA, optional causal / sliding-window mask.

    ``q_offset`` is the absolute position of q[0] (the causal frontier of
    query row i sits at q_offset + i).
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    kb = _broadcast_kv(k, h)
    vb = _broadcast_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float()) * sm_scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = _mask(q_pos, k_pos, causal=causal, window=window)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vb.float())
    return o.to(q.dtype)


def attention_chunked(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,  # (B, Skv, KVH, D)
    *,
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
    softcap: float = 0.0,
    q_offset: int = 0,
    chunk: int = 512,
) -> torch.Tensor:
    """Streaming attention: a loop over KV chunks with an online softmax.

    The same function as :func:`attention_ref` with O(Sq·chunk) live memory
    instead of O(Sq·Skv), and the flash kernel's loop in plain PyTorch. Held
    against the JAX package by the tests; no serving path calls it.
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if skv <= chunk:
        return attention_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale, softcap=softcap, q_offset=q_offset)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    pad = (-skv) % chunk
    kb = F.pad(_broadcast_kv(k, h).float(), (0, 0, 0, 0, 0, pad))
    vb = F.pad(_broadcast_kv(v, h).float(), (0, 0, 0, 0, 0, pad))
    qf = q.float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for start in range(0, skv + pad, chunk):
        kc = kb[:, start:start + chunk]
        vc = vb[:, start:start + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        k_pos = start + torch.arange(chunk, device=q.device)
        mask = (k_pos < skv)[None, :] & _mask(q_pos, k_pos, causal=causal, window=window)
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        row_sum = alpha * row_sum + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
        m = m_new
    row_sum = torch.where(row_sum == 0.0, 1.0, row_sum)
    out = (acc / row_sum[..., None]).transpose(1, 2)
    return out.to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D) one new token per sequence
    k_cache: torch.Tensor,  # (B, S, KVH, D)
    v_cache: torch.Tensor,  # (B, S, KVH, D)
    lengths: torch.Tensor,  # (B,) int32: number of valid cache positions
    *,
    sm_scale: Optional[float] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Single-token decode attention over a (ragged-length) KV cache."""
    b, h, d = q.shape
    s_len = k_cache.shape[1]
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    kb = _broadcast_kv(k_cache, h)
    vb = _broadcast_kv(v_cache, h)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kb.float()) * sm_scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    valid = torch.arange(s_len, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, vb.float())
    return o.to(q.dtype)


def decode_attention_split_ref(
    q: torch.Tensor,  # (B, H, D) one new token per sequence
    k_cache: torch.Tensor,  # (B, S, KVH, D)
    v_cache: torch.Tensor,  # (B, S, KVH, D)
    lengths: torch.Tensor,  # (B,) int32: number of valid cache positions
    *,
    split: int,
    sm_scale: Optional[float] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """The split-KV algorithm of ``csrc/decode_attention.cu`` in plain PyTorch.

    Each split of ``split`` keys gets a partial (m, l, acc) with the finite
    ``NEG_INF``; a split at or past the length is empty (m = NEG_INF, l = 0,
    acc = 0); the partials merge as out = sum exp(m_i - M) acc_i / sum
    exp(m_i - M) l_i, and a sum of 0 (length 0) gives zeros, as the Pallas
    kernel does (``decode_attention_ref`` averages V there instead). The tests
    and ``chip_smoke.py`` hold the kernel's algorithm to it; no serving path
    calls it.
    """
    b, h, d = q.shape
    s_len = k_cache.shape[1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    n = -(-s_len // split)
    pad = n * split - s_len
    kb = F.pad(_broadcast_kv(k_cache, h).float(), (0, 0, 0, 0, 0, pad))  # (B, n*split, H, D)
    vb = F.pad(_broadcast_kv(v_cache, h).float(), (0, 0, 0, 0, 0, pad))
    lens = lengths.clamp(0, s_len)
    valid = torch.arange(n * split, device=q.device)[None, :] < lens[:, None]  # (B, n*split)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kb) * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid[:, None, :], s, NEG_INF).view(b, h, n, split)
    m = s.amax(dim=-1)  # (B, H, n)
    p = torch.exp(s - m[..., None])
    row_sum = p.sum(dim=-1)
    vb = torch.where(valid[:, :, None, None], vb, 0.0).view(b, n, split, h, d)
    acc = torch.einsum("bhns,bnshd->bhnd", p, vb)
    live = (torch.arange(n, device=q.device)[None, :] * split < lens[:, None])[:, None, :]
    m = torch.where(live, m, NEG_INF)
    row_sum = torch.where(live, row_sum, 0.0)
    acc = torch.where(live[..., None], acc, 0.0)
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))  # (B, H, n)
    total = (w * row_sum).sum(dim=-1)
    out = (w[..., None] * acc).sum(dim=-2) / torch.where(total == 0.0, 1.0, total)[..., None]
    return out.to(q.dtype)
