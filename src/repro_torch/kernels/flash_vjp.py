"""Flash-attention forward and backward in plain PyTorch, O(S·chunk) memory.

The port of ``repro.kernels.flash_vjp``, operation for operation: the
forward streams KV chunks with an online softmax and keeps only
``(out, lse)``; the backward streams the chunks again, rebuilds p from lse,
takes ``delta = Σ dout·out``, ``ds = p (dp − delta)`` (times ``1 − t²``
under a softcap, t the tanh of the capped score) and folds the GQA groups
back onto the kv heads. The finite ``NEG_INF``, the zero padding of the last
chunk and ``lsafe`` (l == 0 -> 1) are the reference's, so a fully masked
query row gives the reference's numbers too: the mean of V over the padded
chunks, and a non-zero dv.

It is the plain version of ``csrc/flash_attention_bwd.cu`` (and of the
forward kernel's ``lse``): ``chip_smoke.py`` holds the kernels against
:func:`flash_fwd` / :func:`flash_bwd` on the card, and
``ops.attention(impl="chunked")`` runs :func:`flash_attention_torch`, as the
reference's ``impl="chunked"`` runs ``flash_attention_jnp``. No path on the
card calls it otherwise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _bcast_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    kvh = k.shape[2]
    return k if kvh == h else torch.repeat_interleave(k, h // kvh, dim=2)


def _mask(sq, skv, chunk, ci, q_offset, causal, window, device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = ci * chunk + torch.arange(chunk, device=device)
    m = (k_pos < skv)[None, :]
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m  # (sq, chunk), or (1, chunk) without causal or window


def _padded(k: torch.Tensor, v: torch.Tensor, h: int, chunk: int):
    """k, v broadcast to the query heads, zero-padded to a whole number of chunks."""
    kb, vb = _bcast_kv(k, h), _bcast_kv(v, h)
    pad = (-k.shape[1]) % chunk
    if pad:
        kb, vb = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (kb, vb))
    return kb, vb


def _chunk_of(a: torch.Tensor, ci: int, chunk: int) -> torch.Tensor:
    return a[:, ci * chunk:(ci + 1) * chunk].float()


def flash_fwd(q, k, v, *, causal: bool, window: int, scale: float, softcap: float,
              q_offset: int, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) fp32, natural log)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kb, vb = _padded(k, v, h, chunk)
    qf = q.float()
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for ci in range(kb.shape[1] // chunk):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, _chunk_of(kb, ci, chunk)) * scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        msk = _mask(sq, skv, chunk, ci, q_offset, causal, window, q.device)
        s = torch.where(msk[None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    _chunk_of(vb, ci, chunk))
        m = m_new
    lsafe = torch.where(l == 0.0, 1.0, l)
    out = (acc / lsafe[..., None]).transpose(1, 2).to(q.dtype)
    return out, m + torch.log(lsafe)


def flash_bwd(q, k, v, out, lse, dout, *, causal: bool, window: int, scale: float,
              softcap: float, q_offset: int, chunk: int):
    """(dq, dk, dv) in the inputs' dtypes, from the forward's (out, lse)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    kb, vb = _padded(k, v, h, chunk)
    nc = kb.shape[1] // chunk
    qf = q.float()
    go = dout.float().transpose(1, 2)                  # (b, h, sq, d)
    of = out.float().transpose(1, 2)
    delta = torch.sum(go * of, dim=-1)                 # (b, h, sq)
    dq = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    dk_chunks, dv_chunks = [], []
    for ci in range(nc):
        kf, vf = _chunk_of(kb, ci, chunk), _chunk_of(vb, ci, chunk)
        s1 = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if softcap > 0.0:
            t = torch.tanh(s1 / softcap)
            s = t * softcap
        else:
            s = s1
        msk = _mask(sq, skv, chunk, ci, q_offset, causal, window, q.device)
        s = torch.where(msk[None, None], s, NEG_INF)
        p = torch.exp(s - lse[..., None])              # (b, h, q, k)
        dv_chunks.append(torch.einsum("bhqk,bhqd->bkhd", p, go))
        dp = torch.einsum("bhqd,bkhd->bhqk", go, vf)
        ds = p * (dp - delta[..., None])               # d/d(s_soft)
        if softcap > 0.0:
            ds = ds * (1.0 - t * t)
        ds = torch.where(msk[None, None], ds, 0.0)
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk_chunks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale)
    dk = torch.cat(dk_chunks, dim=1)[:, :skv]
    dv = torch.cat(dv_chunks, dim=1)[:, :skv]
    if group > 1:  # GQA: fold query-head groups back onto kv heads
        dk = dk.reshape(b, skv, kvh, group, d).sum(dim=3)
        dv = dv.reshape(b, skv, kvh, group, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashVJP(torch.autograd.Function):
    """The reference's ``custom_vjp``: saves (q, k, v, out, lse) only."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = flash_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_bwd(q, k, v, out, lse, dout, **ctx.kw), None)


def flash_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
    softcap: float = 0.0,
    q_offset: int = 0,
    chunk: int = 512,
) -> torch.Tensor:
    """Differentiable flash-equivalent attention (O(S·chunk) fwd AND bwd)."""
    d, skv = q.shape[3], k.shape[1]
    kw = dict(causal=bool(causal), window=int(window),
              scale=float(sm_scale) if sm_scale is not None else d ** -0.5,
              softcap=float(softcap), q_offset=int(q_offset), chunk=int(min(chunk, skv)))
    return _FlashVJP.apply(q, k, v, kw)
