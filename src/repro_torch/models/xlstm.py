"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar).

A port of ``repro.models.xlstm``. The mLSTM runs a prompt in the chunkwise
form: within a chunk the stabilized quadratic form, across chunks the
(C, n, m) matrix memory carried by a Python loop over the chunks; decode is
the O(1) recurrent update of that memory. ``mlstm_parallel`` is the whole
quadratic form at once, which the tests hold the chunkwise form against.
The sLSTM has true sequential recurrence (h_{t-1} enters the gates): a
Python loop over time, one ``slstm_cell`` a step.

All gate math is in fp32 with the reference's stabilizers: the -1e30 mask
and ``max(|den|, exp(-m))`` of the mLSTM, the sLSTM's ``n + 1e-6``, taken in
the reference's order. The causal depthwise-conv helpers are shared with the
RG-LRU block (``models/rglru.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .layers import DTYPES, Params, dense, dense_init, gelu

NEG_INF = -1e30
CHUNK = 256  # mLSTM chunk of a prompt (the reference's default; no config sets another)


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time. x (B, S, C), w (W, C).

    The taps are summed in the reference's order, oldest first.
    """
    wdt, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, wdt - 1, 0))
    return sum(xp[:, i:i + s] * w[i] for i in range(wdt))


def _conv_step(x_t: torch.Tensor, w: torch.Tensor, buf: torch.Tensor):
    """Single decode step. x_t (B, C); buf (B, W-1, C) past inputs.

    Returns (output (B, C), the new buffer).
    """
    full = torch.cat([buf, x_t[:, None]], dim=1)  # (B, W, C)
    out = torch.einsum("bwc,wc->bc", full, w)
    return out, full[:, 1:]


def conv_tail_buffer(x: torch.Tensor, width: int) -> torch.Tensor:
    """Last width-1 inputs, for continuing a causal conv at decode time."""
    s = x.shape[1]
    need = width - 1
    if s >= need:
        return x[:, s - need:]
    return F.pad(x, (0, 0, need - s, 0))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    inner = 2 * d
    h = cfg.num_heads
    dt = DTYPES[cfg.param_dtype]
    conv = torch.randn((cfg.conv_width, inner), dtype=torch.float32, device=gen.device,
                       generator=gen)
    return {
        "w_up": dense_init(gen, d, inner, dt),
        "w_z": dense_init(gen, d, inner, dt),
        "wq": dense_init(gen, inner, inner, dt),
        "wk": dense_init(gen, inner, inner, dt),
        "wv": dense_init(gen, inner, inner, dt),
        "w_if": dense_init(gen, inner, 2 * h, torch.float32, bias=True),
        "conv": {"w": conv.to(dt) * 0.1},
        "w_down": dense_init(gen, inner, d, dt, scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, inner = x.shape
    return x.reshape(b, s, h, inner // h)


def _tril(n: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((n, n), dtype=torch.bool, device=device))


def mlstm_parallel(q, k, v, log_i, log_f) -> torch.Tensor:
    """Stabilized parallel (quadratic) mLSTM form.

    q, k, v: (B, S, H, dh); log_i, log_f: (B, S, H) fp32. Returns h_tilde
    (B, S, H, dh) in q's dtype.
    """
    s, dh = q.shape[1], q.shape[-1]
    lf_cum = torch.cumsum(log_f, dim=1)  # F_t = sum_{u<=t} log f_u
    # D[t, u] = F_t - F_u + log i_u for u <= t: the weight of step u at t
    dmat = lf_cum[:, :, None, :] - lf_cum[:, None, :, :] + log_i[:, None, :, :]
    dmat = torch.where(_tril(s, q.device)[None, :, :, None], dmat, NEG_INF)  # (B, T, U, H)
    m = torch.amax(dmat, dim=2, keepdim=True)  # (B, T, 1, H) stabilizer
    dexp = torch.exp(dmat - m)
    scores = torch.einsum("bthd,buhd->btuh", q.float(), k.float())
    scores = scores / math.sqrt(dh)
    w = scores * dexp
    norm = torch.maximum(torch.abs(torch.sum(w, dim=2)), torch.exp(-m[:, :, 0]))  # (B, T, H)
    out = torch.einsum("btuh,buhd->bthd", w, v.float())
    out = out / (norm[..., None] + 1e-6)
    return out.to(q.dtype)


def mlstm_step(state: Dict[str, torch.Tensor], q, k, v, log_i, log_f):
    """O(1) recurrent update. q, k, v: (B, H, dh); gates (B, H).

    state: C (B, H, dh, dh) laid out [d_v, d_k], n (B, H, dh), m (B, H).
    Returns (new state, h (B, H, dh) in q's dtype).
    """
    dh = q.shape[-1]
    m_prev, c_prev, n_prev = state["m"], state["C"], state["n"]
    m_new = torch.maximum(log_f + m_prev, log_i)
    i_ = torch.exp(log_i - m_new)
    f_ = torch.exp(log_f + m_prev - m_new)
    kf = k.float() / math.sqrt(dh)
    c_new = f_[..., None, None] * c_prev + i_[..., None, None] * (
        v.float()[..., :, None] * kf[..., None, :])
    n_new = f_[..., None] * n_prev + i_[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhvk,bhk->bhv", c_new, qf)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n_new, qf)), torch.exp(-m_new))
    h = num / (den[..., None] + 1e-6)
    return {"C": c_new, "n": n_new, "m": m_new}, h.to(q.dtype)


def _mlstm_qk_gates(p: Params, cfg, x_in: torch.Tensor):
    """Shared projection path: x_in (B, S, inner) post-conv activations."""
    h = cfg.num_heads
    q = _split_heads(dense(p["wq"], x_in), h)
    k = _split_heads(dense(p["wk"], x_in), h)
    gates = dense(p["w_if"], x_in.float())  # (B, S, 2H)
    log_i = gates[..., :h]  # exponential input gate: log i = pre-activation
    log_f = F.logsigmoid(gates[..., h:])
    return q, k, log_i, log_f


def mlstm_state0(b: int, h: int, dh: int, device) -> Dict[str, torch.Tensor]:
    """The empty matrix memory: C and n zero, the stabilizer m at -1e9."""
    return {"C": torch.zeros((b, h, dh, dh), dtype=torch.float32, device=device),
            "n": torch.zeros((b, h, dh), dtype=torch.float32, device=device),
            "m": torch.full((b, h), -1e9, dtype=torch.float32, device=device)}


def mlstm_sequence(q, k, v, log_i, log_f, state0: Optional[Dict[str, torch.Tensor]] = None,
                   chunk: int = CHUNK):
    """Chunkwise-parallel mLSTM: O(S chunk) memory, exact math.

    q, k, v: (B, S, H, dh); gates (B, S, H) fp32. The sequence is padded to a
    whole number of chunks (zero q, k, v, forget gates log 1, input gates at
    NEG_INF, so the padding adds nothing to the state). Returns (out
    (B, S, H, dh) in q's dtype, the final state {C, n, m}).
    """
    b, s, h, dh = q.shape
    k = k / math.sqrt(dh)
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG_INF)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    state = state0 if state0 is not None else mlstm_state0(b, h, dh, q.device)
    tmask = _tril(chunk, q.device)[None, :, :, None]
    outs = []
    for c in range(nc):
        rows = slice(c * chunk, (c + 1) * chunk)
        c0, n0, m0 = state["C"], state["n"], state["m"]
        qf, kf, vf = (a[:, rows].float() for a in (q, k, v))
        li, lf = log_i[:, rows], log_f[:, rows]
        fcum = torch.cumsum(lf, dim=1)  # (B, W, H) inclusive
        dmat = fcum[:, :, None] - fcum[:, None] + li[:, None]  # (B, t, u, H)
        dmat = torch.where(tmask, dmat, NEG_INF)
        e_t = fcum + m0[:, None]  # (B, W, H) weight of the entering state at t
        m_t = torch.maximum(torch.amax(dmat, dim=2), e_t)  # (B, W, H)
        dexp = torch.exp(dmat - m_t[:, :, None])
        scores = torch.einsum("bthd,buhd->btuh", qf, kf) * dexp
        inter_w = torch.exp(e_t - m_t)  # (B, W, H)
        num = torch.einsum("btuh,buhd->bthd", scores, vf)
        num = num + torch.einsum("bhvk,bthk->bthv", c0, qf) * inter_w[..., None]
        den = torch.sum(scores, dim=2) + torch.einsum("bhk,bthk->bth", n0, qf) * inter_w
        den = torch.maximum(torch.abs(den), torch.exp(-m_t))
        outs.append((num / (den[..., None] + 1e-6)).to(q.dtype))
        # the state handed to the next chunk
        f_last = fcum[:, -1]  # (B, H)
        m_new = torch.maximum(m0 + f_last, torch.amax(f_last[:, None] - fcum + li, dim=1))
        decay = torch.exp(m0 + f_last - m_new)
        per_u = torch.exp(f_last[:, None] - fcum + li - m_new[:, None])  # (B, W, H)
        c_new = decay[..., None, None] * c0 + torch.einsum("buh,buhv,buhk->bhvk", per_u, vf, kf)
        n_new = decay[..., None] * n0 + torch.einsum("buh,buhk->bhk", per_u, kf)
        state = {"C": c_new, "n": n_new, "m": m_new}
    return torch.cat(outs, dim=1)[:, :s], state


def mlstm_apply(p: Params, cfg, x: torch.Tensor, state0=None, return_state: bool = False):
    """Full-sequence mLSTM block body (after the outer norm). x (B, S, D).

    With ``return_state`` also the decode state: the matrix memory and the
    conv's last inputs.
    """
    up = dense(p["w_up"], x)
    z = dense(p["w_z"], x)
    conv = F.silu(_causal_conv(up, p["conv"]["w"]))
    q, k, log_i, log_f = _mlstm_qk_gates(p, cfg, conv)
    v = _split_heads(up, cfg.num_heads)  # values from the pre-conv stream
    ht, state = mlstm_sequence(q, k, v, log_i, log_f, state0=state0)
    b, s = ht.shape[:2]
    out = ht.reshape(b, s, -1) * F.silu(z)
    y = dense(p["w_down"], out)
    if return_state:
        return y, dict(state, conv_buf=conv_tail_buffer(up, p["conv"]["w"].shape[0]))
    return y


def mlstm_decode(p: Params, cfg, x_t: torch.Tensor, state: Dict[str, Any]):
    """One-token step. x_t (B, 1, D); state {C, n, m, conv_buf}."""
    up = dense(p["w_up"], x_t)[:, 0]
    z = dense(p["w_z"], x_t)[:, 0]
    conv_out, conv_buf = _conv_step(up, p["conv"]["w"], state["conv_buf"])
    conv_out = F.silu(conv_out)
    h = cfg.num_heads
    inner = up.shape[-1]
    dh = inner // h
    q = dense(p["wq"], conv_out).reshape(-1, h, dh)
    k = dense(p["wk"], conv_out).reshape(-1, h, dh)
    gates = dense(p["w_if"], conv_out.float())
    log_i, log_f = gates[..., :h], F.logsigmoid(gates[..., h:])
    v = up.reshape(-1, h, dh)
    cell = {"C": state["C"], "n": state["n"], "m": state["m"]}
    new_cell, ht = mlstm_step(cell, q, k, v, log_i, log_f)
    out = ht.reshape(ht.shape[0], inner) * F.silu(z)
    y = dense(p["w_down"], out)[:, None]
    return y, dict(new_cell, conv_buf=conv_buf)


def mlstm_state_init(cfg, batch: int, dtype=torch.float32, *, device) -> Dict[str, torch.Tensor]:
    h = cfg.num_heads
    inner = 2 * cfg.d_model
    return dict(mlstm_state0(batch, h, inner // h, device),
                conv_buf=torch.zeros((batch, cfg.conv_width - 1, inner), dtype=dtype,
                                     device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    dt = DTYPES[cfg.param_dtype]
    # 4 gates (i, f, z, o); the recurrent weights are block-diagonal per head
    w = torch.randn((d, 4 * d), dtype=torch.float32, device=gen.device, generator=gen)
    r = torch.randn((h, dh, 4 * dh), dtype=torch.float32, device=gen.device, generator=gen)
    up_f = int(d * 4 / 3 / 64) * 64 or d
    return {
        "w": {"w": (w / math.sqrt(d)).to(dt)},
        "r": {"w": (r / math.sqrt(dh) * 0.1).to(dt)},
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=gen.device),
        "w_up": dense_init(gen, d, up_f, dt),
        "w_down": dense_init(gen, up_f, d, dt, scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }


def slstm_cell(p: Params, cfg, gx_t: torch.Tensor, state: Dict[str, torch.Tensor]):
    """One step. gx_t: (B, 4D) input-side gate pre-activations at step t."""
    heads = cfg.num_heads
    b = gx_t.shape[0]
    d = gx_t.shape[-1] // 4
    dh = d // heads
    h_prev = state["h"].reshape(b, heads, dh)
    rec = torch.einsum("bhd,hde->bhe", h_prev.float(), p["r"]["w"].float())
    g = gx_t.float() + rec.reshape(b, 4 * d) + p["b"]
    gi, gf, gz, go = torch.split(g, d, dim=-1)
    m_prev = state["m"]
    m_new = torch.maximum(gf + m_prev, gi)  # exponential forget gate variant
    i_ = torch.exp(gi - m_new)
    f_ = torch.exp(gf + m_prev - m_new)
    c_new = f_ * state["c"] + i_ * torch.tanh(gz)
    n_new = f_ * state["n"] + i_
    h_new = torch.sigmoid(go) * c_new / (n_new + 1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_apply(p: Params, cfg, x: torch.Tensor, state0=None, return_state: bool = False):
    """Sequential sLSTM over x (B, S, D), one ``slstm_cell`` a step from
    ``state0`` (the empty state if None), then the gated up / down
    projection. With ``return_state`` also the final state."""
    gx = dense(p["w"], x)  # (B, S, 4D) input-side contributions, one product
    state = state0 if state0 is not None else slstm_state_init(cfg, x.shape[0], device=x.device)
    hs = []
    for t in range(gx.shape[1]):
        state = slstm_cell(p, cfg, gx[:, t], state)
        hs.append(state["h"])
    y = dense(p["w_down"], gelu(dense(p["w_up"], torch.stack(hs, dim=1).to(x.dtype))))
    return (y, state) if return_state else y


def slstm_decode(p: Params, cfg, x_t: torch.Tensor, state: Dict[str, Any]):
    """One-token step. x_t (B, 1, D)."""
    gx = dense(p["w"], x_t)[:, 0]
    new = slstm_cell(p, cfg, gx, state)
    h = new["h"].to(x_t.dtype)[:, None]
    return dense(p["w_down"], gelu(dense(p["w_up"], h))), new


def slstm_state_init(cfg, batch: int, dtype=torch.float32, *,
                     device) -> Dict[str, torch.Tensor]:
    """c, h and the stabilizer m at zero, the normalizer n at one (fp32 whatever ``dtype``)."""
    shape = (batch, cfg.d_model)
    return {"c": torch.zeros(shape, dtype=torch.float32, device=device),
            "n": torch.ones(shape, dtype=torch.float32, device=device),
            "h": torch.zeros(shape, dtype=torch.float32, device=device),
            "m": torch.zeros(shape, dtype=torch.float32, device=device)}
