"""Causal depthwise-conv helpers of the xLSTM and RG-LRU blocks.

A copy of what ``repro.models.rglru`` takes from ``repro.models.xlstm``
(``_causal_conv``, ``_conv_step``, ``conv_tail_buffer``). The mLSTM and sLSTM
blocks themselves are not ported yet (ROADMAP A.10.6).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
