"""LR schedules (pure functions of the step counter)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10000, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor`` of peak (scale factor),
    a float32 tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos


def constant(step, **_):
    device = step.device if torch.is_tensor(step) else None
    return torch.ones((), dtype=torch.float32, device=device)
