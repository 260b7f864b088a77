"""Numerical graceful degradation: finite-guards on solver outputs.

The port of ``repro.faults.guard``. A diverged solver (NaN/Inf logits after a
bad gradient step, a degenerate all-zero simplex row) must cost a metric —
``fallback_hours`` — not a crashed or silently-poisoned run.
``guard_fractions`` runs in the faulted engines (and any spec with
``guard=True``): when the hour's joint strategy is non-finite or degenerate
it is replaced wholesale by the capacity-proportional allocation (the fd
baseline's natural feasible start, ``game.capacity_fractions``) and the hour
is counted. The fallback is computed unconditionally and selected with
``torch.where`` on the device: nothing is read back, and the batched
engine's rows each choose their own.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..dcsim import env as E
from ..dcsim import ties

_EPS = 1e-6


def guard_fractions(env: E.EnvParams, tau: int,
                    fractions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return ``(fractions, fell_back)``: the solver's joint strategy if
    every entry is finite and every simplex row carries mass, else the
    capacity-proportional fallback; ``fell_back`` is 1.0 on fallback hours
    (summed into the ``fallback_hours`` total by the engines)."""
    er_t = E.capacity_at(env, tau)
    base = er_t / ties.maximum(torch.sum(er_t, dim=1, keepdim=True), 1e-9)
    fallback = base.expand(fractions.shape)
    ok = torch.all(torch.isfinite(fractions)) & torch.all(torch.sum(fractions, dim=-1) > _EPS)
    return torch.where(ok, fractions, fallback), torch.where(ok, 0.0, 1.0).to(fractions.dtype)
