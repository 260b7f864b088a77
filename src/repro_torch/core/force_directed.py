"""FD: Force-Directed greedy baseline (comparison technique (a), [18]).

The port of ``repro.core.force_directed``. The "force" on a (task-type, DC)
cell is the marginal objective increase of routing load there; each
iteration greedily moves a quantum of every player's load from its
highest-force DC to its lowest-force DC. Fast, but the myopic quantum moves
stall in local minima (paper §7.1 observes FD over-provisioning nodes).

The iterations run as a Python loop of device ops: the best-so-far is a
``torch.where`` on the device and nothing is read back to the host, so the
card's queue stays full.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..dcsim import ties
from .game import GameContext, SolveResult, cloud_objective, grad_of, uniform_fractions


@dataclasses.dataclass(frozen=True)
class FDConfig:
    iters: int = 120
    quantum: float = 0.06  # fraction of a player's load moved per iteration


def solve_epoch(gen, ctx: GameContext, peak_state: torch.Tensor,
                cfg: FDConfig = FDConfig()) -> SolveResult:
    """``gen`` (a ``torch.Generator``) is ignored: fd is deterministic."""
    del gen

    def obj(f):
        return cloud_objective(ctx, f, peak_state)

    f = uniform_fractions(ctx)
    d = f.shape[-1]
    # forces: marginal d(objective)/d(fraction) per cell; axis -1 is the DC
    # simplex for both the (I, D) game and the routed (S, I, D) one. Each
    # pass gives the value of the current f and the forces of the next move.
    best_v, force = grad_of(obj, f)
    best_f = f
    vals = []
    for _ in range(cfg.iters):
        src = torch.argmax(torch.where(f > 1e-6, force, -torch.inf), dim=-1)
        dst = torch.argmin(force, dim=-1)
        move = cfg.quantum * torch.gather(f, -1, src[..., None])[..., 0]
        onehot_src = F.one_hot(src, d).to(f.dtype)
        onehot_dst = F.one_hot(dst, d).to(f.dtype)
        f = f - move[..., None] * onehot_src + move[..., None] * onehot_dst
        f = ties.maximum(f, 0.0)
        f = f / torch.sum(f, dim=-1, keepdim=True)
        v, force = grad_of(obj, f)
        better = v < best_v
        best_f = torch.where(better, f, best_f)
        best_v = torch.where(better, v, best_v)
        vals.append(v)
    return SolveResult(best_f, {"values": torch.stack(vals), "best": best_v})
