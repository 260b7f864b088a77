"""NASH: Best-Reply game-theoretic baseline (comparison technique (c), [17]).

The port of ``repro.core.nash``. Classic sequential best-response: players
take turns locally minimizing their own objective (projected gradient descent
in logit space) with the others fixed. Converges fast but to *local*
equilibria — the deficiency GT-DRL's exploration addresses (paper §5.1).

Each inner step takes the gradient of a fresh leaf (``game.grad_of``), so no
graph grows across the steps; a player's row is written out of place
(``game.replace_player``); the ``better`` test stays on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from .game import (GameContext, SolveResult, cloud_objective, grad_of, player_rewards,
                   replace_player, uniform_fractions)


@dataclasses.dataclass(frozen=True)
class NashConfig:
    sweeps: int = 6
    inner_steps: int = 40
    lr: float = 0.4


def _best_reply(ctx: GameContext, peak_state, fractions, i: int, cfg: NashConfig):
    """Local projected-gradient best response of player i: its (D,) simplex
    row, or in a routed game its (S, D) routing matrix (softmax per row)."""

    def obj(logits):
        f = replace_player(fractions, i, torch.softmax(logits, dim=-1))
        return player_rewards(ctx, f, peak_state)[i]

    logits0 = torch.log(fractions[..., i, :] + 1e-9)
    logits = logits0
    for _ in range(cfg.inner_steps):
        _, g = grad_of(obj, logits)
        logits = logits - cfg.lr * g / (torch.linalg.vector_norm(g) + 1e-9)
    better = obj(logits) < obj(logits0)
    return torch.where(better, torch.softmax(logits, dim=-1), fractions[..., i, :])


def solve_epoch(gen, ctx: GameContext, peak_state: torch.Tensor,
                cfg: NashConfig = NashConfig()) -> SolveResult:
    """``gen`` (a ``torch.Generator``) is ignored: nash is deterministic."""
    del gen
    f = uniform_fractions(ctx)
    vals = []
    for _ in range(cfg.sweeps):
        for j in range(ctx.num_players()):
            f = replace_player(f, j, _best_reply(ctx, peak_state, f, j, cfg))
        vals.append(cloud_objective(ctx, f, peak_state))
    vals = torch.stack(vals)
    return SolveResult(f, {"sweep_values": vals, "best": vals[-1]})
