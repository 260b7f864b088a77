"""Joint (non-game-theoretic) PPO baseline (comparison technique (e), [33]).

The port of ``repro.core.ppo_joint``. One agent controls the entire cloud:
state/action dims are |I|·|D|, the configuration whose state-space growth
the paper's decomposition removes. It reuses ``core.ppo`` with a stack of
one agent, so the comparison isolates the decomposition. Its draws come in
as ``JointDraws`` (``draw_joint``); ``draw_epoch`` adds the fresh agent, so
that the batched engine stacks one whole start per row.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from . import networks as nets
from .draws import to_device
from .game import GameContext, SolveResult, cloud_objective, grad_of, uniform_fractions
from .ppo import AgentState, PPOConfig, agent_init, draw_eps, ppo_improve

POLISH_STEPS, POLISH_LR = 30, 0.4


@dataclasses.dataclass(frozen=True)
class JointPPOConfig:
    ppo: PPOConfig = PPOConfig(horizon=6, episodes=64, iters=40, update_epochs=4)


class JointDraws(NamedTuple):
    state0: torch.Tensor   # (1, iters, B, A) Dirichlet starts around the uniform split
    eps: torch.Tensor      # (1, iters, T, B, A) rollout normals


def draw_joint(gen: torch.Generator, ctx: GameContext, cfg: JointPPOConfig,
               device=None) -> JointDraws:
    """The starts' Dirichlet has a constant concentration (around the
    uniform split), so it is drawn whole on the host. On ``device``, the
    env's by default."""
    dev = ctx.env.er.device if device is None else device
    joint = ctx.joint_shape()
    alpha = torch.full((1, cfg.ppo.iters, cfg.ppo.episodes) + joint, 20.0 / joint[-1] + 0.5)
    state0 = torch._sample_dirichlet(alpha, generator=gen).reshape(alpha.shape[:3] + (-1,))
    eps = draw_eps(gen, 1, int(np.prod(joint)), cfg.ppo, dev)
    return JointDraws(to_device(state0, dev), eps)


class EpochDraws(NamedTuple):
    """What a solve starts from: a fresh agent (a stack of one) and its draws."""
    agent: AgentState
    draws: JointDraws


def draw_epoch(gen: torch.Generator, ctx: GameContext, cfg: JointPPOConfig,
               device) -> EpochDraws:
    """The fresh agent and every draw of ``solve_epoch``, on ``device``."""
    sdim = adim = int(np.prod(ctx.joint_shape()))
    agent = agent_init(gen, sdim, adim, cfg.ppo, 1, device=device)
    return EpochDraws(agent, draw_joint(gen, ctx, cfg, device))


def solve_with(agent: AgentState, draws: JointDraws, ctx: GameContext,
               peak_state: torch.Tensor, cfg: JointPPOConfig) -> SolveResult:
    """The solve from a stack of one agent and its draws."""
    joint = ctx.joint_shape()
    f0 = uniform_fractions(ctx)
    scale = torch.abs(cloud_objective(ctx, f0, peak_state)) + 1e-6

    def to_f(logits):
        return torch.softmax(logits.reshape(logits.shape[:-1] + joint), dim=-1)

    def reward_one(logits):
        return -cloud_objective(ctx, to_f(logits), peak_state) / scale

    rewards = vmap(reward_one)

    def reward_of(logits):  # (1, B, A) -> (1, B)
        return rewards(logits.reshape(-1, logits.shape[-1])).reshape(logits.shape[:-1])

    def state_of(logits):
        return to_f(logits).reshape(logits.shape)

    agent, info = ppo_improve(agent, draws.state0, draws.eps, state_of, reward_of, cfg.ppo)
    # greedy output + a short local refinement of the learned proposal
    logits = nets.actor_mean(agent.actor, f0.reshape(1, -1))[0]
    for _ in range(POLISH_STEPS):
        _, g = grad_of(lambda z: -reward_one(z), logits)
        logits = logits - POLISH_LR * g / (torch.linalg.vector_norm(g) + 1e-9)
    row = to_f(logits)
    v_row = cloud_objective(ctx, row, peak_state)
    v0 = cloud_objective(ctx, f0, peak_state)
    best = torch.where(v_row < v0, row, f0)
    return SolveResult(best, {"best": torch.minimum(v_row, v0),
                              "mean_reward": info["mean_reward"][0]})


def solve_drawn(draws: EpochDraws, ctx: GameContext, peak_state: torch.Tensor,
                cfg: JointPPOConfig = JointPPOConfig()) -> SolveResult:
    return solve_with(draws.agent, draws.draws, ctx, peak_state, cfg)


def solve_epoch(gen: torch.Generator, ctx: GameContext, peak_state: torch.Tensor,
                cfg: JointPPOConfig = JointPPOConfig()) -> SolveResult:
    return solve_drawn(draw_epoch(gen, ctx, cfg, ctx.env.er.device), ctx, peak_state, cfg)
