"""DDPG baseline (comparison technique (d), adapted from [32]).

The port of ``repro.core.ddpg``. Joint control: one actor maps the full
flattened strategy (|I|·|D|) to new logits for every player at once; the
critic is Q(s, a). Off-policy with a ring replay buffer (written in place),
Gaussian exploration, soft target updates.

The reference's ``lax.cond`` on the buffer count is a host branch here: the
count is the step index, which the host knows. The step's draws (the action
noise and the replay indices, whose range grows with the count) come in as
``StepDraws`` (``draw_steps``); nothing is read back from the device.
``draw_epoch`` makes a solve's initial state and draws together (the batched
engine stacks one per row, so each row writes its own ring buffer) and
``solve_drawn`` computes from them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..tree import tree_map
from . import networks as nets
from .draws import to_device
from .game import GameContext, SolveResult, cloud_objective, uniform_fractions
from .ppo import value_and_grad


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    steps: int = 200            # environment interactions per epoch solve
    batch: int = 64
    buffer: int = 512
    gamma: float = 0.9
    tau_soft: float = 0.02
    act_noise: float = 0.3
    lr: float = 1e-3
    hidden: Tuple[int, ...] = (64, 64)
    warmup: int = 32


class DDPGState(NamedTuple):
    actor: Any
    critic: Any
    target_actor: Any
    target_critic: Any
    actor_opt: Any
    critic_opt: Any
    buf_s: torch.Tensor
    buf_a: torch.Tensor
    buf_r: torch.Tensor
    buf_s2: torch.Tensor


class StepDraws(NamedTuple):
    noise: torch.Tensor    # (steps, A) exploration normals
    idx: torch.Tensor      # (steps, batch) replay indices below each step's fill count


def _q(params, s, a):
    return nets.mlp_apply(params, torch.cat([s, a], dim=-1))[..., 0]


def _opt_cfg(cfg: DDPGConfig) -> AdamWConfig:
    return AdamWConfig(lr=cfg.lr, weight_decay=0.0)


def ddpg_init(gen: torch.Generator, ctx: GameContext, cfg: DDPGConfig,
              device=None) -> DDPGState:
    """Fresh networks from ``gen`` and an empty buffer, on ``device`` (the
    env's by default)."""
    sdim = adim = int(np.prod(ctx.joint_shape()))
    dev = ctx.env.er.device if device is None else device
    actor = nets.mlp_init(gen, (sdim, *cfg.hidden, adim), device=dev)
    critic = nets.mlp_init(gen, (sdim + adim, *cfg.hidden, 1), out_scale=1.0, device=dev)
    oc = _opt_cfg(cfg)
    z = lambda *shape: torch.zeros(shape, device=dev)
    copy = lambda tree: tree_map(torch.clone, tree)
    return DDPGState(actor, critic, copy(actor), copy(critic),
                     adamw_init(actor, oc), adamw_init(critic, oc),
                     z(cfg.buffer, sdim), z(cfg.buffer, adim), z(cfg.buffer), z(cfg.buffer, sdim))


def draw_steps(gen: torch.Generator, adim: int, cfg: DDPGConfig, device) -> StepDraws:
    noise = torch.randn((cfg.steps, adim), generator=gen)
    # after step t the buffer holds min(t + 1, buffer) transitions
    idx = torch.stack([torch.randint(0, min(t + 1, cfg.buffer), (cfg.batch,), generator=gen)
                       for t in range(cfg.steps)])
    return StepDraws(to_device(noise, device), to_device(idx, device))


def td_update(st: DDPGState, batch_idx: torch.Tensor, cfg: DDPGConfig) -> DDPGState:
    """One critic and one actor step on a replay batch, then the soft
    target updates."""
    oc = _opt_cfg(cfg)
    s, a = st.buf_s[batch_idx], st.buf_a[batch_idx]
    r, s2 = st.buf_r[batch_idx], st.buf_s2[batch_idx]
    a2 = nets.mlp_apply(st.target_actor, s2)
    q_tgt = r + cfg.gamma * _q(st.target_critic, s2, a2)

    def c_loss(c):
        return torch.mean((_q(c, s, a) - q_tgt) ** 2)

    _, gc = value_and_grad(c_loss, st.critic)
    critic, copt, _ = adamw_update(gc, st.critic_opt, st.critic, oc)

    def a_loss(actor):
        return -torch.mean(_q(critic, s, nets.mlp_apply(actor, s)))

    _, ga = value_and_grad(a_loss, st.actor)
    actor, aopt, _ = adamw_update(ga, st.actor_opt, st.actor, oc)
    soft = lambda t, o: tree_map(lambda a_, b_: (1 - cfg.tau_soft) * a_ + cfg.tau_soft * b_, t, o)
    return st._replace(actor=actor, critic=critic, actor_opt=aopt, critic_opt=copt,
                       target_actor=soft(st.target_actor, actor),
                       target_critic=soft(st.target_critic, critic))


class EpochDraws(NamedTuple):
    """What a solve starts from: its initial state and its steps' draws."""
    state: DDPGState
    steps: StepDraws


def draw_epoch(gen: torch.Generator, ctx: GameContext, cfg: DDPGConfig, device) -> EpochDraws:
    """The initial state and every draw of ``solve_epoch``, on ``device``."""
    state = ddpg_init(gen, ctx, cfg, device)
    return EpochDraws(state, draw_steps(gen, int(np.prod(ctx.joint_shape())), cfg, device))


def solve_drawn(draws: EpochDraws, ctx: GameContext, peak_state: torch.Tensor,
                cfg: DDPGConfig = DDPGConfig()) -> SolveResult:
    return solve_with(draws.state, draws.steps, ctx, peak_state, cfg)


def solve_epoch(gen: torch.Generator, ctx: GameContext, peak_state: torch.Tensor,
                cfg: DDPGConfig = DDPGConfig()) -> SolveResult:
    return solve_drawn(draw_epoch(gen, ctx, cfg, ctx.env.er.device), ctx, peak_state, cfg)


def solve_with(st: DDPGState, draws: StepDraws, ctx: GameContext, peak_state: torch.Tensor,
               cfg: DDPGConfig) -> SolveResult:
    """The solve from an initial state and its draws."""
    joint = ctx.joint_shape()
    f0 = uniform_fractions(ctx)
    scale = torch.abs(cloud_objective(ctx, f0, peak_state)) + 1e-6
    s = f0.reshape(-1)
    best_f, best_v = f0, cloud_objective(ctx, f0, peak_state)
    rs = []
    for t in range(cfg.steps):
        a = nets.mlp_apply(st.actor, s) + cfg.act_noise * draws.noise[t]
        f = torch.softmax(a.reshape(joint), dim=-1)
        v = cloud_objective(ctx, f, peak_state)
        r = -v / scale
        s2 = f.reshape(-1)
        k = t % cfg.buffer  # the ring buffer, written in place
        st.buf_s[k], st.buf_a[k], st.buf_r[k], st.buf_s2[k] = s, a, r, s2
        if t + 1 >= cfg.warmup:
            st = td_update(st, draws.idx[t], cfg)
        better = v < best_v
        best_f = torch.where(better, f, best_f)
        best_v = torch.where(better, v, best_v)
        rs.append(r)
        s = s2
    return SolveResult(best_f, {"best": best_v, "rewards": torch.stack(rs)})
