"""Proximal Policy Optimization in PyTorch (paper §5.3 and baseline [33]).

The port of ``repro.core.ppo``. The MDP (paper §5.2): state = the current
strategy (simplex fractions, flattened); action = new desired-fraction
logits; next state = the action's fractions; reward = −objective. The same
machinery drives the per-player GT-DRL agents (|D| actions) and the
joint-PPO baseline (|I|·|D| actions); only the callbacks differ.

Agents are always stacked: every leaf of an ``AgentState`` has a leading
axis of n independent agents (n = 1 for joint PPO), and so do the states,
actions and rewards, which are (n, B, ...) for B episodes. One call of
``reward_of`` scores every agent's every episode at once. Each agent's
gradient comes from one backward of the sum of the agents' losses: their
parameters are disjoint, so each gets its own gradient, and each loss keeps
its own mean. The rollout's normal draws come in as ``eps``
(``draw_eps``); nothing is read back from the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from ..dcsim import ties
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..tree import tree_map
from . import networks as nets
from .draws import to_device


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    horizon: int = 8          # steps per episode
    episodes: int = 64        # parallel episodes per iteration
    iters: int = 12           # rollout+update cycles
    update_epochs: int = 4
    clip: float = 0.2
    gamma: float = 0.9
    lam: float = 0.95
    lr: float = 3e-3
    vf_coef: float = 0.5
    ent_coef: float = 1e-3
    hidden: Tuple[int, ...] = (64, 64)


class AgentState(NamedTuple):
    actor: Any
    critic: Any
    actor_opt: Any
    critic_opt: Any


def _opt_cfg(cfg: PPOConfig) -> AdamWConfig:
    return AdamWConfig(lr=cfg.lr, weight_decay=0.0, grad_clip=1.0)


def agent_init(gen: torch.Generator, state_dim: int, action_dim: int, cfg: PPOConfig,
               n: int, device="cpu") -> AgentState:
    """n stacked agents, their weights drawn from ``gen`` (actor, then critic)."""
    actor = nets.actor_init(gen, state_dim, action_dim, cfg.hidden, lead=(n,), device=device)
    critic = nets.critic_init(gen, state_dim, cfg.hidden, lead=(n,), device=device)
    oc = _opt_cfg(cfg)
    return AgentState(actor, critic, adamw_init(actor, oc, (n,)), adamw_init(critic, oc, (n,)))


class Rollout(NamedTuple):
    states: torch.Tensor    # (n, B, T, S)
    actions: torch.Tensor   # (n, B, T, A) logits
    logps: torch.Tensor     # (n, B, T)
    rewards: torch.Tensor   # (n, B, T)
    values: torch.Tensor    # (n, B, T+1)


def draw_eps(gen: torch.Generator, n: int, action_dim: int, cfg: PPOConfig,
             device) -> torch.Tensor:
    """The rollouts' normal draws of ``ppo_improve``: (n, iters, T, B, A)."""
    shape = (n, cfg.iters, cfg.horizon, cfg.episodes, action_dim)
    return to_device(torch.randn(shape, generator=gen), device)


def _rollout(
    eps: torch.Tensor,                       # (n, T, B, A) normal draws
    agent: AgentState,
    state0: torch.Tensor,                    # (n, B, S) initial states
    state_of: Callable[[torch.Tensor], torch.Tensor],   # (n, B, A) logits -> (n, B, S)
    reward_of: Callable[[torch.Tensor], torch.Tensor],  # (n, B, A) logits -> (n, B)
    cfg: PPOConfig,
) -> Rollout:
    s = state0
    ss, aa, lp, rr, vv = [], [], [], [], []
    for t in range(cfg.horizon):
        logits, logp = nets.actor_sample_eps(agent.actor, s, eps[:, t])
        ss.append(s)
        aa.append(logits)
        lp.append(logp)
        rr.append(reward_of(logits))
        vv.append(nets.critic_value(agent.critic, s))
        s = state_of(logits)
    vv.append(nets.critic_value(agent.critic, s))
    st = lambda xs: torch.stack(xs, dim=2)
    return Rollout(st(ss), st(aa), st(lp), st(rr), st(vv))


def _gae(ro: Rollout, cfg: PPOConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advantages (normalized per agent, ddof 0 as ``jnp.std``) and returns."""
    deltas = ro.rewards + cfg.gamma * ro.values[..., 1:] - ro.values[..., :-1]
    carry = torch.zeros_like(deltas[..., 0])
    adv = []
    for t in reversed(range(deltas.shape[-1])):
        carry = deltas[..., t] + cfg.gamma * cfg.lam * carry
        adv.append(carry)
    adv = torch.stack(adv[::-1], dim=-1)
    returns = adv + ro.values[..., :-1]
    mean = torch.mean(adv, dim=(1, 2), keepdim=True)
    std = torch.std(adv, dim=(1, 2), correction=0, keepdim=True)
    return (adv - mean) / (std + 1e-8), returns


def value_and_grad(fn: Callable[[Any], torch.Tensor], tree: Any):
    """(fn(tree), d sum(fn) / d tree): for per-agent losses of shape (n,),
    each stacked agent's gradient of its own loss. ``torch.func``, so that it
    also runs under ``vmap`` (pretraining batches its contexts)."""
    def total(t):
        value = fn(t)
        return torch.sum(value), value

    grads, (_, value) = torch.func.grad_and_value(total, has_aux=True)(tree)
    return value, grads


def _update(agent: AgentState, ro: Rollout, adv, returns,
            cfg: PPOConfig) -> Tuple[AgentState, Dict]:
    n = ro.states.shape[0]
    s = ro.states.reshape(n, -1, ro.states.shape[-1])
    a = ro.actions.reshape(n, -1, ro.actions.shape[-1])
    lp_old = ro.logps.reshape(n, -1)
    adv_f = adv.reshape(n, -1)
    ret_f = returns.reshape(n, -1)
    oc = _opt_cfg(cfg)

    def actor_loss(actor):
        mu = nets.actor_mean(actor, s)
        lp = nets.gaussian_logp(a, mu, nets.actor_std(actor, mu))
        ratio = torch.exp(lp - lp_old)
        unclipped = ratio * adv_f
        clipped = ties.clip(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv_f
        ent = torch.sum(ties.clip(actor["log_std"], -4.0, 1.0), dim=-1)
        # torch.minimum splits a tie's gradient in half, as jnp.minimum does:
        # in the first epoch ratio == 1 and the two branches tie
        return -torch.mean(torch.minimum(unclipped, clipped), dim=-1) - cfg.ent_coef * ent

    def critic_loss(critic):
        v = nets.critic_value(critic, s)
        return cfg.vf_coef * torch.mean((v - ret_f) ** 2, dim=-1)

    for _ in range(cfg.update_epochs):
        la, ga = value_and_grad(actor_loss, agent.actor)
        new_actor, aopt, _ = adamw_update(ga, agent.actor_opt, agent.actor, oc)
        lc, gc = value_and_grad(critic_loss, agent.critic)
        new_critic, copt, _ = adamw_update(gc, agent.critic_opt, agent.critic, oc)
        agent = AgentState(new_actor, new_critic, aopt, copt)
    return agent, {"actor_loss": la, "critic_loss": lc}


def ppo_improve(
    agent: AgentState,
    state0: torch.Tensor,      # (n, iters, B, S) each iteration's initial states
    eps: torch.Tensor,         # (n, iters, T, B, A) the rollouts' normal draws
    state_of: Callable[[torch.Tensor], torch.Tensor],
    reward_of: Callable[[torch.Tensor], torch.Tensor],
    cfg: PPOConfig,
) -> Tuple[AgentState, Dict[str, torch.Tensor]]:
    """Run ``iters`` × (rollout → GAE → clipped update)."""
    rew, al = [], []
    for it in range(cfg.iters):
        ro = _rollout(eps[:, it], agent, state0[:, it], state_of, reward_of, cfg)
        adv, ret = _gae(ro, cfg)
        agent, losses = _update(agent, ro, adv, ret, cfg)
        rew.append(torch.mean(ro.rewards, dim=(1, 2)))
        al.append(losses["actor_loss"])
    return agent, {"mean_reward": torch.stack(rew, 1), "actor_loss": torch.stack(al, 1)}


def greedy_fractions(agent: AgentState, state: torch.Tensor) -> torch.Tensor:
    """Deterministic action: softmax of the policy mean."""
    return torch.softmax(nets.actor_mean(agent.actor, state), dim=-1)


def average_agents(agents_b) -> AgentState:
    """Collapse a leading batch axis by parameter averaging (parallel SGD).

    Float leaves (params, AdamW moments) are averaged; integer leaves (the
    optimizer step counters) take the first copy so their dtype survives.
    """
    def avg(x):
        return x[0] if not x.is_floating_point() else torch.mean(x, dim=0)

    return tree_map(avg, agents_b)
