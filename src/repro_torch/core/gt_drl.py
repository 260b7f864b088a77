"""GT-DRL: the paper's contribution (§5.3).

The port of ``repro.core.gt_drl``. Per-player PPO agents embedded in the
non-cooperative game: each round, every player best-responds with a few PPO
iterations against the others' current strategies, then strategies are
re-combined (red-black halves). The decomposition shrinks each agent's
state/action space from |I|·|D| to |D| (paper §5.3).

Agents are stacked with a leading player axis on every leaf, and every
player of a half is batched, never looped: the policy MLPs run as one
batched matmul over the stack, and the water-fill and ``player_reward`` run
under ``torch.func.vmap`` over players and episodes (candidates, polish
starts). A player's row enters the joint strategy by a one-hot
``torch.where`` and its reward leaves by the same mask, so the player index
may vary along the batch, as the reference's traced index does under
``jax.vmap``.

Random draws come in as ``PlayerDraws`` (``draw_players``); see
``core.draws``. ``draw_epoch`` draws a whole hour's at once (the batched
engine stacks one per row), ``solve_drawn`` computes from them, and
``solve_epoch`` is the two in turn.
Routed games grow each player's strategy from a (D,) row to an (S, D)
routing matrix; ``state_mode="env"`` appends per-DC context features.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, vmap

from .. import obs
from ..dcsim import env as E
from ..dcsim import ties
from ..tree import tree_map
from . import networks as nets
from .draws import dirichlet, draw_gammas, generator, stack_draws, to_device
from .game import GameContext, SolveResult, player_rewards, uniform_fractions
from .ppo import AgentState, PPOConfig, agent_init, average_agents, draw_eps, ppo_improve

N_CAND = 16  # policy samples proposed beside the greedy mean and the incumbent


@dataclasses.dataclass(frozen=True)
class GTDRLConfig:
    ppo: PPOConfig = PPOConfig(horizon=6, episodes=32, iters=4, update_epochs=4)
    rounds: int = 8                 # best-response (game) rounds per epoch
    polish_steps: int = 40          # best-reply refinement of adopted proposals
    polish_lr: float = 0.4
    damping: float = 0.5            # Jacobi damping (unused, as in the reference)
    state_mode: str = "strategy"    # strategy | env
    pretrain_iters: int = 60        # total (tau, joint) contexts seen offline
    pretrain_batch: int = 4         # contexts trained from the same agents per step
    half_update: str = "gather"     # gather (I/2 dispatch) | masked (reference)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Max-normalize along the last axis; zeros stay zeros, not NaN."""
    return x / ties.maximum(torch.amax(torch.abs(x), dim=-1, keepdim=True), 1e-9)


def _ctx_features(env: E.EnvParams, tau: int, i, routed: bool = False) -> torch.Tensor:
    """Per-DC context for state_mode='env' (beyond-paper): (F,) for player
    ``i``, or (n, F) when ``i`` is a tensor of n player indices.

    Routed games append the player's origin-weighted access RTT per DC.
    """
    n_i = E.num_players(env)
    shared = torch.cat([_norm(E.dp_max_t(env, tau)), _norm(env.carbon[:, tau]),
                        _norm(env.eprice[:, tau]), _norm(env.rp[:, tau])])
    feats = [_norm(env.er), shared.expand(n_i, shared.shape[0])]
    if routed:
        w = E.origin_at(env, tau)                                   # (S, I)
        feats.append(_norm(torch.sum(w[:, :, None] * E.source_rtt(env)[:, None, :], dim=0)))
    allf = torch.cat(feats, dim=-1)                                 # (I, F)
    return allf[i] if isinstance(i, int) else allf.index_select(0, i)


def _row_shape(env: E.EnvParams, routed: bool) -> Tuple[int, ...]:
    """One player's strategy shape: (D,), or (S, D) in a routed game. The
    degenerate S = 1 origin is the unrouted (D,) shape."""
    d = E.num_dcs(env)
    s = E.num_sources(env)
    return (s, d) if (routed and s > 1) else (d,)


def state_dim(env: E.EnvParams, mode: str, routed: bool = False) -> int:
    d = E.num_dcs(env)
    shape = _row_shape(env, routed)
    own = int(np.prod(shape))
    if mode == "strategy":
        return own
    return own + (6 if len(shape) == 2 else 5) * d


def _with_ctx(frac: torch.Tensor, ctx: Optional[torch.Tensor]) -> torch.Tensor:
    """States from the players' fractions (n, ..., A): the fractions, then
    (state_mode "env") each player's context features (n, F)."""
    if ctx is None:
        return frac
    c = ctx.reshape(ctx.shape[:1] + (1,) * (frac.ndim - 2) + ctx.shape[1:])
    return torch.cat([frac, c.expand(frac.shape[:-1] + ctx.shape[1:])], dim=-1)


def _state_of(shape: Tuple[int, ...], ctx: Optional[torch.Tensor]):
    """logits (n, ..., A) of n players -> their states (n, ..., S), for
    strategy rows of ``shape`` and the players' context features ``ctx``
    (None in state_mode "strategy")."""

    def fn(logits):
        frac = torch.softmax(logits.reshape(logits.shape[:-1] + shape), dim=-1)
        return _with_ctx(frac.reshape(logits.shape), ctx)
    return fn


def init_agents(gen: torch.Generator, env: E.EnvParams, cfg: GTDRLConfig,
                routed: bool = False) -> AgentState:
    """Stacked per-player agents: leading axis |I| on every leaf, on the
    env's device. In a routed game each agent acts on the flattened (S, D)
    routing matrix."""
    sd = state_dim(env, cfg.state_mode, routed)
    ad = int(np.prod(_row_shape(env, routed)))
    return agent_init(gen, sd, ad, cfg.ppo, E.num_players(env), device=env.er.device)


def _player_reward_closure(env, tau, objective, peak_state, joint):
    """reward(logits (A,), hot (I,), scale) = -objective_i(joint with row i
    replaced) / scale, for the player i that the one-hot ``hot`` marks."""
    routed = joint.ndim == 3
    shape = _row_shape(env, routed)
    proj = E.project_feasible_routed if routed else E.project_feasible

    def fn(logits, hot, scale):
        row = torch.softmax(logits.reshape(shape), dim=-1)
        fr = torch.where(hot[:, None], row.unsqueeze(-2), joint)
        r = E.player_reward(env, proj(env, fr, tau), tau, peak_state, objective)
        return -torch.sum(torch.where(hot, r, 0.0)) / scale

    return fn


class PlayerDraws(NamedTuple):
    """The draws of one best-response round for n players (leading axis)."""
    state0: object        # Gammas or (n, iters, B, *row) Dirichlet starts
    eps: torch.Tensor     # (n, iters, T, B, A) rollout normals
    cand: torch.Tensor    # (n, N_CAND, A) candidate normals


def draw_players(gen: torch.Generator, n: int, row_shape: Tuple[int, ...],
                 ppo_cfg: PPOConfig, device) -> PlayerDraws:
    a = int(np.prod(row_shape))
    state0 = draw_gammas(gen, (n, ppo_cfg.iters, ppo_cfg.episodes) + tuple(row_shape), device)
    eps = draw_eps(gen, n, a, ppo_cfg, device)
    cand = to_device(torch.randn((n, N_CAND, a), generator=gen), device)
    return PlayerDraws(state0, eps, cand)


def _take(draws, idx):
    return tree_map(lambda x: x.index_select(0, idx), draws)


def _one_player_round(draws: PlayerDraws, agent: AgentState, env, tau, objective, peak_state,
                      joint, idx, mode, ppo_cfg, polish_steps=30, polish_lr=0.4):
    """PPO-improve the players ``idx`` against fixed others, all at once;
    return (agents, greedy rows (n, *row)).

    ``agent`` and ``draws`` carry the players' leading axis. The joint is
    (I, D), or (S, I, D) in a routed game.
    """
    routed = joint.ndim == 3
    shape = _row_shape(env, routed)
    n, a = idx.shape[0], int(np.prod(shape))
    proj = E.project_feasible_routed if routed else E.project_feasible
    hot = torch.arange(E.num_players(env), device=joint.device)[None, :] == idx[:, None]
    base = torch.abs(E.player_reward(env, proj(env, joint, tau), tau, peak_state,
                                     objective).index_select(0, idx)) + 1e-6
    one = _player_reward_closure(env, tau, objective, peak_state, joint)
    rewards = vmap(vmap(one, in_dims=(0, None, None)))
    grads = vmap(vmap(grad(lambda lg, h, s: -one(lg, h, s)), in_dims=(0, None, None)))

    def reward_of(logits):  # (n, K, A) -> (n, K)
        return rewards(logits, hot, base)

    ctx = None if mode == "strategy" else _ctx_features(env, tau, idx, routed)
    state_of = _state_of(shape, ctx)
    own = joint.index_select(0, idx) if not routed else joint.index_select(1, idx).movedim(1, 0)
    own_logits = torch.log(own + 1e-9).reshape(n, a)

    # episodes start around the current strategy with Dirichlet jitter
    fr = dirichlet(own[:, None, None] * 20.0 + 0.5, draws.state0)   # (n, iters, B, *row)
    state0 = _with_ctx(fr.reshape(fr.shape[:3] + (a,)), ctx)
    agent, info = ppo_improve(agent, state0, draws.eps, state_of, reward_of, ppo_cfg)
    if obs.enabled("gt_drl/ppo"):
        for j in range(n):  # an event per player, as the reference's vmapped tap
            obs.tap("gt_drl/ppo", {"player": idx[j], "actor_loss": info["actor_loss"][j],
                                   "mean_reward": info["mean_reward"][j]})

    # best response over the learned policy's support: greedy mean, the
    # incumbent and N_CAND samples; the player adopts the best proposal
    mu = nets.actor_mean(agent.actor, state_of(own_logits))
    std = nets.actor_std(agent.actor, mu)
    cand = torch.cat([mu[:, None], own_logits[:, None], mu[:, None] + std[:, None] * draws.cand],
                     dim=1)
    best = _pick(cand, reward_of(cand))
    # ... then the best-reply polish of both the proposal and the incumbent
    starts = torch.stack([best, own_logits], dim=1)
    logits = starts
    for _ in range(polish_steps):
        g = grads(logits, hot, base)
        logits = logits - polish_lr * g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True)
                                           + 1e-9)
    finals = torch.cat([logits, starts], dim=1)
    row = torch.softmax(_pick(finals, reward_of(finals)).reshape((n,) + shape), dim=-1)
    return agent, row


def _pick(cands: torch.Tensor, rewards: torch.Tensor) -> torch.Tensor:
    """Each player's candidate (n, K, A) of the highest reward (n, K), the
    first at a tie, as ``jnp.argmax``."""
    best = torch.argmax(rewards, dim=1)
    return torch.gather(cands, 1, best[:, None, None].expand(-1, 1, cands.shape[-1]))[:, 0]


def _run_players(draws, agents, idx, env, tau, objective, peak_state, joint, cfg):
    """``_one_player_round`` for the players ``idx`` (batched)."""
    return _one_player_round(
        draws, agents, env=env, tau=tau, objective=objective, peak_state=peak_state,
        joint=joint, idx=idx, mode=cfg.state_mode, ppo_cfg=cfg.ppo,
        polish_steps=cfg.polish_steps, polish_lr=cfg.polish_lr)


def draw_half(gen: torch.Generator, ctx: GameContext, cfg: GTDRLConfig,
              device=None) -> PlayerDraws:
    """The draws of one half-update, for every player (the gather mode
    takes its half's), so that both modes see the same draws. On ``device``,
    the env's by default."""
    return draw_players(gen, ctx.num_players(), _row_shape(ctx.env, ctx.is_routed()),
                        cfg.ppo, ctx.env.er.device if device is None else device)


def draw_epoch(gen: torch.Generator, ctx: GameContext, cfg: GTDRLConfig,
               device) -> PlayerDraws:
    """The draws of an epoch's 2 x rounds half-updates, in order,
    each field with a leading half-update axis, on ``device``."""
    return stack_draws([draw_half(gen, ctx, cfg, "cpu") for _ in range(2 * cfg.rounds)], device)


def half_update(agents, joint, draws: PlayerDraws, parity: int, ctx: GameContext,
                peak_state, cfg: GTDRLConfig):
    """Red-black Gauss-Seidel half-step: players with index%2==parity
    best-respond simultaneously; the other half hold.

    ``"gather"`` (default) dispatches the active half only; ``"masked"``
    dispatches every player and keeps the active half by a parity mask. Both
    give the same result: each player's draws are its own row of ``draws``.
    """
    if cfg.half_update not in ("gather", "masked"):
        raise ValueError(f"unknown half_update {cfg.half_update!r}")
    env = ctx.env
    i_n = E.num_players(env)
    routed = joint.ndim == 3
    dev = joint.device
    # rows arrive player-major ((n,) + row_shape); a routed joint is (S, I, D)
    to_joint = (lambda rows: rows.movedim(0, 1)) if routed else (lambda rows: rows)
    if cfg.half_update == "gather":
        idx = torch.arange(parity, i_n, 2, device=dev)
        sub, rows = _run_players(_take(draws, idx), _take(agents, idx), idx, env, ctx.tau,
                                 ctx.objective, peak_state, joint, cfg)
        agents = tree_map(lambda full, new: full.index_copy(0, idx, new), agents, sub)
        return agents, joint.index_copy(joint.ndim - 2, idx, to_joint(rows))
    new_agents, rows = _run_players(draws, agents, torch.arange(i_n, device=dev), env, ctx.tau,
                                    ctx.objective, peak_state, joint, cfg)
    active = torch.arange(i_n, device=dev) % 2 == parity
    agents = tree_map(
        lambda old, new: torch.where(active.reshape((i_n,) + (1,) * (new.ndim - 1)), new, old),
        agents, new_agents)
    mask = active[None, :, None] if routed else active[:, None]
    return agents, torch.where(mask, to_joint(rows), joint)


def solve_drawn(draws: PlayerDraws, agents: AgentState, ctx: GameContext,
                peak_state: torch.Tensor, cfg: GTDRLConfig,
                init_fracs: Optional[torch.Tensor] = None) -> Tuple[AgentState, SolveResult]:
    """Run the game for one epoch from ``draw_epoch``'s draws: rounds × (red
    half, black half).

    A round whose joint strategy or game value goes non-finite is rewound:
    agents and joint revert to the previous iterate, and the round is
    counted in ``info["diverged_rounds"]``. The rewind is a ``torch.where``
    on the device; finite trajectories are unchanged by it.
    """
    joint0 = init_fracs if init_fracs is not None else uniform_fractions(ctx)
    joint, best_joint = joint0, joint0
    best_val = torch.sum(player_rewards(ctx, joint0, peak_state))
    diverged = torch.zeros((), dtype=torch.int32, device=joint0.device)
    vals = []
    for r in range(cfg.rounds):
        prev_agents, prev_joint = agents, joint
        for parity in (0, 1):
            half = tree_map(lambda x: x[2 * r + parity], draws)
            agents, joint = half_update(agents, joint, half, parity, ctx, peak_state, cfg)
        val = torch.sum(player_rewards(ctx, joint, peak_state))
        ok = torch.all(torch.isfinite(joint)) & torch.isfinite(val)
        agents = tree_map(lambda new, old: torch.where(ok, new, old), agents, prev_agents)
        joint = torch.where(ok, joint, prev_joint)
        diverged = diverged + (~ok).to(torch.int32)
        better = ok & (val < best_val)
        best_joint = torch.where(better, joint, best_joint)
        best_val = torch.where(better, val, best_val)
        if obs.enabled("gt_drl/round"):
            obs.tap("gt_drl/round", {"value": val, "best": best_val,
                                     "delta": torch.amax(torch.abs(joint - prev_joint))})
        vals.append(val)
    return agents, SolveResult(best_joint, {"round_values": torch.stack(vals), "best": best_val,
                                            "diverged_rounds": diverged})


def solve_epoch(
    gen: torch.Generator,
    agents: AgentState,
    ctx: GameContext,
    peak_state: torch.Tensor,
    cfg: GTDRLConfig,
    init_fracs: Optional[torch.Tensor] = None,
) -> Tuple[AgentState, SolveResult]:
    """``solve_drawn`` from an epoch's draws made on ``gen``."""
    return solve_drawn(draw_epoch(gen, ctx, cfg, ctx.env.er.device), agents, ctx, peak_state,
                       cfg, init_fracs)


def deploy(gen: torch.Generator, env: E.EnvParams, objective: str,
           cfg: Optional[GTDRLConfig] = None, routed: bool = False,
           pretrain_agents: bool = True) -> AgentState:
    """The deploy-once snapshot the engine threads through its carry:
    pretrained on ``gen`` (the paper's protocol), or fresh agents from a
    generator seeded 0 (the reference's fixed ``PRNGKey(0)`` init)."""
    cfg = cfg or GTDRLConfig()
    if pretrain_agents:
        return pretrain(gen, env, objective, cfg, routed)
    return init_agents(generator(0), env, cfg, routed)


# ---------------------------------------------------------------------------
# offline pretraining (paper §6: random uniformly-sampled arrival rates)
# ---------------------------------------------------------------------------

class PretrainDraws(NamedTuple):
    """One pretraining step: ``pretrain_batch`` contexts."""
    taus: Tuple[int, ...]       # each context's hour, drawn on the host
    joints: torch.Tensor        # (batch, *joint) Dirichlet(1) joint strategies
    players: PlayerDraws        # leading (batch, I)


def draw_pretrain(gen: torch.Generator, env: E.EnvParams, cfg: GTDRLConfig,
                  routed: bool = False) -> PretrainDraws:
    i_n, d = E.num_players(env), E.num_dcs(env)
    row = _row_shape(env, routed)
    batch = max(1, cfg.pretrain_batch)
    taus = tuple(int(t) for t in torch.randint(0, 24, (batch,), generator=gen))
    joint_shape = row[:-1] + (i_n, d)
    joints = torch._sample_dirichlet(torch.ones((batch,) + joint_shape), generator=gen)
    players = draw_players(gen, batch * i_n, row, cfg.ppo, env.er.device)
    players = tree_map(lambda x: x.reshape((batch, i_n) + x.shape[1:]), players)
    return PretrainDraws(taus, to_device(joints, env.er.device), players)


# the EnvParams fields with a last axis of 24 UTC hours
_HOURLY = ("rp", "carbon", "eprice", "car", "avail", "origin")


def _hour_env(env: E.EnvParams, tau: int) -> E.EnvParams:
    """``env`` cut to hour ``tau`` (a time axis of one, read as hour 0), so
    that contexts at different hours stack along a batch axis."""
    return env._replace(**{f: getattr(env, f)[..., tau:tau + 1] for f in _HOURLY})


def pretrain_step(agents: AgentState, draws: PretrainDraws, env: E.EnvParams, objective: str,
                  cfg: GTDRLConfig) -> AgentState:
    """Every player's round in each of the step's contexts, from the same
    agents, then parameter averaging (parallel SGD). The contexts are
    batched like the players (``vmap``, as the reference's ``jax.vmap``):
    each is the env cut to its own hour. Live ``gt_drl/ppo`` taps stream
    each context's players, as the reference's do: an engine pretrains
    before its dispatch, so only an ambient tap set reaches here."""
    dev = env.er.device
    idx = torch.arange(E.num_players(env), device=dev)
    peak0 = torch.zeros((E.num_dcs(env),), device=dev)
    envs = E.stack_envs([_hour_env(env, tau) for tau in draws.taus])

    def one_ctx(env_c, joint_c, draws_c):
        return _run_players(draws_c, agents, idx, env_c, 0, objective, peak0, joint_c, cfg)[0]

    return average_agents(obs.tap_mod.vmap(one_ctx)(envs, draws.joints, draws.players))


def pretrain(
    gen: torch.Generator,
    env: E.EnvParams,
    objective: str,
    cfg: GTDRLConfig,
    routed: bool = False,
) -> AgentState:
    """Offline training over random (tau, strategy) contexts, ``pretrain_batch``
    at a time, ``ceil(pretrain_iters / pretrain_batch)`` steps."""
    agents = init_agents(gen, env, cfg, routed)
    steps = -(-cfg.pretrain_iters // max(1, cfg.pretrain_batch))
    for _ in range(steps):
        agents = pretrain_step(agents, draw_pretrain(gen, env, cfg, routed), env, objective, cfg)
    return agents
