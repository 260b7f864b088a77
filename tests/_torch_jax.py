"""Shared helpers of the learning-solver parity tests (``tests/test_torch_rl.py``,
``tests/test_torch_solvers.py``): carry JAX state into the port, and build the
port's draw NamedTuples from ``jax.random`` with the reference's own key
splits, so that both packages compute from identical draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import gt_drl as JGT
from repro.core.ppo import PPOConfig as JPPOConfig
from repro.dcsim import env as JE
from repro_torch import convert
from repro_torch.core import gt_drl as TGT
from repro_torch.core.ppo import PPOConfig
from repro_torch.tree import tree_map

# the tiny GT-DRL config of tests/test_game_solvers.py
FAST_GTDRL = JGT.GTDRLConfig(
    ppo=JPPOConfig(horizon=4, episodes=16, iters=2, update_epochs=2),
    rounds=2, polish_steps=15, pretrain_iters=4)


def port_cfg(jcfg, cls):
    """The port's config dataclass with the JAX config's field values (a
    nested PPOConfig is carried too)."""
    vals = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if "ppo" in vals:
        vals["ppo"] = PPOConfig(**dataclasses.asdict(vals["ppo"]))
    return cls(**vals)


FAST_T = port_cfg(FAST_GTDRL, TGT.GTDRLConfig)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def agents(jagents):
    """A JAX AgentState (stacked or not) as the port's, on the CPU."""
    return convert.agents_from_jax(np_tree(jagents), device="cpu")


def stack1(tree):
    """One agent as a stack of one (the port's PPO agents are stacked)."""
    return tree_map(lambda x: x[None], tree)


def rollout_eps(key, horizon, episodes, action_dim):
    """``ppo._rollout``'s normal draws from its key: (T, B, A)."""
    per_episode = jax.vmap(lambda k: jax.random.normal(k, (action_dim,)))
    return np.stack([np.asarray(per_episode(jax.random.split(kt, episodes)))
                     for kt in jax.random.split(key, horizon)])


def ppo_draws(key, state0_fn, cfg, action_dim):
    """``ppo_improve``'s draws from its key: the iterations' initial states
    (iters, B, S) from ``state0_fn(k2)`` and the rollout normals (iters, T, B, A)."""
    s0, eps = [], []
    for key_i in jax.random.split(key, cfg.iters):
        k1, k2 = jax.random.split(key_i)
        s0.append(np.asarray(state0_fn(k2)))
        eps.append(rollout_eps(k1, cfg.horizon, cfg.episodes, action_dim))
    return np.stack(s0), np.stack(eps)


def player_draws(key, joint, i, cfg, routed):
    """``gt_drl._one_player_round``'s draws for player i from its key:
    (Dirichlet starts (iters, B, *row), rollout normals, candidate normals)."""
    row = joint[..., i, :]
    a = int(np.prod(row.shape))
    alpha = row * 20.0 + 0.5
    k_ppo, k_cand = jax.random.split(key)

    def state0_fn(k):
        return jax.random.dirichlet(k, jnp.broadcast_to(alpha, (cfg.ppo.episodes,) + alpha.shape))

    s0, eps = ppo_draws(k_ppo, state0_fn, cfg.ppo, a)
    cand = np.asarray(jax.random.normal(k_cand, (TGT.N_CAND, a)))
    return s0, eps, cand


def half_draws(key_r, joint, env, cfg, routed=False):
    """``gt_drl.half_update``'s draws for every player (split(key_r, I))."""
    keys = jax.random.split(key_r, JE.num_players(env))
    per = [player_draws(k, joint, i, cfg, routed) for i, k in enumerate(keys)]
    return TGT.PlayerDraws(*(t(np.stack(x)) for x in zip(*per)))
