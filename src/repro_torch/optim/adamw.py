"""AdamW over the port's pytrees, with float32 moments.

The port of the part of ``repro.optim.adamw`` that the scheduler's learning
solvers use (PPO, GT-DRL, DDPG). The 8-bit and bfloat16 moments belong to
training (ROADMAP.md A.11) and raise here.

A batch of independent agents is stacked along a leading axis on every leaf,
as ``jax.vmap`` of the reference gives it. ``state.step`` then has that axis
too, and each agent is clipped by its own gradient norm, over its own leaves:
a norm over the whole stack would couple the agents through the clip.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from ..dcsim import ties
from ..tree import tree_leaves, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False
    moment_dtype: str = "float32"


def _check(cfg: AdamWConfig) -> None:
    if cfg.quantize_moments or cfg.moment_dtype != "float32":
        raise NotImplementedError(
            "the port's AdamW keeps float32 moments; quantized and bfloat16 moments "
            "belong to training: ROADMAP.md A.11")


class OptState(NamedTuple):
    step: torch.Tensor   # int32: () for one agent, (n,) for a stack of n
    mu: Any
    nu: Any


def adamw_init(params: Params, cfg: AdamWConfig, lead: Tuple[int, ...] = ()) -> OptState:
    """Zero moments. For agents stacked along the leading ``lead`` axes,
    ``step`` has those axes (the shape of the JAX package's vmapped init)."""
    _check(cfg)
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return OptState(torch.zeros(lead, dtype=torch.int32, device=device),
                    tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree, batch_ndim: int = 0) -> torch.Tensor:
    """sqrt of the sum of squares over the leaves, one norm for each of the
    leading ``batch_ndim`` axes (each stacked agent's own)."""
    leaves = [torch.sum(torch.square(x.float()), dim=tuple(range(batch_ndim, x.ndim)))
              for x in tree_leaves(tree)]
    # leaf by leaf, not a sum over a stack: a reduction across the stack's
    # axis rounds differently for different stack sizes, and a player's norm
    # must not depend on how many players share the batch
    total = leaves[0]
    for x in leaves[1:]:
        total = total + x
    return torch.sqrt(total)


def adamw_update(
    grads: Params,
    state: OptState,
    params: Params,
    cfg: AdamWConfig,
    lr_scale: float = 1.0,
) -> Tuple[Params, OptState, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    _check(cfg)
    nb = state.step.ndim  # stacked agents: one clip and one bias correction each
    step = state.step + 1
    gnorm = global_norm(grads, nb)
    clip = ties.minimum(cfg.grad_clip / (gnorm + 1e-9), 1.0) if cfg.grad_clip > 0 else 1.0

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    lr = cfg.lr * lr_scale

    def per_agent(x, like):
        # a (n,) per-agent factor against an (n, ...) leaf
        return x.reshape(x.shape + (1,) * (like.ndim - nb)) if torch.is_tensor(x) else x

    def upd(p, g, mu, nu):
        g = g.float() * per_agent(clip, p)
        m = b1 * mu + (1 - b1) * g
        v = b2 * nu + (1 - b2) * g * g
        mhat = m / per_agent(bc1, p)
        vhat = v / per_agent(bc2, p)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        out.append(((p.float() - lr * delta).to(p.dtype), m, v))

    out = []
    tree_map(upd, params, grads, state.mu, state.nu)

    def pick(j):
        it = iter(o[j] for o in out)
        return tree_map(lambda _: next(it), params)

    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), OptState(step, pick(1), pick(2)), metrics
