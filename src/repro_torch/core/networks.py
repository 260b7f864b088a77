"""Actor / critic MLPs for the DRL components (dicts of tensors).

The port of ``repro.core.networks``. Initial weights are drawn from an
explicit CPU ``torch.Generator`` and then moved to ``device``. A stack of
independent networks carries a leading axis on every leaf (the JAX
package's vmapped init); ``mlp_apply`` then runs one batched matmul per
layer for the whole stack, and its input carries the same leading axis.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch

from ..dcsim import ties

Params = Dict[str, Any]


def mlp_init(gen: torch.Generator, sizes: Sequence[int], out_scale: float = 0.01,
             lead: Tuple[int, ...] = (), device="cpu") -> Params:
    """Weights N(0, 2/fan_in) (the last layer scaled by ``out_scale``), zero
    biases; ``lead`` stacks that many independent networks."""
    p: Params = {}
    for li, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = out_scale if li == len(sizes) - 2 else 1.0
        w = torch.randn(lead + (a, b), generator=gen, dtype=torch.float32) * scale \
            * math.sqrt(2.0 / a)
        p[f"w{li}"] = w.to(device)
        p[f"b{li}"] = torch.zeros(lead + (b,), dtype=torch.float32, device=device)
    return p


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """tanh MLP. For a stack of n networks, ``x`` is (n, ..., in)."""
    n = len(p) // 2
    stacked = p["w0"].ndim == 3
    if stacked:
        lead = x.shape[:-1]
        x = x.reshape(x.shape[0], -1, x.shape[-1])
    for li in range(n):
        b = p[f"b{li}"]
        x = x @ p[f"w{li}"] + (b[:, None, :] if stacked else b)
        if li < n - 1:
            x = torch.tanh(x)
    return x.reshape(lead + x.shape[-1:]) if stacked else x


def actor_init(gen: torch.Generator, state_dim: int, action_dim: int, hidden=(64, 64),
               lead: Tuple[int, ...] = (), device="cpu") -> Params:
    return {
        "mlp": mlp_init(gen, (state_dim, *hidden, action_dim), lead=lead, device=device),
        "log_std": torch.full(lead + (action_dim,), -0.7, dtype=torch.float32, device=device),
    }


def actor_mean(p: Params, state: torch.Tensor) -> torch.Tensor:
    return mlp_apply(p["mlp"], state)


def actor_std(p: Params, like: torch.Tensor) -> torch.Tensor:
    """exp(clip(log_std, -4, 1)), shaped to broadcast against ``like`` (the
    actor's mean, which for a stack has the stack's axis first)."""
    std = torch.exp(ties.clip(p["log_std"], -4.0, 1.0))
    if std.ndim == 2:  # stacked: (n, A) against (n, ..., A)
        std = std.reshape(std.shape[:1] + (1,) * (like.ndim - 2) + std.shape[1:])
    return std


def actor_sample_eps(p: Params, state: torch.Tensor,
                     eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian in logit space with the normal draw ``eps`` given; returns
    (logits, log_prob). Fractions are softmax(logits) (paper eq. 21)."""
    mu = actor_mean(p, state)
    std = actor_std(p, mu)
    logits = mu + std * eps
    return logits, gaussian_logp(logits, mu, std)


def actor_sample(p: Params, state: torch.Tensor,
                 gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """``actor_sample_eps`` with ``eps`` drawn from ``gen`` (a CPU generator)."""
    mu = actor_mean(p, state)
    eps = torch.randn(mu.shape, generator=gen, dtype=mu.dtype).to(mu.device)
    return actor_sample_eps(p, state, eps)


def gaussian_logp(x, mu, std):
    z = (x - mu) / std
    return torch.sum(-0.5 * z * z - torch.log(std) - 0.5 * math.log(2 * math.pi), dim=-1)


def critic_init(gen: torch.Generator, state_dim: int, hidden=(64, 64),
                lead: Tuple[int, ...] = (), device="cpu") -> Params:
    return mlp_init(gen, (state_dim, *hidden, 1), out_scale=1.0, lead=lead, device=device)


def critic_value(p: Params, state: torch.Tensor) -> torch.Tensor:
    return mlp_apply(p, state)[..., 0]
