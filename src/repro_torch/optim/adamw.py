"""AdamW over the port's pytrees, with optional 8-bit quantized moments.

The port of ``repro.optim.adamw``. Moments are float32 by default,
bfloat16 with ``moment_dtype="bfloat16"``, or blockwise absmax int8 with
``quantize_moments`` (blocks of 256 of the flattened leaf, scale = absmax /
127, requantized every step; ``torch.round`` rounds half to even as
``jnp.round`` does, so the codes equal the reference's).

A batch of independent agents (the scheduler's learning solvers: PPO,
GT-DRL, DDPG) is stacked along a leading axis on every leaf, as ``jax.vmap``
of the reference gives it. ``state.step`` then has that axis too, and each
agent is clipped by its own gradient norm, over its own leaves: a norm over
the whole stack would couple the agents through the clip. Stacked agents
keep float32 moments.

Over a mesh (parameters as DTensors) the int8 moments of a sharded leaf are
quantized as the reference quantizes them on its global-view arrays: in
blocks of 256 over the flattened *whole* leaf. A shard's slice of the
flattened leaf seldom starts on a block boundary (a column shard is not a
contiguous span at all), so each step gathers the leaf's moment
(``full_tensor``), quantizes it whole, and keeps ``q`` and ``scale``
replicated on every rank; reading dequantizes the whole leaf and keeps the
rank's own slice. This costs one gather of each fp32 moment a step and a
replicated int8 copy, and gives the same codes as the unsharded port, which
``tests/test_torch_optim.py`` holds to the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..dcsim import ties
from ..distributed.sharding import is_dtensor
from ..tree import tree_leaves, tree_map, tree_unflatten

Params = Any

QBLOCK = 256  # absmax quantization block (flattened)


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


MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# int8 blockwise quantization
# ---------------------------------------------------------------------------

def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % QBLOCK))
    blocks = flat.reshape(-1, QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


class _QTensor(NamedTuple):
    q: torch.Tensor      # int8 (blocks, QBLOCK)
    scale: torch.Tensor  # float32 (blocks, 1)


def _is_q(x) -> bool:
    return isinstance(x, _QTensor)


def _weak(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c * x`` with ``c`` in ``x``'s dtype first, as JAX applies a Python
    scalar (weakly typed): a bfloat16 moment is scaled by bf16(0.9) =
    0.8984375, where torch would scale by 0.9 and round once."""
    return torch.tensor(c, dtype=x.dtype) * x


def _moment_read(m, p: torch.Tensor) -> torch.Tensor:
    """A moment's values, laid out as its parameter ``p``."""
    if not isinstance(m, _QTensor):
        return m
    if not is_dtensor(p):
        return _dequantize(m.q, m.scale, p.shape)
    from torch.distributed.tensor import DTensor

    whole = _dequantize(m.q.to_local(), m.scale.to_local(), p.shape)
    mesh = p.device_mesh
    return DTensor.from_local(whole, mesh, _replicated(mesh), run_check=False).redistribute(
        mesh, p.placements)


def _replicated(mesh):
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def _moment_write(val: torch.Tensor, cfg: "AdamWConfig"):
    if not cfg.quantize_moments:
        return val.to(MOMENT_DTYPES[cfg.moment_dtype])
    if not is_dtensor(val):
        return _QTensor(*_quantize(val))
    from torch.distributed.tensor import DTensor

    mesh = val.device_mesh
    return _QTensor(*(DTensor.from_local(t, mesh, _replicated(mesh), run_check=False)
                      for t in _quantize(val.full_tensor())))


class OptState(NamedTuple):
    step: torch.Tensor   # int32: () for one agent, (n,) for a stack of n
    mu: Any
    nu: Any


def adamw_init(params: Params, cfg: AdamWConfig, lead: Tuple[int, ...] = ()) -> OptState:
    """Zero moments. For agents stacked along the leading ``lead`` axes,
    ``step`` has those axes (the shape of the JAX package's vmapped init)."""
    if lead and (cfg.quantize_moments or cfg.moment_dtype != "float32"):
        raise ValueError("stacked agents keep float32 moments")
    device = tree_leaves(params)[0].device
    zeros = lambda p: _moment_write(torch.zeros_like(p, dtype=torch.float32), cfg)
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
        if not nb or not torch.is_tensor(x):
            return x
        return x.reshape(x.shape + (1,) * (like.ndim - nb))

    def upd(p, g, mu, nu):
        g = g.float() * per_agent(clip, p)
        m = _weak(b1, _moment_read(mu, p)) + (1 - b1) * g
        v = _weak(b2, _moment_read(nu, p)) + (1 - b2) * g * g
        mhat = m / per_agent(bc1, p)
        vhat = v / per_agent(bc2, p)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        out.append(((p.float() - lr * delta).to(p.dtype), _moment_write(m, cfg),
                    _moment_write(v, cfg)))

    out = []
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state.mu, _is_q), tree_leaves(state.nu, _is_q)):
        upd(p, g, mu, nu)

    def pick(j):
        return tree_unflatten(params, [o[j] for o in out])

    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), OptState(step, pick(1), pick(2)), metrics
