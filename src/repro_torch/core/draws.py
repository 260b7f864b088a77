"""Random draws of the learning solvers: made on the host, shaped on the device.

``jax.random`` and ``torch.Generator`` cannot be made to agree, so every
solver of the port splits *drawing* from *computing*: a ``draw_*`` function
makes a NamedTuple of tensors for one step from a CPU ``torch.Generator``, and
the compute function takes that NamedTuple. The tests build the same
NamedTuple from ``jax.random`` with the reference's own key splits.

Drawing on a CPU generator and copying each batch of draws to the device
once makes a card run and a CPU run of the same spec see identical draws.
Two of the reference's draws depend on values that live on the device (the
Dirichlet jitter around GT-DRL's current strategy, GA's mutation around a
child, and GA's fitness-ranked parent choice): reading those back would stall
the card's queue. So for them the host draws only what the sample is made
from, and the device finishes it:

- ``Gammas``: Marsaglia-Tsang tries for Gamma(alpha + 1), boosted to
  Gamma(alpha) by U^(1/alpha), normalized to a Dirichlet (``dirichlet``);
- a uniform, which ``choice`` turns into an index by the reference's inverse
  CDF.

A field of a draw NamedTuple is either such a recipe or the drawn value
itself (what the tests inject); ``dirichlet`` and ``choice`` accept both.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import torch

from ..tree import tree_map

# Marsaglia-Tsang tries a sample. With alpha + 1 >= 1.3 each try is accepted
# with probability > 0.95, so all four fail about once in 10^6 samples; that
# sample then takes v = 1, the mode of the proposal (a bias far below the
# jitter's own spread).
GAMMA_TRIES = 4


class Gammas(NamedTuple):
    """What a Dirichlet sample of shape (..., D) is made from on the device."""
    z: torch.Tensor      # (..., D, GAMMA_TRIES) standard normals
    u: torch.Tensor      # (..., D, GAMMA_TRIES) uniforms for the acceptance test
    boost: torch.Tensor  # (..., D) uniforms for the alpha < 1 boost


def generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with ``seed``: every solver draws on the host."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """A CPU tensor on ``device``; to a card by a copy from pinned memory
    that does not wait for the card's queue."""
    device = torch.device(device)
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def stack_draws(trees: List[Any], device) -> Any:
    """Same-shaped trees of host draws stacked along a new leading axis,
    each leaf moved to ``device`` once."""
    return tree_map(lambda *xs: to_device(torch.stack(xs), device), trees[0], *trees[1:])


def draw_gammas(gen: torch.Generator, shape: Tuple[int, ...], device) -> Gammas:
    """The recipe of a Dirichlet sample of ``shape`` (the simplex last)."""
    z = torch.randn(tuple(shape) + (GAMMA_TRIES,), generator=gen)
    u = torch.rand(tuple(shape) + (GAMMA_TRIES,), generator=gen)
    boost = torch.rand(tuple(shape), generator=gen)
    return Gammas(*(to_device(x, device) for x in (z, u, boost)))


def dirichlet(alpha: torch.Tensor, draw) -> torch.Tensor:
    """Dirichlet(alpha) along the last axis, ``alpha`` broadcasting against
    the draw. ``draw`` is the sample itself or its ``Gammas``."""
    if not isinstance(draw, Gammas):
        return draw
    a = alpha + 1.0
    d = (a - 1.0 / 3.0)[..., None]
    c = 1.0 / torch.sqrt(9.0 * d)
    v = (1.0 + c * draw.z) ** 3
    safe_v = torch.where(v > 0, v, 1.0)
    ok = (v > 0) & (torch.log(draw.u) < 0.5 * draw.z * draw.z + d - d * safe_v
                    + d * torch.log(safe_v))
    first = torch.argmax(ok.to(torch.int8), dim=-1, keepdim=True)  # first accepted try
    v = torch.where(torch.any(ok, dim=-1, keepdim=True), torch.gather(v, -1, first), 1.0)
    g = (d * v)[..., 0] * draw.boost ** (1.0 / alpha)
    return g / torch.sum(g, dim=-1, keepdim=True)


def choice(p: torch.Tensor, draw: torch.Tensor) -> torch.Tensor:
    """An index drawn with probabilities ``p``: ``draw`` is the index itself
    (integer) or a uniform in [0, 1), turned into an index by the reference's
    inverse CDF (``jax.random.choice`` with ``p``)."""
    if not draw.is_floating_point():
        return draw
    p_cuml = torch.cumsum(p, dim=0)
    return torch.searchsorted(p_cuml, p_cuml[-1:] * (1 - draw))
