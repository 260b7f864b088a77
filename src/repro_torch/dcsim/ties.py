"""Elementwise min, max and clip against a constant, with JAX's gradient at a tie.

The scheduler differentiates through ``jnp.maximum`` / ``jnp.minimum`` /
``jnp.clip`` (fd's forces, nash's best reply). Where the two sides are equal,
JAX gives each half the gradient, and so do ``torch.maximum`` and
``torch.minimum``; ``torch.clamp`` and ``relu`` give the input all of it.
Ties are common here: the water-fill caps cells exactly at their capacity. So
every differentiated bound in the port goes through these helpers.

The bound is a 0-d CPU tensor, which a CUDA operand takes as a scalar
argument: no copy to the card and no extra launch.
"""
from __future__ import annotations

import torch


def maximum(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``jnp.maximum(x, bound)``."""
    return torch.maximum(x, torch.tensor(bound, dtype=x.dtype))


def minimum(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``jnp.minimum(x, bound)``."""
    return torch.minimum(x, torch.tensor(bound, dtype=x.dtype))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, which JAX computes as min(max(x, lo), hi)."""
    return minimum(maximum(x, lo), hi)
