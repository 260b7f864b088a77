"""Error-feedback int8 gradient compression for the data-parallel all-reduce.

The port of ``repro.optim.grad_compress``. Gradients are quantized to int8
with blockwise absmax scales (``adamw._quantize``) before the reduction, and
the quantization error is carried to the next step (error feedback keeps
SGD/Adam convergence). On one card there is nothing to reduce: the train
step does not call it, as the reference's flag-gated train step does not.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten
from .adamw import _dequantize, _quantize


def compress_decompress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize -> dequantize one tensor; returns (approx, error)."""
    q, s = _quantize(g.float())
    approx = _dequantize(q, s, g.shape)
    return approx.to(g.dtype), (g.float() - approx).to(g.dtype)


def ef_compress_tree(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Error-feedback compression over a grad tree.

    grads_compensated = grads + carried_error; returns (approx, new_error).
    """
    comp = tree_map(lambda g, e: g + e.to(g.dtype), grads, error)
    out = [compress_decompress(g) for g in tree_leaves(comp)]
    return (tree_unflatten(comp, [a for a, _ in out]),
            tree_unflatten(comp, [e for _, e in out]))


def init_error(grads: Any) -> Any:
    """Zero error of the shapes and dtypes of the tree ``grads``."""
    return tree_map(torch.zeros_like, grads)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Quantized all-reduce over a process group. Without one (one card)
    there is nothing to reduce and ``x`` comes back, as the reference's
    returns ``x`` when its axis is not in the mesh."""
    if group is None:
        return x
    raise NotImplementedError("a compressed all-reduce over a process group needs the "
                              "port's mesh: ROADMAP.md A.12")
