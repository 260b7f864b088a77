"""Error-feedback int8 gradient compression for the data-parallel all-reduce.

The port of ``repro.optim.grad_compress``. Gradients are quantized to int8
with blockwise absmax scales (``adamw._quantize``) before the reduction, and
the quantization error is carried to the next step (error feedback keeps
SGD/Adam convergence). :func:`compressed_psum` is the reduction over a
process group (the reference's ``shard_map`` over a mesh axis, "pod" by
default); the train step does not call it, as the reference's flag-gated
train step does not.
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
    """Quantized all-reduce over the process group ``group`` (e.g. a mesh
    dim's, ``mesh.get_group("pod")``): each rank quantizes its own ``x`` to
    int8 blocks and back, and the ranks' dequantized values are summed.
    Without a group (one card) ``x`` comes back, as the reference's returns
    ``x`` when its axis is not in the mesh."""
    if group is None:
        return x
    import torch.distributed as dist

    q, s = _quantize(x.float())
    approx = _dequantize(q, s, x.shape)
    dist.all_reduce(approx, op=dist.ReduceOp.SUM, group=group)
    return approx
