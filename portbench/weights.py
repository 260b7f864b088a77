"""Random weights from ``--seed``, drawn on the card in the port's parameter
layout, in the type they are served in.

The weights are inputs: the benchmark makes them and hands the same tensors
to the port (``ModelServer``) and to the plain reference. Every bf16 leaf is
a view into one buffer and the float32 router leaves into another, each
filled by one ``normal_`` call on a ``torch.Generator`` of the device; each
leaf is then scaled in place: dense weights to N(0, 1/d_in) (the output
projections also by 1/sqrt(layers), as the port's own init), the embedding
and the head to N(0, 1/d), q/k/v biases to N(0, 0.1^2), norm scales to
1 + N(0, 0.1^2), so that every part of a layer, biases and norms included,
moves the logits.

The tree of leaves to draw is the configuration's architecture module's
(``archs/<arch>.py`` ``layout``, built from ``dense`` and ``norm``): the
port's parameter layout, which a test holds to the tree the port would
build (``repro_torch.configs.param_specs_struct``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from . import archs

ALIGN = 64  # elements: each leaf starts a multiple of 128 bytes into its buffer
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dense(d_in: int, d_out: int, dt, scale: float = 1.0, bias: bool = False) -> Dict[str, Any]:
    """A product's (d_in, d_out) weight leaf at std ``scale / sqrt(d_in)``,
    and its bias leaf where ``bias``."""
    p = {"w": ("weight", (d_in, d_out), dt, scale / math.sqrt(d_in))}
    if bias:
        p["b"] = ("bias", (d_out,), dt, 0.1)
    return p


def norm(d: int, dt) -> Dict[str, Any]:
    """A norm's scale leaf, drawn as 1 + N(0, 0.1^2)."""
    return {"scale": ("norm", (d,), dt, 0.1)}


def _leaves(tree, path: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree) for x in _leaves(t, f"{path}/{i}")]
    return [(path, tree)]


def _rebuild(tree, values: Dict[str, Any], path: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(t, values, f"{path}/{i}") for i, t in enumerate(tree)]
    return values[path]


def draw(cfg: Dict, seed: int, device) -> Dict[str, Any]:
    """The seed's weights on ``device``, in the port's tree."""
    tree = archs.of(cfg).layout(cfg)
    leaves = _leaves(tree)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    values: Dict[str, torch.Tensor] = {}
    for dtype in sorted({spec[2] for _, spec in leaves}, key=str):
        mine = [(p, spec) for p, spec in leaves if spec[2] == dtype]
        sizes = [-(-math.prod(spec[1]) // ALIGN) * ALIGN for _, spec in mine]
        if not mine:
            continue
        buf = torch.empty(sum(sizes), dtype=dtype, device=device)
        buf.normal_(generator=gen)
        offset = 0
        for (path, (kind, shape, _, std)), size in zip(mine, sizes):
            view = buf[offset:offset + math.prod(shape)].view(shape)
            offset += size
            view.mul_(std)
            if kind == "norm":
                view.add_(1.0)
            values[path] = view
    return _rebuild(tree, values)


def nbytes(params: Dict[str, Any]) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(params))
