"""Carry ``repro`` (JAX) model parameters and fleet environments over to the port.

The caller turns the JAX pytree into numpy arrays first
(``jax.tree_util.tree_map(np.asarray, params)``), so this module imports no
JAX. Dense weights keep their (d_in, d_out) layout, since the port applies
them as ``x @ w`` too. The scanned ``stack/layers`` subtree, whose leaves
carry a leading ``num_layers`` axis, becomes a list of per-layer dicts.
``env_from_numpy`` carries an ``EnvParams`` across, so that both packages can
be held on the same env, including one the JAX package's scenario transforms
made.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .dcsim.env import EnvParams
from .models.model import resolve_device


def _to_torch(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a).reshape(np.shape(a))  # keeps a 0-d array 0-d
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: move the bits as int16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    return fn(node)


def params_from_jax(tree: Dict[str, Any], cfg, device="cuda") -> Dict[str, Any]:
    """Port parameters, on ``device``, from a numpy copy of ``repro.models.model.init(...)``'s
    tree. They go to the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    if set(tree) != {"embed", "stack", "final_norm"} or "layers" not in tree["stack"]:
        raise ValueError("expected a tied-embedding, scanned-layer parameter tree, got "
                         f"keys {sorted(tree)} / stack {sorted(tree.get('stack', {}))}")
    layers = tree["stack"]["layers"]

    def check_depth(a):
        if np.shape(a)[0] != cfg.num_layers:
            raise ValueError(f"stacked leaf of shape {np.shape(a)} has no leading "
                             f"num_layers={cfg.num_layers} axis")

    _map(layers, check_depth)
    return {
        "embed": _map(tree["embed"], lambda a: _to_torch(a, device)),
        "stack": {"layers": [_map(layers, lambda a, i=i: _to_torch(a[i], device))
                             for i in range(cfg.num_layers)]},
        "final_norm": _map(tree["final_norm"], lambda a: _to_torch(a, device)),
    }


def env_from_numpy(fields: Dict[str, np.ndarray], device="cuda"):
    """The port's ``EnvParams``, on ``device``, from a JAX ``EnvParams`` given as
    ``{name: np.asarray(leaf)}`` (``env._asdict()`` mapped to numpy).

    Every field must be there and be float32, as the JAX package builds it:
    no rounding hides in the carry. The env goes to the card unless the caller
    asks for the CPU.
    """
    device = resolve_device(device)
    if set(fields) != set(EnvParams._fields):
        raise ValueError(f"expected the EnvParams fields {EnvParams._fields}, got "
                         f"{sorted(fields)}")
    bad = {k: np.asarray(a).dtype.name for k, a in fields.items()
           if np.asarray(a).dtype != np.float32}
    if bad:
        raise ValueError(f"EnvParams fields must be float32, got {bad}")
    return EnvParams(**{k: _to_torch(np.asarray(fields[k]), device)
                        for k in EnvParams._fields})
