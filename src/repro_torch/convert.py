"""Carry ``repro`` (JAX) model parameters and fleet environments over to the port.

The caller turns the JAX pytree into numpy arrays first
(``jax.tree_util.tree_map(np.asarray, params)``), so this module imports no
JAX. Dense weights keep their (d_in, d_out) layout, since the port applies
them as ``x @ w`` too. A decoder's stack becomes a list of per-layer dicts,
from the scanned ``stack/layers`` subtree of a uniform stack (leaves with a
leading ``num_layers`` axis, stacked MoE experts and arctic's dense residual
included) or from the unrolled ``stack/blocks/{"0", "1", ...}`` of a hybrid
one (RG-LRU, mLSTM and sLSTM blocks). An encoder-decoder tree (whisper) keeps
the reference's layout: ``embed``, ``pos_embed``, ``enc/{i}``, ``enc_norm``,
``dec/{i}``, ``dec_norm``.
``env_from_numpy`` carries an ``EnvParams`` across, so that both packages can
be held on the same env, including one the JAX package's scenario transforms
made. ``agents_from_jax`` and ``tree_from_jax`` carry the learning solvers'
state (PPO agents with their AdamW states, DDPG's networks), so that both
packages can start from the same agents. ``train_state_from_jax`` carries a
training state (parameters, step and moments) across.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.ppo import AgentState
from .dcsim.env import EnvParams
from .models.model import resolve_device
from .tree import tree_leaves, tree_map


def _to_torch(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a).reshape(np.shape(a))  # keeps a 0-d array 0-d
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: move the bits as int16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree: Dict[str, Any], cfg, device="cuda") -> Dict[str, Any]:
    """Port parameters, on ``device``, from a numpy copy of ``repro.models.model.init(...)``'s
    tree. They go to the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    if cfg.is_encoder_decoder:
        return _encdec_from_jax(tree, cfg, device)
    stack = tree.get("stack", {})
    top = {"embed", "stack", "final_norm"} | ({"head"} if "head" in tree else set())
    blocks = [str(i) for i in range(cfg.num_layers)]
    if (set(tree) != top or set(stack) not in ({"layers"}, {"blocks"})
            or ("blocks" in stack and sorted(stack["blocks"]) != sorted(blocks))):
        raise ValueError("expected a decoder parameter tree of embed, stack (scanned layers or "
                         f"blocks '0'..'{cfg.num_layers - 1}'), final_norm and an optional "
                         f"head, got keys {sorted(tree)} / stack {sorted(stack)}")

    def torch_tree(t):
        return tree_map(lambda a: _to_torch(a, device), t)

    if "blocks" in stack:
        layers = [torch_tree(stack["blocks"][i]) for i in blocks]
    else:
        def check_depth(a):
            if np.shape(a)[0] != cfg.num_layers:
                raise ValueError(f"stacked leaf of shape {np.shape(a)} has no leading "
                                 f"num_layers={cfg.num_layers} axis")

        tree_map(check_depth, stack["layers"])
        layers = [tree_map(lambda a, i=i: _to_torch(a[i], device), stack["layers"])
                  for i in range(cfg.num_layers)]
    out = {name: torch_tree(tree[name]) for name in sorted(top - {"stack"})}
    out["stack"] = {"layers": layers}
    return out


ENC_BLOCK = {"norm1", "attn", "norm2", "mlp"}
DEC_BLOCK = {"norm1", "self_attn", "norm_x", "cross_attn", "norm2", "mlp"}


def _encdec_from_jax(tree: Dict[str, Any], cfg, device) -> Dict[str, Any]:
    """An encoder-decoder tree, checked for the reference's layout, leaf by leaf."""
    enc, dec = tree.get("enc", {}), tree.get("dec", {})
    if (set(tree) != {"embed", "pos_embed", "enc", "enc_norm", "dec", "dec_norm"}
            or sorted(enc) != sorted(str(i) for i in range(cfg.num_encoder_layers))
            or sorted(dec) != sorted(str(i) for i in range(cfg.num_layers))
            or any(set(b) != ENC_BLOCK for b in enc.values())
            or any(set(b) != DEC_BLOCK for b in dec.values())):
        raise ValueError(
            "expected an encoder-decoder parameter tree of embed, pos_embed, enc blocks "
            f"'0'..'{cfg.num_encoder_layers - 1}' of {sorted(ENC_BLOCK)}, enc_norm, dec "
            f"blocks '0'..'{cfg.num_layers - 1}' of {sorted(DEC_BLOCK)} and dec_norm, got "
            f"keys {sorted(tree)}")
    return tree_map(lambda a: _to_torch(a, device), tree)


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


def tree_from_jax(tree, device="cuda"):
    """A numpy copy of a JAX parameter tree (nested dicts of arrays, e.g. an
    MLP of ``repro.core.networks``) as tensors on ``device``, dtypes kept."""
    device = resolve_device(device)
    return tree_map(lambda a: _to_torch(np.asarray(a), device), tree)


def agents_from_jax(tree, device="cuda") -> AgentState:
    """The port's ``AgentState`` from a numpy copy of a JAX ``AgentState``
    (``jax.tree_util.tree_map(np.asarray, agents)``): actor, critic and both
    AdamW states with their int32 ``step``, stacked (a leading player axis on
    every leaf) or not."""
    from .optim.adamw import OptState

    if len(tree) != len(AgentState._fields):
        raise ValueError(f"expected an AgentState of {AgentState._fields}, got {len(tree)} fields")
    actor, critic, aopt, copt = (tree_from_jax(x, device) for x in tree)
    return AgentState(actor, critic, OptState(*aopt), OptState(*copt))


def _is_qtensor(x) -> bool:
    # the reference's ``_QTensor`` (a NamedTuple of q, scale), known by its fields
    return getattr(x, "_fields", None) == ("q", "scale")


def train_state_from_jax(tree, cfg, device="cuda"):
    """The port's ``TrainState``, on ``device``, from a numpy copy of a JAX
    ``repro.train.step.TrainState`` (``jax.tree_util.tree_map(np.asarray,
    state)``): parameters through :func:`params_from_jax`, the int32 ``step``,
    and the moments ``mu`` and ``nu`` laid out as the parameters. float32 and
    bfloat16 moments carry over as they are; int8 ones (the reference's
    ``_QTensor``) are dequantized, laid out, and quantized again leaf by leaf
    (a scanned stack's moment is one quantized array in the reference and a
    moment a layer here), which gives the same codes where a leaf's blocks
    are the reference's."""
    from .optim.adamw import OptState, _QTensor, _dequantize, _quantize
    from .train.step import TrainState

    params_np, (step, mu, nu) = tree
    device = resolve_device(device)
    params = params_from_jax(params_np, cfg, device)

    def dequantized(m, like):
        """``m`` with every _QTensor node replaced by its float32 values."""
        if _is_qtensor(m):
            q, s = (torch.from_numpy(np.asarray(a)) for a in m)
            return _dequantize(q, s, np.shape(like)).numpy()
        if isinstance(m, dict):
            return {k: dequantized(m[k], like[k]) for k in m}
        if isinstance(m, (list, tuple)):
            return type(m)(dequantized(a, b) for a, b in zip(m, like))
        return m

    def moments(m):
        quantized = any(_is_qtensor(x) for x in tree_leaves(m, _is_qtensor))
        out = params_from_jax(dequantized(m, params_np), cfg, device)
        return tree_map(lambda x: _QTensor(*_quantize(x)), out) if quantized else out

    return TrainState(params, OptState(_to_torch(np.asarray(step), device), moments(mu),
                                       moments(nu)))
