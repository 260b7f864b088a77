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

The layout is the port's (``models/model.py`` ``init``): ``layout`` builds
it from the configuration file, and a test holds it to the tree the port
would build (``repro_torch.configs.param_specs_struct``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

ALIGN = 64  # elements: each leaf starts a multiple of 128 bytes into its buffer
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dense(d_in: int, d_out: int, dt, scale: float = 1.0, bias: bool = False) -> Dict[str, Any]:
    p = {"w": ("weight", (d_in, d_out), dt, scale / math.sqrt(d_in))}
    if bias:
        p["b"] = ("bias", (d_out,), dt, 0.1)
    return p


def _norm(d: int, dt) -> Dict[str, Any]:
    return {"scale": ("norm", (d,), dt, 0.1)}


def layout(cfg: Dict) -> Dict[str, Any]:
    """The parameter tree as (kind, shape, dtype, std) leaves, in the
    configuration's ``torch_dtype`` (the router in float32)."""
    dt = DTYPES[cfg["torch_dtype"]]
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    bias, out_scale = bool(cfg.get("qkv_bias")), 1.0 / math.sqrt(layers)
    vocab = cfg["vocab_size"]

    def mlp(f: int) -> Dict[str, Any]:
        return {"w_in": _dense(d, f, dt), "w_out": _dense(f, d, dt, out_scale),
                "w_gate": _dense(d, f, dt)}

    def layer() -> Dict[str, Any]:
        p = {"norm1": _norm(d, dt),
             "attn": {"wq": _dense(d, h * hd, dt, bias=bias),
                      "wk": _dense(d, kvh * hd, dt, bias=bias),
                      "wv": _dense(d, kvh * hd, dt, bias=bias),
                      "wo": _dense(h * hd, d, dt, out_scale)},
             "norm2": _norm(d, dt)}
        if cfg.get("num_experts"):
            e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
            p["moe"] = {
                "router": {"w": ("weight", (d, e), torch.float32, 1.0 / math.sqrt(d))},
                "experts": {
                    "w_in": {"w": ("weight", (e, d, f), dt, 1.0 / math.sqrt(d))},
                    "w_gate": {"w": ("weight", (e, d, f), dt, 1.0 / math.sqrt(d))},
                    "w_out": {"w": ("weight", (e, f, d), dt,
                                    out_scale / math.sqrt(f))}},
                "shared": mlp(cfg["shared_expert_intermediate_size"])}
        else:
            p["mlp"] = mlp(cfg["intermediate_size"])
        return p

    tree = {"embed": {"w": ("weight", (vocab, d), dt, 1.0 / math.sqrt(d))},
            "stack": {"layers": [layer() for _ in range(layers)]},
            "final_norm": _norm(d, dt)}
    if not cfg.get("tie_word_embeddings"):
        tree["head"] = {"w": ("weight", (vocab, d), dt, 1.0 / math.sqrt(d))}
    return tree


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
    tree = layout(cfg)
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
