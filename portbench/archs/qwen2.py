"""Qwen2's dense decoder and Qwen1.5-MoE's decoder (``"arch": "qwen2"``).

The plain reference follows the published architecture
(``modeling_qwen2.py``, ``modeling_qwen2_moe.py``) and the departures that
the configuration file lists: RMSNorm, rotary embeddings over the
half-split pairs, grouped-query attention with q/k/v biases and a causal
mask, a SwiGLU MLP; for the MoE a float32 softmax router, its top-k
renormalized where the file's ``as_served`` says so (``norm_topk_prob``),
each routed (token, choice) pair kept only while its expert has a free slot
of ``ceil(T k cf / E)`` counted in (token, choice) order over a capacity
group, and the shared expert added ungated.

Serving couples the rows of a batch only through the MoE's capacity: the
prompt positions of all rows form one capacity group (prefill), and each
later position its own group across the rows (one decode step), so an MoE
batch is run whole. The weight tree is the port's (``models/model.py``
``init``), and a test holds it to the tree the port would build
(``repro_torch.configs.param_specs_struct``).

Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .. import weights, yardstick
from ..reference import (Linear, capacity_keep, causal_attention, exact_float32, rms_norm,
                         rnd, rope, swiglu)


# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------

def layout(cfg: Dict) -> Dict[str, Any]:
    """The parameter tree as (kind, shape, dtype, std) leaves, in the
    configuration's ``torch_dtype`` (the router in float32)."""
    dt = weights.DTYPES[cfg["torch_dtype"]]
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    bias, out_scale = bool(cfg.get("qkv_bias")), 1.0 / math.sqrt(layers)
    vocab = cfg["vocab_size"]
    dense, norm = weights.dense, weights.norm

    def mlp(f: int) -> Dict[str, Any]:
        return {"w_in": dense(d, f, dt), "w_out": dense(f, d, dt, out_scale),
                "w_gate": dense(d, f, dt)}

    def layer() -> Dict[str, Any]:
        p = {"norm1": norm(d, dt),
             "attn": {"wq": dense(d, h * hd, dt, bias=bias),
                      "wk": dense(d, kvh * hd, dt, bias=bias),
                      "wv": dense(d, kvh * hd, dt, bias=bias),
                      "wo": dense(h * hd, d, dt, out_scale)},
             "norm2": norm(d, dt)}
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
            "final_norm": norm(d, dt)}
    if not cfg.get("tie_word_embeddings"):
        tree["head"] = {"w": ("weight", (vocab, d), dt, 1.0 / math.sqrt(d))}
    return tree


# ---------------------------------------------------------------------------
# the plain reference
# ---------------------------------------------------------------------------

def couples_rows(cfg: Dict) -> bool:
    return bool(cfg.get("num_experts"))


def moe(p: Dict, cfg: Dict, x: torch.Tensor, prefill_len: int, precision: str) -> torch.Tensor:
    """The MoE layer over x (R, T, d): positions < prefill_len form one
    capacity group in row-major order, every later position one group over
    the R rows."""
    r, t, d = x.shape
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    served = cfg["as_served"]  # the port's departures from the published block
    if served["shared_expert_gate"]:
        raise ValueError("the reference adds the shared expert ungated")
    cf = served["capacity_factor"]
    probs = torch.softmax(x.reshape(-1, d) @ p["router"]["w"].float(), dim=-1)
    weights, sel = torch.topk(probs, k, dim=-1, sorted=True)
    if served["norm_topk_prob"]:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    sel, weights = sel.reshape(r, t, k), weights.reshape(r, t, k)
    keep = torch.empty_like(sel, dtype=torch.bool)
    s = prefill_len
    keep[:, :s] = capacity_keep(sel[:, :s].reshape(-1, k), e, cf["prefill"]).reshape(r, s, k)
    for j in range(s, t):
        keep[:, j] = capacity_keep(sel[:, j], e, cf["decode"])
    flat_x = x.reshape(-1, d)
    flat_sel, flat_w = sel.reshape(-1, k), (weights * keep).reshape(-1, k)
    y = torch.zeros_like(flat_x)
    for ex in range(e):
        tok, choice = torch.nonzero((flat_sel == ex) & keep.reshape(-1, k), as_tuple=True)
        if tok.numel() == 0:
            continue
        w = {n: {"w": p["experts"][n]["w"][ex]} for n in ("w_in", "w_gate", "w_out")}
        y.index_add_(0, tok, swiglu(w, flat_x[tok], precision) * flat_w[tok, choice, None])
    y = rnd(y, precision) + swiglu(p["shared"], flat_x, precision)
    return rnd(y, precision).reshape(r, t, d)


def layer(p: Dict, cfg: Dict, x: torch.Tensor, prefill_len: int,
          precision: str) -> torch.Tensor:
    eps = cfg["rms_norm_eps"]
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kvh = cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    r, t, _ = x.shape
    a = p["attn"]
    hn = rnd(rms_norm(x, p["norm1"]["scale"], eps), precision)
    q = rope(Linear(a["wq"], precision)(hn).reshape(r, t, h, hd), cfg["rope_theta"])
    k = rope(Linear(a["wk"], precision)(hn).reshape(r, t, kvh, hd), cfg["rope_theta"])
    v = Linear(a["wv"], precision)(hn).reshape(r, t, kvh, hd)
    del hn
    q, k = rnd(q, precision), rnd(k, precision)
    o = rnd(causal_attention(q, k, v), precision).reshape(r, t, h * hd)
    del q, k, v
    x = rnd(x + Linear(a["wo"], precision)(o), precision)
    del o
    hn = rnd(rms_norm(x, p["norm2"]["scale"], eps), precision)
    if "moe" in p:
        return rnd(x + moe(p["moe"], cfg, hn, prefill_len, precision), precision)
    y = swiglu(p["mlp"], hn.reshape(r * t, d), precision).reshape(r, t, d)
    return rnd(x + y, precision)


def forward(cfg: Dict, params: Dict, tokens: torch.Tensor, positions: Sequence[List[int]],
            reduce: Callable[[int, torch.Tensor], None], *, prefill_len: Optional[int] = None,
            precision: str = "fp32") -> None:
    """Run rows ``tokens`` (R, T) and call ``reduce(row, logits)`` with each
    row's float32 logits at ``positions[row]`` (n, V). ``prefill_len`` (the
    batch's padded prompt) splits the MoE's capacity groups; a dense model
    couples no rows."""
    if precision not in ("fp32", "bf16", "fp8"):
        raise ValueError(f"precision {precision!r} not in ('fp32', 'bf16', 'fp8')")
    prefill_len = tokens.shape[1] if prefill_len is None else prefill_len
    with exact_float32(), torch.no_grad():
        x = params["embed"]["w"][tokens].float()
        for lp in params["stack"]["layers"]:
            x = layer(lp, cfg, x, prefill_len, precision)
        head = Linear({"w": (params["head"] if "head" in params else params["embed"])["w"].T},
                      precision)
        for i, pos in enumerate(positions):
            hn = rms_norm(x[i, list(pos)], params["final_norm"]["scale"], cfg["rms_norm_eps"])
            reduce(i, head(rnd(hn, precision)))


# ---------------------------------------------------------------------------
# the model FLOPs
# ---------------------------------------------------------------------------

def layer_params(cfg: Dict) -> Dict[str, int]:
    """Parameters of one decoder layer by part, from the configuration file's
    (Hugging Face) keys: attention (with its q, k, v biases), the dense MLP,
    and the MoE's router, one routed expert and the shared expert."""
    d, h, kvh = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    attn = d * h * hd + 2 * d * kvh * hd + h * hd * d
    if cfg.get("qkv_bias"):
        attn += h * hd + 2 * kvh * hd
    out = {"attn": attn, "norms": 2 * d}
    if cfg.get("num_experts"):
        out["router"] = d * cfg["num_experts"]
        out["expert"] = 3 * d * cfg["moe_intermediate_size"]
        out["shared"] = 3 * d * cfg.get("shared_expert_intermediate_size", 0)
    else:
        out["mlp"] = 3 * d * cfg["intermediate_size"]
    return out


def active_params_per_token(cfg: Dict) -> int:
    """Non-embedding parameters a token goes through: every layer's
    attention, norms and MLP, or its router, ``num_experts_per_tok`` routed
    experts and the shared expert; the final norm. The embedding and the head
    are not in it (the head is counted per generated token)."""
    p = layer_params(cfg)
    per_layer = p["attn"] + p["norms"] + p.get("mlp", 0)
    if cfg.get("num_experts"):
        per_layer += p["router"] + cfg["num_experts_per_tok"] * p["expert"] + p["shared"]
    return cfg["num_hidden_layers"] * per_layer + cfg["hidden_size"]


def request_flops(cfg: Dict, prompt: int, max_new: int) -> float:
    """Model FLOPs a served request needs, over its own lengths: 2 FLOPs a
    parameter for each of the ``prompt + max_new - 1`` positions it runs,
    attention over each position's own prefix (two products over the causal
    pairs in every layer), and the head for each of the ``max_new`` tokens."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // h
    positions = prompt + max_new - 1
    dense = 2.0 * active_params_per_token(cfg) * positions
    attn = 4.0 * h * hd * yardstick.sum_range(1, positions) * cfg["num_hidden_layers"]
    head = 2.0 * cfg["vocab_size"] * d * max_new
    return dense + attn + head


# ---------------------------------------------------------------------------
# the port's config
# ---------------------------------------------------------------------------

def check_port_config(pc, cfg: Dict) -> None:
    """Raise where the port's config departs from the file's numbers."""
    want = {"d_model": cfg["hidden_size"], "num_layers": cfg["num_hidden_layers"],
            "num_heads": cfg["num_attention_heads"], "num_kv_heads": cfg["num_key_value_heads"],
            "vocab_size": cfg["vocab_size"], "rope_theta": cfg["rope_theta"],
            "qkv_bias": cfg["qkv_bias"], "tie_embeddings": cfg["tie_word_embeddings"],
            "act": cfg["hidden_act"], "norm": "rmsnorm", "attn_window": 0,
            "attn_logit_softcap": 0.0, "rope_mode": "rope",
            "dtype": cfg["torch_dtype"], "param_dtype": cfg["torch_dtype"]}
    got = {k: getattr(pc, k) for k in want}
    got["hd"], want["hd"] = pc.hd(), cfg["head_dim"]
    if cfg.get("num_experts"):
        want.update(d_ff=cfg["moe_intermediate_size"], num_experts=cfg["num_experts"],
                    num_experts_per_tok=cfg["num_experts_per_tok"],
                    shared=cfg["shared_expert_intermediate_size"])
        got.update(d_ff=pc.d_ff, num_experts=pc.num_experts,
                   num_experts_per_tok=pc.num_experts_per_tok,
                   shared=(pc.shared_d_ff or pc.d_ff) * pc.num_shared_experts)
    else:
        want.update(d_ff=cfg["intermediate_size"], num_experts=0)
        got.update(d_ff=pc.d_ff, num_experts=pc.num_experts)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise ValueError(f"the port's {pc.name} departs from the configuration file "
                         f"(port, file): {bad}")
