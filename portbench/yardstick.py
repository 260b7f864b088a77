"""The benchmark's frozen arithmetic: the H100's peaks, the attention
kernels' operations and bytes, and the model FLOPs of served tokens.

Copied from the port's ``launch/roofline.py`` (``Chip``'s H100 peaks,
``active_param_count``'s rule) and ``chip_smoke.py`` (``bound``,
``attn_pairs``, the kernels' bytes), so that a later change to the port
cannot move the yardstick. It counts the work the inputs need: the kept
(query, key) pairs, each input byte read once and each output byte written
once, a decode row's keys only up to its length. Everything here reads
shapes and the configuration file's numbers, never the port.
"""
from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM 80GB HBM3 at its 700 W power limit, NVIDIA's data sheet:
# dense bf16 without sparsity, and HBM3
PEAK_BF16_FLOPS = 989e12  # FLOP/s
PEAK_BYTES_PER_S = 3.35e12  # B/s


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: its bytes at HBM speed or its
    operations at the bf16 peak, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def attn_pairs(sq: int, skv: int, causal: bool, window: int, q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps, in closed form: query ``i`` sits at
    position ``q_offset + i`` and keeps the keys in ``[lo, hi]``."""
    if not causal and window <= 0:
        return sq * skv
    total = 0
    for i in range(sq) if window > 0 else ():
        qp = q_offset + i
        hi = min(skv - 1, qp) if causal else skv - 1
        lo = max(0, qp - window + 1)
        total += max(0, hi - lo + 1)
    if window > 0:
        return total
    # causal, no window: query i keeps min(skv, q_offset + i + 1) keys
    cut_rows = max(0, min(sq, skv - q_offset))  # queries whose row the diagonal cuts
    return sum_range(q_offset + 1, q_offset + cut_rows) + (sq - cut_rows) * skv


def sum_range(lo: int, hi: int) -> int:
    """lo + (lo + 1) + ... + hi (0 when hi < lo)."""
    return (lo + hi) * (hi - lo + 1) // 2 if hi >= lo else 0


def flash_cost(b: int, sq: int, skv: int, h: int, kvh: int, d: int, *, causal: bool,
               window: int = 0, q_offset: int = 0, elem: int = 2):
    """(FLOPs, bytes) of one forward attention call: two products over the
    kept pairs; q, k, v read once and the output written once."""
    flops = 4 * b * h * d * attn_pairs(sq, skv, causal, window, q_offset)
    nbytes = elem * (2 * b * sq * h * d + 2 * b * skv * kvh * d)
    return flops, nbytes


def decode_cost(b: int, h: int, kvh: int, d: int, lengths: Sequence[int], elem: int = 2):
    """(FLOPs, bytes) of one decode attention call: the keys and values below
    each sequence's length read once, the query read and the output written
    once, the lengths read."""
    valid = int(sum(lengths))
    flops = 4 * h * d * valid
    nbytes = elem * (2 * b * h * d + 2 * valid * kvh * d) + 4 * b
    return flops, nbytes


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
    attn = 4.0 * h * hd * sum_range(1, positions) * cfg["num_hidden_layers"]
    head = 2.0 * cfg["vocab_size"] * d * max_new
    return dense + attn + head
