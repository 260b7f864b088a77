"""Mixture-of-Experts FFN: top-k routing with capacity, from ``repro.models.moe``.

Routing is a softmax over the experts in fp32, the top k of it (in descending
order, as ``jax.lax.top_k``) renormalized. Each (token, choice) pair takes
the next slot of its expert in (token, choice) order, an exclusive cumulative
count; pairs past the expert's capacity ``ceil(T k cf / E)`` are dropped and
lose that expert's contribution. Shared experts (qwen2-moe) and a dense
residual MLP (arctic) add to the routed output. Two dispatch forms, as in the
reference:

* ``gather`` (the default): the kept pairs scatter their token index into an
  (E, C) slot table, the experts run as batched products over (E, C, d), and
  each pair gathers its slot back. The kept pairs' slots are unique, so the
  scatter has no collisions and the result does not depend on write order;
  dropped pairs write to a spare row that is cut off, as the reference's
  ``mode="drop"`` does, so no mask reads the device.
* ``einsum``: GShard's one-hot dispatch and combine tensors.

The expert products are ``torch.bmm`` (plain matrix products, which the
reference leaves to XLA). ``moe_apply_ep`` is the reference's un-meshed
fallback: the port has no mesh (ROADMAP A.12).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import DTYPES, Params, activation, dense_init
from .mlp import mlp_apply, mlp_init


def moe_init(gen: torch.Generator, cfg) -> Params:
    dt = DTYPES[cfg.param_dtype]
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    std = 1.0 / math.sqrt(d)

    def stack(shape, scale=1.0):
        # one expert at a time, so that no fp32 copy of the whole stack is
        # made (arctic-480b's is 17.8 GB a layer)
        out = torch.empty(shape, dtype=dt, device=gen.device)
        w = torch.empty(shape[1:], dtype=torch.float32, device=gen.device)
        for i in range(shape[0]):
            torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
            out[i] = (w * std).to(dt) * scale
        return out

    p: Params = {
        "router": dense_init(gen, d, e, torch.float32),
        "experts": {
            "w_in": {"w": stack((e, d, f))},
            "w_gate": {"w": stack((e, d, f))},
            "w_out": {"w": stack((e, f, d), 1.0 / max(1, cfg.num_layers) ** 0.5)},
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=(cfg.shared_d_ff or f) * cfg.num_shared_experts)
    if cfg.moe_dense_residual:
        p["dense"] = mlp_init(gen, cfg, d_ff=cfg.moe_dense_d_ff or f)
    return p


def _route(p: Params, cfg, x2d: torch.Tensor):
    """Router: (weights (T, k), experts (T, k), probs (T, E))."""
    probs = torch.softmax(x2d.float() @ p["router"]["w"], dim=-1)
    weights, sel = torch.topk(probs, cfg.num_experts_per_tok, dim=-1, sorted=True)
    return weights / weights.sum(dim=-1, keepdim=True), sel, probs


def aux_load_balance(probs: torch.Tensor, sel: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e f_e * P_e."""
    onehot = F.one_hot(sel, num_experts).float()  # (T, k, E)
    f_e = onehot.sum(dim=1).mean(dim=0)
    p_e = probs.mean(dim=0)
    return num_experts * torch.sum(f_e * p_e)


def _expert_ffn(experts: Params, cfg, h_in: torch.Tensor) -> torch.Tensor:
    """Batched per-expert gated FFN over (E, C, d)."""
    act = activation(cfg.act)
    up = torch.bmm(h_in, experts["w_in"]["w"])
    gate = torch.bmm(h_in, experts["w_gate"]["w"])
    return torch.bmm(act(gate) * up, experts["w_out"]["w"])


def _slots(sel: torch.Tensor, num_experts: int, cap: int):
    """(flat expert ids (T k,), slot of each pair in its expert, kept mask).

    The slot is the exclusive count of earlier pairs on the same expert, in
    (token, choice) order. The one-hot is laid out (E, T k) so that the count
    runs along the inner dimension (an integer scan along the outer one took
    1.5 ms a layer on an H100 at T k = 8192)."""
    flat_sel = sel.reshape(-1)
    onehot = F.one_hot(flat_sel, num_experts).T.contiguous()  # (E, T k)
    pos_in_expert = torch.cumsum(onehot, dim=1) - onehot  # exclusive count
    pos = torch.gather(pos_in_expert, 0, flat_sel[None])[0]
    return flat_sel, pos, pos < cap


def moe_apply(p: Params, cfg, x: torch.Tensor, *, capacity_factor: float = 1.25,
              impl: str = "gather") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D), aux load-balance loss)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = b * s
    x2d = x.reshape(t, d)
    weights, sel, probs = _route(p, cfg, x2d)
    aux = aux_load_balance(probs, sel, e)
    cap = max(int(math.ceil(t * k * capacity_factor / e)), 1)
    flat_sel, pos, keep = _slots(sel, e, cap)
    wts = weights.to(x.dtype)

    if impl == "einsum":
        disp = (F.one_hot(flat_sel, e).to(x.dtype)[:, :, None]
                * F.one_hot(torch.where(keep, pos, cap), cap + 1).to(x.dtype)[:, None, :cap]
                ).reshape(t, k, e, cap)
        expert_in = torch.einsum("tkec,td->ecd", disp, x2d)
        expert_out = _expert_ffn(p["experts"], cfg, expert_in)
        comb = disp * wts[:, :, None, None]
        y2d = torch.einsum("tkec,ecd->td", comb, expert_out)
    elif impl == "gather":
        token_ids = torch.arange(t * k, device=x.device) // k
        # slot_owner[e, c]: the token in that slot (t: the zero pad row); row
        # e is the spare row the dropped pairs write to
        slot_owner = torch.full((e + 1, cap), t, dtype=torch.int64, device=x.device)
        slot_owner.index_put_((torch.where(keep, flat_sel, e), torch.where(keep, pos, 0)),
                              token_ids)
        x_pad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
        expert_in = x_pad[slot_owner[:e]]  # (E, C, D)
        expert_out = _expert_ffn(p["experts"], cfg, expert_in)
        out_choice = expert_out[flat_sel, torch.where(keep, pos, 0)]  # (T k, D)
        out_choice = torch.where(keep[:, None], out_choice, 0.0)
        y2d = torch.sum(out_choice.reshape(t, k, d) * wts[:, :, None], dim=1)
    else:
        raise ValueError(f"moe impl {impl!r} not in ('gather', 'einsum')")

    y = y2d.reshape(b, s, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], cfg, x)
    if "dense" in p:  # arctic's dense residual, beside the experts
        y = y + mlp_apply(p["dense"], cfg, x)
    return y.to(x.dtype), aux


def moe_apply_ep(p: Params, cfg, x: torch.Tensor, *,
                 capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's expert-parallel MoE without a mesh: ``moe_apply`` at the
    same capacity factor. Expert parallelism over a mesh is ROADMAP A.12."""
    return moe_apply(p, cfg, x, capacity_factor=capacity_factor)
