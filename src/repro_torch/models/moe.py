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
reference leaves to XLA).

``moe_apply_ep`` is the reference's expert-parallel form under a mesh with a
"model" dim (its ``shard_map`` body): tokens stay sharded over the batch
axes and whole over "model"; the experts are padded to ``e_pad``, a multiple
of the "model" size (pad experts are unroutable); each "model" rank routes
its tokens, runs only its ``e_pad / m`` experts (:func:`ep_shard`, a plain
function of the rank and the size) and one all-reduce over "model" sums the
ranks' outputs. The capacity is sized over ``e_pad``, as the reference's is,
so where E does not divide the "model" size more pairs are dropped than in
``moe_apply`` (ROADMAP C.7). Un-meshed it is ``moe_apply``.

Both forms open the spans ``moe.route``, ``moe.aux``, ``moe.dispatch``,
``moe.experts``, ``moe.combine`` and ``moe.shared`` (``obs.span``, recorded
inside ``obs.spans.recording()`` only) and emit the ``moe/dispatch`` tap.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from .. import obs
from ..distributed import sharding as shd
from .layers import DTYPES, Params, activation, dense_init, trunc_normal_
from .mlp import mlp_apply, mlp_init


def moe_init(gen: torch.Generator, cfg) -> Params:
    dt = DTYPES[cfg.param_dtype]
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    std = 1.0 / math.sqrt(d)

    def stack(shape, scale=1.0):
        # one expert at a time, so that no fp32 copy of the whole stack is
        # made (arctic-480b's is 17.8 GB a layer)
        out = torch.empty(shape, dtype=dt, device=gen.device)
        if is_fake(out):  # shapes only (``trunc_normal_``): nothing to draw
            return out
        w = torch.empty(shape[1:], dtype=torch.float32, device=gen.device)
        for i in range(shape[0]):
            trunc_normal_(w, 1.0, gen)
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
    with obs.span("moe.route"):
        probs = torch.softmax(x2d.float() @ p["router"]["w"], dim=-1)
        weights, sel = torch.topk(probs, cfg.num_experts_per_tok, dim=-1, sorted=True)
        return weights / weights.sum(dim=-1, keepdim=True), sel, probs


def aux_load_balance(probs: torch.Tensor, sel: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e f_e * P_e."""
    with obs.span("moe.aux"):
        onehot = F.one_hot(sel, num_experts).float()  # (T, k, E)
        f_e = onehot.sum(dim=1).mean(dim=0)
        p_e = probs.mean(dim=0)
        return num_experts * torch.sum(f_e * p_e)


def _expert_ffn(experts: Params, cfg, h_in: torch.Tensor) -> torch.Tensor:
    """Batched per-expert gated FFN over (E, C, d)."""
    with obs.span("moe.experts"):
        act = activation(cfg.act)
        up = torch.bmm(h_in, experts["w_in"]["w"])
        gate = torch.bmm(h_in, experts["w_gate"]["w"])
        h = shd.constrain(act(gate) * up, "model", None, None)
        return torch.bmm(h, experts["w_out"]["w"])


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


def _tap_dispatch(t: int, k: int, slots: int, keep: torch.Tensor) -> None:
    """The ``moe/dispatch`` event: the layer call's tokens, its (token,
    choice) pairs, its expert slots and the mask of the pairs kept in them.
    The mask is kept as it is on its device (nothing is launched); kept and
    dropped pairs are counted when the events move to the host."""
    obs.tap("moe/dispatch", {"tokens": t, "routed": t * k, "slots": slots, "keep": keep})


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
    with obs.span("moe.dispatch"):
        flat_sel, pos, keep = _slots(sel, e, cap)
        if impl == "einsum":
            disp = (F.one_hot(flat_sel, e).to(x.dtype)[:, :, None]
                    * F.one_hot(torch.where(keep, pos, cap), cap + 1).to(x.dtype)[:, None, :cap]
                    ).reshape(t, k, e, cap)
            expert_in = torch.einsum("tkec,td->ecd", disp, x2d)
        elif impl == "gather":
            token_ids = torch.arange(t * k, device=x.device) // k
            # slot_owner[e, c]: the token in that slot (t: the zero pad row);
            # row e is the spare row the dropped pairs write to
            slot_owner = torch.full((e + 1, cap), t, dtype=torch.int64, device=x.device)
            slot_owner.index_put_((torch.where(keep, flat_sel, e), torch.where(keep, pos, 0)),
                                  token_ids)
            x_pad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
            expert_in = shd.constrain(x_pad[slot_owner[:e]], "model", None, None)  # (E, C, D)
        else:
            raise ValueError(f"moe impl {impl!r} not in ('gather', 'einsum')")
    _tap_dispatch(t, k, e * cap, keep)
    expert_out = _expert_ffn(p["experts"], cfg, expert_in)
    with obs.span("moe.combine"):
        wts = weights.to(x.dtype)
        if impl == "einsum":
            y2d = torch.einsum("tkec,ecd->td", disp * wts[:, :, None, None], expert_out)
        else:
            out_choice = expert_out[flat_sel, torch.where(keep, pos, 0)]  # (T k, D)
            out_choice = torch.where(keep[:, None], out_choice, 0.0)
            y2d = torch.sum(out_choice.reshape(t, k, d) * wts[:, :, None], dim=1)

    return _residuals(p, cfg, x, y2d.reshape(b, s, d)).to(x.dtype), aux


# ---------------------------------------------------------------------------
# expert-parallel MoE: the production path under a mesh
# ---------------------------------------------------------------------------

def ep_layout(e: int, size: int, tokens: int, k: int, capacity_factor: float):
    """(e_pad, experts a rank, capacity) of the reference's expert-parallel
    MoE over a "model" dim of ``size`` for ``tokens`` local tokens."""
    e_pad = -(-e // size) * size
    cap = max(int(math.ceil(tokens * k * capacity_factor / e_pad)), 1)
    return e_pad, e_pad // size, cap


def _pad_experts(p: Params, e_pad: int, e: int):
    """(padded experts, padded router weight): zero experts and zero router
    columns past ``e``."""
    if e_pad == e:
        return p["experts"], p["router"]["w"]
    experts = {name: {"w": F.pad(v["w"], (0, 0, 0, 0, 0, e_pad - e))}
               for name, v in p["experts"].items()}
    return experts, F.pad(p["router"]["w"], (0, e_pad - e))


def ep_local(rw: torch.Tensor, experts: Params, cfg, x: torch.Tensor, lo: int, e: int,
             cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One "model" rank's part of the expert-parallel MoE: its tokens x
    (B, S, D) routed over all ``e_pad`` experts (router weight ``rw``, (D,
    e_pad)), its experts ``experts`` (``[lo, lo + e_loc)`` of the padded
    stack) run on the pairs that chose them. Returns (its partial sum of the
    routed output, the aux loss of its tokens)."""
    b, s, d = x.shape
    t, k = b * s, cfg.num_experts_per_tok
    e_pad, e_loc = rw.shape[1], experts["w_in"]["w"].shape[0]
    x2 = x.reshape(t, d)
    with obs.span("moe.route"):
        logits = x2.float() @ rw.float()
        if e_pad != e:  # padded experts are unroutable
            logits = torch.cat([logits[:, :e], torch.full_like(logits[:, e:], -1e9)], dim=1)
        probs = torch.softmax(logits, dim=-1)
        weights, sel = torch.topk(probs, k, dim=-1, sorted=True)
        weights = weights / weights.sum(dim=-1, keepdim=True)
    aux = aux_load_balance(probs[:, :e], torch.clamp(sel, max=e - 1), e)

    with obs.span("moe.dispatch"):
        flat_sel, pos, keep = _slots(sel, e_pad, cap)
        mine = keep & (flat_sel >= lo) & (flat_sel < lo + e_loc)
        local_e = flat_sel - lo
        token_ids = torch.arange(t * k, device=x.device) // k
        slot_owner = torch.full((e_loc + 1, cap), t, dtype=torch.int64, device=x.device)
        slot_owner.index_put_((torch.where(mine, local_e, e_loc), torch.where(mine, pos, 0)),
                              token_ids)
        x_pad = torch.cat([x2, x2.new_zeros((1, d))], dim=0)
        expert_in = x_pad[slot_owner[:e_loc]]  # (e_loc, C, D)
    _tap_dispatch(t, k, e_loc * cap, mine)  # this rank's experts' slots and kept pairs
    expert_out = _expert_ffn(experts, cfg, expert_in)
    with obs.span("moe.combine"):
        out_choice = expert_out[torch.where(mine, local_e, 0), torch.where(mine, pos, 0)]
        out_choice = torch.where(mine[:, None], out_choice, 0.0)
        y = torch.sum(out_choice.reshape(t, k, d) * weights.to(x.dtype)[:, :, None], dim=1)
    return y.reshape(b, s, d), aux


def ep_shard(p: Params, cfg, x: torch.Tensor, rank: int, size: int, *,
             capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ep_local`` of rank ``rank`` of ``size`` from the whole (unpadded)
    router and experts of ``p``: the sum over the ranks, in rank order, is
    the reference's psum; the shared experts and dense residual are not
    included."""
    e = cfg.num_experts
    e_pad, e_loc, cap = ep_layout(e, size, x.shape[0] * x.shape[1],
                                  cfg.num_experts_per_tok, capacity_factor)
    experts, rw = _pad_experts(p, e_pad, e)
    lo = rank * e_loc
    mine = {name: {"w": v["w"][lo:lo + e_loc]} for name, v in experts.items()}
    return ep_local(rw, mine, cfg, x, lo, e, cap)


def _residuals(p: Params, cfg, x, y):
    with obs.span("moe.shared"):
        if "shared" in p:
            y = y + mlp_apply(p["shared"], cfg, x)
        if "dense" in p:  # arctic's dense residual, beside the experts
            y = y + mlp_apply(p["dense"], cfg, x)
        return y


def moe_apply_ep(p: Params, cfg, x: torch.Tensor, *,
                 capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE under the active mesh (x a DTensor); ``moe_apply``
    un-meshed, or on a mesh with no "model" dim."""
    mesh = shd.active_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names or not shd.is_dtensor(x):
        return moe_apply(p, cfg, x, capacity_factor=capacity_factor)
    from torch.distributed.tensor import DTensor, Partial, Shard

    names = tuple(mesh.mesh_dim_names)
    mi = names.index("model")
    b, s, d = x.shape
    e, size = cfg.num_experts, mesh.size(mi)
    dp = shd.axis_size(mesh, shd.dp_axes(mesh, b))
    e_pad, e_loc, cap = ep_layout(e, size, (b // dp) * s, cfg.num_experts_per_tok,
                                  capacity_factor)
    lo = mesh.get_local_rank("model") * e_loc
    # tokens sharded over the batch axes, whole over "model"; each rank's
    # output is a part of the sum over "model" (its experts) and its aux a
    # part of the mean over the batch axes, so the gradients of the whole
    # inputs are partial sums there
    tokens, sums, whole = shd.row_placements(mesh, b)
    over_model = [Partial() if i == mi else t for i, t in enumerate(tokens)]
    everywhere = [Partial()] * len(names)
    xl = x.redistribute(mesh, tokens).to_local(grad_placements=over_model)
    rw = p["router"]["w"].redistribute(mesh, whole).to_local(grad_placements=everywhere)
    if e_pad == e and all(w["w"].placements[mi] == Shard(0) for w in p["experts"].values()):
        # the experts are already sharded over "model": each rank holds its own
        place = [Shard(0) if i == mi else w for i, w in enumerate(whole)]
        grad = [Shard(0) if i == mi else Partial() for i in range(len(names))]
        mine = {name: {"w": v["w"].redistribute(mesh, place).to_local(grad_placements=grad)}
                for name, v in p["experts"].items()}
    else:
        full = {name: {"w": v["w"].redistribute(mesh, whole).to_local(grad_placements=everywhere)}
                for name, v in p["experts"].items()}
        experts, rw = _pad_experts({"experts": full, "router": {"w": rw}}, e_pad, e)
        mine = {name: {"w": v["w"][lo:lo + e_loc]} for name, v in experts.items()}
    y, aux = ep_local(rw, mine, cfg, xl, lo, e, cap)
    y = DTensor.from_local(y.to(x.dtype), mesh, over_model,
                           run_check=False).redistribute(mesh, tokens)
    # the reference's pmean over the batch axes, each "model" rank a 1/m share
    aux_place = [Partial() if i == mi else t for i, t in enumerate(sums)]
    aux = DTensor.from_local(aux / (size * dp), mesh, aux_place,
                             run_check=False).redistribute(mesh, whole)
    return _residuals(p, cfg, x, y), aux
