"""Training and serving step functions.

The port of ``repro.train.step``. The LM loss is computed *chunked over the
sequence*: hidden states are unembedded and soft-maxed ``LOSS_CHUNK`` tokens
at a time, and each chunk's fp32 logits are recomputed in backward
(``torch.utils.checkpoint``), so no two chunks' (B, C, V) logits are live at
once. ``train_step`` takes its gradients with ``torch.autograd.grad`` over
fresh leaves of the parameters: a leaf the loss never reads (the mLSTM's
``wv``) gets zeros, as ``jax.grad`` gives it, so weight decay still moves it
as in the reference. PyTorch runs eagerly; there is nothing to jit.

Over a mesh the parameters and the batch are DTensors (``launch/train.py``):
a gradient comes back a partial sum over the axes its parameter is
replicated on (the data-parallel reduction) and is redistributed to its
parameter's placements before the optimizer; the metrics are plain tensors
with every rank's full value.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed import sharding as shd
from ..models import model as model_lib
from ..models.layers import unembed
from ..optim.adamw import AdamWConfig, OptState, adamw_init, adamw_update
from ..optim.schedules import warmup_cosine
from ..tree import tree_leaves, tree_unflatten

LOSS_CHUNK = 512


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, *, seed: int = 0,
                     device="cuda") -> TrainState:
    """Random parameters from ``seed`` and zero moments, on ``device`` (the
    card unless the caller asks for the CPU)."""
    params = model_lib.init(cfg, seed=seed, device=device)
    return TrainState(params, adamw_init(params, opt_cfg))


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed negative log-likelihood, count) of fp32 ``logits`` at the
    labels that are >= 0. DTensors are summed over each rank's rows
    (:func:`_nll_rows`)."""
    if shd.is_dtensor(logits):
        return _nll_rows(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def _nll_rows(logits, labels):
    """``_nll`` of DTensors: each rank sums its own batch rows with the vocab
    whole (a gather over a vocab-sharded dim has no working rule), and the
    rows' sums are added over the batch axes."""
    from torch.distributed.tensor import DTensor

    mesh = logits.device_mesh
    rows, sums, whole = shd.row_placements(mesh, logits.shape[0])
    local = _nll(logits.redistribute(mesh, rows).to_local(),
                 labels.redistribute(mesh, rows).to_local())
    return tuple(DTensor.from_local(t, mesh, sums, run_check=False).redistribute(mesh, whole)
                 for t in local)


def _chunk_nll(table: torch.Tensor, h: torch.Tensor, lab: torch.Tensor):
    return _nll(unembed({"w": table}, h).float(), lab)  # (B, C, V) fp32 logits


def _chunked_ce(table: Dict[str, torch.Tensor], hidden: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy without materializing full logits.

    hidden: (B, S, D) final normed states; labels (B, S) with next-token ids
    already aligned by the caller; label -1 masks a position out.
    """
    b, s, _ = hidden.shape
    chunk = min(LOSS_CHUNK, s)
    pad = (-s) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, s + pad, chunk):
        args = (table["w"], hidden[:, c:c + chunk], labels[:, c:c + chunk])
        # the chunk's logits are recomputed in backward: they are never saved
        nll, n = (checkpoint(_chunk_nll, *args, use_reentrant=False)
                  if torch.is_grad_enabled() else _chunk_nll(*args))
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            impl: str = "auto") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    labels = batch["labels"]
    if cfg.is_encoder_decoder:
        logits, aux = model_lib.forward(params, cfg, batch, impl=impl)
        nll, n = _nll(logits.float(), labels)
        ce = nll / torch.clamp(n, min=1.0)
    else:
        hidden, aux = model_lib.hidden_forward(params, cfg, batch, impl=impl)
        ce = _chunked_ce(params["head"] if "head" in params else params["embed"], hidden,
                         labels)
    total = ce + cfg.router_aux_loss * aux
    return total, {"ce": ce, "aux": aux}


def loss_and_grads(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                   impl: str = "auto") -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, {"ce", "aux"}, grads): the gradient of every parameter leaf,
    zeros for a leaf the loss does not read, each cast to its parameter's
    dtype (the reference pins the reduction boundary to it) and, over a
    mesh, reduced to its parameter's placements."""
    leaves: List[torch.Tensor] = tree_leaves(params)
    with torch.enable_grad():
        fresh = [p.detach().requires_grad_(True) for p in leaves]
        loss, parts = loss_fn(tree_unflatten(params, fresh), cfg, batch, impl=impl)
        grads = torch.autograd.grad(loss, fresh, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _reduced(g.to(p.dtype), p)
             for g, p in zip(grads, leaves)]
    parts = {k: v.detach() for k, v in parts.items()}
    return loss.detach(), parts, tree_unflatten(params, grads)


def _reduced(g, p):
    """A DTensor gradient on its parameter's placements (an all-reduce where
    it is partial); a plain one as it is."""
    if shd.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def train_step(
    state: TrainState,
    batch: Dict[str, Any],
    *,
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    schedule_kwargs: Optional[dict] = None,
    impl: str = "auto",
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step. Returns (new state, metrics); ``state`` is left as
    it was. Nothing is read back to the host."""
    loss, parts, grads = loss_and_grads(state.params, cfg, batch, impl=impl)
    lr_scale = warmup_cosine(state.opt.step, **(schedule_kwargs or {}))
    new_params, new_opt, om = adamw_update(grads, state.opt, state.params, opt_cfg, lr_scale)
    metrics = {"loss": shd.full(loss), **{k: shd.full(v) for k, v in parts.items()},
               "grad_norm": shd.full(om["grad_norm"]), "lr": om["lr"], "step": new_opt.step}
    return TrainState(new_params, new_opt), metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, schedule_kwargs=None):
    return functools.partial(train_step, cfg=cfg, opt_cfg=opt_cfg,
                             schedule_kwargs=schedule_kwargs)


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def prefill_step(params, batch: Dict[str, Any], *, cfg: ModelConfig, cache_len: int,
                 impl: str = "auto"):
    """Prompt pass: returns (last-token logits, filled cache)."""
    return model_lib.prefill(params, cfg, batch, cache_len, impl=impl)


def decode_step(params, token, positions, cache, *, cfg: ModelConfig, impl: str = "auto"):
    """One new token for every sequence in the batch; the cache is updated in place."""
    return model_lib.decode_step(params, cfg, token, positions, cache, impl=impl)


def forward_step(params, batch: Dict[str, Any], *, cfg: ModelConfig, impl: str = "auto"):
    """Plain forward (used by evaluation + tests)."""
    return model_lib.forward(params, cfg, batch, impl=impl)
