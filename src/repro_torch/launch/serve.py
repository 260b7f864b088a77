"""Serving entry points: the fleet the GT-DRL control plane schedules.

``ModelServer`` runs prefill + batched greedy decode for one architecture
(one "task type" in the paper's terms); ``Fleet`` stands up one server per
task type per data center and dispatches the control plane's arrival-rate
split to them. Batching, padding and greedy semantics are those of
``repro.launch.serve``: prompts are right-padded with token 0 to the longest,
and the whole batch decodes at one synchronized position.

The servers run on the CUDA card by default and raise when there is none;
``device="cpu"`` runs the plain attention path on the CPU (the tests do).

Inside ``obs.spans.recording()`` a ``generate`` call records its spans
(``obs.span``; under ``torch.profiler`` each is a ``repro_torch/<name>``
range), nested as listed:

- ``serve.generate``, the whole call (``meta``: the server's call number
  and the requests' uids; every span below reaches it through its
  ``parent``), around ``serve.batchify`` (pad, stack, copy to the card),
  ``serve.prefill`` (the prefill step and the first argmax), then each
  step's ``serve.readback`` (the produced tokens to the host, the one sync
  a step) and ``serve.decode`` (positions, the decode step, its argmax);
- in the model step: ``norm`` (``layers.apply_norm``), ``rope``
  (``attention._apply_positional``), a block's ``block.attn`` (or
  ``block.recur`` / ``block.mlstm`` / ``block.slstm``: the norm and the
  mixer) and ``block.ffn`` (the norm and the MLP or MoE);
- in a MoE layer (``models/moe.py``): ``moe.route``, ``moe.aux``,
  ``moe.dispatch``, ``moe.experts``, ``moe.combine``, ``moe.shared``; the
  layer also emits the ``moe/dispatch`` tap.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from ..configs import get_config
from ..configs.base import ModelConfig
from ..models import model as model_lib
from ..train.step import decode_step, prefill_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: torch.Tensor  # (S,) int32
    max_new: int = 16


class ModelServer:
    """Single-arch server over a fixed decode batch."""

    def __init__(self, cfg: ModelConfig, *, batch_size: int = 8, cache_len: int = 512,
                 seed: int = 0, device="cuda"):
        self.device = model_lib.resolve_device(device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.cache_len = cache_len
        self.params = model_lib.init(cfg, seed=seed, device=self.device)
        self.stats = {"requests": 0, "tokens": 0, "decode_s": 0.0, "prefill_s": 0.0}
        self._calls = itertools.count()

    def _clock(self) -> float:
        """Host time after the card has finished the work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _batchify(self, reqs: List[Request]) -> Dict[str, torch.Tensor]:
        with obs.span("serve.batchify"):
            maxlen = max(int(r.prompt.shape[0]) for r in reqs)
            toks = torch.stack([F.pad(r.prompt, (0, maxlen - r.prompt.shape[0])) for r in reqs])
            batch = {"tokens": toks.to(device=self.device, dtype=torch.int32)}
            b, s = toks.shape
            if self.cfg.rope_mode == "mrope":  # text only: the three streams equal
                batch["positions"] = torch.arange(s, dtype=torch.int32, device=self.device)[
                    None, :, None].expand(b, s, 3)
            if self.cfg.is_encoder_decoder:  # the stub frontend's frames: zeros, as the reference's
                batch["frames"] = torch.zeros((b, self.cfg.encoder_seq, self.cfg.d_model),
                                              dtype=torch.float32, device=self.device)
            return batch

    def generate(self, reqs: List[Request]) -> Dict[int, List[int]]:
        """Prefill all prompts, then decode max_new tokens, batched."""
        if len(reqs) > self.batch_size:
            raise ValueError(f"{len(reqs)} requests exceed the batch of {self.batch_size}")
        with obs.span("serve.generate", call=next(self._calls),
                      uids=tuple(r.uid for r in reqs)):
            return self._generate(reqs)

    def _generate(self, reqs: List[Request]) -> Dict[int, List[int]]:
        batch = self._batchify(reqs)
        b, s = batch["tokens"].shape
        t0 = self._clock()
        with obs.span("serve.prefill"):
            logits, cache = prefill_step(self.params, batch, cfg=self.cfg,
                                         cache_len=self.cache_len)
            self.stats["prefill_s"] += self._clock() - t0
            token = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        outs: Dict[int, List[int]] = {r.uid: [] for r in reqs}
        max_new = max(r.max_new for r in reqs)
        t0 = self._clock()
        for step in range(max_new):
            # the token produced by the previous pass (prefill for step 0)
            # IS generation `step`; decode then advances the cache past it
            with obs.span("serve.readback"):
                produced = token[:, 0].tolist()
                for i, r in enumerate(reqs):
                    if step < r.max_new:
                        outs[r.uid].append(produced[i])
            if step == max_new - 1:
                break
            with obs.span("serve.decode"):
                pos = torch.full((b, 1), s + step, dtype=torch.int32, device=self.device)
                if self.cfg.rope_mode == "mrope":
                    pos = pos[..., None].expand(b, 1, 3)
                logits, cache = decode_step(self.params, token, pos, cache, cfg=self.cfg)
                token = torch.argmax(logits, dim=-1).to(torch.int32)[:, :1]
        self.stats["decode_s"] += self._clock() - t0
        self.stats["requests"] += len(reqs)
        self.stats["tokens"] += sum(r.max_new for r in reqs)
        return outs

    def tokens_per_second(self) -> float:
        """Tokens delivered (each request its own ``max_new``, not the
        batch's padded ``b x max(max_new)``) over the decode seconds; the
        prefill's seconds are not counted (``stats["prefill_s"]``)."""
        t = self.stats["decode_s"]
        return self.stats["tokens"] / t if t > 0 else 0.0


class Fleet:
    """The serving fleet behind the paper's CWM: task types x data centers.

    ``route(ar)`` takes the GT-DRL arrival-rate matrix AR[i, d]
    (requests/hour) and dispatches batches accordingly.
    """

    def __init__(self, archs: List[str], num_dcs: int, *, smoke: bool = True,
                 batch_size: int = 4, cache_len: int = 128, device="cuda"):
        self.archs = archs
        self.num_dcs = num_dcs
        self.servers: Dict[Tuple[int, int], ModelServer] = {}
        for i, a in enumerate(archs):
            cfg = get_config(a)
            cfg = cfg.smoke() if smoke else cfg
            for d in range(num_dcs):
                self.servers[(i, d)] = ModelServer(
                    cfg, batch_size=batch_size, cache_len=cache_len, seed=i * 97 + d,
                    device=device)

    def route(self, ar, requests_per_unit: int = 1, prompt_len: int = 16,
              max_new: int = 4) -> Dict[str, Any]:
        """Dispatch a scaled-down sample of the assignment matrix."""
        ar = np.asarray(ar, dtype=np.float32)
        share = ar / np.maximum(np.sum(ar), np.float32(1e-9))
        uid = 0
        dispatched = {}
        for i in range(len(self.archs)):
            for d in range(self.num_dcs):
                n = int(round(float(share[i, d]) * requests_per_unit * len(self.archs)
                              * self.num_dcs))
                n = min(n, self.servers[(i, d)].batch_size)
                if n <= 0:
                    continue
                reqs = [Request(uid + k, torch.ones((prompt_len,), dtype=torch.int32), max_new)
                        for k in range(n)]
                uid += n
                self.servers[(i, d)].generate(reqs)
                dispatched[(i, d)] = n
        return {"dispatched": dispatched,
                "total": sum(dispatched.values()),
                "per_server_tps": {k: s.tokens_per_second()
                                   for k, s in self.servers.items() if s.stats["tokens"]}}
