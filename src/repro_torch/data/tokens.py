"""Deterministic synthetic token pipeline with O(1) skip-ahead.

The port of ``repro.data.tokens``. Every batch is a pure function of
(seed, step): it is drawn on a CPU ``torch.Generator`` seeded from both and
then moved to the device, so a restart from a checkpoint at step N
reproduces batch N + 1 bitwise without replaying the stream, on any device.
Tokens have the reference's Zipf-like marginal (a uniform on [1e-6, 1)
cubed, times the vocabulary), plus the stub modality inputs each
architecture family needs. ``torch.Generator`` does not give
``jax.random``'s draws, so the two packages agree by distribution and by
structure, not value for value.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..models.model import resolve_device


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator keyed by (seed, step): distinct pairs, distinct streams."""
    return torch.Generator().manual_seed((seed * 1_000_003 + step) % (2 ** 63))


def _zipf_tokens(gen: torch.Generator, shape, vocab: int) -> torch.Tensor:
    """Zipf-like marginal via exponentiating a uniform."""
    u = 1e-6 + (1.0 - 1e-6) * torch.rand(shape, generator=gen, dtype=torch.float32)
    # inverse-CDF of a truncated power law, exponent ~1.1
    r = torch.pow(u, 3.0)  # skew towards small ids
    return torch.clamp((r * vocab).to(torch.int32), 0, vocab - 1)


def make_batch(cfg: ModelConfig, seed: int, step: int, batch: int, seq: int,
               with_labels: bool = True, device="cuda") -> Dict[str, Any]:
    """The batch of ``step``, on ``device`` (the card unless the caller asks
    for the CPU): ``tokens`` (B, S) int32, ``labels`` the stream shifted left,
    and ``frames`` (B, encoder_seq, D) for an encoder-decoder, M-RoPE
    ``positions`` (B, S, 3), ``vision_embeds`` (B, min(1024, S), D) for the
    vision stub, as the reference's."""
    device = resolve_device(device)
    gen = _generator(seed, step)
    tokens = _zipf_tokens(gen, (batch, seq), cfg.vocab_size)
    out: Dict[str, Any] = {"tokens": tokens}
    if with_labels:
        # next-token prediction: labels are the stream shifted left
        out["labels"] = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    if cfg.is_encoder_decoder:
        out["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen) * 0.02
    if cfg.rope_mode == "mrope":
        pos = torch.arange(seq, dtype=torch.int32)[None, :, None]
        out["positions"] = pos.expand(batch, seq, 3).contiguous()
    if cfg.frontend == "vision_stub":
        sv = min(1024, seq)
        out["vision_embeds"] = torch.randn((batch, sv, cfg.d_model), generator=gen) * 0.02
    return {k: v.to(device) for k, v in out.items()}


class TokenPipeline:
    """Stateful wrapper: checkpointable as a single int (the step cursor)."""

    def __init__(self, cfg: ModelConfig, seed: int, batch: int, seq: int, device="cuda"):
        self.cfg, self.seed, self.batch, self.seq = cfg, seed, batch, seq
        self.device = resolve_device(device)
        self.step = 0

    def next(self) -> Dict[str, Any]:
        b = make_batch(self.cfg, self.seed, self.step, self.batch, self.seq, device=self.device)
        self.step += 1
        return b

    def state(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: Dict[str, int]):
        assert state["seed"] == self.seed, "pipeline seed mismatch"
        self.step = int(state["step"])
