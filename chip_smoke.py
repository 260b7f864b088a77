#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels/`` (ignored by git), holds each kernel against its plain
PyTorch version on the card (head dim 16 in fp32 too, 256 in both dtypes,
whisper-base's non-causal shapes), times both (at llama3.2-1b's and
recurrentgemma-9b's shapes, and at whisper-base's, qwen2-vl-72b's and
arctic-480b's; the RoPE kernel ``csrc/rope.cu`` bit for bit, and timed at the
benchmark cells' prefill and decode shapes), then serves llama3.2-1b at full
width (16 layers, d_model 2048, bf16, random weights from seed 0) through
``ModelServer.generate`` and
a two-data-center ``Fleet``, and checks that the serving path went through
both kernels and that its logits and tokens are sane; ``[fleet-smoke]``
serves the default ``Fleet`` (``cfg.smoke()``, head dim 16) of llama3.2-1b
and of whisper-base the same way; ``[serve-arch]`` serves ``SERVE_ARCHS``
at their published widths, one at a time, the same way: qwen2-moe-a2.7b,
recurrentgemma-9b (a prompt past its attention window), qwen2-7b,
llama3.2-3b, whisper-base, xlstm-125m, and qwen2-vl-72b and arctic-480b at
the depth one card holds; ``[serve-fleet]`` runs the reference's
examples/serve_fleet.py loop (GT-DRL's split to a dense, an MoE and a
hybrid smoke server x 2 DCs). It trains: ``[kernel-bwd]`` holds the flash
backward kernel (``csrc/flash_attention_bwd.cu``) against the plain backward
of ``kernels/flash_vjp.py`` case by case and at llama3.2-1b's training
shape; ``[train-hold]`` one fp32 train step of llama3.2-1b at full width
through the kernels against ``impl="ref"``, then bf16 by distance from fp32;
``[train]`` ``train_loop`` at full width (10 steps: step ms, tokens/s, peak
memory, launches held exactly, one step profiled); ``[mesh-train]`` the same
run through ``train_loop(mesh=make_host_mesh())`` (a world of one rank on
NCCL, parameters and batches DTensors) against ``[train]``;
``[mesh-shards]`` each rank's calls of both flash kernels under a 4-wide
and a 16-wide "model" dim, in turn, against the unsharded call, and
qwen2-moe-a2.7b's expert-parallel layer at full width over 4 and 16 ranks;
``[train-arch]`` every
arch at smoke width against the same steps on the host CPU (a second process,
``--cpu-train-reference PATH``); ``[train-resume]`` a crash at step 17 and a
resume bit-equal to an uninterrupted run. ``[dryrun-card]`` dry-runs
(``launch/dryrun.py``) [train]'s step on a (1, 1) mesh: its argument bytes
held to what [train]'s state takes on the card, its peak against [train]'s,
the step's share of the card's bf16 peak; ``[dryrun]`` prints the dry run of
one cell of each kind on the 16 x 16 mesh, from a third process on the host
CPU (``--dryrun PATH``, a fake world of 256). Then
it drives the scheduler path (``repro_torch.core``) on the paper's fleets
built on the card:

- ``[gtdrl-step]`` / ``[gtdrl-profile]``: one GT-DRL half-update at D = 16
  on the card and on the host CPU from the same agents and draws (the card's
  under CUDA's sync debug mode), then its profile;
- ``[sched]``: days of fd, nash and gt-drl (pretrained, the paper's default
  config), each held against the same spec on the host CPU, which a second
  process of this script (``--cpu-reference PATH``) runs beside the card's
  work;
- ``[compare]``: ``compare_techniques`` ranking the paper's six techniques
  over two fleets on its default batched engine (fd held against the hour
  loop; ga, ddpg, ppo and gt-drl against the CPU process, ``[compare-cpu]``), each
  writing a run record; ``[obs]``: an fd day with its taps off
  and on (bit for bit), the batched stress day's taps, a tapped gt-drl
  half-update under CUDA's sync debug mode, and the scoreboard rendered from
  the records; ``[sched-profile]``: one fd hour under the profiler;
- the scenario engine at D = 16: ``[scenarios]`` (every suite built on the
  card, equal to the CPU build), ``[sched-batched]`` (fd over the 11-day
  stress suite under one vmap a hour, rows against the card's scan days,
  GA, ddpg and joint PPO over the same rows, then a profiled batched hour), ``[sched-month]`` (days in a row, the peak
  threaded), ``[sched-faults]`` (a crash and a brownout under each failover
  policy, and a stacked random trace a row on the batched engine) and
  ``[sweep]`` (a severity grid, then killed after two chunks and resumed
  from its journal); each run against the same spec on the host CPU.

Last, ``[lint]`` runs the port's static analysis (``python -m
repro_torch.lint --format json``, in a subprocess, over this checkout) and
requires no finding, validates the D = 16 fleet built on the card and a
crash trace moved to the card against their pytree schemas and bounds
(``lint.validate`` / ``lint.validate_bounds``), and holds two identical fd
days to one new engine key and then none (``lint.expect_compiles``), their
hours run under CUDA's sync debug mode set to raise, the runtime witness
of the purity pass.

Phases print one line each; the second line from the end is the kernels'
JSON record and the last line ``{"ok": true, "device": ...}``.

It exits non-zero, without a result, when there is no CUDA device or the
port's sources are missing, and on any failed check. It imports nothing of
JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import faults as fault_mod  # noqa: E402
from repro_torch import lint, obs, scenarios  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import ExperimentSpec, compare_techniques, run, sweep  # noqa: E402
from repro_torch.core import experiment, game, gt_drl, schedulers  # noqa: E402
from repro_torch.core.draws import generator  # noqa: E402
from repro_torch.core.schedulers import StatefulScheduler  # noqa: E402
from repro_torch.dcsim import env as sched_env  # noqa: E402
from repro_torch.dcsim import latency  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import flash_vjp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rope as rope_mod  # noqa: E402
from repro_torch.kernels.ops import kv_heads_of_shard  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.configs.base import ATTN  # noqa: E402
from repro_torch.data.tokens import make_batch  # noqa: E402
from repro_torch.launch.serve import Fleet, ModelServer, Request  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, global_norm  # noqa: E402
from repro_torch.train import step as train_step_mod  # noqa: E402
from repro_torch.train.step import (decode_step, init_train_state, loss_and_grads,  # noqa: E402
                                    make_train_step, prefill_step, train_step)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth, bf16 tensor cores,
# fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
# clock cycles of the spin kernel per second of host time to cover (above
# the H100's 1.98 GHz boost clock, so the spin lasts at least that long)
SPIN_CYCLES_PER_S = 2e9
L2_FLUSH_BYTES = 128 * 2 ** 20  # over twice the H100's 50 MB L2
# the device kernels of csrc/flash_attention.cu and csrc/decode_attention.cu
ATTENTION_KERNEL_NAMES = ("flash_fwd", "decode_split_kernel", "decode_combine_kernel")

# kernel cases: those of tests/test_kernels.py plus softcap / q_offset cases
# (b, sq, skv, h, kvh, d, causal, window, softcap, q_offset)
FLASH_CASES = [
    (1, 128, 128, 4, 4, 64, True, 0, 0.0, 0),
    (2, 256, 256, 4, 2, 64, True, 0, 0.0, 0),
    (2, 256, 256, 8, 1, 32, True, 0, 0.0, 0),
    (1, 384, 384, 4, 2, 128, True, 64, 0.0, 0),
    (1, 128, 128, 2, 2, 64, False, 0, 0.0, 0),
    (2, 192, 192, 6, 3, 32, True, 0, 0.0, 0),
    (1, 128, 128, 4, 2, 64, True, 0, 30.0, 0),
    (2, 64, 192, 4, 2, 64, True, 0, 0.0, 128),
    (1, 96, 320, 4, 1, 32, True, 64, 25.0, 224),
    (1, 100, 100, 4, 2, 64, True, 0, 0.0, 0),
    (1, 128, 200, 4, 2, 128, False, 0, 0.0, 0),
    (2, 1, 100, 4, 4, 64, False, 0, 0.0, 0),
    (3, 4, 150, 8, 2, 64, False, 0, 0.0, 0),
    (2, 1, 70, 8, 1, 128, False, 0, 0.0, 0),
]
# whisper-base's flash calls at its serving shapes (the audio-asr profile:
# batch 48, 1500 frames, 8 heads of 64): the decoder's cross attention at
# decode (one query row) and over the 4-token prompt, and the encoder; none
# causal, Skv not a multiple of the 64-key tile. Both dtypes
FLASH_CASES_WHISPER = [
    (48, 1, 1500, 8, 8, 64, False, 0, 0.0, 0),
    (48, 4, 1500, 8, 8, 64, False, 0, 0.0, 0),
    (48, 1500, 1500, 8, 8, 64, False, 0, 0.0, 0),
]
# llama3.2-1b attention at batch 8 beyond the serving prefill: (sq, skv, causal)
FLASH_SWEEP = [(256, 64, False), (256, 128, False), (256, 256, False), (1024, 1024, True)]
# (b, s, h, kvh, d, softcap)
DECODE_CASES = [
    (2, 512, 8, 2, 64, 0.0),
    (1, 300, 4, 1, 32, 0.0),
    (3, 1024, 4, 4, 128, 0.0),
    (2, 257, 14, 2, 64, 0.0),
    (2, 512, 8, 2, 64, 25.0),
]
# decode with explicit lengths: 0, S, on a split boundary, one past a split
# (b, s, h, kvh, d, softcap, lengths)
DECODE_LENGTH_CASES = [
    (5, 300, 8, 2, 64, 0.0, (0, 300, 128, 65, 129)),
    (4, 256, 4, 1, 128, 25.0, (0, 256, 64, 129)),
    (3, 192, 14, 2, 32, 0.0, (192, 0, 65)),
]
# head dim 16, fp32 only: the smoke configs' (cfg.smoke()), which the default
# Fleet serves; the smoke fleet's prefill and decode shapes first
FLASH_CASES_D16 = [
    (4, 16, 16, 4, 4, 16, True, 0, 0.0, 0),
    (3, 1, 16, 4, 4, 16, False, 0, 0.0, 0),  # the smoke whisper's cross attention at decode
    (3, 16, 16, 4, 4, 16, False, 0, 0.0, 0),  # and its encoder
    (2, 100, 100, 4, 2, 16, True, 0, 0.0, 0),
    (1, 96, 320, 4, 1, 16, True, 64, 25.0, 224),
]
DECODE_CASES_D16 = [
    (4, 128, 4, 4, 16, 0.0),
    (2, 257, 8, 2, 16, 25.0),
]
DECODE_LENGTH_CASES_D16 = [(3, 192, 8, 2, 16, 0.0, (192, 0, 65))]
# head dim 256, fp32 and bf16: recurrentgemma-9b's (MQA, 16 query heads over
# one kv head, window 2048), and GQA; a window shorter than Skv, Sq not a
# multiple of 64, decode lengths on and one past a split's edge
FLASH_CASES_D256 = [
    (1, 200, 200, 16, 1, 256, True, 64, 0.0, 0),
    (2, 128, 128, 4, 2, 256, True, 0, 0.0, 0),
    (1, 96, 320, 8, 1, 256, True, 128, 30.0, 224),
    (1, 100, 164, 4, 4, 256, False, 0, 0.0, 0),
]
DECODE_CASES_D256 = [
    (2, 300, 16, 1, 256, 0.0),
    (2, 257, 8, 2, 256, 25.0),
]
DECODE_LENGTH_CASES_D256 = [(4, 256, 16, 1, 256, 0.0, (0, 256, 64, 65))]


class ServeCase(NamedTuple):
    """One arch served at full width, bf16, by [serve-arch]: ``batch``
    requests of ``prompt`` tokens, ``new`` new tokens each, a ``cache``-slot
    KV cache. ``layers`` cuts the depth where one 80 GB card forces it (None:
    all); the first-step logits are held on ``logit_layers`` of them at
    ``logit_prompt`` tokens (None: as served), in fp32 once the server is
    freed, the copy made leaf by leaf in place of the bf16 weights."""
    arch: str
    prompt: int
    cache: int
    batch: int = 8
    new: int = 32
    layers: Optional[int] = None
    logit_layers: Optional[int] = None
    logit_prompt: Optional[int] = None


# recurrentgemma-9b's prompt outruns its 2048-token window, so its prefill
# takes the windowed mask and the ring roll and its decode writes the ring.
# qwen2-moe-a2.7b's fp32 copy (57 GB) fits once its bf16 weights (28.6 GB)
# are converted in place, so its logits are held at full depth.
# whisper-base at the llm workload's audio-asr profile (batch 48, 1500
# frames, a 4-token decoder prompt, 180 new tokens). xlstm-125m's 1000-token
# prompt takes the mLSTM's chunkwise form over 4 chunks (24 rows padded).
# qwen2-vl-72b's prompt is its 1024 patch positions and 256 of text; 8 of its
# 80 layers (19 GB in bf16) leave room for the fp32 copy (38 GB). arctic-480b
# at its moe-480b profile's 2048-token prompt: one layer's 128 experts take
# 26.8 GB in bf16, so 2 of its 35 layers are served (55 GB) and its fp32
# logits (one layer, 56 GB) are held at 256 tokens once the server is freed
SERVE_ARCHS = [
    ServeCase("qwen2-moe-a2.7b", 256, 1024),
    ServeCase("recurrentgemma-9b", 2304, 4096),
    ServeCase("qwen2-7b", 256, 1024),
    ServeCase("llama3.2-3b", 256, 1024),
    ServeCase("whisper-base", 4, 256, batch=48, new=180),
    ServeCase("xlstm-125m", 1000, 1024),
    ServeCase("qwen2-vl-72b", 1280, 2048, layers=8),
    ServeCase("arctic-480b", 2048, 4096, layers=2, logit_layers=1, logit_prompt=256),
]
VISION_GRID = 32  # qwen2-vl's stub patches: a 32 x 32 grid leads its prompt
# the reference's examples/serve_fleet.py: GT-DRL's split over build_env(4)
# dispatched to a dense, an MoE and a hybrid arch (smoke widths) x 2 DCs
FLEET_ARCHS = ["llama3.2-1b", "qwen2-moe-a2.7b", "recurrentgemma-9b"]
# RoPE (b, s, h, kvh, d, lowest position, past the highest): the benchmark
# cells' prefill (positions 0 .. 1,499, as ModelServer gives them, one row
# expanded over the batch) and decode (one token a row at 1,500 .. 1,512),
# then other head dims at positions drawn up to 131,071: 64, recurrentgemma's
# MQA at 256, the smoke configs' 16, and 10 (16-byte loads do not fit a half)
ROPE_THETA = 1e6  # qwen2's
ROPE_SERVE_CASES = [
    (64, 1500, 28, 4, 128, 0, 1500),    # qwen2-7b.rag prefill
    (64, 1, 28, 4, 128, 1500, 1513),    # qwen2-7b.rag decode
    (64, 1500, 16, 16, 128, 0, 1500),   # qwen2-moe-a2.7b.rag prefill
    (64, 1, 16, 16, 128, 1500, 1513),   # qwen2-moe-a2.7b.rag decode
]
ROPE_CASES = ROPE_SERVE_CASES + [
    (2, 37, 8, 2, 64, 0, 131072),
    (3, 1, 8, 2, 64, 0, 131072),
    (2, 37, 16, 1, 256, 0, 131072),
    (2, 37, 4, 2, 16, 0, 131072),
    (2, 5, 3, 1, 10, 0, 131072),
]


def rope_positions(b: int, s: int, lo: int, hi: int, device, gen=None) -> torch.Tensor:
    """(b, s) int32 positions: ``lo .. hi - 1`` expanded over the batch where
    they are a prompt's (``hi - lo == s > 1``), else drawn in ``[lo, hi)``."""
    if s > 1 and hi - lo == s:
        return torch.arange(lo, hi, dtype=torch.int32, device=device)[None].expand(b, s)
    return torch.randint(lo, hi, (b, s), generator=gen, device=device, dtype=torch.int32)


def rope_rows(randn, records: dict) -> None:
    """[kernel] rows of the RoPE kernel at ``ROPE_SERVE_CASES`` in bf16: its
    output bit-equal to the plain version's (``ops.rope(impl="ref")``), kernel
    and plain ms, the bound (q and k read and written once, and the
    positions read, at 3.35 TB/s; the rotation's fp32 products at 67
    TFLOP/s). No PyTorch call computes RoPE, so there is no library time."""
    bf16 = torch.bfloat16
    for b, s, h, kvh, d, lo, hi in ROPE_SERVE_CASES:
        q, k = randn(b, s, h, d, dtype=bf16), randn(b, s, kvh, d, dtype=bf16)
        pos = rope_positions(b, s, lo, hi, q.device)
        kernel = lambda: rope_mod.rope_fwd(q, k, pos, ROPE_THETA)
        plain = lambda: ops.rope(q, k, pos, ROPE_THETA, impl="ref")
        got, want = kernel(), plain()
        unequal = sum(int((g != w).sum()) for g, w in zip(got, want))
        if unequal:
            fail(f"rope at q{tuple(q.shape)} k{tuple(k.shape)}: {unequal} elements differ "
                 "from the plain version")
        elems = q.numel() + k.numel()
        nbytes = 2 * elems * q.element_size() + 4 * b * s
        flops = 3 * elems
        bound_ms, bound_by = bound(nbytes, flops, PEAK_FP32_FLOPS)
        launches = rope_mod.KERNEL.launches
        rec = dict(shape=f"q{tuple(q.shape)} k{tuple(k.shape)} positions {lo}..{hi - 1} bf16",
                   unequal_elements=unequal, ms=time_ms(kernel, iters=100 if s == 1 else 20),
                   plain_ms=time_ms(plain, iters=20 if s == 1 else 5),
                   bound_ms=bound_ms, bound_by=bound_by, library_ms="none")
        rec["launches_a_call"] = 1 if rope_mod.KERNEL.launches > launches else 0
        records["rope"].setdefault("rows", []).append(rec)
        phase("kernel", name="rope", bytes=nbytes, flops=flops, **rec)
        del q, k, got, want


# fp32: summation order only; bf16: one rounding of O(1) outputs (2^-8) plus order
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# [kernel-bwd]: the backward kernel against flash_vjp's plain backward, both
# through autograd from the same inputs and output cotangent. The cases of
# tests/test_kernels.py::test_flash_vjp_gradients (softcap 0 and 30), window
# + GQA, q_offset with Sq < Skv, non-causal Sq != Skv, D = 16 (fp32 only) and
# D = 256 (MQA_BWD_CASE, a group of 8 over one kv head), arctic-480b's group
# of 7 (a head split of 1 or 7) and recurrentgemma-9b's group of 16 at D = 256
# with its window, then llama3.2-1b's training shape (TRAIN_ATTN_CASE).
# (b, sq, skv, h, kvh, d, causal, window, softcap, q_offset)
MQA_BWD_CASE = (1, 200, 200, 8, 1, 256, True, 0, 0.0, 0)
BWD_CASES = [
    (1, 256, 256, 4, 2, 32, True, 0, 0.0, 0),
    (1, 256, 256, 4, 2, 32, True, 0, 30.0, 0),
    (1, 384, 384, 4, 2, 128, True, 64, 0.0, 0),
    (2, 64, 192, 4, 2, 64, True, 0, 0.0, 128),
    (1, 96, 320, 4, 1, 32, True, 64, 25.0, 224),
    (1, 128, 200, 4, 2, 128, False, 0, 0.0, 0),
    (3, 4, 150, 8, 2, 64, False, 0, 0.0, 0),
    (2, 100, 100, 4, 2, 16, True, 0, 0.0, 0),
    MQA_BWD_CASE,
    (1, 130, 70, 4, 4, 256, False, 0, 0.0, 0),
    (1, 256, 256, 14, 2, 128, True, 0, 0.0, 0),
    (1, 256, 256, 16, 1, 256, True, 64, 0.0, 0),
]
TRAIN_ATTN_CASE = (8, 256, 256, 32, 8, 64, True, 0, 0.0, 0)
# the cases whose rows also give each backward kernel's device time
BWD_SPLIT_CASES = (TRAIN_ATTN_CASE, MQA_BWD_CASE)
BWD_PARTS = ("delta", "dkdv", "reduce", "dq")
# dq, dk, dv against the plain backward. fp32: max abs, summation order over
# up to 384 keys of O(10) gradients (2.1e-5 at most on an H100 80GB HBM3);
# bf16: relative norm, the gradients' own bf16 rounding (2^-8 an element,
# ~1.6e-3 in norm) and the forward kernel's bf16 P
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# training: llama3.2-1b at full width, the reference launcher's batch 8 x 256
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 10
# [train-hold], one fp32 step at full width, kernel path against impl="ref"
# from the same state (opt step 100: the schedule's peak lr) and batch: loss
# at rtol 1e-5 and the grad norm at 1e-4 (16 layers of ~1e-6 summation-order
# differences); each leaf's gradient at a relative norm of 1e-3; the
# parameters' update (new - old) at a relative norm of 1e-2, since Adam
# normalizes each element, so an element whose gradient is within the
# paths' noise of 0 can move by a whole lr either way. bf16: the kernel
# path's loss and gradients no further from the fp32 ones than twice the
# plain bf16 path's (the loss with a floor of 1e-3 of its value: one scalar
# can land on the fp32 one by chance)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_LEAF_RTOL, TRAIN_UPDATE_RTOL = 1e-5, 1e-4, 1e-3, 1e-2
TRAIN_BF16_FACTOR, TRAIN_BF16_LOSS_FLOOR = 2.0, 1e-3
# [train-arch]: each arch at smoke width (fp32, head dim 16), eight steps on
# one batch as tests/test_arch_smoke.py takes them, card against the CPU
# process's run from the same parameters: the first loss at rtol 1e-5
# (summation order), the later ones at 1e-3 (Adam's normalized steps carry
# the last bits forward)
ARCH_STEPS, ARCH_LR = 8, 5e-3
ARCH_FIRST_RTOL, ARCH_LOSS_RTOL = 1e-5, 1e-3
# [dryrun-card]: the dry run of [train]'s step on a (1, 1) mesh; its
# argument bytes held to what [train]'s state and batch take on the card (the
# caching allocator rounds each block up to 512 bytes: ~0.1 MB of ~12.4 GB)
DRYRUN_ARG_RTOL = 0.01
# [dryrun]: one cell of each kind on the 16 x 16 mesh, in a CPU process of its
# own (a fake world of 256); the quadratic long_500k cell must be skipped
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("qwen2-7b", "prefill_32k"),
                ("qwen2-moe-a2.7b", "decode_32k"), ("xlstm-125m", "long_500k"),
                ("llama3.2-1b", "long_500k"))
DRYRUN_SKIPPED = (("llama3.2-1b", "long_500k"),)
DRYRUN_TIMEOUT_S = 900
# [train-resume]: tests/test_fault_tolerance.py's crash at step 17 of 30
RESUME_KW = dict(arch="llama3.2-1b", smoke=True, batch=2, seq=32, lr=1e-3, seed=3,
                 save_every=10, log_every=1000)
RESUME_STEPS, RESUME_FAIL_AT = 30, 17

# [mesh-shards]: the calls a 4-wide "model" dim makes of the flash kernels at
# llama3.2-1b's training shape, each rank's against the unsharded call (fp32:
# out and dq at the forward's 2e-5, dk and dv summed in rank order at the
# backward's 1e-4, each reported bit-equal or not; bf16 by its distance from
# fp32: within MESH_BF16_FACTOR of the unsharded bf16 call's); the GQA case at a
# 16-wide dim (2 q heads a rank, half a kv head's group); qwen2-moe-a2.7b's
# expert-parallel layer at full width (60 experts, fp32, 2 x 256 tokens) at
# 4 ranks against moe_apply and at 16 (padded to 64) against the CPU process
MESH_M, MESH_GQA_M, MESH_OUT_TOL, MESH_BF16_FACTOR = 4, 16, 2e-5, 2.0
EP_ARCH, EP_SHAPE, EP_SIZES, EP_RTOL = "qwen2-moe-a2.7b", (2, 256), (4, 16), 1e-5

# llama3.2-1b serving: batch 8, 256-token prompts, 32 new tokens, cache 1024
ARCH, BATCH, PROMPT, MAX_NEW, CACHE = "llama3.2-1b", 8, 256, 32, 1024
# first-step logits, kernel path vs impl="ref" on the card. fp32: the kernels
# sum in another order than the plain versions, ~1e-6 relative per layer.
# bf16: the two attention paths round to bf16 at different places, and 16
# bf16 layers carry those one-ulp flips (2^-8) into the logits, so each bf16
# path is held by its distance from the fp32 logits instead
FP32_LOGIT_RTOL, FP32_LOGIT_ATOL = 1e-4, 1e-3
BF16_LOGIT_FACTOR = 2.0

# scheduler path: the paper's fleets (D = 16 is its largest), the SLA priced
# and the WAN visible, objective cost_sla. (technique, D, routed, hours): fd
# plays 6 hours at D = 16 and 2 hours at D = 4 and 8; nash takes 6 sweeps x
# I players x 40 gradient steps an hour (~20 s an hour on the card,
# launch-bound), so it plays one hour at D = 16
SCHED_CASES = [("fd", d, routed, 6 if d == 16 else 2) for d in (4, 8, 16)
               for routed in (False, True)]
SCHED_CASES += [("nash", 16, False, 1)]
# gt-drl at the paper's default config, pretrained (15 steps of 4 contexts,
# the contexts batched) and ~15 s an hour on the card
GTDRL_HOURS = 2
SCHED_CASES += [("gt-drl", 16, routed, GTDRL_HOURS) for routed in (False, True)]
SLA_PRICE = 1e-4  # $/task per expected SLA miss
# the card's day against the host CPU's: the day's cost (what the solvers
# minimize) agrees closely; carbon and SLA cost move along directions the
# objective barely sees, where float32 sums in another order settle the
# solvers elsewhere (fd keeps the best of iterates that tie within an ulp,
# nash's normalized gradient steps come from cancelling ~1e6 $/h terms), so
# they are held loosely
SCHED_OBJECTIVE_RTOL = 5e-4
SCHED_OTHER_RTOL = 1e-1
SCHED_VIOLATION_SHARE = 1e-5  # violation / Σ CAR: float32 rounding of the sums
# the violation and unserved mass of a scenario-engine run, card against CPU:
# under a failover policy that drops, both are the shed load, which follows
# fd's plan (picked between iterates tied within an ulp) as carbon does: held
# within the larger of SCHED_VIOLATION_SHARE of Σ CAR and SHED_RTOL of their
# value (1.1e-3 of it apart, routed drop, on an H100 80GB HBM3). Replayed on
# the card from the CPU's own plans, the failover itself is held within
# SCHED_VIOLATION_SHARE of Σ CAR alone
SHED_RTOL = 1e-2
# one gt-drl half-update, card against host CPU from the same agents and
# draws: the adopted rows' objective values, and the agents' weights (16 Adam
# steps; 1.1e-5 at most on an H100 80GB HBM3)
GTDRL_ROW_RTOL = 1e-5
GTDRL_AGENT_ATOL = 1e-4
# a gt-drl day, card against CPU: each hour adopts the best of candidates
# whose values may tie within float32, and the pretrained agents carry the
# card's rounding into every later choice, so its cost is held looser than
# fd's, and its carbon and SLA cost (directions the cost barely sees: 1.1e-2
# and 1.4e-1 apart on an H100 80GB HBM3) are reported, not held
GTDRL_COST_RTOL = 1e-3
# the techniques ranked by compare_techniques on the card: two priced
# D = 16 fleets (seeds 0 and 1), one hour each, default configs
COMPARE_HOURS = 1
# the scenario engine at D = 16 (fd, priced, cost_sla); hours are cut,
# never widths: the 11 days of the stress suite, 3 days of the month
BATCH_HOURS, MONTH_DAYS, MONTH_HOURS, FAULT_HOURS, SWEEP_HOURS = 2, 3, 2, 2, 2
STACKED_ROWS = 4  # stress-suite rows under a stacked random trace a row
# the stochastic techniques held card against CPU on the batched engine
# (default configs, the stress suite, unrouted): each row's draws come from
# the host, the same in both processes, so only float32 order differs; held
# as fd is (cost SCHED_OBJECTIVE_RTOL, others SCHED_OTHER_RTOL)
BATCHED_STOCHASTIC = ("ga", "ddpg", "ppo")
# [compare-cpu]: [compare]'s batched rows of the stochastic techniques, the
# card's mean daily cost against the CPU process's from the same host draws:
# at the rtol GA's batched totals hold, gt-drl at its own day's
COMPARE_HELD = {**{t: SCHED_OBJECTIVE_RTOL for t in BATCHED_STOCHASTIC},
                "gt-drl": GTDRL_COST_RTOL}
# run_sweep.py --quick's grid over a priced D = 16 fleet, routed fd
SWEEP_GRID = {"wan_degradation": (1.0, 3.0),
              "origin_shift": tuple({"weight": w, "toward": (0,)} for w in (0.0, 0.8))}
SWEEP_BASE = (scenarios.Scenario("sla_tighten", {"tighten": 0.7}),)
SWEEP_KILL_AFTER = 2
# batched rows against the card's scan days of their seeds: the same
# program on other shapes, so float32 summation order only
ROW_RTOL = 1e-5
# [obs]: the fd day whose taps are switched on, and the records that
# [compare] writes and [obs] renders into a scoreboard
OBS_HOURS = 2
OBS_TAPS = ("engine/hour", "game/nash_residual")
RECORDS = ROOT / "build" / "chip_smoke_records.jsonl"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAIL: {msg}")


T_START = time.perf_counter()


def phase(tag: str, /, **fields) -> None:
    """One line of results; ``t_s`` is the script's time so far."""
    fields["t_s"] = f"{time.perf_counter() - T_START:.1f}"
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3, flush: torch.Tensor | None = None) -> float:
    """Mean device time of one call, by CUDA events.

    The calls are queued behind a spin kernel that lasts longer than the host
    takes to queue them, so the host's launch time is not counted. Warm: one
    pair of events around ``iters`` calls back to back. With ``flush``, a
    buffer larger than the L2 cache is overwritten before each call, outside
    that call's own pair of events.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(1 if flush is None else iters)]
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (2 * iters * host_s + 1e-3)))
    if flush is None:
        pairs[0][0].record()
        for _ in range(iters):
            fn()
        pairs[0][1].record()
    else:
        for start, end in pairs:
            flush.zero_()
            start.record()
            fn()
            end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def bound(nbytes: int, flops: int, peak_flops: float = PEAK_BF16_FLOPS):
    """(ms, "bytes" | "operations"): the least time the card could take, its
    operations at ``peak_flops`` (bf16's unless given)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attn_pairs(sq: int, skv: int, causal: bool, window: int, q_offset: int) -> int:
    """Number of (query, key) pairs the mask keeps."""
    total = 0
    for i in range(sq):
        qp = q_offset + i
        hi = min(skv - 1, qp) if causal else skv - 1
        lo = max(0, qp - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def next_positions(batch) -> torch.Tensor:
    """The first decode step's positions: one past the prompt's last, (B, 1)
    or, given M-RoPE streams (B, S, 3), each stream's last plus one."""
    if "positions" in batch:
        return (batch["positions"][:, -1:] + 1).to(torch.int32)
    b, s = batch["tokens"].shape
    return torch.full((b, 1), s, dtype=torch.int32, device=batch["tokens"].device)


def first_logits(params, cfg, batch, token, impl, cache_len=CACHE):
    """fp32 logits of the prefill and of the first decode step, one attention path."""
    logits, cache = prefill_step(params, batch, cfg=cfg, cache_len=cache_len, impl=impl)
    dlogits, _ = decode_step(params, token, next_positions(batch), cache, cfg=cfg, impl=impl)
    return {"prefill": logits.float(), "decode": dlogits.float()}


def fp32_in_place(tree) -> None:
    """Every tensor of the nested dicts and lists ``tree`` made fp32 in place,
    one at a time, so that the bf16 original is freed before the next copy."""
    for key in list(tree) if isinstance(tree, dict) else range(len(tree)):
        if isinstance(tree[key], torch.Tensor):
            tree[key] = tree[key].float()  # the slot held the only reference
        else:
            fp32_in_place(tree[key])


def library_kernels(fn) -> str:
    """The device kernels one call of ``fn`` runs, by torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return "; ".join(e.key[:120] for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total > 0) or "not measured"


def profile_steps(srv, batch, token):
    """Host time, device-busy time and the top kernels of one prefill and one
    decode step, from torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    cache = None
    out = {}
    for step in ("prefill", "decode"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == "prefill":
                _, cache = prefill_step(srv.params, batch, cfg=srv.cfg, cache_len=srv.cache_len)
            else:
                decode_step(srv.params, token, next_positions(batch), cache, cfg=srv.cfg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side entries only: an operator's entry repeats its kernels' time
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        # the port's own attention kernels (csrc/*.cu), by name
        ours = [e for e in kernels if any(n in e.key for n in ATTENTION_KERNEL_NAMES)]
        out[step] = dict(
            wall_ms=f"{wall_ms:.3f}",
            device_busy_ms=f"{busy_ms:.3f}" if kernels else "not measured",
            idle_share=f"{1 - busy_ms / wall_ms:.3f}" if kernels else "not measured",
            attention_kernels="; ".join(
                f"{e.key.split('<')[0].split()[-1].split('::')[-1]} x{e.count} "
                f"{e.self_device_time_total / 1e3:.4f}ms" for e in ours) or "none",
            kernels=sum(e.count for e in kernels),
            top="; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f}ms"
                          for e in top),
        )
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device --------------------------------------------------------
    print(card_line(), flush=True)
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------
    sources = [flash_mod.KERNEL.source, flash_mod.BWD_KERNEL.source, dec_mod.KERNEL.source,
               rope_mod.KERNEL.source]
    t0 = time.perf_counter()
    seconds = _build.build(sources)
    phase("build", wall_s=f"{time.perf_counter() - t0:.1f}",
          **{s: f"{v:.1f}s" for s, v in seconds.items()})
    for s in sources:
        for line in _build.library_path(s).with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  ptxas {s}: {line.strip()}")

    # -- 3. kernels against their plain versions --------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def check(what, out, want, dtype):
        err = max_err(out, want)
        torch.cuda.synchronize()
        if not err < TOL[dtype]:
            fail(f"{what} {dtype}: max err {err} >= {TOL[dtype]}")

    cases = [(dtype, FLASH_CASES + FLASH_CASES_D256 + FLASH_CASES_WHISPER,
              DECODE_CASES + DECODE_CASES_D256, DECODE_LENGTH_CASES + DECODE_LENGTH_CASES_D256)
             for dtype in (torch.float32, torch.bfloat16)]
    cases.append((torch.float32, FLASH_CASES_D16, DECODE_CASES_D16, DECODE_LENGTH_CASES_D16))
    for dtype, flash_cases, decode_cases, decode_length_cases in cases:
        for case in flash_cases:
            b, sq, skv, h, kvh, d, causal, window, softcap, q_offset = case
            q, k, v = randn(b, sq, h, d, dtype=dtype), randn(b, skv, kvh, d, dtype=dtype), \
                randn(b, skv, kvh, d, dtype=dtype)
            kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
            want = ref.attention_ref(q, k, v, **kw)
            check(f"flash_attention {case}", flash_mod.flash_attention(q, k, v, **kw), want, dtype)
        for case in decode_cases:
            b, s, h, kvh, d, softcap = case
            q, k, v = randn(b, h, d, dtype=dtype), randn(b, s, kvh, d, dtype=dtype), \
                randn(b, s, kvh, d, dtype=dtype)
            lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
            want = ref.decode_attention_ref(q, k, v, lens, softcap=softcap)
            check(f"decode_attention {case}",
                  dec_mod.decode_attention(q, k, v, lens, softcap=softcap), want, dtype)
        for case in decode_length_cases:
            b, s, h, kvh, d, softcap, lengths = case
            q, k, v = randn(b, h, d, dtype=dtype), randn(b, s, kvh, d, dtype=dtype), \
                randn(b, s, kvh, d, dtype=dtype)
            lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
            # length 0 gives zeros, as the Pallas kernel and the split algorithm
            # do; decode_attention_ref averages V there, so it holds the rest
            rows = lens > 0
            out = dec_mod.decode_attention(q, k, v, lens, softcap=softcap)
            check(f"decode_attention {case}", out, ref.decode_attention_split_ref(
                q, k, v, lens, split=dec_mod.SPLIT, softcap=softcap), dtype)
            check(f"decode_attention {case} rows of length > 0", out[rows],
                  ref.decode_attention_ref(q, k, v, lens, softcap=softcap)[rows], dtype)
    phase("kernels-cases", flash=len(FLASH_CASES) * 2, decode=len(DECODE_CASES) * 2,
          decode_lengths=len(DECODE_LENGTH_CASES) * 2,
          d16_fp32=len(FLASH_CASES_D16 + DECODE_CASES_D16 + DECODE_LENGTH_CASES_D16),
          d256=len(FLASH_CASES_D256 + DECODE_CASES_D256 + DECODE_LENGTH_CASES_D256) * 2,
          whisper=len(FLASH_CASES_WHISPER) * 2,
          tol_fp32=TOL[torch.float32],
          tol_bf16=TOL[torch.bfloat16], result="within")

    cfg = get_config(ARCH)
    h, kvh, d, bf16 = cfg.num_heads, cfg.num_kv_heads, cfg.hd(), torch.bfloat16
    F = torch.nn.functional
    records = {}
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    # prefill at the serving shape
    q, k, v = (randn(BATCH, PROMPT, n, d, dtype=bf16) for n in (h, kvh, kvh))
    out = flash_mod.flash_attention(q, k, v, causal=True)
    err = max_err(out, ref.attention_ref(q, k, v, causal=True))
    if not err < TOL[bf16]:
        fail(f"flash_attention at the serving shape: max err {err}")
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    flops = 4 * BATCH * h * d * attn_pairs(PROMPT, PROMPT, True, 0, 0)
    bound_ms, bound_by = bound(nbytes, flops)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kernel = lambda: flash_mod.flash_attention(q, k, v, causal=True)
    library = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    records["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:120",
        max_abs_err=err,
        ms=time_ms(kernel),
        plain_ms=time_ms(lambda: ref.attention_ref(q, k, v, causal=True)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(library),
    )
    phase("kernel", shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 causal",
          bytes=nbytes, flops=flops, **records["flash_attention"],
          ms_cold_l2=time_ms(kernel, flush=flush), library_ms_cold_l2=time_ms(library, flush=flush),
          library_kernels=library_kernels(library))

    # where the flash kernel stands against the library call beyond the
    # serving shape: 1, 2 and 4 KV tiles a block without a mask, and a long
    # causal prompt
    def flash_against_library(sq, skv, causal):
        q, k, v = (randn(BATCH, rows, n, d, dtype=bf16)
                   for rows, n in ((sq, h), (skv, kvh), (skv, kvh)))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return dict(shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 causal={causal}",
                    ms=time_ms(lambda: flash_mod.flash_attention(q, k, v, causal=causal)),
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True)))

    for sq, skv, causal in FLASH_SWEEP:
        phase("flash-sweep", **flash_against_library(sq, skv, causal))

    # decode at the serving shape: cache 1024, lengths as the serving run's
    # decode steps see them (prompt + 1 .. prompt + MAX_NEW - 1), ragged
    q = randn(BATCH, h, d, dtype=bf16)
    kc, vc = randn(BATCH, CACHE, kvh, d, dtype=bf16), randn(BATCH, CACHE, kvh, d, dtype=bf16)
    lens = torch.randint(PROMPT + 1, PROMPT + MAX_NEW, (BATCH,), generator=gen, device=dev,
                         dtype=torch.int32)
    out = dec_mod.decode_attention(q, kc, vc, lens)
    err = max_err(out, ref.decode_attention_ref(q, kc, vc, lens))
    if not err < TOL[bf16]:
        fail(f"decode_attention at the serving shape: max err {err}")
    valid = int(lens.sum())
    nbytes = 2 * (q.numel() + out.numel()) + 2 * 2 * valid * kvh * d + 4 * BATCH
    flops = 4 * h * d * valid
    bound_ms, bound_by = bound(nbytes, flops)
    mask = (torch.arange(CACHE, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    kernel = lambda: dec_mod.decode_attention(q, kc, vc, lens)
    library = lambda: F.scaled_dot_product_attention(
        q4, kt, vt, attn_mask=mask, enable_gqa=True)
    records["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:99",
        max_abs_err=err,
        ms=time_ms(kernel, iters=100),
        plain_ms=time_ms(lambda: ref.decode_attention_ref(q, kc, vc, lens), iters=100),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(library, iters=100),
    )
    phase("kernel", shape=f"q{tuple(q.shape)} cache{tuple(kc.shape)} lengths "
          f"{lens.tolist()} bf16", bytes=nbytes, flops=flops, **records["decode_attention"],
          split=dec_mod.SPLIT, ms_cold_l2=time_ms(kernel, iters=100, flush=flush),
          library_ms_cold_l2=time_ms(library, iters=100, flush=flush))
    kernels_at_d256(randn, records, flush)
    del flush
    kernels_at_new_shapes(randn, records)
    records["rope"] = dict(name="rope", route="cuda",
                           source="src/repro_torch/kernels/csrc/rope.cu",
                           replaces="none (jnp in src/repro/models/layers.py apply_rope)",
                           launches_by_path={})
    rope_rows(randn, records)
    kernel_bwd_phase(randn, records)
    mesh_shards_phase(randn)

    # -- 4. serving: the main path ----------------------------------------
    t0 = time.perf_counter()
    srv = ModelServer(cfg, batch_size=BATCH, cache_len=CACHE, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(srv.params))
    phase("serve-init", params=n_params, seconds=f"{time.perf_counter() - t0:.2f}")
    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(1, cfg.vocab_size, PROMPT).astype(np.int32))
               for _ in range(BATCH)]
    reqs = [Request(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    srv.generate([Request(0, prompts[0], 2)])  # warm-up: library handles, allocator
    srv.stats = {"requests": 0, "tokens": 0, "decode_s": 0.0, "prefill_s": 0.0}
    torch.cuda.reset_peak_memory_stats()
    flash_mod.KERNEL.launches = dec_mod.KERNEL.launches = rope_mod.KERNEL.launches = 0
    outs = srv.generate(reqs)
    launches = {"flash_attention": flash_mod.KERNEL.launches,
                "decode_attention": dec_mod.KERNEL.launches, "rope": rope_mod.KERNEL.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = serve_launches(cfg, MAX_NEW)
    if launches != want:
        fail(f"serving launches {launches}, expected {want}")
    for uid, toks in outs.items():
        if len(toks) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {uid}: tokens {toks}")
    for name, n in launches.items():
        records[name]["launches"] = n
        records[name]["launches_by_path"] = {f"serve {ARCH}": n}
    phase("serve", requests=len(outs), prompt=PROMPT, new=MAX_NEW,
          prefill_ms=f"{srv.stats['prefill_s'] * 1e3:.2f}",
          decode_tok_s=f"{srv.tokens_per_second():.1f}",
          decode_ms_per_step=f"{srv.stats['decode_s'] * 1e3 / (MAX_NEW - 1):.2f}",
          peak_gib=f"{peak_gib:.2f}", launches=launches, first_tokens=outs[0][:8])

    # first-step logits of the kernel path against impl="ref": in fp32 the two
    # must agree to summation order; in bf16 the kernel path must be no
    # further from the fp32 logits than twice the plain bf16 path is
    batch = srv._batchify(reqs)
    token = torch.from_numpy(rng.integers(1, cfg.vocab_size, (BATCH, 1)).astype(np.int32)).to(dev)
    hold_logits("serve-logits", srv.params, cfg, batch, token, CACHE)

    # where the time of one prefill and one decode step goes on the card
    for step, fn in profile_steps(srv, batch, token).items():
        phase("serve-profile", step=step, **fn)
    del srv

    # -- 5. fleet: the control plane's split over two data centers ---------
    ar = np.array([[3.0, 1.0]], dtype=np.float32)  # arrival rates, 1 task type x 2 DCs
    fleet = Fleet([ARCH], 2, smoke=False, batch_size=BATCH, cache_len=CACHE)
    flash_mod.KERNEL.launches = dec_mod.KERNEL.launches = 0
    report = fleet.route(ar, requests_per_unit=4)
    fleet_launches = (flash_mod.KERNEL.launches, dec_mod.KERNEL.launches)
    if report["dispatched"] != {(0, 0): 6, (0, 1): 2}:
        fail(f"fleet dispatched {report['dispatched']} for ar {ar.tolist()}")
    if fleet_launches != (2 * cfg.num_layers, 2 * cfg.num_layers * 3):
        fail(f"fleet launches {fleet_launches}")
    phase("fleet", ar=ar.tolist(), dispatched={str(k): n for k, n in report["dispatched"].items()},
          total=report["total"], launches=fleet_launches,
          tok_s={str(k): f"{v:.1f}" for k, v in report["per_server_tps"].items()})
    del fleet
    fleet_smoke_phase(dev)
    fleet_smoke_phase(dev, "whisper-base")

    # -- 5b. the MoE, hybrid and larger dense archs, and the paper's fleet --
    serve_arch_phase(dev, records)
    serve_fleet_phase(dev, records)

    # -- 5c. training: llama3.2-1b at full width, every arch at smoke width --
    train_phases(dev, records)

    # -- 6. the scheduler path: fleet env, game, simulator ----------------
    sched_phases(dev)

    # -- 7. the port's static analysis and its runtime checks --------------
    lint_phase(dev)

    phase("done", seconds=f"{time.perf_counter() - T_START:.1f}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "launches_by_path", "d256", "rows")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def moe_routes(fn):
    """(fn(), the experts every MoE layer it runs selects, each (T, k) sorted)."""
    seen = []
    route = moe_mod._route

    def recording(p, cfg, x2d):
        out = route(p, cfg, x2d)
        seen.append(torch.sort(out[1], dim=-1).values)
        return out

    moe_mod._route = recording
    try:
        return fn(), seen
    finally:
        moe_mod._route = route


def hold_logits(tag: str, params, cfg, batch, token, cache_len: int, in_place: bool = False,
                **fields) -> None:
    """First-step logits of the kernel path against impl="ref": in fp32 the two
    must agree to summation order; in bf16 the kernel path must be no further
    from the fp32 logits than twice the plain bf16 path is. For an MoE, the
    share of (token, choice) routes the two bf16 paths agree on. With
    ``in_place`` the fp32 copy replaces ``params`` leaf by leaf (the caller
    holds no other reference to them), where both would not fit at once."""
    b = batch["tokens"].shape[0]
    runs, routes = {}, {}
    for impl in ("auto", "ref"):
        runs["bf16", impl], routes[impl] = moe_routes(
            lambda: first_logits(params, cfg, batch, token, impl, cache_len))
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    if in_place:
        fp32_in_place(params)
        torch.cuda.empty_cache()
        params32 = params
    else:
        params32 = tree_map(lambda t: t.float(), params)
    runs.update({("fp32", impl): first_logits(params32, cfg32, batch, token, impl, cache_len)
                 for impl in ("auto", "ref")})
    del params32
    if routes["auto"]:
        got, want = (torch.cat([r.reshape(-1) for r in routes[i]]) for i in ("auto", "ref"))
        fields["moe_routes"] = got.numel()
        fields["moe_route_agree_bf16"] = f"{float((got == want).float().mean()):.5f}"
    for step in ("prefill", "decode"):
        for key, out in runs.items():
            if tuple(out[step].shape) != (b, 1, cfg.vocab_size):
                fail(f"{tag} {step} logits {key} of shape {tuple(out[step].shape)}")
            if not torch.isfinite(out[step]).all():
                fail(f"{tag} {step} logits {key} not finite")
        truth = runs["fp32", "ref"][step]
        fp32 = rel_norm(runs["fp32", "auto"][step], truth)
        fp32_abs = max_err(runs["fp32", "auto"][step], truth)
        kern, plain = (rel_norm(runs["bf16", impl][step], truth) for impl in ("auto", "ref"))
        direct = rel_norm(runs["bf16", "auto"][step], runs["bf16", "ref"][step])
        if not (fp32 <= FP32_LOGIT_RTOL and fp32_abs <= FP32_LOGIT_ATOL):
            fail(f"{tag} {step} fp32 logits: kernel vs ref relative norm {fp32}, "
                 f"max |diff| {fp32_abs}")
        if not kern <= BF16_LOGIT_FACTOR * plain:
            fail(f"{tag} {step} bf16 logits: kernel path {kern} from the fp32 logits, "
                 f"plain path {plain}")
        agree = float((runs["bf16", "auto"][step].argmax(-1)
                       == runs["bf16", "ref"][step].argmax(-1)).float().mean())
        phase(tag, **fields, step=step, fp32_rel_norm=f"{fp32:.3g}",
              fp32_max_abs=f"{fp32_abs:.3g}", bf16_kernel_vs_fp32=f"{kern:.4g}",
              bf16_plain_vs_fp32=f"{plain:.4g}", bf16_kernel_vs_plain=f"{direct:.4g}",
              bf16_argmax_agree=agree, logit_absmax=f"{float(truth.abs().max()):.3g}")


def kernels_at_d256(randn, records: dict, flush: torch.Tensor) -> None:
    """Both kernels at recurrentgemma-9b's serving shapes (head dim 256, MQA):
    prefill over a 2304-token prompt under its 2048-token window, and decode
    over the full 2048-slot ring. Times warm and L2-flushed, against the
    bound, the plain version and the library call (the kv head expanded)."""
    F = torch.nn.functional
    cfg = get_config("recurrentgemma-9b")
    h, kvh, d, window, bf16 = cfg.num_heads, cfg.num_kv_heads, cfg.hd(), cfg.attn_window, \
        torch.bfloat16
    s = serve_case(cfg.name).prompt
    q, k, v = (randn(BATCH, s, n, d, dtype=bf16) for n in (h, kvh, kvh))
    kw = dict(causal=True, window=window)
    kernel = lambda: flash_mod.flash_attention(q, k, v, **kw)
    out = kernel()
    err = max_err(out, ref.attention_ref(q, k, v, **kw))
    if not err < TOL[bf16]:
        fail(f"flash_attention at recurrentgemma's shape: max err {err}")
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    flops = 4 * BATCH * h * d * attn_pairs(s, s, True, window, 0)
    bound_ms, bound_by = bound(nbytes, flops)
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).expand(BATCH, h, s, d).contiguous() for t in (k, v))
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    rec = dict(shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 causal window {window}",
               max_abs_err=err, ms=time_ms(kernel),
               plain_ms=time_ms(lambda: ref.attention_ref(q, k, v, **kw), iters=5),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(library),
               ms_cold_l2=time_ms(kernel, flush=flush),
               library_ms_cold_l2=time_ms(library, flush=flush))
    records["flash_attention"]["d256"] = rec
    phase("kernel", head_dim=d, bytes=nbytes, flops=flops, **rec,
          library_kernels=library_kernels(library))
    del q, k, v, out, kt, vt, qt, mask

    cache = min(serve_case(cfg.name).cache, window)
    q = randn(BATCH, h, d, dtype=bf16)
    kc, vc = randn(BATCH, cache, kvh, d, dtype=bf16), randn(BATCH, cache, kvh, d, dtype=bf16)
    lens = torch.full((BATCH,), cache, dtype=torch.int32, device=q.device)
    kernel = lambda: dec_mod.decode_attention(q, kc, vc, lens)
    out = kernel()
    err = max_err(out, ref.decode_attention_ref(q, kc, vc, lens))
    if not err < TOL[bf16]:
        fail(f"decode_attention at recurrentgemma's shape: max err {err}")
    valid = int(lens.sum())
    nbytes = 2 * (q.numel() + out.numel()) + 2 * 2 * valid * kvh * d + 4 * BATCH
    bound_ms, bound_by = bound(nbytes, 4 * h * d * valid)
    kmask = (torch.arange(cache, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    library = lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=kmask,
                                                     enable_gqa=True)
    rec = dict(shape=f"q{tuple(q.shape)} cache{tuple(kc.shape)} lengths {cache} bf16",
               max_abs_err=err, ms=time_ms(kernel, iters=100),
               plain_ms=time_ms(lambda: ref.decode_attention_ref(q, kc, vc, lens), iters=100),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(library, iters=100),
               ms_cold_l2=time_ms(kernel, iters=100, flush=flush),
               library_ms_cold_l2=time_ms(library, iters=100, flush=flush))
    records["decode_attention"]["d256"] = rec
    phase("kernel", head_dim=d, bytes=nbytes, flops=4 * h * d * valid, **rec,
          library_kernels=library_kernels(library))


def shape_rows() -> tuple:
    """(flash rows, decode rows) at the serving shapes of whisper-base,
    qwen2-vl-72b and arctic-480b, from their configs and SERVE_ARCHS, each
    with its launches in one ``generate`` of [serve-arch] (at the depth it
    serves). Flash: (arch, what, b, sq, skv, h, kvh, d, causal, launches).
    Decode: (arch, what, b, cache, h, kvh, d, (lowest, highest) length, launches)."""
    flash, decode = [], []
    for arch in ("whisper-base", "qwen2-vl-72b", "arctic-480b"):
        case = serve_case(arch)
        cfg = get_config(arch)
        n, steps = case.layers or cfg.num_layers, case.new - 1
        b, h, kvh, d = case.batch, cfg.num_heads, cfg.num_kv_heads, cfg.hd()
        if cfg.is_encoder_decoder:
            se, p = cfg.encoder_seq, case.prompt
            flash += [(arch, "encoder", b, se, se, h, kvh, d, False, cfg.num_encoder_layers),
                      (arch, "prefill self", b, p, p, h, kvh, d, True, n),
                      (arch, "prefill cross", b, p, se, h, kvh, d, False, n),
                      (arch, "decode cross", b, 1, se, h, kvh, d, False, n * steps)]
            # the self caches start empty (ROADMAP C.6): lengths 1 .. new - 1
            decode.append((arch, "decode self", b, case.cache, h, kvh, d, (1, steps), n * steps))
        else:
            flash.append((arch, "prefill", b, case.prompt, case.prompt, h, kvh, d, True, n))
            decode.append((arch, "decode", b, case.cache, h, kvh, d,
                           (case.prompt + 1, case.prompt + steps), n * steps))
    return flash, decode


def kernels_at_new_shapes(randn, records: dict) -> None:
    """Both kernels at each row of ``shape_rows``: the error against the plain
    version, kernel, plain and library times (scaled_dot_product_attention
    with enable_gqa), the bound, and the launches a generate makes there."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    flash_rows, decode_rows = shape_rows()
    for arch, what, b, sq, skv, h, kvh, d, causal, launches in flash_rows:
        q, k, v = randn(b, sq, h, d, dtype=bf16), randn(b, skv, kvh, d, dtype=bf16), \
            randn(b, skv, kvh, d, dtype=bf16)
        kernel = lambda: flash_mod.flash_attention(q, k, v, causal=causal)
        out = kernel()
        err = max_err(out, ref.attention_ref(q, k, v, causal=causal))
        if not err < TOL[bf16]:
            fail(f"flash_attention at {arch} {what}: max err {err}")
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
        flops = 4 * b * h * d * attn_pairs(sq, skv, causal, 0, 0)
        bound_ms, bound_by = bound(nbytes, flops)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rec = dict(arch=arch, what=what, shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 "
                   f"causal={causal}", max_abs_err=err, ms=time_ms(kernel),
                   plain_ms=time_ms(lambda: ref.attention_ref(q, k, v, causal=causal), iters=5),
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=causal, enable_gqa=True)),
                   launches_per_generate=launches)
        records["flash_attention"].setdefault("rows", []).append(rec)
        phase("kernel", name="flash_attention", bytes=nbytes, flops=flops, **rec)
        del q, k, v, out, qt, kt, vt
    for arch, what, b, cache, h, kvh, d, (lo, hi), launches in decode_rows:
        q = randn(b, h, d, dtype=bf16)
        kc, vc = randn(b, cache, kvh, d, dtype=bf16), randn(b, cache, kvh, d, dtype=bf16)
        gen = torch.Generator(device=q.device).manual_seed(1)
        lens = torch.randint(lo, hi + 1, (b,), generator=gen, device=q.device,
                             dtype=torch.int32)
        kernel = lambda: dec_mod.decode_attention(q, kc, vc, lens)
        out = kernel()
        err = max_err(out, ref.decode_attention_ref(q, kc, vc, lens))
        if not err < TOL[bf16]:
            fail(f"decode_attention at {arch} {what}: max err {err}")
        valid = int(lens.sum())
        nbytes = 2 * (q.numel() + out.numel()) + 2 * 2 * valid * kvh * d + 4 * b
        flops = 4 * h * d * valid
        bound_ms, bound_by = bound(nbytes, flops)
        mask = (torch.arange(cache, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
        q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        rec = dict(arch=arch, what=what, shape=f"q{tuple(q.shape)} cache{tuple(kc.shape)} "
                   f"lengths {lo}..{hi} bf16", max_abs_err=err, ms=time_ms(kernel, iters=100),
                   plain_ms=time_ms(lambda: ref.decode_attention_ref(q, kc, vc, lens), iters=20),
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       q4, kt, vt, attn_mask=mask, enable_gqa=True), iters=100),
                   launches_per_generate=launches)
        records["decode_attention"].setdefault("rows", []).append(rec)
        phase("kernel", name="decode_attention", bytes=nbytes, flops=flops, **rec)
        del q, kc, vc, out, kt, vt, q4


def attn_layers(cfg) -> int:
    return cfg.pattern().count(ATTN)


def serve_case(arch: str) -> ServeCase:
    return next(c for c in SERVE_ARCHS if c.arch == arch)


def serve_launches(cfg, new: int) -> dict:
    """Launches of each kernel in one ``generate`` of ``new`` tokens. A
    decoder: one flash launch per attention layer at prefill, one decode
    launch per attention layer and step. An encoder-decoder: the encoder's
    layers and the decoder's self and cross attention at prefill, then a
    decode launch (self) and a one-row flash launch (cross) per decoder layer
    and step. RoPE (``rope_mode`` "rope" only): one launch per attention
    layer at prefill and at each step."""
    steps = new - 1
    if cfg.is_encoder_decoder:
        return {"flash_attention": cfg.num_encoder_layers + 2 * cfg.num_layers
                + cfg.num_layers * steps, "decode_attention": cfg.num_layers * steps, "rope": 0}
    n_attn = attn_layers(cfg)
    return {"flash_attention": n_attn, "decode_attention": n_attn * steps,
            "rope": n_attn * new if cfg.rope_mode == "rope" else 0}


def logit_batch(cfg, batch, prompt: int, rng) -> dict:
    """The served batch cut to ``prompt`` tokens, with what serving leaves out:
    random frames for the encoder-decoder; for the vlm, random patch
    embeddings over the VISION_GRID x VISION_GRID grid that leads the prompt
    and distinct M-RoPE streams (patch i at (0, i // grid, i % grid), the text
    after it at grid + j on all three)."""
    dev = batch["tokens"].device
    b = batch["tokens"].shape[0]
    out = {"tokens": batch["tokens"][:, :prompt]}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(dev)
    if cfg.frontend == "vision_stub":
        n = VISION_GRID ** 2
        out["vision_embeds"] = torch.from_numpy(
            rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)).to(dev)
        i = torch.arange(n, device=dev)
        patches = torch.stack([torch.zeros_like(i), i // VISION_GRID, i % VISION_GRID], -1)
        text = (VISION_GRID + torch.arange(prompt - n, device=dev))[:, None].expand(-1, 3)
        out["positions"] = torch.cat([patches, text]).to(torch.int32)[None].expand(b, -1, -1)
    return out


def serve_arch_phase(dev: torch.device, records: dict) -> None:
    """Each of SERVE_ARCHS at full width through ``ModelServer.generate``, one
    server at a time: launches held exactly (``serve_launches``), the tokens
    sane, the MoE's, the hybrids' and the encoder-decoder's prefill and decode
    step profiled, then the first-step logits held as [serve-logits] holds
    them, on the inputs ``logit_batch`` adds."""
    for case in SERVE_ARCHS:
        cfg = get_config(case.arch)
        if case.layers:
            cfg = dataclasses.replace(cfg, num_layers=case.layers)
        t0 = time.perf_counter()
        srv = ModelServer(cfg, batch_size=case.batch, cache_len=case.cache, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        prompts = [torch.from_numpy(rng.integers(1, cfg.vocab_size, case.prompt).astype(np.int32))
                   for _ in range(case.batch)]
        reqs = [Request(i, p, case.new) for i, p in enumerate(prompts)]
        srv.generate([Request(0, prompts[0], 2)])  # warm-up
        srv.stats = {"requests": 0, "tokens": 0, "decode_s": 0.0, "prefill_s": 0.0}
        torch.cuda.reset_peak_memory_stats()
        flash_mod.KERNEL.launches = dec_mod.KERNEL.launches = rope_mod.KERNEL.launches = 0
        outs = srv.generate(reqs)
        launches = {"flash_attention": flash_mod.KERNEL.launches,
                    "decode_attention": dec_mod.KERNEL.launches, "rope": rope_mod.KERNEL.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        want = serve_launches(cfg, case.new)
        if launches != want:
            fail(f"serve-arch {case.arch}: launches {launches}, expected {want}")
        for uid, toks in outs.items():
            if len(toks) != case.new or not all(0 <= t < cfg.vocab_size for t in toks):
                fail(f"serve-arch {case.arch} request {uid}: tokens {toks}")
        for name, n in launches.items():
            records[name]["launches_by_path"][f"serve-arch {case.arch}"] = n
        window = min(case.cache, cfg.attn_window) if cfg.attn_window else case.cache
        full_depth = get_config(case.arch).num_layers
        phase("serve-arch", arch=case.arch,
              layers=cfg.num_layers if not case.layers else
              f"{cfg.num_layers}_of_{full_depth}_(depth_cut:_one_80_GB_card)",
              encoder_layers=cfg.num_encoder_layers, attn_layers=attn_layers(cfg),
              head_dim=cfg.hd(), heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
              params=sum(t.numel() for t in tree_leaves(srv.params)), init_s=f"{init_s:.2f}",
              batch=case.batch, prompt=case.prompt, new=case.new, cache=case.cache,
              attn_cache_slots=window, ring_roll=case.prompt >= window,
              prefill_ms=f"{srv.stats['prefill_s'] * 1e3:.2f}",
              decode_ms_per_step=f"{srv.stats['decode_s'] * 1e3 / (case.new - 1):.2f}",
              decode_tok_s=f"{srv.tokens_per_second():.1f}", peak_gib=f"{peak_gib:.2f}",
              launches=launches, first_tokens=outs[0][:8])
        batch = srv._batchify(reqs)
        token = torch.from_numpy(
            rng.integers(1, cfg.vocab_size, (case.batch, 1)).astype(np.int32)).to(dev)
        if cfg.num_experts or cfg.block_pattern or cfg.is_encoder_decoder:
            for step, fn in profile_steps(srv, batch, token).items():
                phase("serve-profile", arch=case.arch, step=step, **fn)
        batch = logit_batch(cfg, batch, case.logit_prompt or case.prompt, rng)
        lcfg, fields = cfg, {"arch": case.arch}
        params = srv.params
        if case.logit_layers:
            lcfg = dataclasses.replace(cfg, num_layers=case.logit_layers)
            params = {**srv.params, "stack": {"layers": srv.params["stack"]["layers"][
                :case.logit_layers]}}
            fields["layers"] = (f"{case.logit_layers}_of_{full_depth}_(depth_cut:_an_fp32_"
                                "copy_of_the_served_layers_outgrows_one_80_GB_card)")
        if case.logit_prompt:
            fields["prompt"] = f"{case.logit_prompt}_of_{case.prompt}"
        del srv  # its other layers go; the fp32 copy replaces the rest leaf by leaf
        torch.cuda.empty_cache()
        hold_logits("serve-arch-logits", params, lcfg, batch, token, case.cache,
                    in_place=True, **fields)
        del params, batch
        torch.cuda.empty_cache()


def serve_fleet_phase(dev: torch.device, records: dict | None = None) -> None:
    """The reference's examples/serve_fleet.py on the card: GT-DRL's split of
    the hour over build_env(4), dispatched to FLEET_ARCHS x 2 DCs (smoke
    widths; recurrentgemma's window of 8 is shorter than the 12-token
    prompts, so its ring rolls); launches held exactly, and the first-step
    logits of every server of the fleet, dispatched or not, held against
    impl="ref" at the fp32 tolerance.

    The same solve (same generators) also runs on the host CPU, and the two
    plans' hour costs, both priced on the CPU, are held at GTDRL_COST_RTOL.
    The split is reported, not held: at hour 14 the game sends all of each
    task type to DC 2, and DCs 0 and 1, the example's split, keep only the
    softmax's tail (~1e-11 of a row), far below what the cost resolves in
    float32, so its shares, and the dispatch rounded from them, differ
    between two devices (PERF.md §6, PR 17)."""
    cpu = torch.device("cpu")
    cfg = gt_drl.GTDRLConfig(rounds=2, pretrain_iters=0)
    ctx, frac, gtdrl_ms = {}, {}, {}
    for d in (dev, cpu):
        ctx[d] = game.GameContext(env=sched_env.build_env(4, seed=0, device=d), tau=14,
                                  objective="cost")
        t0 = time.perf_counter()
        agents = gt_drl.init_agents(generator(0), ctx[d].env, cfg)
        _, res = gt_drl.solve_epoch(generator(1), agents, ctx[d], torch.zeros(4, device=d), cfg)
        frac[d] = res.fractions
        sync(d)
        gtdrl_ms[d] = (time.perf_counter() - t0) * 1e3
    split = game.fractions_to_ar(ctx[dev], frac[dev])[:len(FLEET_ARCHS), :2].cpu().numpy()
    cpu_split = game.fractions_to_ar(ctx[cpu], frac[cpu])[:len(FLEET_ARCHS), :2].numpy()
    cost = {d: float(game.cloud_objective(ctx[cpu], frac[d].cpu(), torch.zeros(4)))
            for d in (dev, cpu)}
    cost_rel = abs(cost[dev] / cost[cpu] - 1)
    if not (np.isfinite(split).all() and split.sum() > 0 and cost_rel <= GTDRL_COST_RTOL):
        fail(f"serve-fleet: GT-DRL split {split.tolist()}, hour cost card {cost[dev]} "
             f"against CPU {cost[cpu]}")
    fleet = Fleet(FLEET_ARCHS, 2, smoke=True, batch_size=4, cache_len=64)
    flash_mod.KERNEL.launches = dec_mod.KERNEL.launches = 0
    report = fleet.route(split, requests_per_unit=2, prompt_len=12, max_new=4)
    launches = {"flash_attention": flash_mod.KERNEL.launches,
                "decode_attention": dec_mod.KERNEL.launches}
    n_attn = sum(attn_layers(fleet.servers[key].cfg) for key in report["dispatched"])
    want = {"flash_attention": n_attn, "decode_attention": n_attn * 3}
    if report["total"] == 0 or launches != want:
        fail(f"serve-fleet dispatched {report['dispatched']}: launches {launches}, "
             f"expected {want}")
    if records is not None:
        for name, n in launches.items():
            records[name]["launches_by_path"]["serve-fleet"] = n
    rng = np.random.default_rng(2)
    worst = {"prefill": 0.0, "decode": 0.0}
    for key, srv in fleet.servers.items():  # the dispatched ones and the rest
        batch = {"tokens": torch.from_numpy(
            rng.integers(1, srv.cfg.vocab_size, (srv.batch_size, 12)).astype(np.int32)).to(dev)}
        token = torch.from_numpy(
            rng.integers(1, srv.cfg.vocab_size, (srv.batch_size, 1)).astype(np.int32)).to(dev)
        out = {impl: first_logits(srv.params, srv.cfg, batch, token, impl, srv.cache_len)
               for impl in ("auto", "ref")}
        for step in worst:
            got, want_ = out["auto"][step], out["ref"][step]
            rel, err = rel_norm(got, want_), max_err(got, want_)
            if not (torch.isfinite(got).all() and rel <= FP32_LOGIT_RTOL
                    and err <= FP32_LOGIT_ATOL):
                fail(f"serve-fleet {key} {step} logits: kernel vs ref relative norm {rel}, "
                     f"max |diff| {err}")
            worst[step] = max(worst[step], rel)
    phase("serve-fleet", archs=",".join(FLEET_ARCHS), num_dcs=2,
          gtdrl_split=[[f"{x:.4g}" for x in row] for row in split],
          cpu_split=[[f"{x:.4g}" for x in row] for row in cpu_split],
          split_fraction_of_rows=f"{float(frac[dev][:, :2].sum(-1).max()):.3g}",
          fractions_max_abs_diff=f"{float((frac[dev].cpu() - frac[cpu]).abs().max()):.3g}",
          hour_cost_card=cost[dev], hour_cost_cpu=cost[cpu], hour_cost_rel_diff=f"{cost_rel:.3g}",
          gtdrl_ms=f"{gtdrl_ms[dev]:.1f}", gtdrl_cpu_ms=f"{gtdrl_ms[cpu]:.1f}",
          dispatched={f"{FLEET_ARCHS[i]}@dc{d}": n for (i, d), n in report["dispatched"].items()},
          total=report["total"], launches=launches,
          tok_s={f"{FLEET_ARCHS[i]}@dc{d}": f"{v:.1f}"
                 for (i, d), v in report["per_server_tps"].items()},
          servers_held=len(fleet.servers), prefill_rel_norm_max=f"{worst['prefill']:.3g}",
          decode_rel_norm_max=f"{worst['decode']:.3g}",
          tol=f"rel norm {FP32_LOGIT_RTOL}, abs {FP32_LOGIT_ATOL}; hour cost "
          f"{GTDRL_COST_RTOL}")


def fleet_smoke_phase(dev: torch.device, arch: str = ARCH) -> None:
    """``Fleet([arch], 2)`` at its defaults (cfg.smoke(): head dim 16, fp32)
    on the card: routed through both kernels, then one server's prefill and
    first decode logits held against ``impl="ref"`` at the fp32 tolerance
    (an encoder-decoder's on random frames)."""
    ar = np.array([[3.0, 1.0]], dtype=np.float32)
    fleet = Fleet([arch], 2)
    srv = fleet.servers[(0, 0)]
    cfg = srv.cfg
    flash_mod.KERNEL.launches = dec_mod.KERNEL.launches = rope_mod.KERNEL.launches = 0
    report = fleet.route(ar, requests_per_unit=2, prompt_len=16, max_new=4)
    launches = (flash_mod.KERNEL.launches, dec_mod.KERNEL.launches, rope_mod.KERNEL.launches)
    if report["dispatched"] != {(0, 0): 3, (0, 1): 1}:
        fail(f"fleet-smoke dispatched {report['dispatched']} for ar {ar.tolist()}")
    want = serve_launches(cfg, 4)
    if launches != (2 * want["flash_attention"], 2 * want["decode_attention"],
                    2 * want["rope"]):
        fail(f"fleet-smoke {arch} launches {launches}")
    rng = np.random.default_rng(1)
    batch = logit_batch(cfg, {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (srv.batch_size, 16)).astype(np.int32)).to(dev)}, 16, rng)
    token = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (srv.batch_size, 1)).astype(np.int32)).to(dev)
    out = {impl: first_logits(srv.params, cfg, batch, token, impl, srv.cache_len)
           for impl in ("auto", "ref")}
    fields = {}
    for step in ("prefill", "decode"):
        got, want_ = out["auto"][step], out["ref"][step]
        rel, err = rel_norm(got, want_), max_err(got, want_)
        if not (torch.isfinite(got).all() and rel <= FP32_LOGIT_RTOL
                and err <= FP32_LOGIT_ATOL):
            fail(f"fleet-smoke {arch} {step} logits: kernel vs ref relative norm {rel}, "
                 f"max |diff| {err}")
        fields[f"{step}_rel_norm"] = f"{rel:.3g}"
        fields[f"{step}_max_abs"] = f"{err:.3g}"
    phase("fleet-smoke", arch=cfg.name, head_dim=cfg.hd(), dtype=cfg.dtype,
          layers=cfg.num_layers, dispatched={str(k): n for k, n in report["dispatched"].items()},
          launches=launches, tol=f"rel norm {FP32_LOGIT_RTOL}, abs {FP32_LOGIT_ATOL}", **fields)


def priced_env(num_dcs: int, device, seed: int = 0) -> sched_env.EnvParams:
    """The paper's fleet of ``num_dcs`` DCs with the WAN visible (the RTT
    matrix of its cities) and SLA misses priced."""
    env = sched_env.build_env(num_dcs, seed=seed, device=device)
    rtt = torch.from_numpy(latency.rtt_matrix(num_dcs=num_dcs).astype(np.float32))
    return env._replace(rtt=rtt.to(env.rtt.device),
                        sla_price=torch.full_like(env.sla_price, SLA_PRICE))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sched_spec(case) -> ExperimentSpec:
    technique, _, routed, hours = case
    return ExperimentSpec(technique=technique, objective="cost_sla", routed=routed, hours=hours)


def traced_day(spec: ExperimentSpec, env) -> tuple:
    """(result, ms, infos): the spec's day on the loop engine, from the same
    initial state and generators as ``run(spec, env)``, keeping each hour's
    [diverged rounds, adopted value, the uniform split's value] on the device
    until the day has ended. ms counts the initial state (gt-drl's
    pretraining) too."""
    sync(env.er.device)
    t0 = time.perf_counter()
    _, state0 = experiment._day_inputs(env, spec.technique, spec.objective, spec.seed,
                                       spec.pretrain, spec.cfg, None, spec.routed)
    sched = StatefulScheduler(spec.technique, state0, spec.cfg)
    infos = []

    def solve(gen, ctx, peak):
        res = sched.solve_epoch(gen, ctx, peak)
        uniform = game.cloud_objective(ctx, game.uniform_fractions(ctx), peak)
        diverged = res.info.get("diverged_rounds", torch.zeros((), device=uniform.device))
        infos.append(torch.stack([diverged.to(uniform.dtype), res.info["best"], uniform]))
        return res

    result = run(spec.replace(engine="loop"), env, solver=solve)
    ms = (time.perf_counter() - t0) * 1e3
    return result, ms, torch.stack(infos).cpu().tolist()


def cpu_reference(path: Path) -> int:
    """The scheduler cases on the host CPU, written to ``path`` as JSON. Run
    in a process of its own (``--cpu-reference``) beside the card's runs."""
    torch.set_num_threads(2)
    out = {}
    for case in SCHED_CASES:
        result, ms, infos = traced_day(sched_spec(case), priced_env(case[1], "cpu"))
        out["|".join(map(str, case))] = {"result": result, "ms": ms, "infos": infos}
    out["scenario"] = scenario_runs(torch.device("cpu"))
    out["fault_plans"] = {f"{routed}|{policy}": planned_fault_day(routed, policy)
                          for routed, policy in FAULT_CASES}
    envs = compare_envs(torch.device("cpu"))
    out["compare"] = {t: compare_techniques(envs, (t,), "cost_sla",
                                            hours=COMPARE_HOURS)[t]["mean"]
                      for t in COMPARE_HELD}
    out["seconds"] = time.perf_counter() - T_START
    path.write_text(json.dumps(out))
    return 0


def profile_phase(tag: str, fn, host_ops: bool = True, **fields) -> dict:
    """One call of ``fn`` on the card under torch.profiler: kernels, device
    busy and idle share against the unprofiled wall time, host time a launch,
    the top kernels and, with ``host_ops``, the operators that fill the
    host's time (their events take the profiler a minute to sort at ~50,000
    launches). Returns the kernels and the unprofiled host ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    activities = ([ProfilerActivity.CPU] if host_ops else []) + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:5]
    nm = "not measured"
    phase(tag, **fields, host_ms_unprofiled=f"{plain_ms:.1f}", wall_ms=f"{wall_ms:.1f}",
          device_busy_ms=f"{busy_ms:.3f}" if kernels else nm,
          idle_share=f"{1 - busy_ms / wall_ms:.3f}" if kernels else nm,
          idle_share_unprofiled=f"{1 - busy_ms / plain_ms:.3f}" if kernels else nm,
          kernels=n, us_per_kernel=f"{busy_ms * 1e3 / n:.2f}" if n else nm,
          host_us_per_launch=f"{plain_ms * 1e3 / n:.2f}" if n else nm,
          top="; ".join(f"{e.key[:50]} x{e.count} {e.self_device_time_total / 1e3:.3f}ms"
                        for e in top),
          host_top="; ".join(f"{e.key[:40]} x{e.count} {e.self_cpu_time_total / 1e3:.1f}ms"
                             for e in host) or nm)
    return {"kernels": n, "host_ms": plain_ms}


def gtdrl_step_phase(dev: torch.device) -> None:
    """One gt-drl half-update at D = 16 (the paper's default config, the
    black half's five players batched) on the card and on the host CPU, from
    the same agents and the same draws; the card's run under CUDA's sync
    debug mode, so a read back to the host inside the step fails. Then the
    unrouted one's profile on the card."""
    cfg = gt_drl.GTDRLConfig()
    cpu = torch.device("cpu")
    for routed in (False, True):
        env = {d: priced_env(16, d) for d in (dev, cpu)}
        ctx = {d: game.GameContext(env=env[d], tau=9, objective="cost_sla", routed=routed)
               for d in env}
        gen = generator(0)
        start = (gt_drl.init_agents(gen, env[cpu], cfg, routed),
                 game.uniform_fractions(ctx[cpu]), gt_drl.draw_half(gen, ctx[cpu], cfg),
                 0.5 * sched_env.dp_max_t(env[cpu], 9))
        args = {cpu: start, dev: tree_map(lambda x: x.to(dev), start)}

        def step(d):
            agents, joint, draws, peak = args[d]
            return gt_drl.half_update(agents, joint, draws, 1, ctx[d], peak, cfg)

        step(dev)  # first call: lazy initialisation on the card
        out, ms = {}, {}
        for d in (dev, cpu):
            sync(d)
            t0 = time.perf_counter()
            if d == dev:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out[d] = step(d)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sync(d)
            ms[d] = (time.perf_counter() - t0) * 1e3
        (agents_c, joint_c), (agents_h, joint_h) = tree_map(lambda x: x.cpu(), out[dev]), out[cpu]
        weights = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves((agents_c.actor, agents_c.critic)),
            tree_leaves((agents_h.actor, agents_h.critic))))
        joint0, peak = start[1], start[3]
        rel = max(abs(float(game.player_objective(ctx[cpu], joint0, i, joint_c[..., i, :], peak))
                      / float(game.player_objective(ctx[cpu], joint0, i, joint_h[..., i, :], peak))
                      - 1) for i in range(1, sched_env.num_players(env[cpu]), 2))
        ok = (all(bool(torch.isfinite(x).all()) for x in tree_leaves(out[dev]))
              and weights <= GTDRL_AGENT_ATOL and rel <= GTDRL_ROW_RTOL)
        phase("gtdrl-step", num_dcs=16, routed=routed, players=5, card_ms=f"{ms[dev]:.1f}",
              cpu_ms=f"{ms[cpu]:.1f}", weights_max_abs_diff=f"{weights:.3g}",
              row_value_max_rel_diff=f"{rel:.3g}", joint_max_abs_diff=
              f"{float((joint_c - joint_h).abs().max()):.3g}", host_reads="none",
              tol=f"weights {GTDRL_AGENT_ATOL}, row values {GTDRL_ROW_RTOL}")
        if not ok:
            fail(f"gtdrl-step routed={routed}: card vs CPU weights {weights}, rows {rel}")
        if not routed:
            profile_phase("gtdrl-profile", lambda: step(dev), what="one half-update",
                          num_dcs=16, routed=routed)


def obs_phase(dev: torch.device) -> None:
    """Telemetry on the card (priced D = 16, cost_sla, routed): an fd day
    with its taps off and then on, bit for bit; the batched fd day over the
    stress suite with engine/hour live, an event an hour and row; one gt-drl
    half-update with its taps live under CUDA's sync debug mode; and the
    scoreboard rendered from [compare]'s records."""
    env = priced_env(16, dev)
    spec = ExperimentSpec(technique="fd", objective="cost_sla", routed=True, hours=OBS_HOURS)
    off, off_ms = timed(dev, lambda: run(spec.replace(taps=()), env))
    with obs.capture() as buf:
        on, on_ms = timed(dev, lambda: run(spec.replace(taps=OBS_TAPS), env))
    bit_equal = all(on["totals"][k] == v for k, v in off["totals"].items()) and all(
        a[k] == b[k] for a, b in zip(on["per_epoch"], off["per_epoch"]) for k in a)
    series = {k: buf.series("engine/hour", k) for k in ("carbon_kg", "cost_usd",
                                                         "sla_miss_cost_usd", "grid_power_w")}
    series_exact = all(np.array_equal(v, np.asarray([r[k] for r in on["per_epoch"]], v.dtype))
                       for k, v in series.items())
    residual = buf.series("game/nash_residual", "residual")
    counts = buf.counts()
    phase("obs", what="fd day, taps off then on", num_dcs=16, routed=True, hours=OBS_HOURS,
          taps=",".join(OBS_TAPS), events=counts, bit_equal=bit_equal,
          series_equals_per_epoch=series_exact,
          residual=[f"{x:.4g}" for x in residual], off_ms=f"{off_ms:.1f}", on_ms=f"{on_ms:.1f}")
    if not (bit_equal and series_exact
            and counts == {name: OBS_HOURS for name in OBS_TAPS}
            and np.all(np.isfinite(residual)) and np.all(residual >= 0)):
        fail(f"obs fd day: bit_equal {bit_equal}, series {series_exact}, {counts}, {residual}")

    envs = stress_envs(dev)
    bspec = batched_spec(True).replace(taps=("engine/hour",))
    with obs.capture() as buf:
        got, ms = timed(dev, lambda: run(bspec, envs))
    events = buf.by_name("engine/hour")
    n = len(envs)
    taus = [int(e["tau"]) for e in events]
    rows_exact = len(events) == n * BATCH_HOURS and taus == [t for t in range(BATCH_HOURS)
                                                             for _ in range(n)] and all(
        float(events[t * n + r][k]) == float(got["per_epoch"][k][r, t])
        for t in range(BATCH_HOURS) for r in range(n) for k in ("carbon_kg", "cost_usd"))
    phase("obs", what="batched fd over the stress suite, engine/hour live", days=n,
          num_dcs=16, routed=True, hours=BATCH_HOURS, events=len(events),
          hour_then_row_equal_per_epoch=rows_exact, card_ms=f"{ms:.1f}")
    if not rows_exact:
        fail(f"obs batched: {len(events)} events for {n} rows x {BATCH_HOURS} hours, "
             f"taus {taus}")

    cfg = gt_drl.GTDRLConfig()
    ctx = game.GameContext(env=env, tau=9, objective="cost_sla", routed=True)
    gen = generator(0)
    cpu_ctx = game.GameContext(env=priced_env(16, "cpu"), tau=9, objective="cost_sla",
                               routed=True)
    agents = gt_drl.init_agents(gen, env, cfg, True)
    draws = tree_map(lambda x: x.to(dev), gt_drl.draw_half(gen, cpu_ctx, cfg))
    joint, peak = game.uniform_fractions(ctx), 0.5 * sched_env.dp_max_t(env, 9)
    with obs.capture("gt_drl/*") as buf:
        sync(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = gt_drl.half_update(agents, joint, draws, 1, ctx, peak, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ppo = buf.by_name("gt_drl/ppo")
    players = sorted(int(v["player"]) for v in ppo)
    active = list(range(1, sched_env.num_players(env), 2))
    finite = all(np.all(np.isfinite(v["actor_loss"])) and np.all(np.isfinite(v["mean_reward"]))
                 for v in ppo) and all(bool(torch.isfinite(x).all()) for x in tree_leaves(out))
    phase("obs", what="one gt-drl half-update, gt_drl/* live, sync debug mode", num_dcs=16,
          routed=True, host_reads="none", events=buf.counts(), players=players, finite=finite)
    if players != active or not finite:
        fail(f"obs gt-drl: ppo events of players {players}, active {active}, finite {finite}")

    recs = obs.load_records(str(RECORDS))
    board = obs.report(recs, title="chip_smoke [compare] scoreboard")
    for line in board.splitlines():
        print(f"  {line}")
    ranked = [ln.split("|")[1].strip() for ln in board.splitlines()
              if ln.startswith("| ") and "technique" not in ln]
    phase("obs", what="records -> scoreboard", records=len(recs),
          path=str(RECORDS.relative_to(ROOT)), ranked=",".join(ranked),
          device_kind=recs[0]["device_kind"] if recs else "none")
    if sorted(ranked) != sorted(schedulers.TECHNIQUES) or any(
            r["backend"] != "cuda" or r["kind"] != "compare" for r in recs):
        fail(f"obs records: {len(recs)} records ranked {ranked}")


def compare_envs(device) -> list:
    return [priced_env(16, device, seed) for seed in (0, 1)]


def compare_phase(dev: torch.device) -> dict:
    """The paper's table on the card: every technique over two priced D = 16
    fleets on the default (batched) engine, ranked by the day's cost, each
    technique's run record written to RECORDS; fd's mean held against the
    hour loop's. Returns the means, which [compare-cpu] holds against the
    CPU process's."""
    envs = compare_envs(dev)
    means = {}
    RECORDS.unlink(missing_ok=True)
    for t in schedulers.TECHNIQUES:
        r, ms = timed(dev, lambda: compare_techniques(envs, (t,), "cost_sla",
                                                      hours=COMPARE_HOURS,
                                                      record=str(RECORDS))[t])
        if not (np.isfinite(r["mean"]) and np.isfinite(r["stderr"])
                and len(r["curve_mean"]) == COMPARE_HOURS):
            fail(f"compare {t}: {r}")
        means[t] = r["mean"]
        fields = {}
        if t == "fd":
            loop, loop_ms = timed(dev, lambda: compare_techniques(
                envs, (t,), "cost_sla", hours=COMPARE_HOURS, engine="loop")[t])
            diff = abs(r["mean"] - loop["mean"]) / abs(loop["mean"])
            fields = dict(loop_mean=f"{loop['mean']:.8g}", loop_ms=f"{loop_ms:.1f}",
                          batched_vs_loop=f"{diff:.3g}", tol=SCHED_OBJECTIVE_RTOL)
            if not diff <= SCHED_OBJECTIVE_RTOL:
                fail(f"compare fd: batched mean {r['mean']} against the loop's {loop['mean']}")
        phase("compare", technique=t, engine="batched", envs=2, num_dcs=16,
              hours=COMPARE_HOURS, metric="cost_usd", mean=f"{r['mean']:.8g}",
              stderr=f"{r['stderr']:.4g}", ms=f"{ms:.1f}", **fields)
    phase("compare-rank", order=",".join(sorted(means, key=means.get)))
    return means


def compare_hold_phase(card: dict, cpu: dict) -> None:
    """[compare-cpu]: the batched rows of COMPARE_HELD, the card's mean daily
    cost against the CPU process's from the same host draws."""
    for t, tol in COMPARE_HELD.items():
        rel = abs(card[t] - cpu[t]) / abs(cpu[t])
        phase("compare-cpu", technique=t, engine="batched", envs=2, num_dcs=16,
              hours=COMPARE_HOURS, mean=f"{card[t]:.8g}", cpu_mean=f"{cpu[t]:.8g}",
              rel_diff=f"{rel:.3g}", tol=tol)
        if not rel <= tol:
            fail(f"compare {t}: card mean {card[t]} against the CPU's {cpu[t]}")


def sched_phases(dev: torch.device) -> None:
    """Build the fleets on the card, play days on it against the host CPU
    (run by a second process, beside the card's work), hold one gt-drl
    half-update card against CPU, rank the six techniques, and profile."""
    ref_path = ROOT / "build" / "chip_smoke_cpu_reference.json"
    ref_path.parent.mkdir(exist_ok=True)
    ref_path.unlink(missing_ok=True)
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--cpu-reference",
                              str(ref_path)], env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    try:
        _sched_phases(dev, child, ref_path)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()


def _sched_phases(dev: torch.device, child, ref_path: Path) -> None:
    cpu = torch.device("cpu")
    for workload in ("aibench", "llm"):
        t0 = time.perf_counter()
        on_card = sched_env.build_env(16, seed=0, workload=workload, device=dev)
        card_ms = (time.perf_counter() - t0) * 1e3
        on_host = sched_env.build_env(16, seed=0, workload=workload, device=cpu)
        for name in sched_env.EnvParams._fields:
            a, b = getattr(on_card, name), getattr(on_host, name)
            if a.device.type != dev.type or a.dtype != torch.float32 or not torch.equal(a.cpu(), b):
                fail(f"sched-env {workload} field {name} differs from the CPU build")
        phase("sched-env", workload=workload, num_dcs=16,
              players=sched_env.num_players(on_card), fields=len(on_card),
              equal_to_cpu=True, build_ms=f"{card_ms:.1f}")

    gtdrl_step_phase(dev)
    card = {case: traced_day(sched_spec(case), priced_env(case[1], dev)) for case in SCHED_CASES}
    compare_means = compare_phase(dev)
    obs_phase(dev)
    # where the time of one fd hour goes on the card (D = 16, routed)
    spec = ExperimentSpec(technique="fd", objective="cost_sla", routed=True, hours=1)
    env = priced_env(16, dev)
    single = profile_phase("sched-profile", lambda: run(spec, env), technique="fd",
                           num_dcs=16, routed=True, hours=1)
    # the scenario engine: runs beside the CPU process's, held after it
    scenarios_phase(dev)
    card_scenario = scenario_runs(dev)

    if child.wait(timeout=900) != 0:
        fail(f"the CPU reference process exited {child.returncode}")
    ref = json.loads(ref_path.read_text())
    phase("sched-cpu-reference", cases=len(SCHED_CASES) + len(ref["scenario"]),
          seconds=f"{ref['seconds']:.1f}")
    compare_hold_phase(compare_means, ref["compare"])
    for case in SCHED_CASES:
        technique, d, routed, hours = case
        (got, card_ms, infos), want = card[case], ref["|".join(map(str, case))]
        host = want["result"]
        rel = {k: abs(got["totals"][k] - host["totals"][k]) / abs(host["totals"][k])
               for k in ("carbon_kg", "cost_usd", "sla_miss_cost_usd")}
        sum_car = float(priced_env(d, cpu).car[:, :hours].double().sum())
        share = {"card": got["totals"]["violation"] / sum_car,
                 "cpu": host["totals"]["violation"] / sum_car}
        rows_ok = all(np.isfinite(list(r.values())).all() for r in got["per_epoch"])
        diverged = sum(int(i[0]) for i in infos + want["infos"])
        # gt-drl's adopted value never exceeds the uniform split's (its best
        # starts there); fd's and nash's are not held to that
        above_uniform = sum(i[1] > i[2] for i in infos + want["infos"])
        phase("sched", technique=technique, num_dcs=d, routed=routed, objective="cost_sla",
              hours=hours, **{k: f"{v:.6g}" for k, v in got["totals"].items()},
              cost_rel_diff=f"{rel['cost_usd']:.3g}", max_rel_diff=f"{max(rel.values()):.3g}",
              violation_share=f"{share['card']:.3g}", diverged_rounds=diverged,
              card_ms=f"{card_ms:.1f}", cpu_ms=f"{want['ms']:.1f}",
              tol=f"cost {GTDRL_COST_RTOL}, others reported" if technique == "gt-drl"
              else f"cost {SCHED_OBJECTIVE_RTOL}, others {SCHED_OTHER_RTOL}")
        if not rows_ok or len(got["per_epoch"]) != hours:
            fail(f"sched {technique} D={d}: {len(got['per_epoch'])} rows, finite {rows_ok}")
        gtdrl = technique == "gt-drl"
        others = 0.0 if gtdrl else max(rel.values())
        if (not rel["cost_usd"] <= (GTDRL_COST_RTOL if gtdrl else SCHED_OBJECTIVE_RTOL)
                or not others <= SCHED_OTHER_RTOL):
            fail(f"sched {technique} D={d} routed={routed}: card vs CPU {rel}")
        if not max(abs(v) for v in share.values()) <= SCHED_VIOLATION_SHARE:
            fail(f"sched {technique} D={d}: violation share {share}")
        if technique == "gt-drl" and (diverged or above_uniform):
            fail(f"sched gt-drl D={d} routed={routed}: {diverged} diverged rounds, "
                 f"{above_uniform} hours above the uniform split")
    sweep_phase(dev, card_scenario, ref["scenario"])
    batched_phase(dev, card_scenario, ref["scenario"], single)
    month_phase(dev, card_scenario, ref["scenario"])
    faults_phase(dev, card_scenario, ref["scenario"], ref["fault_plans"])


# ---------------------------------------------------------------------------
# the scenario engine: suites, the batched and month engines, realized
# faults and (resumable) sweeps at D = 16
# ---------------------------------------------------------------------------

def plain(x):
    """A result as JSON: numpy arrays as lists, numpy scalars as floats."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def timed(device, fn):
    """(fn(), host ms around it, the device's work included)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def stress_envs(device) -> list:
    return [env for _, env in scenarios.build_suite("stress", priced_env(16, device))]


def batched_spec(routed: bool) -> ExperimentSpec:
    return ExperimentSpec(technique="fd", objective="cost_sla", routed=routed,
                          hours=BATCH_HOURS, engine="batched")


def crash_trace(env):
    """DC 1 crashes and DC 0 browns out from hour 0, while fd plans on the
    healthy fleet."""
    return fault_mod.compose(
        fault_mod.dc_crash(env, dc=1, start=0, duration=FAULT_HOURS),
        fault_mod.brownout(env, dc=0, start=0, duration=FAULT_HOURS, severity=0.5))


FAULT_CASES = [(routed, policy) for routed in (False, True) for policy in fault_mod.POLICIES]

LINT_TIMEOUT_S = 300
LINT_DAY = ExperimentSpec(technique="fd", objective="cost_sla", hours=2)
LINT_DCS = 4


def lint_phase(dev: torch.device) -> None:
    """``repro_torch.lint`` over this checkout (a subprocess, JSON out): no
    finding; the schemas and bounds over the card's D = 16 fleet and a crash
    trace moved to the card; two identical fd days dispatch under one new
    engine key, then under none."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.lint", "--root", str(ROOT),
                          "--format", "json"], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=LINT_TIMEOUT_S)
    try:
        violations = json.loads(res.stdout)
    except json.JSONDecodeError:
        violations = None
    if res.returncode != 0 or violations != []:
        fail(f"repro_torch.lint exited {res.returncode}: {res.stdout[-2000:]} "
             f"{res.stderr[-2000:]}")
    static_s = time.perf_counter() - t0

    env = priced_env(16, dev)
    trace = tree_map(lambda x: x.to(dev), crash_trace(priced_env(16, "cpu")))
    for tree in (env, trace):
        if {x.device.type for x in tree} != {"cuda"}:
            fail(f"lint: {type(tree).__name__} is not on the card")
        lint.validate(tree)
        lint.validate_bounds(tree)

    day_env = priced_env(LINT_DCS, dev)
    obs.reset_stats()  # the engine keys of earlier phases are seen already
    hours, strict_hours = experiment._hours, []

    def hours_without_sync(*args, **kwargs):
        # the runtime witness of the purity pass: a host sync in the hour
        # root raises under CUDA's sync debug mode
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = hours(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        strict_hours.append(args[0].hours)
        return out

    torch.cuda.set_sync_debug_mode("error")
    try:
        day_env.er.sum().item()
        witness_raises = False
    except RuntimeError:
        witness_raises = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not witness_raises:
        fail("lint: CUDA's sync debug mode let an .item() through; it witnesses nothing")
    experiment._hours = hours_without_sync
    try:
        with lint.expect_compiles(1) as first:
            a = run(LINT_DAY, day_env)
        with lint.expect_compiles(0) as again:
            b = run(LINT_DAY, day_env)
    finally:
        experiment._hours = hours
    if a["totals"] != b["totals"] or again["hits"] != 1:
        fail(f"lint: the repeated fd day differs ({a['totals']} vs {b['totals']}) "
             f"or did not hit its key ({again})")
    if strict_hours != [LINT_DAY.hours] * 2:
        fail(f"lint: the fd days' hours did not all run under sync debug mode ({strict_hours})")
    phase("lint", violations=len(violations), static_s=f"{static_s:.1f}",
          validated="EnvParams(D=16) FaultTrace(D=16) on cuda",
          expect_compiles=f"{first['misses']} then {again['misses']}",
          hours_without_sync=sum(strict_hours),
          seconds=f"{time.perf_counter() - t0:.1f}", card=card_line())


def fault_spec(routed: bool, policy: str, engine: str = "scan") -> ExperimentSpec:
    return ExperimentSpec(technique="fd", objective="cost_sla", routed=routed,
                          hours=FAULT_HOURS, failover=policy, engine=engine)


def planned_fault_day(routed: bool, policy: str) -> dict:
    """The faulted day on the host CPU through the loop engine, keeping fd's
    plan of each hour for the card to replay through the failover."""
    env = priced_env(16, "cpu")
    spec = fault_spec(routed, policy, "loop")
    _, state0 = experiment._day_inputs(env, spec.technique, spec.objective, spec.seed,
                                       spec.pretrain, spec.cfg, None, spec.routed)
    sched = StatefulScheduler(spec.technique, state0, spec.cfg)
    plans = []

    def solve(gen, ctx, peak):
        res = sched.solve_epoch(gen, ctx, peak)
        plans.append(res.fractions.tolist())
        return res

    return {"plans": plans, "totals": run(spec, env, faults=crash_trace(env),
                                          solver=solve)["totals"]}


def replayed_fault_day(dev, routed: bool, policy: str, plans) -> tuple:
    """(result, ms): the faulted day on the card from the CPU's plans, so
    only the failover and the simulator run on the card."""
    env = priced_env(16, dev)

    def solve(gen, ctx, peak):
        return game.SolveResult(torch.tensor(plans[ctx.tau], device=dev), {})

    return timed(dev, lambda: run(fault_spec(routed, policy, "loop"), env,
                                  faults=crash_trace(env), solver=solve))


def stacked_case(device):
    """(spec, envs, trace): the first stress rows, each under its own random
    day of trouble, on the batched engine."""
    envs = stress_envs(device)[:STACKED_ROWS]
    trace = fault_mod.stack_traces([fault_mod.random_trace(envs[0], seed=r, n_events=6)
                                    for r in range(STACKED_ROWS)])
    return fault_spec(True, "spill_nearest", "batched"), envs, trace


def scenario_runs(device) -> dict:
    """The scenario engine's runs that the card holds against the host CPU:
    {case: (JSON result, ms)}."""
    out = {}
    for routed in (False, True):
        envs = stress_envs(device)
        out[f"batched|{routed}"] = timed(device, lambda: run(batched_spec(routed), envs))
    for t in BATCHED_STOCHASTIC:
        out[f"{t}|stress"] = timed(device, lambda: run(
            batched_spec(False).replace(technique=t), stress_envs(device)))
    out["sweep"] = timed(device, lambda: sweep(
        sweep_spec(), SWEEP_GRID, base_env=priced_env(16, device),
        base_scenarios=SWEEP_BASE)["results"]["fd"])
    month = scenarios.build_month(priced_env(16, device), days=MONTH_DAYS)
    spec = ExperimentSpec(technique="fd", objective="cost_sla", engine="month",
                          days=MONTH_DAYS, hours=MONTH_HOURS)
    out["month"] = timed(device, lambda: run(spec, month))
    for routed, policy in FAULT_CASES:
        env = priced_env(16, device)
        trace = crash_trace(env)
        out[f"faults|{routed}|{policy}"] = timed(
            device, lambda: run(fault_spec(routed, policy), env, faults=trace))
    spec, envs, trace = stacked_case(device)
    out["faults|stacked"] = timed(device, lambda: run(spec, envs, faults=trace))
    return {k: (plain(v), ms) for k, (v, ms) in out.items()}


def rel_diffs(got: dict, want: dict, keys) -> dict:
    """max relative difference of each key's (possibly per-row) totals."""
    out = {}
    for k in keys:
        a, b = np.asarray(got[k], float), np.asarray(want[k], float)
        out[k] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    return out


def hold_card_cpu(tag: str, got: dict, want: dict, sum_car: float,
                  shed_rtol: float = SHED_RTOL, **fields) -> None:
    """Card totals against the CPU's: the cost (what fd minimizes) at
    SCHED_OBJECTIVE_RTOL, carbon and SLA cost at SCHED_OTHER_RTOL, the moved
    mass and the SLA delta at SCHED_OTHER_RTOL of their scale. The violation
    and the unserved mass within SCHED_VIOLATION_SHARE of Σ CAR (their
    float32 rounding) or ``shed_rtol`` of their value, whichever is larger
    (see SHED_RTOL)."""
    rel = rel_diffs(got, want, ("carbon_kg", "cost_usd", "sla_miss_cost_usd"))
    share = {}
    for k in ("violation", "unserved_demand"):
        if k in want:
            a, b = np.asarray(got[k], float), np.asarray(want[k], float)
            share[k] = float(np.max(np.abs(a - b) / np.maximum(
                SCHED_VIOLATION_SHARE * sum_car, shed_rtol * np.abs(b))))
    spread = {}
    for k in ("failover_moved", "degraded_sla_cost_usd"):
        if k in want:
            a, b = np.asarray(got[k], float), np.asarray(want[k], float)
            spread[k] = float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1.0))
    phase(tag, **fields, cost_rel_diff=f"{rel['cost_usd']:.3g}",
          max_rel_diff=f"{max(rel.values()):.3g}",
          **{f"{k}_diff_of_tol": f"{v:.3g}" for k, v in share.items()},
          **{f"{k}_diff": f"{v:.3g}" for k, v in spread.items()},
          tol=f"cost {SCHED_OBJECTIVE_RTOL}, others {SCHED_OTHER_RTOL}, violation/unserved "
              f"max({SCHED_VIOLATION_SHARE} of sum CAR, {shed_rtol} of the value)")
    if not (rel["cost_usd"] <= SCHED_OBJECTIVE_RTOL and max(rel.values()) <= SCHED_OTHER_RTOL
            and all(v <= 1.0 for v in share.values())
            and all(v <= SCHED_OTHER_RTOL for v in spread.values())):
        fail(f"{tag} {fields}: card vs CPU {rel} {share} {spread}")


def scenarios_phase(dev: torch.device) -> None:
    """Every suite built on the card, field for field the CPU build (the
    routing suite at D = 4: its source indices assume the 4-DC fleet)."""
    cpu = torch.device("cpu")
    for name in scenarios.suite_names():
        d = 4 if name == "routing" else 16
        (card, ms) = timed(dev, lambda: scenarios.build_suite(name, priced_env(d, dev)))
        host = scenarios.build_suite(name, priced_env(d, cpu))
        for (day, a), (_, b) in zip(card, host):
            for field in sched_env.EnvParams._fields:
                x = getattr(a, field)
                if x.device.type != dev.type or not torch.equal(x.cpu(), getattr(b, field)):
                    fail(f"scenarios {name}/{day} field {field} differs from the CPU build")
        phase("scenarios", suite=name, num_dcs=d, days=len(card), fields=len(card[0][1]),
              equal_to_cpu=True, build_ms=f"{ms:.1f}")


def batched_phase(dev: torch.device, card: dict, ref: dict, single: dict) -> None:
    """fd over the stress suite under one vmap a hour: against the CPU, rows
    0 and 2 against the card's scan days of their seeds, ms per scenario-day,
    and a profiled batched hour."""
    envs = stress_envs(dev)
    sum_car = float(sum(float(e.car[:, :BATCH_HOURS].double().sum()) for e in envs))
    for routed in (False, True):
        (got, ms), (want, cpu_ms) = card[f"batched|{routed}"], ref[f"batched|{routed}"]
        rows = {}
        for r in (0, 2):
            day, day_ms = timed(dev, lambda: run(batched_spec(routed).replace(
                engine="scan", seed=r), envs[r]))
            rows[r] = day_ms
            for k in ("carbon_kg", "cost_usd", "sla_miss_cost_usd"):
                a = np.asarray(got["per_epoch"][k][r], float)
                b = np.asarray([e[k] for e in day["per_epoch"]], float)
                diff = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
                if not diff <= (ROW_RTOL if k == "cost_usd" else SCHED_OTHER_RTOL):
                    fail(f"sched-batched routed={routed} row {r} {k}: {diff} from its scan day")
        if not all(np.isfinite(np.asarray(v, float)).all() for v in got["per_epoch"].values()):
            fail(f"sched-batched routed={routed}: non-finite metrics")
        hold_card_cpu("sched-batched", got["totals"], want["totals"], sum_car, suite="stress",
                      days=len(envs), num_dcs=16, routed=routed, hours=BATCH_HOURS,
                      card_ms=f"{ms:.1f}", ms_per_day=f"{ms / len(envs):.1f}",
                      ms_per_day_hour=f"{ms / len(envs) / BATCH_HOURS:.1f}",
                      scan_day_ms=f"{rows[0]:.1f}",
                      scan_ms_per_hour=f"{rows[0] / BATCH_HOURS:.1f}", cpu_ms=f"{cpu_ms:.1f}",
                      rows_0_2_vs_scan=f"cost {ROW_RTOL}, others {SCHED_OTHER_RTOL}")
    # the stochastic techniques on the batched engine: every row draws on
    # the host, so card and CPU see the same draws
    for t in BATCHED_STOCHASTIC:
        (got, ms), (want, cpu_ms) = card[f"{t}|stress"], ref[f"{t}|stress"]
        if not all(np.isfinite(np.asarray(v, float)).all() for v in got["per_epoch"].values()):
            fail(f"sched-batched {t}: non-finite metrics")
        cost = np.asarray(want["totals"]["cost_usd"], float)
        per_row = np.abs(np.asarray(got["totals"]["cost_usd"], float) - cost) / np.abs(cost)
        hold_card_cpu("sched-batched", got["totals"], want["totals"], sum_car, technique=t,
                      suite="stress", days=len(envs), num_dcs=16, routed=False,
                      hours=BATCH_HOURS, card_ms=f"{ms:.1f}", cpu_ms=f"{cpu_ms:.1f}",
                      rows_cost_within_row_rtol=f"{int(np.sum(per_row <= ROW_RTOL))}/{len(envs)}",
                      row_cost_max_rel_diff=f"{per_row.max():.3g}")
    # where the time of one batched hour goes, beside [sched-profile]'s
    # single-env fd hour (D = 16, routed)
    spec = batched_spec(True).replace(hours=1)
    profile_phase("sched-batched", lambda: run(spec, envs), host_ops=False,
                  what="profile of one batched hour", technique="fd", days=len(envs),
                  num_dcs=16, routed=True,
                  single_env_hour_kernels=single["kernels"],
                  single_env_hour_host_ms=f"{single['host_ms']:.1f}")


def month_phase(dev: torch.device, card: dict, ref: dict) -> None:
    (got, ms), (want, cpu_ms) = card["month"], ref["month"]
    peaks = np.asarray(got["peak_w"])
    month = scenarios.build_month(priced_env(16, dev), days=MONTH_DAYS)
    day0, _ = timed(dev, lambda: run(ExperimentSpec(technique="fd", objective="cost_sla",
                                                    hours=MONTH_HOURS), month[0][1]))
    d0 = rel_diffs({k: got["per_day"][k][0] for k in got["per_day"]},
                   {k: [e[k] for e in day0["per_epoch"]] for k in got["per_day"]},
                   ("carbon_kg", "cost_usd", "sla_miss_cost_usd"))
    monotone = bool(np.all(np.diff(peaks, axis=0) >= 0))
    paid = np.asarray(got["per_day"]["peak_cost_usd"], float).sum(axis=1)[1:] > 0
    rises = np.any(np.diff(peaks, axis=0) > 0, axis=1)
    sum_car = float(sum(float(e.car[:, :MONTH_HOURS].double().sum()) for _, e in month))
    if not (monotone and np.array_equal(paid, rises) and max(d0.values()) <= ROW_RTOL
            and np.array_equal(peaks[-1], np.asarray(got["final_peak_w"]))):
        fail(f"sched-month: day 0 vs scan {d0}, monotone {monotone}, paid {paid} rises {rises}")
    hold_card_cpu("sched-month", got["totals"], want["totals"], sum_car, days=MONTH_DAYS,
                  hours=MONTH_HOURS, num_dcs=16, card_ms=f"{ms:.1f}", cpu_ms=f"{cpu_ms:.1f}",
                  day0_vs_scan=f"{max(d0.values()):.3g}", peaks_monotone=monotone,
                  peak_paid_when_raised=True,
                  final_peak_mw=f"{float(peaks[-1].sum()) / 1e6:.4f}")


def faults_phase(dev: torch.device, card: dict, ref: dict, plans: dict) -> None:
    """Each policy's faulted day on the card against the CPU's: from the
    card's own plans, then replaying the CPU's plans (the failover alone);
    then the stacked random traces on the batched engine."""
    sum_car = float(priced_env(16, "cpu").car[:, :FAULT_HOURS].double().sum())
    for routed, policy in FAULT_CASES:
        key = f"faults|{routed}|{policy}"
        (got, ms), (want, cpu_ms) = card[key], ref[key]
        t = got["totals"]
        hold_card_cpu("sched-faults", t, want["totals"], sum_car, routed=routed, policy=policy,
                      hours=FAULT_HOURS, num_dcs=16, trace="dc_crash(1)+brownout(0)",
                      unserved=f"{t['unserved_demand']:.6g}",
                      moved=f"{t['failover_moved']:.6g}",
                      degraded_sla_usd=f"{t['degraded_sla_cost_usd']:.6g}",
                      fallback_hours=t["fallback_hours"], card_ms=f"{ms:.1f}",
                      cpu_ms=f"{cpu_ms:.1f}")
        if t["fallback_hours"] != 0 or (policy == "drop") != (t["failover_moved"] == 0):
            fail(f"sched-faults {key}: {t}")
        cpu_day = plans[f"{routed}|{policy}"]
        replay, replay_ms = replayed_fault_day(dev, routed, policy, cpu_day["plans"])
        hold_card_cpu("sched-faults", replay["totals"], cpu_day["totals"], sum_car, shed_rtol=0.0,
                      routed=routed, policy=policy, plan="the CPU's, replayed",
                      hours=FAULT_HOURS, num_dcs=16,
                      unserved=f"{replay['totals']['unserved_demand']:.6g}",
                      card_ms=f"{replay_ms:.1f}")
    (got, ms), (want, cpu_ms) = card["faults|stacked"], ref["faults|stacked"]
    envs = stress_envs("cpu")[:STACKED_ROWS]
    hold_card_cpu("sched-faults", got["totals"], want["totals"],
                  float(sum(float(e.car[:, :FAULT_HOURS].double().sum()) for e in envs)),
                  engine="batched", days=STACKED_ROWS, trace="random_trace a row (stacked)",
                  routed=True, policy="spill_nearest", hours=FAULT_HOURS, num_dcs=16,
                  unserved=[f"{v:.4g}" for v in got["totals"]["unserved_demand"]],
                  card_ms=f"{ms:.1f}", cpu_ms=f"{cpu_ms:.1f}")


def sweep_spec() -> ExperimentSpec:
    return ExperimentSpec(technique="fd", objective="cost_sla", routed=True, hours=SWEEP_HOURS)


def sweep_phase(dev: torch.device, card: dict, ref: dict) -> None:
    """run_sweep.py --quick's grid at D = 16, routed fd, against the CPU's;
    then the same grid journaled under build/, killed after SWEEP_KILL_AFTER
    chunks and rerun: the rerun restores them, its totals equal an unkilled
    journaled sweep's exactly, the batched sweep's as the card's rows do,
    and the CPU's."""
    import shutil

    (tot, ms), (want, cpu_ms) = card["sweep"], ref["sweep"]
    rows = scenarios.build_grid(priced_env(16, "cpu"), SWEEP_GRID, base=SWEEP_BASE)[1]
    sum_car = float(sum(float(e.car[:, :SWEEP_HOURS].double().sum()) for _, e in rows))
    if not all(np.isfinite(v).all() and np.shape(v) == (len(rows),)
               for v in tot["totals"].values()):
        fail(f"sweep totals {tot['totals']}")
    grid = dict(grid="wan_degradation(1,3) x origin_shift(0,0.8 toward DC 0)",
                base="sla_tighten 0.7", num_dcs=16, routed=True, hours=SWEEP_HOURS)
    hold_card_cpu("sweep", tot["totals"], want["totals"], sum_car, **grid, points=len(rows),
                  card_ms=f"{ms:.1f}", cpu_ms=f"{cpu_ms:.1f}",
                  sla_miss_usd=[f"{v:.6g}" for v in tot["totals"]["sla_miss_cost_usd"]],
                  cost_usd=[f"{v:.8g}" for v in tot["totals"]["cost_usd"]])
    spec = sweep_spec()
    kw = dict(base_env=priced_env(16, dev), base_scenarios=SWEEP_BASE)
    journals = ROOT / "build" / "chip_smoke_sweep"
    shutil.rmtree(journals, ignore_errors=True)
    whole, whole_ms = timed(dev, lambda: sweep(spec, SWEEP_GRID, resume_dir=str(
        journals / "whole"), **kw))
    killed = journals / "killed"
    t0 = time.perf_counter()
    try:
        with fault_mod.inject_kill_after(SWEEP_KILL_AFTER):
            sweep(spec, SWEEP_GRID, resume_dir=str(killed), **kw)
        fail("sweep: the injected kill did not stop the sweep")
    except fault_mod.KilledMidSweep:
        pass
    journaled = len(os.listdir(killed))
    resumed, resumed_ms = timed(dev, lambda: sweep(spec, SWEEP_GRID, resume_dir=str(killed),
                                                   **kw))
    kill_ms = (time.perf_counter() - t0) * 1e3 - resumed_ms
    meta = resumed["resume"]
    got, whole = resumed["results"]["fd"], whole["results"]["fd"]
    exact = all(np.array_equal(got[s][k], whole[s][k]) for s in ("totals", "per_epoch")
                for k in whole[s])
    vs_batched = rel_diffs(got["totals"], tot["totals"],
                           ("carbon_kg", "cost_usd", "sla_miss_cost_usd"))
    hold_card_cpu("sweep", got["totals"], want["totals"], sum_car, **grid,
                  resume_dir="build/chip_smoke_sweep/killed", chunks=meta["chunks"],
                  killed_after=SWEEP_KILL_AFTER, journaled_at_kill=journaled,
                  restored=meta["restored"], computed=meta["computed"], retries=meta["retries"],
                  equal_to_unkilled_journal=exact,
                  cost_rel_diff_vs_batched=f"{vs_batched['cost_usd']:.3g}",
                  max_rel_diff_vs_batched=f"{max(vs_batched.values()):.3g}",
                  journaled_ms=f"{whole_ms:.1f}", killed_run_ms=f"{kill_ms:.1f}",
                  resumed_ms=f"{resumed_ms:.1f}")
    if not (journaled == SWEEP_KILL_AFTER and meta["restored"] == SWEEP_KILL_AFTER
            and meta["computed"] == meta["chunks"] - SWEEP_KILL_AFTER and exact
            and vs_batched["cost_usd"] <= ROW_RTOL
            and max(vs_batched.values()) <= SCHED_OTHER_RTOL):
        fail(f"sweep resume: {meta}, exact {exact}, vs batched {vs_batched}")
    shutil.rmtree(journals, ignore_errors=True)


# ---------------------------------------------------------------------------
# training: the backward kernel, llama3.2-1b's train step at full width, every
# arch at smoke width, and the trainer's crash and resume
# ---------------------------------------------------------------------------

def _positions_mask(sq: int, skv: int, causal: bool, window: int, q_offset: int, device):
    """(Sq, Skv) bool: the keys each query row sees, as the kernels mask them."""
    qp = q_offset + torch.arange(sq, device=device)[:, None]
    kp = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= kp > qp - window
    return ok


def bwd_kernel_ms(fn, iters: int = 20) -> dict:
    """Device ms a call of each of the backward's kernels (delta, dk/dv, the
    head split's reduce, dq), by torch.profiler over ``iters`` calls of ``fn``
    back to back; "not measured" where the profiler saw none of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        part = next((p for p in BWD_PARTS if f"bwd_{p}_" in e.key), None)
        if (part and e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            ms[part] = ms.get(part, 0.0) + e.self_device_time_total / 1e3 / iters
    if not ms:
        return {f"{p}_ms": "not measured" for p in BWD_PARTS}
    return {f"{p}_ms": ms.get(p, 0.0) for p in BWD_PARTS}


def bwd_row(randn, case, dtype, flush: torch.Tensor) -> dict:
    """The backward kernel at one case: dq, dk, dv through autograd (the
    forward kernel with lse, then the backward kernel) against flash_vjp's
    plain forward and backward from the same inputs and cotangent; a second
    call of the backward kernel bit-equal to the first; then the backward
    kernel alone timed, warm and L2-flushed, against the plain backward, the
    library's backward (scaled_dot_product_attention with enable_gqa, through
    autograd; none under a softcap, which it does not take) and the bound, and
    at BWD_SPLIT_CASES each of its kernels' device time."""
    F = torch.nn.functional
    b, sq, skv, h, kvh, d, causal, window, softcap, q_offset = case
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    q, k, v = (randn(*s, dtype=dtype).requires_grad_()
               for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
    g = randn(b, sq, h, d, dtype=dtype)
    out = flash_mod.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), g)
    plain_out = flash_vjp.flash_attention_torch(q, k, v, **kw)
    want = torch.autograd.grad(plain_out, (q, k, v), g)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        err = max(max_err(a, w) for a, w in zip(got, want))
    else:
        err = max(rel_norm(a, w) for a, w in zip(got, want))
    if not err < BWD_TOL[dtype]:
        fail(f"flash_attention_bwd {case} {dtype}: dq/dk/dv {err} >= {BWD_TOL[dtype]}")
    q, k, v = (t.detach() for t in (q, k, v))
    scale, chunk = d ** -0.5, min(512, skv)
    o, lse = flash_mod.flash_attention_fwd(q, k, v, sm_scale=None, **kw)
    po, plse = flash_vjp.flash_fwd(q, k, v, scale=scale, chunk=chunk, **kw)
    kernel = lambda: flash_mod.flash_attention_bwd(q, k, v, o, lse, g, sm_scale=None, **kw)
    plain = lambda: flash_vjp.flash_bwd(q, k, v, po, plse, g, scale=scale, chunk=chunk, **kw)
    first, second = kernel(), kernel()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f"flash_attention_bwd {case} {dtype}: two calls on the same inputs differ")
    library_ms = library_cold = None
    if softcap == 0.0:
        lq, lk, lv = (t.transpose(1, 2).requires_grad_() for t in (q, k, v))
        mask = _positions_mask(sq, skv, causal, window, q_offset, q.device)
        lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask, enable_gqa=True)
        lg = g.transpose(1, 2)
        library = lambda: torch.autograd.grad(lout, (lq, lk, lv), lg, retain_graph=True)
        library_ms = time_ms(library, iters=10)
        library_cold = time_ms(library, iters=10, flush=flush)
    split = bwd_kernel_ms(kernel) if case in BWD_SPLIT_CASES else {}
    elt = q.element_size()
    nbytes = elt * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) + 4 * lse.numel()
    flops = 10 * b * h * d * attn_pairs(sq, skv, causal, window, q_offset)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS if dtype == torch.bfloat16
                               else PEAK_FP32_FLOPS)
    return dict(shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} {str(dtype)[6:]} causal={causal} "
                f"window={window} softcap={softcap} q_offset={q_offset}",
                grad_err=err, err_measure="max_abs" if dtype == torch.float32 else "rel_norm",
                max_abs_err=max(max_err(a, w) for a, w in zip(got, want)),
                out_max_abs_err=max_err(out.detach(), plain_out.detach()),
                lse_max_abs_err=max_err(lse, plse), repeat_bit_equal=True,
                splits=flash_mod._bwd_plan(b, sq, skv, h, kvh, d, dtype).splits,
                ms=time_ms(kernel, iters=10), plain_ms=time_ms(plain, iters=5),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                ms_cold_l2=time_ms(kernel, iters=10, flush=flush),
                library_ms_cold_l2=library_cold, **split, bytes=nbytes, flops=flops)


def kernel_bwd_phase(randn, records: dict) -> None:
    """[kernel-bwd]: a row per case and dtype (D = 16 in fp32 only), then
    llama3.2-1b's training shape in both dtypes; the bf16 training row is the
    kernel's record."""
    rows = []
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=torch.device("cuda"))
    for dtype in (torch.float32, torch.bfloat16):
        for case in BWD_CASES + [TRAIN_ATTN_CASE]:
            if case[5] in _build.FP32_HEAD_DIMS and dtype != torch.float32:
                continue
            row = bwd_row(randn, case, dtype, flush)
            rows.append(row)
            phase("kernel-bwd", **row, tol=BWD_TOL[dtype])
    main = rows[-1]
    records["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_vjp.py:101",
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        launches=0, launches_by_path={}, rows=rows[:-1])


def global_rel(got, want) -> float:
    """sqrt(sum |a - b|^2) / sqrt(sum |b|^2) over two lists of tensors."""
    num = sum(float(((a.float() - b.float()) ** 2).sum()) for a, b in zip(got, want))
    den = sum(float((b.float() ** 2).sum()) for b in want)
    return (num / den) ** 0.5


def train_hold_phase(dev: torch.device) -> None:
    """[train-hold]: one fp32 step of llama3.2-1b at full width (16 layers),
    the kernel path against impl="ref" from the same state and batch: loss,
    grad norm, every leaf's gradient and the parameters' update. Then bf16
    (the fp32 weights rounded): each path's loss and gradients by their
    distance from the fp32 reference path's."""
    cfg = get_config(ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    opt = AdamWConfig(lr=1e-3)
    state = init_train_state(cfg32, opt, seed=0, device=dev)
    state = state._replace(opt=state.opt._replace(
        step=torch.full((), 100, dtype=torch.int32, device=dev)))
    batch = make_batch(cfg32, seed=1, step=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev)
    runs = {impl: loss_and_grads(state.params, cfg32, batch, impl=impl)
            for impl in ("auto", "ref")}
    (lk, _, gk), (l32, _, g32) = runs["auto"], runs["ref"]
    del runs
    gk, g32 = tree_leaves(gk), tree_leaves(g32)
    loss_rel = abs(float(lk) / float(l32) - 1)
    gnorm = [float(global_norm(x)) for x in (gk, g32)]
    gnorm_rel = abs(gnorm[0] / gnorm[1] - 1)
    leaf_rel = [rel_norm(a, w) for a, w in zip(gk, g32)]
    del gk
    updates = {}
    for impl in ("auto", "ref"):
        new, _ = train_step(state, batch, cfg=cfg32, opt_cfg=opt, impl=impl)
        updates[impl] = [a - w for a, w in zip(tree_leaves(new.params),
                                               tree_leaves(state.params))]
        del new
    update_rel = global_rel(updates["auto"], updates["ref"])
    del updates
    torch.cuda.synchronize()
    phase("train-hold", arch=ARCH, dtype="float32", layers=cfg.num_layers,
          batch=f"{TRAIN_BATCH}x{TRAIN_SEQ}", loss=f"{float(lk):.8g}",
          loss_ref=f"{float(l32):.8g}", loss_rel=f"{loss_rel:.3g}",
          grad_norm=f"{gnorm[0]:.8g}", grad_norm_rel=f"{gnorm_rel:.3g}",
          worst_leaf_grad_rel=f"{max(leaf_rel):.3g}", leaves=len(leaf_rel),
          update_rel=f"{update_rel:.3g}", lr_scale=1.0,
          tol=f"loss {TRAIN_LOSS_RTOL}, grad norm {TRAIN_GNORM_RTOL}, leaf "
          f"{TRAIN_LEAF_RTOL}, update {TRAIN_UPDATE_RTOL}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL
            and max(leaf_rel) <= TRAIN_LEAF_RTOL and update_rel <= TRAIN_UPDATE_RTOL
            and math.isfinite(float(lk))):
        fail(f"train-hold fp32: loss {loss_rel}, grad norm {gnorm_rel}, worst leaf "
             f"{max(leaf_rel)}, update {update_rel}")

    params16 = tree_map(lambda t: t.to(torch.bfloat16), state.params)
    del state
    dist = {}
    for impl in ("auto", "ref"):
        loss, _, grads = loss_and_grads(params16, cfg, batch, impl=impl)
        dist[impl] = (abs(float(loss) - float(l32)), global_rel(tree_leaves(grads), g32))
        del grads
    (kl, kg), (rl, rg) = dist["auto"], dist["ref"]
    loss_bound = max(TRAIN_BF16_FACTOR * rl, TRAIN_BF16_LOSS_FLOOR * abs(float(l32)))
    phase("train-hold", arch=ARCH, dtype="bfloat16", loss_kernel_vs_fp32=f"{kl:.4g}",
          loss_plain_vs_fp32=f"{rl:.4g}", grads_kernel_vs_fp32=f"{kg:.4g}",
          grads_plain_vs_fp32=f"{rg:.4g}",
          rule=f"kernel <= {TRAIN_BF16_FACTOR} x plain (loss floor "
          f"{TRAIN_BF16_LOSS_FLOOR} of its value)")
    if not (kl <= loss_bound and kg <= TRAIN_BF16_FACTOR * rg):
        fail(f"train-hold bf16: loss {kl} (plain {rl}), grads {kg} (plain {rg})")


def train_phase(dev: torch.device, records: dict) -> dict:
    """[train]: the trainer at full width, bf16, through both flash kernels,
    launches held exactly (remat "full" runs each attention forward twice a
    step); step ms (median of steps 2-10), tokens/s, peak memory; then one
    step under the profiler, and its forward and backward by CUDA events.
    Returns the losses, step ms and launches, which [mesh-train] is held to."""
    cfg = get_config(ARCH)
    n_attn = attn_layers(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_mod.KERNEL.launches = flash_mod.BWD_KERNEL.launches = dec_mod.KERNEL.launches = 0
    t0 = time.perf_counter()
    res = train_loop(arch=ARCH, smoke=False, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                     seq=TRAIN_SEQ, device=dev, log_every=TRAIN_STEPS)
    wall_s = time.perf_counter() - t0
    launches = {"flash_attention": flash_mod.KERNEL.launches,
                "flash_attention_bwd": flash_mod.BWD_KERNEL.launches,
                "decode_attention": dec_mod.KERNEL.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"flash_attention": 2 * n_attn * TRAIN_STEPS,
            "flash_attention_bwd": n_attn * TRAIN_STEPS, "decode_attention": 0}
    if launches != want:
        fail(f"train launches {launches}, expected {want}")
    losses = res["losses"]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"train losses {losses}")
    step_ms = float(np.median(res["step_s"][1:])) * 1e3
    records["flash_attention"]["launches_by_path"][f"train {ARCH}"] = launches["flash_attention"]
    records["flash_attention_bwd"]["launches"] = launches["flash_attention_bwd"]
    records["flash_attention_bwd"]["launches_by_path"] = {
        f"train {ARCH}": launches["flash_attention_bwd"]}
    phase("train", arch=ARCH, layers=cfg.num_layers, dtype=cfg.dtype, remat=cfg.remat,
          batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
          step_ms_median_2_10=f"{step_ms:.3f}", first_step_ms=f"{res['step_s'][0] * 1e3:.1f}",
          tokens_per_s=f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f}",
          peak_gib=f"{peak_gib:.2f}", wall_s=f"{wall_s:.1f}", launches=launches,
          losses=[f"{x:.4f}" for x in losses])

    opt = AdamWConfig(lr=1e-3)
    state = res["state"]
    del res
    step = make_train_step(cfg, opt)
    batch = make_batch(cfg, seed=1, step=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                       device=dev)
    profile_phase("train-profile", lambda: step(state, batch), what="one train step",
                  arch=ARCH)
    leaves = tree_leaves(state.params)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    marks[0].record()
    with torch.enable_grad():
        fresh = [p.detach().requires_grad_(True) for p in leaves]
        loss, _ = train_step_mod.loss_fn(tree_unflatten(state.params, fresh), cfg, batch)
        marks[1].record()
        torch.autograd.grad(loss, fresh)
    marks[2].record()
    torch.cuda.synchronize()
    phase("train-profile", what="forward and backward by CUDA events (device time between "
          "markers)", forward_ms=f"{marks[0].elapsed_time(marks[1]):.3f}",
          backward_ms=f"{marks[1].elapsed_time(marks[2]):.3f}")
    return {"losses": losses, "step_ms": step_ms, "launches": launches,
            "peak_bytes": peak_gib * 2 ** 30}


def train_arch_losses(device) -> dict:
    """Each arch at smoke width: ARCH_STEPS steps on one batch (seed 3, step
    0, 2 x 32) from parameters drawn on the CPU (seed 0) and moved to
    ``device``; its losses, and its kernel launches on a card."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).smoke()
        opt = AdamWConfig(lr=ARCH_LR)
        state = tree_map(lambda t: t.to(device),
                         init_train_state(cfg, opt, seed=0, device="cpu"))
        batch = make_batch(cfg, seed=3, step=0, batch=2, seq=32, device=device)
        step = make_train_step(cfg, opt)
        flash_mod.KERNEL.launches = flash_mod.BWD_KERNEL.launches = 0
        losses = []
        for _ in range(ARCH_STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out[arch] = {"losses": losses, "launches": [flash_mod.KERNEL.launches,
                                                    flash_mod.BWD_KERNEL.launches]}
    return out


def train_arch_phase(dev: torch.device, child, ref_path: Path) -> None:
    """[train-arch]: every arch at smoke width through the kernels on the
    card: launches held exactly, the loss falls, the losses against the CPU
    process's."""
    t0 = time.perf_counter()
    card = train_arch_losses(dev)
    card_s = time.perf_counter() - t0
    if child.wait(timeout=600) != 0:
        fail(f"the CPU training reference process exited {child.returncode}")
    ref = json.loads(ref_path.read_text())
    for arch in ARCHS:
        cfg = get_config(arch).smoke()
        calls = (cfg.num_encoder_layers + 2 * cfg.num_layers if cfg.is_encoder_decoder
                 else attn_layers(cfg))
        got, want = card[arch]["losses"], ref[arch]["losses"]
        rel = [abs(a / w - 1) for a, w in zip(got, want)]
        phase("train-arch", arch=arch, layers=cfg.num_layers, head_dim=cfg.hd(),
              steps=ARCH_STEPS, launches=card[arch]["launches"],
              first_loss=f"{got[0]:.6f}", last_loss=f"{got[-1]:.6f}",
              first_rel_vs_cpu=f"{rel[0]:.3g}", max_rel_vs_cpu=f"{max(rel):.3g}",
              tol=f"first {ARCH_FIRST_RTOL}, later {ARCH_LOSS_RTOL}")
        if card[arch]["launches"] != [calls * ARCH_STEPS] * 2:
            fail(f"train-arch {arch}: launches {card[arch]['launches']}, expected "
                 f"{calls * ARCH_STEPS} of each")
        if not (got[-1] < got[0] and rel[0] <= ARCH_FIRST_RTOL
                and max(rel) <= ARCH_LOSS_RTOL):
            fail(f"train-arch {arch}: card losses {got}, CPU {want}")
    phase("train-arch", archs=len(ARCHS), card_s=f"{card_s:.1f}",
          cpu_s=f"{ref['seconds']:.1f}")


def train_resume_phase(dev: torch.device) -> None:
    """[train-resume]: on the card at smoke width, a crash at step 17 of 30
    and a resume from the step-10 checkpoint end on the loss, and the state,
    of an uninterrupted 30 steps, bit for bit."""
    import shutil

    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(RESUME_KW, steps=RESUME_STEPS, device=dev)
    whole = train_loop(ckpt_dir=str(root / "whole"), **kw)
    try:
        train_loop(ckpt_dir=str(root / "crashed"), fail_at=RESUME_FAIL_AT, **kw)
        fail("train-resume: the simulated failure did not stop the run")
    except RuntimeError as err:
        if "simulated failure" not in str(err):
            raise
    resumed = train_loop(ckpt_dir=str(root / "crashed"), **kw)
    same_state = all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed["state"]),
                                                         tree_leaves(whole["state"])))
    kept = CheckpointManager(str(root / "crashed")).steps()
    phase("train-resume", arch=RESUME_KW["arch"], smoke=True, steps=RESUME_STEPS,
          crash_at=RESUME_FAIL_AT, resumed_steps=len(resumed["losses"]),
          final_loss=f"{resumed['losses'][-1]:.8g}",
          uninterrupted_final_loss=f"{whole['losses'][-1]:.8g}",
          bit_equal_loss=resumed["losses"][-1] == whole["losses"][-1],
          bit_equal_state=same_state, checkpoints_kept=kept)
    if not (resumed["losses"] == whole["losses"][10:] and same_state and kept == [10, 20, 30]):
        fail(f"train-resume: resumed {resumed['losses']} against {whole['losses'][10:]}, "
             f"state equal {same_state}, kept {kept}")
    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the mesh: the (1, 1) host mesh on the card, and the calls a wider mesh's
# ranks make of the kernels, each rank in turn
# ---------------------------------------------------------------------------

def mesh_train_phase(dev: torch.device, records: dict, plain_run: dict) -> None:
    """[mesh-train]: [train]'s run through ``train_loop(mesh=make_host_mesh())``
    (a world of one rank on NCCL, the parameters, moments and batches
    DTensors, the kernels called on each shard's local tensors): launches held
    exactly as [train]'s, losses against [train]'s (bit-equal, or the largest
    relative gap), step ms beside [train]'s, then one step profiled."""
    import torch.distributed as dist

    cfg = get_config(ARCH)
    mesh = make_host_mesh(device=dev)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_mod.KERNEL.launches = flash_mod.BWD_KERNEL.launches = dec_mod.KERNEL.launches = 0
        t0 = time.perf_counter()
        res = train_loop(arch=ARCH, smoke=False, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                         seq=TRAIN_SEQ, device=dev, log_every=TRAIN_STEPS, mesh=mesh)
        wall_s = time.perf_counter() - t0
        launches = {"flash_attention": flash_mod.KERNEL.launches,
                    "flash_attention_bwd": flash_mod.BWD_KERNEL.launches,
                    "decode_attention": dec_mod.KERNEL.launches}
        if launches != plain_run["launches"]:
            fail(f"mesh-train launches {launches}, [train]'s {plain_run['launches']}")
        for name in ("flash_attention", "flash_attention_bwd"):
            records[name]["launches_by_path"][f"mesh-train {ARCH}"] = launches[name]
        losses, want = res["losses"], plain_run["losses"]
        gap = max(abs(a / w - 1) for a, w in zip(losses, want))
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            fail(f"mesh-train losses {losses}")
        step_ms = float(np.median(res["step_s"][1:])) * 1e3
        phase("mesh-train", arch=ARCH, mesh="(data 1, model 1)", backend=dist.get_backend(),
              world=dist.get_world_size(), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              steps=TRAIN_STEPS, step_ms_median_2_10=f"{step_ms:.3f}",
              train_step_ms=f"{plain_run['step_ms']:.3f}",
              ratio_to_train=f"{step_ms / plain_run['step_ms']:.3f}",
              tokens_per_s=f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f}",
              peak_gib=f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}",
              wall_s=f"{wall_s:.1f}", launches=launches,
              losses_bit_equal_to_train=losses == want, max_rel_loss_gap=f"{gap:.3g}",
              losses=[f"{x:.6f}" for x in losses])
        if gap > TRAIN_LOSS_RTOL:
            fail(f"mesh-train losses {losses} against [train]'s {want}")
        state = res["state"]
        del res
        step = make_train_step(cfg, AdamWConfig(lr=1e-3))
        batch = make_batch(cfg, seed=1, step=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                           device=dev)
        from repro_torch.distributed import sharding as shd
        from repro_torch.launch.train import shard_batch

        def one_step():
            with shd.use_mesh(mesh):
                return step(state, shard_batch(batch, mesh))

        profile_phase("mesh-train-profile", one_step, what="one train step on the (1, 1) mesh",
                      arch=ARCH)
        del state
    finally:
        dist.destroy_process_group()


def attn_call(q, k, v, g, q_offset: int = 0):
    """(out, dq, dk, dv) of one causal flash call through both kernels, on
    contiguous copies of a shard's slices, as ``kernels/ops.py`` makes them."""
    q, k, v = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
    out = flash_mod.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), g))


def head_shard(q, k, v, g, rank: int, m: int):
    """Rank ``rank`` of ``m``'s tensors under the head split, as
    ``kernels/ops.py`` gives them: its q heads, and its kv heads (sharded
    with q where they divide, else gathered by ``kv_heads_of_shard``)."""
    h, kvh = q.shape[2], k.shape[2]
    hl = h // m
    if kvh % m == 0:
        sel = list(range(rank * kvh // m, (rank + 1) * kvh // m))
    else:
        sel = kv_heads_of_shard(h, kvh, rank, m)
    qs = slice(rank * hl, (rank + 1) * hl)
    return q[:, :, qs], k[:, :, sel], v[:, :, sel], g[:, :, qs], qs, sel


def sharded_grads(q, k, v, g, m: int, split: str):
    """(out, dq, dk, dv) assembled from each rank's call in rank order: the
    rows or heads of out and dq placed, a shard's dk and dv added into the
    heads it read (a partial sum where ranks share a kv head)."""
    out, dq = torch.empty_like(q), torch.empty_like(q)
    dk32, dv32 = (torch.zeros(k.shape, dtype=torch.float32, device=k.device) for _ in "kv")
    for r in range(m):
        if split == "heads":
            ql, kl, vl, gl, qs, sel = head_shard(q, k, v, g, r, m)
            o, a, b, c = attn_call(ql, kl, vl, gl)
            out[:, :, qs], dq[:, :, qs] = o, a
            for j, head in enumerate(sel):
                dk32[:, :, head] += b[:, :, j].float()
                dv32[:, :, head] += c[:, :, j].float()
        else:
            rows = slice(r * q.shape[1] // m, (r + 1) * q.shape[1] // m)
            o, a, b, c = attn_call(q[:, rows], k, v, g[:, rows], q_offset=rows.start)
            out[:, rows], dq[:, rows] = o, a
            dk32 += b.float()
            dv32 += c.float()
    return out, dq, dk32.to(k.dtype), dv32.to(v.dtype)


def mesh_shards_phase(randn) -> None:
    """[mesh-shards]: each rank's kernel calls under a wider "model" dim than
    the card count, in rank order, against the unsharded call (see MESH_M)."""
    b, s, _, h, kvh, d = TRAIN_ATTN_CASE[:6]
    names = ("out", "dq", "dk", "dv")
    inputs = [randn(b, s, n, d, dtype=torch.float32) for n in (h, kvh, kvh, h)]
    full32 = None
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = (t.to(dtype) for t in inputs)
        full = attn_call(q, k, v, g)
        for split, m in (("heads", MESH_M), ("seq", MESH_M), ("heads", MESH_GQA_M)):
            got = sharded_grads(q, k, v, g, m, split)
            equal = {n: torch.equal(a, w) for n, a, w in zip(names, got, full)}
            errs = {n: max_err(a, w) for n, a, w in zip(names, got, full)}
            fields = {}
            if dtype == torch.float32:
                full32 = full
                tol = {"out": MESH_OUT_TOL, "dq": MESH_OUT_TOL,
                       "dk": BWD_TOL[dtype], "dv": BWD_TOL[dtype]}
                bad = [n for n in names if not errs[n] <= tol[n]]
            else:
                # no further from the fp32 call than MESH_BF16_FACTOR times the
                # unsharded bf16 call is
                far = {n: rel_norm(a, w) for n, a, w in zip(names, got, full32)}
                near = {n: rel_norm(a, w) for n, a, w in zip(names, full, full32)}
                fields = {"rel_to_fp32": {n: f"{far[n]:.3g}" for n in names},
                          "unsharded_rel_to_fp32": {n: f"{near[n]:.3g}" for n in names}}
                tol = f"{MESH_BF16_FACTOR}x the unsharded bf16 call's distance from fp32"
                bad = [n for n in names if not far[n] <= MESH_BF16_FACTOR * near[n]]
            shard = ((b, s, s, h // m, len(head_shard(q, k, v, g, 0, m)[5]), d)
                     if split == "heads" else (b, s // m, s, h, kvh, d))
            phase("mesh-shards", split=split, m=m, dtype=str(dtype)[6:],
                  shape=f"q({b},{s},{h},{d}) kv({b},{s},{kvh},{d})",
                  shard_shape=f"q({shard[0]},{shard[1]},{shard[3]},{d}) "
                              f"kv({shard[0]},{shard[2]},{shard[4]},{d})",
                  bit_equal=equal, max_abs_err={n: f"{e:.3g}" for n, e in errs.items()},
                  bwd_splits={"shard": flash_mod._bwd_plan(*shard, dtype).splits,
                              "unsharded": flash_mod._bwd_plan(b, s, s, h, kvh, d,
                                                               dtype).splits},
                  tol=tol, **fields)
            if bad:
                fail(f"mesh-shards {split} m={m} {dtype}: {bad} off ({errs})")


def ep_inputs(device):
    """qwen2-moe-a2.7b's routed experts at full width in fp32 (router and 60
    experts, no shared experts: the EP body alone), drawn on the CPU from
    seed 0, and a (2, 256, 2048) input; on ``device``."""
    cfg = dataclasses.replace(get_config(EP_ARCH), dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def draw(*shape, std):
        return (torch.randn(shape, generator=gen) * std).to(device)

    p = {"router": {"w": draw(d, e, std=d ** -0.5)},
         "experts": {"w_in": {"w": draw(e, d, f, std=d ** -0.5)},
                     "w_gate": {"w": draw(e, d, f, std=d ** -0.5)},
                     "w_out": {"w": draw(e, f, d, std=f ** -0.5)}}}
    return cfg, p, draw(*EP_SHAPE, d, std=1.0)


def ep_path(ref_path: Path) -> Path:
    """Where the CPU process leaves its 16-rank expert-parallel output."""
    return ref_path.with_name(ref_path.stem + "_ep16.pt")


def ep_sum(p, cfg, x, m: int) -> torch.Tensor:
    """The expert-parallel layer over ``m`` ranks: each rank's ``ep_shard``,
    summed in rank order (the all-reduce)."""
    out = moe_mod.ep_shard(p, cfg, x, 0, m)[0]
    for r in range(1, m):
        out = out + moe_mod.ep_shard(p, cfg, x, r, m)[0]
    return out


def ep_shards_phase(dev: torch.device, ref_path: Path, child) -> None:
    """[mesh-shards], expert parallel: qwen2-moe-a2.7b's layer at full width,
    the ranks' sum at 4 ranks (60 experts divide: moe_apply's capacity)
    against moe_apply, and at 16 ranks (padded to 64: a capacity over 64)
    against the CPU process's same sum."""
    cfg, p, x = ep_inputs(dev)
    want = moe_mod.moe_apply(p, cfg, x)[0]
    got4 = ep_sum(p, cfg, x, EP_SIZES[0])
    got16 = ep_sum(p, cfg, x, EP_SIZES[1])
    if child.wait(timeout=900) != 0:
        fail(f"the CPU training reference process exited {child.returncode}")
    cpu16 = torch.load(ep_path(ref_path))
    rel4, rel16 = rel_norm(got4, want), rel_norm(got16.cpu(), cpu16)
    gap16 = rel_norm(got16, want)
    e_pad, e_loc, cap = moe_mod.ep_layout(cfg.num_experts, EP_SIZES[1], x.shape[0] * x.shape[1],
                                          cfg.num_experts_per_tok, 1.25)
    phase("mesh-shards", split="experts", arch=EP_ARCH, experts=cfg.num_experts,
          top_k=cfg.num_experts_per_tok, d_model=cfg.d_model, d_ff=cfg.d_ff,
          tokens=x.shape[0] * x.shape[1], dtype="float32",
          m4_rel_to_moe_apply=f"{rel4:.3g}", m16_rel_to_cpu=f"{rel16:.3g}",
          m16_padded_to=e_pad, m16_capacity=cap, m16_rel_to_moe_apply=f"{gap16:.3g}",
          tol=EP_RTOL)
    if not (rel4 <= EP_RTOL and rel16 <= EP_RTOL):
        fail(f"mesh-shards experts: m=4 {rel4} against moe_apply, m=16 {rel16} against the CPU")


def dryrun_card_phase(dev: torch.device, plain_run: dict) -> None:
    """[dryrun-card]: the dry run (``launch/dryrun.py``) of [train]'s step,
    llama3.2-1b at full width, batch 8 x 256, bf16, fp32 moments, remat
    "full", on a (1, 1) mesh in a fake world of one. Its argument bytes are
    held to the bytes [train]'s state and batch take on the card (built as
    ``train_loop`` builds them); its peak against [train]'s peak is reported
    (the dry run takes the plain attention path, not the kernels'); its
    MODEL_FLOPS over [train]'s step time is the step's share of the card's
    989 TFLOP/s (bf16, dense)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    cfg = get_config(ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = init_train_state(cfg, AdamWConfig(lr=1e-3), device=dev)
    batch = make_batch(cfg, seed=1, step=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev)
    torch.cuda.synchronize()
    measured = torch.cuda.memory_allocated() - base
    del state, batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with dryrun.fake_world(1):
        rec = dryrun.lower_cell(ARCH, "train_4k", False,
                                mesh=make_mesh((1, 1), ("data", "model"), device="cpu"),
                                probe=False,
                                shape_override=ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                                           "train"))
    wall_s = time.perf_counter() - t0
    predicted = rec["argument_bytes_per_device"]
    gap = abs(predicted / measured - 1)
    peak = predicted + rec["temp_bytes_per_device"]
    achieved = rec["model_flops"] / (plain_run["step_ms"] / 1e3)
    phase("dryrun-card", arch=ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ, dtype=cfg.dtype,
          moments="float32", remat=cfg.remat, mesh=rec["mesh"], status="OK",
          argument_bytes_predicted=predicted, allocated_bytes_measured=measured,
          argument_rel_gap=f"{gap:.3g}", peak_bytes_predicted=peak,
          train_peak_bytes=int(plain_run["peak_bytes"]),
          peak_ratio_predicted_to_train=f"{peak / plain_run['peak_bytes']:.4f}",
          model_flops=f"{rec['model_flops']:.6g}",
          flops_per_device=f"{rec['flops_per_device']:.6g}",
          useful_ratio=f"{rec['useful_ratio']:.4f}",
          train_step_ms=f"{plain_run['step_ms']:.3f}", achieved_tflops=f"{achieved / 1e12:.3f}",
          share_of_989_tflops=f"{achieved / PEAK_BF16_FLOPS:.5f}", card=f"'{card_line()}'",
          wall_s=f"{wall_s:.1f}")
    if gap > DRYRUN_ARG_RTOL:
        fail(f"dryrun-card: predicted argument bytes {predicted} against {measured} allocated "
             f"({gap:.3g} > {DRYRUN_ARG_RTOL})")


def dryrun_phase(child, path: Path) -> None:
    """[dryrun]: the CPU process's dry run of ``DRYRUN_CELLS`` on the 16 x 16
    mesh (a fake world of 256, no card), a line a cell, the three roofline
    terms against the H100's record; every cell OK but the skipped one."""
    try:
        child.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        fail(f"dryrun: the CPU process did not end in {DRYRUN_TIMEOUT_S} s")
    if child.returncode != 0 or not path.exists():
        fail(f"dryrun: the CPU process exited {child.returncode}")
    out = json.loads(path.read_text())
    for rec in out["cells"]:
        cell = (rec["arch"], rec["shape"])
        want = "SKIP" if cell in DRYRUN_SKIPPED else "OK"
        if rec["status"] != "OK":
            phase("dryrun", arch=cell[0], shape=cell[1], mesh=rec["mesh"],
                  status=rec["status"], why=f"'{rec.get('reason') or rec.get('error')}'")
        else:
            phase("dryrun", arch=cell[0], shape=cell[1], mesh=rec["mesh"], status="OK",
                  kind=rec["kind"], fsdp=rec["fsdp"],
                  argument_bytes_per_device=rec["argument_bytes_per_device"],
                  temp_bytes_per_device=rec["temp_bytes_per_device"],
                  flops_per_device=f"{rec['flops_per_device']:.6g}",
                  collective_bytes_per_device=f"{rec['collective_bytes_per_device']:.6g}",
                  compute_s=f"{rec['compute_s']:.6g}", memory_s=f"{rec['memory_s']:.6g}",
                  collective_s=f"{rec['collective_s']:.6g}", bottleneck=rec["bottleneck"],
                  useful_ratio=f"{rec['useful_ratio']:.4f}", trace_s=rec["trace_s"])
        if rec["status"] != want:
            fail(f"dryrun: {cell} is {rec['status']}, expected {want}")
    if [(r["arch"], r["shape"]) for r in out["cells"]] != list(DRYRUN_CELLS):
        fail("dryrun: the CPU process did not report every cell")
    phase("dryrun", cells=len(out["cells"]), wall_s=f"{out['seconds']:.1f}")


def cpu_dryrun(path: Path) -> int:
    """[dryrun]'s cells in a fake world of 256 on the host CPU, written to
    ``path`` as JSON."""
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cells = dryrun.run_cells(DRYRUN_CELLS, [False], None, probe=False)
    path.write_text(json.dumps({"cells": cells, "seconds": time.perf_counter() - t0},
                               default=str))
    return 0


def train_phases(dev: torch.device, records: dict) -> None:
    """The training path on the card, with the CPU process that [train-arch]
    holds the card against started first, beside the card's work."""
    ref_path = ROOT / "build" / "chip_smoke_cpu_train_reference.json"
    ref_path.parent.mkdir(exist_ok=True)
    ref_path.unlink(missing_ok=True)
    ep_path(ref_path).unlink(missing_ok=True)
    dry_path = ROOT / "build" / "chip_smoke_dryrun.json"
    dry_path.unlink(missing_ok=True)
    cpu_env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                              "--cpu-train-reference", str(ref_path)], env=cpu_env)
    procs = [child]
    try:
        train_hold_phase(dev)
        torch.cuda.empty_cache()
        plain_run = train_phase(dev, records)
        torch.cuda.empty_cache()
        dryrun_card_phase(dev, plain_run)
        mesh_train_phase(dev, records, plain_run)
        torch.cuda.empty_cache()
        # [dryrun]'s process starts after the timed training phases: its CPU
        # work would slow their host-bound steps
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                       "--dryrun", str(dry_path)], env=cpu_env))
        ep_shards_phase(dev, ref_path, child)
        train_arch_phase(dev, child, ref_path)
        train_resume_phase(dev)
        dryrun_phase(procs[1], dry_path)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def cpu_train_reference(path: Path) -> int:
    """[train-arch]'s runs on the host CPU, written to ``path`` as JSON."""
    torch.set_num_threads(2)
    out = train_arch_losses(torch.device("cpu"))
    cfg, p, x = ep_inputs(torch.device("cpu"))
    torch.save(ep_sum(p, cfg, x, EP_SIZES[-1]), ep_path(path))
    out["seconds"] = time.perf_counter() - T_START
    path.write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-reference"]:
        sys.exit(cpu_reference(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--cpu-train-reference"]:
        sys.exit(cpu_train_reference(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--dryrun"]:
        sys.exit(cpu_dryrun(Path(sys.argv[2])))
    sys.exit(main())
