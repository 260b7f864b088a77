"""Pluggable workload capability layer: what can each DC serve, and at what
power/latency?

A copy of ``repro.dcsim.capability`` (host-side numpy). The ``llm`` families
are sized by the port's own ``configs`` (``ModelConfig.param_count``) and the
reference chip constants of ``launch/roofline.py``; the bundles equal the
JAX package's (``tests/test_torch_dcsim.py``).

``build_env`` used to hard-wire the AIBench constants (``topology.TASK_TYPES``
execution times through ``colocation.er_table`` + ``power.node_power_arrays``).
This module extracts that derivation behind a ``WorkloadModel`` interface so
the task-type axis ``I`` and the per-(task, DC) capability numbers become a
pluggable implementation choice:

- ``"aibench"`` (the default): the paper's ten AIBench task types on the
  heterogeneous Xeon fleet — an exact, bit-for-bit mirror of the pre-layer
  ``build_env`` ops.
- ``"llm"``: task classes are model *families* from the ``configs/`` model
  zoo; each DC's tasks/h, W, and ms are **derived** from the roofline
  constants in ``launch/roofline.py`` applied to that DC's accelerator mix
  (``topology.ACCEL_TYPES`` / ``accel_mix``) — compute/memory/collective
  bottleneck terms → tokens/sec/chip, idle+dynamic node power → J/token,
  with per-family prompt/output token-length statistics and a KV-cache
  occupancy batching factor. No hand-set per-task execution-time constants
  exist on this path; the only constants are hardware specs (FLOP/s, bytes/s,
  GiB, W) and workload statistics (token lengths, target batch).

A ``WorkloadModel`` produces a :class:`CapabilityBundle` — the
``(er, node power, sizes, sla_ms)`` bundle ``env.build_env`` consumes; the
solvers never see any of this (they only see ``EnvParams``), which is why all
six techniques run unchanged on derived envs of any ``I``.

Registering a custom model::

    class MyWorkload:
        name = "mine"
        def capabilities(self, num_dcs, seed):
            return CapabilityBundle(...)

    capability.register_workload("mine", MyWorkload)
    env = E.build_env(4, workload="mine")       # or workload=MyWorkload()
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Tuple, Union

import numpy as np

from . import colocation, latency, power, topology
from ..units import BYTES_PER_FP32_TOKEN, BYTES_PER_GB, BYTES_PER_GIB, S_PER_H

__all__ = [
    "CapabilityBundle", "WorkloadModel", "ServingProfile",
    "AIBenchWorkload", "LLMWorkload", "LLM_FAMILIES",
    "register_workload", "get_workload", "workload_names", "resolve",
]


class CapabilityBundle(NamedTuple):
    """Everything ``build_env`` needs to know about a fleet's serving ability.

    Fields (np arrays; D = num DCs, I = task types / model families):

    ==============  =========  ====================================================
    field           shape      units
    ==============  =========  ====================================================
    task_names      (I,) tup   task-type / model-family labels
    er              (I, D)     execution rate, tasks/h at full allocation
    it_idle         (D,)       fleet idle IT power, W
    it_dyn          (D,)       fleet peak dynamic IT power, W
    nn_total        (D,)       node count per DC (M/M/c server count proxy)
    sizes           (I,)       per-task network payload, GB
    sla_ms          (I,)       default SLA latency target, ms
    meta            dict       model-specific extras (llm: tokens/s/chip,
                               J/token, batch, chips per instance, bottleneck)
    ==============  =========  ====================================================

    Machine-read unit table (repro_torch.lint.units):

        task_names: -
        er: task/h
        it_idle: W
        it_dyn: W
        nn_total: node
        sizes: GB/task
        sla_ms: ms
        meta: -
    """

    task_names: Tuple[str, ...]
    er: np.ndarray
    it_idle: np.ndarray
    it_dyn: np.ndarray
    nn_total: np.ndarray
    sizes: np.ndarray
    sla_ms: np.ndarray
    meta: Dict


class WorkloadModel:
    """Interface: a named producer of :class:`CapabilityBundle`.

    Implementations must be deterministic in ``(num_dcs, seed)`` — the same
    arguments must yield the same bundle, because the bundle feeds the
    bit-for-bit-pinned ``EnvParams`` construction.
    """

    name: str = "abstract"

    def capabilities(self, num_dcs: int, seed: int) -> CapabilityBundle:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# aibench: the paper's constants, extracted verbatim
# ---------------------------------------------------------------------------

class AIBenchWorkload(WorkloadModel):
    """The paper's AIBench task types on the heterogeneous Xeon fleet.

    An exact transplant of the capability ops ``build_env`` ran before this
    layer existed — same calls, same order, same seeds — so the default
    ``build_env(workload="aibench")`` is bit-for-bit the pre-layer env
    (pinned in the JAX package by ``test_capability.py::test_aibench_pin``).

    ``include_tpu`` is aibench-specific: it carves a TPU aisle out of the
    Xeon mix (the pre-layer ``build_env(include_tpu=True)`` path).
    """

    name = "aibench"

    def __init__(self, include_tpu: bool = False):
        self.include_tpu = include_tpu

    def capabilities(self, num_dcs: int, seed: int) -> CapabilityBundle:
        nn = topology.node_mix(seed, num_dcs, include_tpu=self.include_tpu)
        er = colocation.er_table(nn)
        idle, dyn = power.node_power_arrays(nn.shape[1])
        nn_total = nn.sum(axis=1).astype(float)
        sizes = np.array([t[2] for t in topology.TASK_TYPES])
        sla_ms = latency.default_sla_ms(er, nn_total)
        names = tuple(t[0] for t in topology.TASK_TYPES)
        return CapabilityBundle(
            task_names=names, er=np.asarray(er), it_idle=nn @ idle,
            it_dyn=nn @ dyn, nn_total=nn_total, sizes=sizes, sla_ms=sla_ms,
            meta={"nn": nn},
        )


# ---------------------------------------------------------------------------
# llm: model-zoo families on the accelerator fleet, derived from the roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingProfile:
    """Workload *statistics* for one served model family (request shapes —
    not execution times; those are derived).

    Machine-read unit table (repro_torch.lint.units):

        arch: -
        prompt_mean: token/task
        output_mean: token/task
        batch_target: 1
        extra_payload_gb: GB/task
    """

    arch: str              # configs/ model-zoo name
    prompt_mean: int       # mean prompt length, tokens
    output_mean: int       # mean output length, tokens
    batch_target: int      # serving batch ceiling (KV capacity may bind first)
    extra_payload_gb: float = 0.0  # non-text payload (audio/video), GB


# family -> profile. Six families (deliberately != the aibench I=10: the
# task-type axis is data-driven, exercised by the I!=5 engine smoke).
LLM_FAMILIES: Tuple[Tuple[str, ServingProfile], ...] = (
    ("chat-1b", ServingProfile("llama3.2-1b", 512, 256, 64)),
    ("chat-7b", ServingProfile("qwen2-7b", 1024, 512, 32)),
    ("moe-light", ServingProfile("qwen2-moe-a2.7b", 1024, 512, 32)),
    ("dense-large", ServingProfile("mistral-large-123b", 2048, 1024, 16)),
    ("moe-480b", ServingProfile("arctic-480b", 2048, 1024, 16)),
    ("audio-asr", ServingProfile("whisper-base", 1500, 180, 48,
                                 extra_payload_gb=0.002)),
)

_DTYPE_BYTES = 2  # bf16 weights and KV cache


def _family_on_accel(profile: ServingProfile, acc: "topology.AccelType"):
    """Derive one (family, accelerator) cell from the roofline.

    Returns ``(tasks_per_h_per_node, tokens_per_s_chip, j_per_token,
    n_chips, bottleneck)``. Pure arithmetic over the ModelConfig and the
    accelerator's hardware spec — the same compute/memory/collective
    bottleneck decomposition as the JAX package's ``roofline.analyze``, applied analytically
    (decode is one token across batch B; prefill is one compute-bound pass
    over the prompt).
    """
    from ..configs import get_config

    cfg = get_config(profile.arch)
    total_b = cfg.param_count() * _DTYPE_BYTES
    active = cfg.param_count(active_only=True)
    hbm_b = acc.hbm_gb * BYTES_PER_GIB

    # chips per model instance: weights must fit in aggregate HBM
    n_chips = max(1, math.ceil(total_b / hbm_b))

    # mean live context per sequence (prompt + half the output, windowed)
    ctx = profile.prompt_mean + profile.output_mean / 2.0
    if cfg.attn_window:
        ctx = min(ctx, float(cfg.attn_window))

    # KV bytes/token: K and V per attention layer (subquadratic blocks carry
    # fixed-size state instead — no per-token growth)
    n_attn = sum(1 for k in cfg.pattern() if k == "attn")
    kv_per_tok = 2 * cfg.kv_dim() * _DTYPE_BYTES * n_attn
    kv_per_seq = kv_per_tok * ctx

    # batch: KV-cache occupancy of the HBM left after weights, capped by the
    # serving target
    free_b = n_chips * hbm_b - total_b
    b = int(np.clip(free_b // max(kv_per_seq, 1.0), 1, profile.batch_target))

    # decode step (one token for each of B sequences), roofline terms:
    flops = 2.0 * active * b                       # matmul FLOPs
    byts = total_b + b * kv_per_seq                # weights + KV streamed
    coll = (b * 4.0 * cfg.d_model * _DTYPE_BYTES * cfg.num_layers
            * (n_chips - 1) / max(n_chips, 1))     # activation all-reduce
    terms = {
        "compute": flops / (n_chips * acc.peak_flops),
        "memory": byts / (n_chips * acc.hbm_bw),
        "collective": coll / acc.ici_bw,
    }
    bottleneck = max(terms, key=terms.get)
    t_step = terms[bottleneck]

    chips_per_node = acc.chips
    tokens_per_s_chip = b / (t_step * n_chips)

    # prefill: one compute-bound pass over the prompt (memory floor: stream
    # the weights once)
    prefill_s = max(2.0 * active * profile.prompt_mean / (n_chips * acc.peak_flops),
                    total_b / (n_chips * acc.hbm_bw))
    req_s = prefill_s + profile.output_mean * t_step / b   # per request
    tasks_per_h_chip = S_PER_H / (req_s * n_chips)
    tasks_per_h_node = tasks_per_h_chip * chips_per_node

    # energy attribution: a chip's dynamic draw divided by its token rate —
    # tokens/s/chip x J/token == dynamic W/chip by construction (the
    # unit-consistency test)
    j_per_token = (acc.dyn_w / chips_per_node) / tokens_per_s_chip
    return tasks_per_h_node, tokens_per_s_chip, j_per_token, n_chips, bottleneck


class LLMWorkload(WorkloadModel):
    """Token-grounded LLM serving: families = model-zoo archs, capability
    derived from the roofline on each DC's accelerator mix.

    ``er[f, d] = sum_a tasks_per_h_per_node[f, a] * accel_mix[d, a]`` — the
    aggregate request rate if the whole fleet served family ``f``; the
    existing M/M/c latency model consumes it unchanged (service time in
    token units: ``3.6e6 / er`` ms/request = prefill + output tokens /
    token rate).
    """

    name = "llm"

    def __init__(self, families: Tuple[Tuple[str, ServingProfile], ...] = LLM_FAMILIES,
                 accel_types: Tuple["topology.AccelType", ...] | None = None):
        self.families = tuple(families)
        self.accel_types = tuple(accel_types if accel_types is not None
                                 else topology.ACCEL_TYPES)

    def capabilities(self, num_dcs: int, seed: int) -> CapabilityBundle:
        accs = self.accel_types
        nn = topology.accel_mix(seed, num_dcs, num_accel_types=len(accs))
        i, a = len(self.families), len(accs)

        tasks_h_node = np.zeros((i, a))
        tok_s_chip = np.zeros((i, a))
        j_tok = np.zeros((i, a))
        chips = np.zeros((i, a), np.int64)
        bneck = np.empty((i, a), object)
        for fi, (_, prof) in enumerate(self.families):
            for ai, acc in enumerate(accs):
                (tasks_h_node[fi, ai], tok_s_chip[fi, ai], j_tok[fi, ai],
                 chips[fi, ai], bneck[fi, ai]) = _family_on_accel(prof, acc)

        er = tasks_h_node @ nn.T.astype(float)           # (I, D) tasks/h
        idle = np.array([acc.idle_w for acc in accs])
        dyn = np.array([acc.dyn_w for acc in accs])
        nn_total = nn.sum(axis=1).astype(float)
        sizes = np.array([
            (p.prompt_mean + p.output_mean) * BYTES_PER_FP32_TOKEN / BYTES_PER_GB
            + p.extra_payload_gb
            for _, p in self.families])                  # ~4 B/token text
        sla_ms = latency.default_sla_ms(er, nn_total)
        return CapabilityBundle(
            task_names=tuple(n for n, _ in self.families),
            er=er, it_idle=nn @ idle, it_dyn=nn @ dyn, nn_total=nn_total,
            sizes=sizes, sla_ms=sla_ms,
            meta={"nn": nn, "tokens_per_s_chip": tok_s_chip,
                  "j_per_token": j_tok, "n_chips": chips,
                  "bottleneck": bneck, "tasks_per_h_node": tasks_h_node,
                  "accel_names": tuple(acc.name for acc in accs)},
        )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], WorkloadModel]] = {}


def register_workload(name: str, factory: Callable[[], WorkloadModel]) -> None:
    """Register a zero-arg factory (usually the class) under ``name``."""
    _REGISTRY[name] = factory


def workload_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_workload(name: str) -> WorkloadModel:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown workload {name!r}; registered: {workload_names()}")
    return _REGISTRY[name]()


def resolve(workload: Union[str, WorkloadModel], *,
            include_tpu: bool = False) -> WorkloadModel:
    """Name or instance -> WorkloadModel.

    ``include_tpu`` only applies to ``"aibench"`` (the pre-layer carve-out
    flag); passing it with any other name raises so a silently-ignored flag
    can't masquerade as a TPU-aware llm fleet.
    """
    if isinstance(workload, WorkloadModel):
        if include_tpu:
            raise ValueError("include_tpu only applies to workload='aibench'")
        return workload
    if workload == "aibench":
        return AIBenchWorkload(include_tpu=include_tpu)
    if include_tpu:
        raise ValueError("include_tpu only applies to workload='aibench'")
    return get_workload(workload)


register_workload("aibench", AIBenchWorkload)
register_workload("llm", LLMWorkload)
