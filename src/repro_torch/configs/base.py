"""Model configuration dataclass (a copy of ``repro.configs.base``).

The port keeps its own copy so that it imports nothing of ``repro``. Every
field is kept, so ``dataclasses.replace`` takes the same arguments in both
packages. ``param_count`` sizes the ``llm`` workload's model families
(``dcsim.capability``). ``SHAPES`` and ``shape_applicable`` are the dry
run's input-shape cells (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

ATTN = "attn"  # full / local self attention block
MLSTM = "mlstm"  # xLSTM matrix-memory block
SLSTM = "slstm"  # xLSTM scalar-memory block
RECUR = "recur"  # RG-LRU (Griffin) recurrent block


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    # -- core dims ---------------------------------------------------------
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # -- attention ---------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_mode: str = "rope"  # rope | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    attn_window: int = 0  # 0 = full attention; >0 = sliding window
    attn_logit_softcap: float = 0.0
    # -- ffn ---------------------------------------------------------------
    act: str = "silu"  # silu (SwiGLU) | gelu (plain MLP)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    # -- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    moe_dense_residual: bool = False
    moe_dense_d_ff: int = 0
    router_aux_loss: float = 0.0
    moe_impl: str = "gather"
    # -- encoder/decoder ---------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500
    # -- hybrid / ssm ------------------------------------------------------
    block_pattern: Tuple[str, ...] = ()  # () -> all ATTN; else tiled to depth
    lru_width: int = 0
    conv_width: int = 4
    # -- vlm / audio stub frontends ----------------------------------------
    frontend: str = "none"  # none | audio_stub | vision_stub
    # -- embeddings --------------------------------------------------------
    tie_embeddings: bool = True
    # -- numerics ----------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # -- training ----------------------------------------------------------
    remat: str = "full"
    scan_layers: bool = True
    act_shard: str = "none"

    # -- derived -----------------------------------------------------------
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def q_dim(self) -> int:
        return self.num_heads * self.hd()

    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd()

    def pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds, tiled to ``num_layers``."""
        if not self.block_pattern:
            return (ATTN,) * self.num_layers
        p = self.block_pattern
        reps = (self.num_layers + len(p) - 1) // len(p)
        return (p * reps)[: self.num_layers]

    def pattern_period(self) -> Tuple[str, ...]:
        return self.block_pattern if self.block_pattern else (ATTN,)

    def is_subquadratic(self) -> bool:
        """True if the arch can decode at 0.5M context (no full-attn KV)."""
        kinds = set(self.pattern())
        if ATTN in kinds and self.attn_window == 0:
            return False
        if self.is_encoder_decoder:
            return False
        return True

    def has_decode(self) -> bool:
        """Encoder-only models have no decode step. All ours decode."""
        return True

    # -- param counting (for roofline MODEL_FLOPS = 6*N*D) --------------------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.hd()
        qd, kvd = self.q_dim(), self.kv_dim()
        embed = self.vocab_size * d
        unembed = 0 if self.tie_embeddings else self.vocab_size * d

        def attn_block() -> int:
            n = d * qd + 2 * d * kvd + qd * d
            if self.qkv_bias:
                n += qd + 2 * kvd
            return n + 2 * d  # 2 norms approx

        def ffn(dff: int) -> int:
            if dff == 0:
                return 0
            if self.act == "silu":
                return 3 * d * dff
            return 2 * d * dff

        def moe_block() -> int:
            n = d * self.num_experts  # router
            e = self.num_experts if not active_only else self.num_experts_per_tok
            n += e * ffn(self.d_ff)
            n += self.num_shared_experts * ffn(self.shared_d_ff or self.d_ff)
            if self.moe_dense_residual:
                n += ffn(self.moe_dense_d_ff or self.d_ff)
            return n

        def mlstm_block() -> int:
            # up-proj x2, q/k/v over inner dim, gates, out-proj (pf = 2)
            inner = 2 * d
            return 2 * d * inner + 3 * inner * inner // 2 + inner * d + 4 * inner

        def slstm_block() -> int:
            # 4 gates, recurrent + input weights, ffn-ish projection (pf 4/3)
            return 8 * d * d + int(2 * 4 / 3 * d * d)

        def recur_block() -> int:
            w = self.lru_width or d
            return 2 * d * w + w * d + self.conv_width * w + 2 * w * w + 2 * w

        total = embed + unembed + d  # final norm
        for kind in self.pattern():
            if kind == ATTN:
                total += attn_block()
                if self.num_experts:
                    total += moe_block()
                else:
                    total += ffn(self.d_ff)
            elif kind == MLSTM:
                total += mlstm_block()
            elif kind == SLSTM:
                total += slstm_block()
            elif kind == RECUR:
                total += recur_block() + ffn(self.d_ff)
        if self.is_encoder_decoder:
            for _ in range(self.num_encoder_layers):
                total += attn_block() + ffn(self.d_ff)
            # decoder cross attention
            total += self.num_layers * attn_block()
        return int(total)

    # -- reduced variant for CPU smoke tests -------------------------------
    def smoke(self) -> "ModelConfig":
        d = 64
        n_heads = min(self.num_heads, 4)
        n_kv = min(self.num_kv_heads, n_heads)
        period = self.pattern_period()
        layers = max(2, len(period))
        updates: Dict[str, Any] = dict(
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=d,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            encoder_seq=16,
            num_encoder_layers=2 if self.is_encoder_decoder else 0,
            lru_width=0,
            attn_window=min(self.attn_window, 8) if self.attn_window else 0,
            mrope_sections=(2, 3, 3),
            dtype="float32",
            param_dtype="float32",
            remat="none",
        )
        if self.num_experts:
            updates.update(
                num_experts=8,
                num_experts_per_tok=min(self.num_experts_per_tok, 2),
                num_shared_experts=min(self.num_shared_experts, 2),
                shared_d_ff=128 if self.shared_d_ff else 0,
                moe_dense_d_ff=128 if self.moe_dense_residual else 0,
            )
        return dataclasses.replace(self, **updates)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and the reason when skipped."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, "full quadratic attention: 0.5M-token decode skipped per assignment"
    return True, ""
