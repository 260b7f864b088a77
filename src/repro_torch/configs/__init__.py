"""Architecture registry of the port, and the dry run's input specs.

The reference's ten architectures, in its order; ``launch/serve.py`` serves
every one of them. ``dcsim.capability``'s ``llm`` workload also sizes its
model families from them with ``ModelConfig.param_count``.

``input_specs(cfg, shape)`` returns (step_kind, specs) for the step function
a dry-run cell traces (``launch/dryrun.py``): ``train_step`` /
``prefill_step`` for train/prefill kinds, ``decode_step`` (one token + the
full cache tree) for decode kinds. Where the reference returns
``jax.ShapeDtypeStruct``s from ``jax.eval_shape``, the port returns tensors
on the ``meta`` device: shapes and dtypes, no memory. A cache's ``pos`` is
the port's Python int, where the reference's is an int32 scalar.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Tuple

import torch

from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable  # noqa: F401

_ARCH_MODULES = {
    "whisper-base": "whisper_base",
    "qwen2-7b": "qwen2_7b",
    "mistral-large-123b": "mistral_large_123b",
    "llama3.2-1b": "llama3_2_1b",
    "llama3.2-3b": "llama3_2_3b",
    "xlstm-125m": "xlstm_125m",
    "arctic-480b": "arctic_480b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}
ARCHS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f".{_ARCH_MODULES[name]}", __package__)
    return mod.CONFIG


def _f(shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _i(shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


VISION_TOKENS = 1024  # stub patch-embedding span for the vlm family


def batch_specs(cfg: ModelConfig, b: int, s: int, with_labels: bool) -> Dict[str, Any]:
    """Model-input specs for a full-sequence (train / prefill) pass."""
    specs: Dict[str, Any] = {"tokens": _i((b, s))}
    if with_labels:
        specs["labels"] = _i((b, s))
    if cfg.is_encoder_decoder:
        specs["frames"] = _f((b, cfg.encoder_seq, cfg.d_model))
    if cfg.rope_mode == "mrope":
        specs["positions"] = _i((b, s, 3))
    if cfg.frontend == "vision_stub":
        specs["vision_embeds"] = _f((b, min(VISION_TOKENS, s), cfg.d_model))
    return specs


def cache_specs(cfg: ModelConfig, b: int, cache_len: int):
    """Decode-cache specs (``models.model.init_cache`` on the meta device)."""
    from ..models import model as model_lib
    from ..models.layers import DTYPES

    if cfg.is_encoder_decoder:
        enc_out = torch.empty((b, cfg.encoder_seq, cfg.d_model), dtype=DTYPES[cfg.dtype],
                              device="meta")
        return model_lib.init_cache(param_specs_struct(cfg), cfg, b, cache_len, enc_out,
                                    device="meta")
    return model_lib.init_cache({}, cfg, b, cache_len, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[str, Dict[str, Any]]:
    """(step_kind, specs) for one (arch x shape) cell."""
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} × {shape.name} skipped: {why}")
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return "train", {"batch": batch_specs(cfg, b, s, with_labels=True)}
    if shape.kind == "prefill":
        return "prefill", {"batch": batch_specs(cfg, b, s, with_labels=False)}
    # decode: one token against a cache of seq_len positions
    specs: Dict[str, Any] = {
        "token": _i((b, 1)),
        "positions": _i((b, 1, 3)) if cfg.rope_mode == "mrope" else _i((b, 1)),
        "cache": cache_specs(cfg, b, s),
    }
    return "decode", specs


def param_specs_struct(cfg: ModelConfig):
    """The parameter tree ``models.model.init`` builds, leaf for leaf, as
    meta tensors: ``init`` runs under ``FakeTensorMode``, so nothing is
    allocated or drawn."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import model as model_lib
    from ..tree import tree_map

    with FakeTensorMode():
        fake = model_lib.init(cfg, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def all_cells():
    """Every (arch, shape) cell with its applicability."""
    out = []
    for a in ARCHS:
        cfg = get_config(a)
        for sname, shp in SHAPES.items():
            ok, why = shape_applicable(cfg, shp)
            out.append((a, sname, ok, why))
    return out
