"""Architecture registry of the port.

The reference's ten architectures, in its order; ``launch/serve.py`` serves
every one of them. ``dcsim.capability``'s ``llm`` workload also sizes its
model families from them with ``ModelConfig.param_count``.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

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
