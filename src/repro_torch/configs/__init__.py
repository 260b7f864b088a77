"""Architecture registry of the port.

The dense, MoE and hybrid language models are served (``launch/serve.py``):
llama3.2-1b, llama3.2-3b, qwen2-7b, qwen2-moe-a2.7b and recurrentgemma-9b.
whisper-base, mistral-large-123b and arctic-480b are here for
``dcsim.capability``'s ``llm`` workload, which sizes its families with
``ModelConfig.param_count``; ``models.model.init`` rejects what the model code
does not run yet (``transformer.check_supported``).
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

_ARCH_MODULES = {
    "whisper-base": "whisper_base",
    "qwen2-7b": "qwen2_7b",
    "mistral-large-123b": "mistral_large_123b",
    "llama3.2-1b": "llama3_2_1b",
    "arctic-480b": "arctic_480b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama3.2-3b": "llama3_2_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"arch {name!r} is not in the port; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f".{_ARCH_MODULES[name]}", __package__)
    return mod.CONFIG
