"""Tiny cells for the CPU tests: the two configurations' layers at the
port's smoke widths (``cfg.smoke()``, bf16 as served, two kv heads for the
dense one so that GQA stays), a small closed-loop mix, the real cells'
limits."""
import dataclasses
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT / "src") not in sys.path:
    sys.path.insert(0, str(CHECKOUT / "src"))

from portbench import harness  # noqa: E402

COMMON = {"arch": "qwen2", "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
          "head_dim": 16, "vocab_size": 256, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
          "qkv_bias": True, "tie_word_embeddings": False, "hidden_act": "silu",
          "torch_dtype": "bfloat16"}
CONFIGS = {
    "qwen2-7b": dict(COMMON, port_arch="qwen2-7b", num_key_value_heads=2,
                     intermediate_size=128),
    "qwen2-moe-a2.7b": dict(COMMON, port_arch="qwen2-moe-a2.7b", num_key_value_heads=4,
                            num_experts=8, num_experts_per_tok=2, moe_intermediate_size=128,
                            shared_expert_intermediate_size=256, norm_topk_prob=False,
                            as_served={"norm_topk_prob": True, "shared_expert_gate": False,
                                       "capacity_factor": {"prefill": 1.25, "decode": 2.0},
                                       "router_dtype": "float32"}),
}
CELLS = {"qwen2-7b": "qwen2-7b.rag", "qwen2-moe-a2.7b": "qwen2-moe-a2.7b.rag"}
MIX = {"batch": 4, "cache_len": 64,
       "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 40},
       "output": {"dist": "lognormal", "median": 4, "sigma": 0.5, "min": 1, "max": 12},
       "trace_batches": 1}
SERVED_TOKENS = 16  # the tokens a tiny run's check reads at least


def port_cfg(arch: str, dtype: str = "bfloat16"):
    from repro_torch.configs import get_config

    cfg = get_config(arch).smoke()
    cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    if arch == "qwen2-7b":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    return cfg


def cell(arch: str, served_tokens: int = SERVED_TOKENS, **mix) -> harness.Cell:
    limit = json.loads((CHECKOUT / "portbench" / "limits" / f"{CELLS[arch]}.json").read_text())
    limit["served_tokens"] = served_tokens
    return harness.Cell(name=f"tiny-{arch}", chips=1, config=dict(CONFIGS[arch]),
                        mix=dict(MIX, **mix), limit=limit,
                        end_to_end=[{"name": "tokens_per_s", "unit": "tokens/s"},
                                    {"name": "setup_s", "unit": "s"}], per_layer=[])


# deeper and wider, with longer answers, for the control: its float8
# rounding has to build up over layers as it does at the cells' sizes
DEEP = {"qwen2-7b": (6, 128), "qwen2-moe-a2.7b": (12, 128)}
LONGER = {"output": {"dist": "lognormal", "median": 10, "sigma": 0.5, "min": 2, "max": 20}}


def run(arch: str, seed: int = 5, deep: bool = False, **kw):
    """A whole run of the tiny cell on the CPU, on one host thread (the test
    workers share the machine's cores)."""
    import time

    import torch

    c, pc = cell(arch), port_cfg(arch)
    if deep:
        layers, d = DEEP[arch]
        c = cell(arch, served_tokens=40, **LONGER)
        c.config = dict(c.config, num_hidden_layers=layers, hidden_size=d)
        pc = dataclasses.replace(pc, num_layers=layers, d_model=d)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run(c, seed, kw.pop("seconds", 0.0), False, t_start=time.perf_counter(),
                           device="cpu", port_cfg=pc, log=lambda msg: None, **kw)
    finally:
        torch.set_num_threads(threads)
