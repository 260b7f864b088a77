"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed top-4 (hf:Qwen/Qwen1.5-MoE-A2.7B)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    num_experts=60,
    num_experts_per_tok=4,
    num_shared_experts=4,
    shared_d_ff=1408,
    router_aux_loss=0.001,
    tie_embeddings=False,
    moe_impl="ep",
    act_shard="seq",
)
