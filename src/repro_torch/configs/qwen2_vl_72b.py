"""qwen2-vl-72b [vlm]: M-RoPE backbone (arXiv:2409.12191).

Vision frontend is a stub: a batch's ``vision_embeds``, (B, 1024, d) patch
embeddings, overwrite the first 1024 token positions; M-RoPE position ids
come in as (B, S, 3) = (temporal, height, width) streams.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    rope_mode="mrope",
    mrope_sections=(16, 24, 24),
    frontend="vision_stub",
    tie_embeddings=False,
    act_shard="seq",
)
