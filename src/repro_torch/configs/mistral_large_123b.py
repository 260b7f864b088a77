"""mistral-large-123b [dense] (hf:mistralai/Mistral-Large-Instruct-2407)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1e6,
    tie_embeddings=False,
    act_shard="seq",
)
