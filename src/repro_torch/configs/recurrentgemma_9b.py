"""recurrentgemma-9b [hybrid]: RG-LRU + local attention 1:2 (arXiv:2402.19427).

Period-3 pattern (recur, recur, attn); local attention window 2048, MQA
(kv=1, head_dim 256); GeGLU MLP; embeddings scaled by sqrt(d). The RG-LRU
state is O(1) and the attention KV cache is window-bounded -> long_500k runs.
"""
from .base import ATTN, RECUR, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    attn_window=2048,
    act="geglu",
    block_pattern=(RECUR, RECUR, ATTN),
    lru_width=4096,
    tie_embeddings=True,
    scan_layers=False,
)
