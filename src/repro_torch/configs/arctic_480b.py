"""arctic-480b [moe]: 128 experts top-2 + dense residual (Snowflake Arctic)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    num_experts=128,
    num_experts_per_tok=2,
    moe_dense_residual=True,
    moe_dense_d_ff=4864,
    router_aux_loss=0.01,
    tie_embeddings=False,
    moe_impl="ep",
    act_shard="seq",
)
