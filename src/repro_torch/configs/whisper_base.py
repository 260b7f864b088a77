"""whisper-base [audio]: enc-dec transformer backbone (arXiv:2212.04356).

Conv audio frontend is a stub: a batch's ``frames`` are the (B, 1500, 512) frame
embeddings. 6L encoder + 6L decoder, MHA (kv=8), LayerNorm + GELU.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    qkv_bias=True,
    rope_mode="none",
    act="gelu",
    norm="layernorm",
    is_encoder_decoder=True,
    num_encoder_layers=6,
    encoder_seq=1500,
    frontend="audio_stub",
    tie_embeddings=True,
    scan_layers=False,
)
