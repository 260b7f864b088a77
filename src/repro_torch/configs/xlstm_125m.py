"""xlstm-125m [ssm]: sLSTM + mLSTM blocks (arXiv:2405.04517).

12 layers at ratio ~7:1 mLSTM:sLSTM (period-8 pattern, sLSTM at index 7).
d_ff=0 per the assignment: xLSTM blocks carry their own up/down projections.
The mLSTM matrix memory is O(1) in sequence length -> long_500k runs.
"""
from .base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope_mode="none",
    block_pattern=(MLSTM,) * 7 + (SLSTM,),
    tie_embeddings=True,
    scan_layers=False,
)
