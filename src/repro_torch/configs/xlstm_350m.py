"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

Assigned: 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0 means
the blocks carry their own internal up/down projections (no separate FFN);
the pattern alternates mLSTM (matrix memory, chunk-scannable) and sLSTM
(scalar memory, strictly recurrent) blocks.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern="xs",          # mLSTM / sLSTM alternating
    ssm=SSMConfig(state_dim=64, head_dim=256, n_groups=1, expand=2, chunk=64),
    sub_quadratic=True,
    tie_embeddings=True,
    source="arXiv:2405.04517",
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                      vocab_size=256,
                      ssm=SSMConfig(state_dim=8, head_dim=16, expand=2, chunk=8))
