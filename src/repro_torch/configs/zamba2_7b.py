"""zamba2-7b — Mamba2 + shared attn blocks [arXiv:2411.15242; unverified].

Assigned: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000 ssm_state=64.
Pattern: five Mamba2 blocks then one SHARED-weight attention+FFN block
("mmmmmA" tiled over 81 layers -> 13 shared-attn call sites reusing one
parameter set, Zamba's signature trick); sub-quadratic -> long_500k runs.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    block_pattern="mmmmmA",
    ssm=SSMConfig(state_dim=64, head_dim=64, n_groups=2, expand=2, chunk=64),
    sub_quadratic=True,
    rope_theta=1e4,
    source="arXiv:2411.15242",
)

SMOKE = CONFIG.scaled(n_layers=6, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab_size=256,
                      ssm=SSMConfig(state_dim=8, head_dim=16, n_groups=2,
                                    expand=2, chunk=8))
