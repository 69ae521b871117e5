"""kimi-k2-1t-a32b — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

Assigned: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840,
MoE 384 experts top-8.  Expert FF dim 2048 -> 61 x 384 x 3 x 7168 x 2048
~= 1.03e12 parameters, ~32B active per token (top-8 + attention).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,                    # = expert d_ff; all layers MoE
    vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048),
    rope_theta=1e6,
    source="arXiv:2501.kimi2",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=32, vocab_size=256,
                      moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32))
