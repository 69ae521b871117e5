"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

Assigned: 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936,
MoE 128e top-8.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=32, vocab_size=256,
                      moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32))
