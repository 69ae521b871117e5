"""qwen3-32b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

Assigned: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
Qwen3 uses explicit head_dim=128 and RMS qk-norm per head.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=256)
