"""qwen3-14b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

Assigned: 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=256)
