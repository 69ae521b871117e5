"""internlm2-1.8b — GQA [arXiv:2403.17297; hf].

Assigned: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1e6,
    source="arXiv:2403.17297",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=256)
