"""minicpm3-4b — MLA [hf:openbmb/MiniCPM3-4B; hf].

Assigned: 62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448.  Multi-head
Latent Attention with the HF config's low-rank dims: q_lora 768, kv_lora 256,
qk nope/rope head dims 64/32, v_head_dim 64.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    rope_theta=1e4,
    source="hf:openbmb/MiniCPM3-4B",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab_size=256, q_lora_rank=32,
                      kv_lora_rank=16, qk_nope_head_dim=8,
                      qk_rope_head_dim=8, v_head_dim=8)
