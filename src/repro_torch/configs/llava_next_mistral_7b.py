"""llava-next-mistral-7b — anyres tiling [hf:llava-hf/...; unverified].

Assigned: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.  The
vision tower + anyres tiling is a STUB: input_specs() provides precomputed
patch embeddings (B, n_patches=1152, d_model) prepended to the text stream;
loss is masked to text positions.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    frontend="vision_stub",
    n_patches=1152,
    rope_theta=1e6,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=256, n_patches=8)
