"""whisper-tiny — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

Assigned: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.  The conv/mel
frontend is a STUB: input_specs() provides precomputed frame embeddings
(B, 1500, d_model); the backbone is the 4+4-layer encoder-decoder.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                  # decoder layers
    encoder_layers=4,
    encoder_seq=1500,
    cross_attention=True,
    frontend="audio_stub",
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    rope_theta=1e4,
    tie_embeddings=True,
    source="arXiv:2212.04356",
)

SMOKE = CONFIG.scaled(n_layers=2, encoder_layers=2, encoder_seq=32,
                      d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                      vocab_size=256)
