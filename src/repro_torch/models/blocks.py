"""Residual blocks keyed by pattern tokens (``repro.models.blocks``):

* ``a`` — pre-norm GQA attention + dense SwiGLU MLP;
* ``A`` — the same block with SHARED parameters across its call sites
  (zamba2);
* ``m`` — pre-norm Mamba-2.

Other tokens (mLSTM, sLSTM, encoder, cross-attention) and MLA/MoE wait.
"""

from __future__ import annotations

import torch

from . import attention as attn
from . import mlp as mlp_mod
from . import ssm
from .common import Init, rms_norm

__all__ = ["TOKENS", "check_supported", "init_block", "init_block_cache", "block_forward"]

TOKENS = ("a", "A", "m")


def check_supported(cfg, tok: str) -> None:
    if tok not in TOKENS:
        raise NotImplementedError(f"block token {tok!r} is not ported yet (ported: {TOKENS})")
    if tok in ("a", "A") and (cfg.attention != "gqa" or cfg.moe is not None):
        raise NotImplementedError("MLA and MoE blocks are not ported yet")


def init_block(init: Init, cfg, tok: str):
    check_supported(cfg, tok)
    ln = init.full((cfg.d_model,), 1.0, torch.float32)
    if tok == "m":
        return {"ln": ln, "mamba": ssm.init_mamba2(init, cfg)}
    return {"ln1": ln, "attn": attn.init_gqa(init, cfg),
            "ln2": init.full((cfg.d_model,), 1.0, torch.float32),
            "mlp": mlp_mod.init_mlp(init, cfg)}


def init_block_cache(init: Init, cfg, tok: str, batch: int, max_len: int):
    check_supported(cfg, tok)
    if tok == "m":
        return ssm.init_mamba2_cache(init, cfg, batch)
    return attn.init_gqa_cache(init, cfg, batch, max_len)


def block_forward(p, cfg, tok: str, x, positions, *, mode: str = "prefill", cache=None,
                  kv_len=None):
    """Apply one residual block.  Returns (x, new_cache)."""
    if tok == "m":
        out, nc = ssm.mamba2_forward(p["mamba"], cfg, rms_norm(x, p["ln"], cfg.norm_eps),
                                     mode=mode, cache=cache)
        return x + out, nc
    check_supported(cfg, tok)
    out, nc = attn.gqa_forward(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps), positions,
                               mode=mode, cache=cache, kv_len=kv_len)
    x = x + out
    x = x + mlp_mod.mlp_forward(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, nc
