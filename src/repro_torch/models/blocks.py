"""Residual blocks keyed by pattern tokens (``repro.models.blocks``):

* ``a`` — pre-norm attention (MLA when ``cfg.attention == "mla"``, else
  GQA) + MoE when ``cfg.moe`` is set, else the dense SwiGLU MLP;
* ``A`` — the same block with SHARED parameters across its call sites
  (zamba2);
* ``m`` — pre-norm Mamba-2;
* ``x`` — pre-norm mLSTM;
* ``s`` — pre-norm sLSTM;
* ``e`` — encoder block (bidirectional attention + SwiGLU MLP; whisper);
* ``c`` — decoder block with cross-attention to the encoder output
  (whisper): causal self-attention, cross-attention, MLP (``e`` and ``c``
  blocks are always GQA with a dense MLP).

``block_axes`` / ``block_cache_axes`` give each block's logical-sharding
trees, of the structure of its parameters and its cache.
"""

from __future__ import annotations

import torch

from . import attention as attn
from . import mlp as mlp_mod
from . import ssm
from .common import Init, constrain, dtype_of, rms_norm

# the residual stream's layout: each sublayer's output is reduced back to it
# before the add (a row-parallel product's partial sums, under DTensor)
_ACT = ("batch", "act_seq", "act_embed")

__all__ = ["TOKENS", "check_supported", "init_block", "block_axes", "init_block_cache",
           "block_cache_axes", "block_forward"]

TOKENS = ("a", "A", "m", "x", "s", "e", "c")


def _is_attn(tok: str) -> bool:
    return tok in ("a", "A", "e", "c")


def _use_mla(cfg, tok: str) -> bool:
    return cfg.attention == "mla" and tok in ("a", "A")


def _use_moe(cfg, tok: str) -> bool:
    return cfg.moe is not None and tok not in ("c", "e")


def check_supported(cfg, tok: str) -> None:
    if tok not in TOKENS:
        raise NotImplementedError(f"block token {tok!r} is not ported yet (ported: {TOKENS})")


def init_block(init: Init, cfg, tok: str):
    check_supported(cfg, tok)
    ln = init.full((cfg.d_model,), 1.0, torch.float32)
    if tok == "m":
        return {"ln": ln, "mamba": ssm.init_mamba2(init, cfg)}
    if tok == "x":
        return {"ln": ln, "mlstm": ssm.init_mlstm(init, cfg)}
    if tok == "s":
        return {"ln": ln, "slstm": ssm.init_slstm(init, cfg)}
    p = {"ln1": ln,
         "attn": attn.init_mla(init, cfg) if _use_mla(cfg, tok) else attn.init_gqa(init, cfg),
         "ln2": init.full((cfg.d_model,), 1.0, torch.float32),
         "mlp": mlp_mod.init_moe(init, cfg) if _use_moe(cfg, tok) else mlp_mod.init_mlp(init, cfg)}
    if tok == "c":
        p["ln_x"] = init.full((cfg.d_model,), 1.0, torch.float32)
        p["cross"] = attn.init_gqa(init, cfg)
    return p


def block_axes(cfg, tok: str):
    check_supported(cfg, tok)
    if tok == "m":
        return {"ln": (None,), "mamba": ssm.mamba2_axes(cfg)}
    if tok == "x":
        return {"ln": (None,), "mlstm": ssm.mlstm_axes(cfg)}
    if tok == "s":
        return {"ln": (None,), "slstm": ssm.slstm_axes(cfg)}
    ax = {"ln1": (None,),
          "attn": attn.mla_axes(cfg) if _use_mla(cfg, tok) else attn.gqa_axes(cfg),
          "ln2": (None,),
          "mlp": mlp_mod.moe_axes(cfg) if _use_moe(cfg, tok) else mlp_mod.mlp_axes(cfg)}
    if tok == "c":
        ax["ln_x"] = (None,)
        ax["cross"] = attn.gqa_axes(cfg)
    return ax


def init_block_cache(init: Init, cfg, tok: str, batch: int, max_len: int):
    check_supported(cfg, tok)
    if tok == "m":
        return ssm.init_mamba2_cache(init, cfg, batch)
    if tok == "x":
        return ssm.init_mlstm_cache(init, cfg, batch)
    if tok == "s":
        return ssm.init_slstm_cache(init, cfg, batch)
    if _use_mla(cfg, tok):
        return attn.init_mla_cache(init, cfg, batch, max_len)
    c = attn.init_gqa_cache(init, cfg, batch, max_len)
    if tok == "c":
        shape = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        c = {"self": c, "cross_k": init.full(shape, 0.0, dtype_of(cfg)),
             "cross_v": init.full(shape, 0.0, dtype_of(cfg))}
    return c


def block_cache_axes(cfg, tok: str):
    check_supported(cfg, tok)
    if tok == "m":
        return ssm.mamba2_cache_axes(cfg)
    if tok == "x":
        return ssm.mlstm_cache_axes(cfg)
    if tok == "s":
        return ssm.slstm_cache_axes(cfg)
    if _use_mla(cfg, tok):
        return attn.mla_cache_axes(cfg)
    ax = attn.gqa_cache_axes(cfg)
    if tok == "c":
        kv_ax = ("batch", None, "cache_heads", None)
        ax = {"self": ax, "cross_k": kv_ax, "cross_v": kv_ax}
    return ax


def block_forward(p, cfg, tok: str, x, positions, *, mode: str = "prefill", cache=None,
                  kv_len=None, enc_out=None):
    """Apply one residual block.  ``mode``: ``train`` (full sequence, no
    cache: the new cache is None), ``prefill`` (full sequence, returns the
    block's cache) or ``decode`` (one step against ``cache``).  ``enc_out``
    is the encoder output a ``c`` block cross-attends to in train and
    prefill; its decode reads the cross K/V from ``cache``.  Returns (x,
    new_cache)."""
    if not _is_attn(tok):
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        if tok == "m":
            out, nc = ssm.mamba2_forward(p["mamba"], cfg, h, mode=mode, cache=cache)
        elif tok == "x":
            out, nc = ssm.mlstm_forward(p["mlstm"], cfg, h, mode=mode, cache=cache)
        elif tok == "s":
            out, nc = ssm.slstm_forward(p["slstm"], cfg, h, mode=mode, cache=cache)
        else:
            raise NotImplementedError(f"block token {tok!r} is not ported yet")
        return x + constrain(out, _ACT), nc
    check_supported(cfg, tok)
    self_cache = cache["self"] if tok == "c" and cache is not None else cache
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if _use_mla(cfg, tok):
        out, nc = attn.mla_forward(p["attn"], cfg, h, positions, mode=mode, cache=self_cache,
                                   kv_len=kv_len)
    else:
        out, nc = attn.gqa_forward(p["attn"], cfg, h, positions, mode=mode, cache=self_cache,
                                   kv_len=kv_len, causal=tok != "e")
    x = x + constrain(out, _ACT)
    if tok == "c":
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        if mode == "decode":   # cross K/V were projected once, at prefill
            qout, _ = attn.gqa_forward(p["cross"], cfg, hx, positions, mode="cross_cached",
                                       cache={"k": cache["cross_k"], "v": cache["cross_v"]})
            nc = {"self": nc, "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}
        else:
            qout, cross = attn.gqa_forward(p["cross"], cfg, hx, positions, mode="prefill",
                                           kv_source=enc_out)
            nc = {"self": nc, "cross_k": cross["k"], "cross_v": cross["v"]} \
                if mode == "prefill" else None
        x = x + constrain(qout, _ACT)
    hm = rms_norm(x, p["ln2"], cfg.norm_eps)
    if _use_moe(cfg, tok):
        return x + constrain(mlp_mod.moe_forward(p["mlp"], cfg, hm), _ACT), nc
    return x + constrain(mlp_mod.mlp_forward(p["mlp"], hm), _ACT), nc
