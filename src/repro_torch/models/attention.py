"""GQA attention (+ optional per-head qk RMS norm) for prefill and decode.

Layouts follow the reference (``repro.models.attention``):

* activations (B, S, d_model); projected heads (B, S, H, Dh); the flash op
  takes (B, H, S, Dh);
* KV cache {"k": (B, Smax, Hkv, Dh), "v": ...} with an int ``kv_len``
  marking the filled prefix; decode writes its new entries into the cache
  in place;
* projection weights 3-D — (d, H, Dh), and (H, Dh, d) for ``wo`` — when
  ``n_heads % 16 == 0``, else 2-D (the reference's default layouts).

MLA and cross-attention wait.
"""

from __future__ import annotations

import torch

from ..kernels.flash import ops as flash_ops
from .common import Init, apply_rotary, dtype_of, rms_norm, rotary_embedding

__all__ = ["init_gqa", "gqa_forward", "init_gqa_cache"]


def init_gqa(init: Init, cfg):
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    dt = dtype_of(cfg)
    std = d ** -0.5
    if h % 16 == 0:
        p = {
            "wq": init.normal((d, h, dh), std, dt),
            "wk": init.normal((d, kv, dh), std, dt),
            "wv": init.normal((d, kv, dh), std, dt),
            "wo": init.normal((h, dh, d), (h * dh) ** -0.5, dt),
        }
    else:
        p = {
            "wq": init.normal((d, h * dh), std, dt),
            "wk": init.normal((d, kv * dh), std, dt),
            "wv": init.normal((d, kv * dh), std, dt),
            "wo": init.normal((h * dh, d), (h * dh) ** -0.5, dt),
        }
    if cfg.qk_norm:
        p["q_norm"] = init.full((dh,), 1.0, torch.float32)
        p["k_norm"] = init.full((dh,), 1.0, torch.float32)
    return p


def init_gqa_cache(init: Init, cfg, batch: int, max_len: int):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": init.full(shape, 0.0, dtype_of(cfg)), "v": init.full(shape, 0.0, dtype_of(cfg))}


def _project_qkv(p, cfg, x):
    """(q, k, v) as (B, S, heads, Dh) under either weight layout."""
    b, s, d = x.shape
    dh = cfg.resolved_head_dim
    q = (x @ p["wq"].reshape(d, -1)).reshape(b, s, cfg.n_heads, dh)
    k = (x @ p["wk"].reshape(d, -1)).reshape(b, s, cfg.n_kv_heads, dh)
    v = (x @ p["wv"].reshape(d, -1)).reshape(b, s, cfg.n_kv_heads, dh)
    return q, k, v


def gqa_forward(p, cfg, x, positions, *, mode: str = "prefill", cache=None, kv_len=None):
    """mode: ``prefill`` (full sequence, causal; returns the new K/V as the
    cache) or ``decode`` (writes K/V into ``cache`` at ``kv_len`` in place
    and attends over the first ``kv_len + S`` entries).
    Returns (out (B, S, d), new_cache)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rotary_embedding(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)

    if mode == "decode":
        cache["k"][:, kv_len: kv_len + s] = k
        cache["v"][:, kv_len: kv_len + s] = v
        out = flash_ops.decode_attention(
            q.transpose(1, 2), cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
            kv_len + s).transpose(1, 2)
        new_cache = cache
    elif mode == "prefill":
        out = flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
        ).transpose(1, 2)
        new_cache = {"k": k, "v": v}
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = out.reshape(b, s, -1)
    return out @ p["wo"].reshape(out.shape[-1], -1), new_cache
