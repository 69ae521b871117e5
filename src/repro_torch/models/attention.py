"""GQA attention (+ optional per-head qk RMS norm) for prefill and decode.

Layouts follow the reference (``repro.models.attention``):

* activations (B, S, d_model); projected heads (B, S, H, Dh); the flash op
  takes (B, H, S, Dh);
* KV cache {"k": (B, Smax, Hkv, Dh), "v": ...} with an int ``kv_len``
  marking the filled prefix; decode writes its new entries into the cache
  in place;
* projection weights 3-D — (d, H, Dh), and (H, Dh, d) for ``wo`` — when
  ``n_heads % 16 == 0``, else 2-D (the reference's default layouts);
* cross-attention (whisper's decoder) takes its keys and values from
  ``kv_source`` (the encoder output), without rotary, and is never causal;
  in prefill it returns the projected cross K/V as its cache, and decode
  (``mode="cross_cached"``) attends over them with the plain attention.

MLA waits.
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


def _project(x, w, heads: int, dh: int):
    """x (B, S, d) through a 2-D or 3-D projection -> (B, S, heads, Dh)."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).reshape(b, s, heads, dh)


def _out(p, out):
    """(B, S, H, Dv) heads through ``wo`` -> (B, S, d)."""
    b, s = out.shape[:2]
    out = out.reshape(b, s, -1)
    return out @ p["wo"].reshape(out.shape[-1], -1)


def gqa_forward(p, cfg, x, positions, *, mode: str = "prefill", cache=None, kv_len=None,
                kv_source=None, causal: bool = True):
    """mode: ``train`` (full sequence, no cache), ``prefill`` (full sequence;
    returns the new K/V as the cache), ``decode`` (writes K/V into ``cache``
    at ``kv_len`` in place and attends over the first ``kv_len + S``
    entries) or ``cross_cached`` (attends over the cross K/V in ``cache``).

    ``kv_source`` (B, Skv, d): cross-attention keys and values come from it
    (no rotary, not causal); ``causal=False`` makes self-attention
    bidirectional (whisper's encoder).  Returns (out (B, S, d), new_cache)."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _project(x, p["wq"], h, dh)
    if mode == "cross_cached":
        out = flash_ops.decode_attention(q.transpose(1, 2), cache["k"].transpose(1, 2),
                                         cache["v"].transpose(1, 2), cache["k"].shape[1])
        return _out(p, out.transpose(1, 2)), None
    src = x if kv_source is None else kv_source
    k = _project(src, p["wk"], kv, dh)
    v = _project(src, p["wv"], kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if kv_source is None:   # cross-attention skips rotary
        cos, sin = rotary_embedding(positions, dh, cfg.rope_theta)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

    if mode == "decode":
        s = x.shape[1]
        cache["k"][:, kv_len: kv_len + s] = k
        cache["v"][:, kv_len: kv_len + s] = v
        out = flash_ops.decode_attention(
            q.transpose(1, 2), cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
            kv_len + s).transpose(1, 2)
        new_cache = cache
    elif mode in ("train", "prefill"):
        out = flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal and kv_source is None,
        ).transpose(1, 2)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return _out(p, out), new_cache
