"""GQA attention (+ optional per-head qk RMS norm) for prefill and decode.

Layouts follow the reference (``repro.models.attention``):

* activations (B, S, d_model); projected heads (B, S, H, Dh); the flash op
  takes (B, H, S, Dh);
* KV cache {"k": (B, Smax, Hkv, Dh), "v": ...} with an int ``kv_len``
  marking the filled prefix; decode writes its new entries into the cache
  in place;
* projection weights 3-D — (d, H, Dh), and (H, Dh, d) for ``wo`` — when
  the ``head_sharded_layouts`` flag is on and ``n_heads % 16 == 0``, else
  2-D (the reference's layouts); the forwards take either;
* cross-attention (whisper's decoder) takes its keys and values from
  ``kv_source`` (the encoder output), without rotary, and is never causal;
  in prefill it returns the projected cross K/V as its cache, and decode
  (``mode="cross_cached"``) attends over them with the plain attention;
* MLA (DeepSeek-V2 / MiniCPM3) caches the compressed latents {"ckv": (B,
  Smax, kv_lora), "krope": (B, Smax, rope_dim)}.  Train and prefill
  materialize per-head K (the latent's ``k_nope`` beside the shared
  ``k_rope``) and V and run the flash op with D = nope + rope, Dv = v_head;
  decode is the reference's absorbed formulation (q_nope through W_uk, the
  scores against the latent cache), plain, in float32.
"""

from __future__ import annotations

import math

import torch

from ..kernels.flash import ops as flash_ops
from . import flags
from .common import (Init, apply_rotary, column_sharded_product, constrain, dtype_of,
                     flat_heads, rms_norm, rotary_embedding, whole_heads, whole_product,
                     write_seq)

__all__ = ["init_gqa", "gqa_axes", "gqa_forward", "init_gqa_cache", "gqa_cache_axes",
           "init_mla", "mla_axes", "init_mla_cache", "mla_cache_axes", "mla_forward"]


def _head_layout(cfg) -> bool:
    """3-D per-head projection weights: the flag, where the heads split
    evenly over the production tensor-parallel width of 16."""
    return flags.get("head_sharded_layouts") and cfg.n_heads % 16 == 0


def init_gqa(init: Init, cfg):
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    dt = dtype_of(cfg)
    std = d ** -0.5
    if _head_layout(cfg):
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


def gqa_axes(cfg):
    if _head_layout(cfg):
        ax = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
              "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}
    else:
        ax = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
              "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qk_norm:
        ax["q_norm"] = (None,)
        ax["k_norm"] = (None,)
    return ax


def init_gqa_cache(init: Init, cfg, batch: int, max_len: int):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": init.full(shape, 0.0, dtype_of(cfg)), "v": init.full(shape, 0.0, dtype_of(cfg))}


def gqa_cache_axes(cfg):
    ax = ("batch", "cache_seq", "cache_heads", None)
    return {"k": ax, "v": ax}


def _project(x, w, heads: int, dh: int, whole: bool = False):
    """x (B, S, d) through a 2-D or 3-D projection -> (B, S, heads, Dh).

    Under ``DTensor`` (the dry run's sharded trace) a projection whose
    weight the ``model`` axis does not split is computed column-sharded and
    gathered, or, with ``whole``, whole on every device (the reference's K
    feeding attention, pinned by its constraint)."""
    b, s, d = x.shape
    w = w.reshape(d, -1)
    if hasattr(w, "device_mesh"):
        y = whole_product(x, w) if whole else column_sharded_product(x, w)
        y = whole_heads(y, heads)
    else:
        y = x @ w
    return y.reshape(b, s, heads, dh)


def _out(p, out):
    """(B, S, H, Dv) heads through ``wo`` -> (B, S, d)."""
    out = flat_heads(out)
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
    k = _project(src, p["wk"], kv, dh, whole=mode != "decode")
    v = _project(src, p["wv"], kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if kv_source is None:   # cross-attention skips rotary
        cos, sin = rotary_embedding(positions, dh, cfg.rope_theta)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    q = constrain(q, ("batch", "act_seq", "act_heads", None))
    k = constrain(k, ("batch", "act_seq", "cache_heads", None))

    if mode == "decode":
        s = x.shape[1]
        write_seq(cache["k"], kv_len, k)
        write_seq(cache["v"], kv_len, v)
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
    return _out(p, constrain(out, ("batch", "act_seq", "act_heads", None))), new_cache


# --------------------------------------------------------------------- #
# MLA
# --------------------------------------------------------------------- #
def init_mla(init: Init, cfg):
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = dtype_of(cfg)
    return {
        "wq_a": init.normal((d, qr), d ** -0.5, dt),
        "q_norm": init.full((qr,), 1.0, torch.float32),
        "wq_b": init.normal((qr, h * (dn + dr)), qr ** -0.5, dt),
        "wkv_a": init.normal((d, kvr + dr), d ** -0.5, dt),
        "kv_norm": init.full((kvr,), 1.0, torch.float32),
        "wk_b": init.normal((kvr, h * dn), kvr ** -0.5, dt),
        "wv_b": init.normal((kvr, h * dv), kvr ** -0.5, dt),
        "wo": init.normal((h * dv, d), (h * dv) ** -0.5, dt),
    }


def mla_axes(cfg):
    return {"wq_a": ("embed", None), "q_norm": (None,), "wq_b": (None, "heads"),
            "wkv_a": ("embed", None), "kv_norm": (None,), "wk_b": (None, "heads"),
            "wv_b": (None, "heads"), "wo": ("heads", "embed")}


def init_mla_cache(init: Init, cfg, batch: int, max_len: int):
    dt = dtype_of(cfg)
    return {"ckv": init.full((batch, max_len, cfg.kv_lora_rank), 0.0, dt),
            "krope": init.full((batch, max_len, cfg.qk_rope_head_dim), 0.0, dt)}


def mla_cache_axes(cfg):
    return {"ckv": ("batch", "cache_seq", None), "krope": ("batch", "cache_seq", None)}


def _heads(y, h: int, dh: int):
    """(..., h * dh) -> (..., h, dh); a ``DTensor`` is first gathered along
    any mesh axis that splits the packed dim inside a head
    (:func:`whole_heads`)."""
    if hasattr(y, "device_mesh"):
        y = whole_heads(y, h)
    return y.reshape(*y.shape[:-1], h, dh)


def _latent(x, w, whole: bool):
    """``x @ w`` into one of MLA's latents (``wq_a``, ``wkv_a``: columns
    split over no mesh axis).  Under ``DTensor``, with ``whole`` (train and
    prefill) it is computed whole on every rank of the axes that store
    ``w`` whole (:func:`whole_product`), as XLA computes the reference's
    there, as GQA's K; else by ``DTensor``'s rule, which splits its columns
    (as XLA does in decode)."""
    return whole_product(x, w) if whole and hasattr(w, "device_mesh") else x @ w


def _mla_project_q(p, cfg, x, positions, whole: bool):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr) with rotary)."""
    h, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = _heads(rms_norm(_latent(x, p["wq_a"], whole), p["q_norm"], cfg.norm_eps) @ p["wq_b"],
               h, dn + dr)
    cos, sin = rotary_embedding(positions, dr, cfg.rope_theta)
    return q[..., :dn], apply_rotary(q[..., dn:], cos, sin)


def mla_forward(p, cfg, x, positions, *, mode: str = "prefill", cache=None, kv_len=None):
    """Modes as :func:`gqa_forward`'s (no cross-attention).  The prefill cache
    is the latents {"ckv", "krope"} at length S; decode writes the step's
    latents into ``cache`` at ``kv_len`` in place.  Returns (out, new_cache)."""
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    b, s, _ = x.shape
    whole = mode != "decode"
    q_nope, q_rope = _mla_project_q(p, cfg, x, positions, whole)
    kv = _latent(x, p["wkv_a"], whole)
    ckv = rms_norm(kv[..., :kvr], p["kv_norm"], cfg.norm_eps)
    cos, sin = rotary_embedding(positions, dr, cfg.rope_theta)
    k_rope = apply_rotary(kv[..., None, kvr:], cos, sin)[:, :, 0, :]

    if mode == "decode":
        write_seq(cache["ckv"], kv_len, ckv)
        write_seq(cache["krope"], kv_len, k_rope)
        # absorbed scores: q_nope through W_uk gives queries in the latent space
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(), _heads(p["wk_b"], h, dn).float())
        ck, kr = cache["ckv"].float(), cache["krope"].float()
        scores = (torch.einsum("bshr,btr->bhst", q_lat, ck)
                  + torch.einsum("bshr,btr->bhst", q_rope.float(), kr)) / math.sqrt(dn + dr)
        valid = torch.arange(ck.shape[1], device=x.device) < kv_len + s
        attn = torch.softmax(scores.masked_fill(~valid, float("-inf")), dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", attn, ck)
        out = torch.einsum("bshr,rhv->bshv", ctx, _heads(p["wv_b"], h, dv).float())
        out, new_cache = out.to(x.dtype), cache
    elif mode in ("train", "prefill"):
        # materialized per-head K and V, each built contiguous in (B, S, H, D)
        # so that the flash op reads them as they are
        k = torch.cat([_heads(ckv @ p["wk_b"], h, dn),
                       k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
        v = _heads(ckv @ p["wv_b"], h, dv)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                        causal=True, scale=float((dn + dr) ** -0.5)).transpose(1, 2)
        new_cache = {"ckv": ckv, "krope": k_rope} if mode == "prefill" else None
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return _out(p, out), new_cache
