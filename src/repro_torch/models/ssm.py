"""Mamba-2 (``repro.models.ssm``): in_proj packs [z | x | B | C | dt], a
short depthwise causal conv over x/B/C, softplus dt, per-head decay
a = exp(-A dt), the SSD scan (kernel B4 on the card), gated RMS norm and
out_proj.  Decode carries (conv tail, state h) and costs O(1) a token.
mLSTM and sLSTM wait.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd import ops as ssd_ops
from .common import Init, dtype_of, rms_norm

__all__ = ["init_mamba2", "mamba2_forward", "init_mamba2_cache"]


def _mamba_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.n_groups, s.state_dim, s.head_dim


def init_mamba2(init: Init, cfg):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nh, g, n, _ = _mamba_dims(cfg)
    dt = dtype_of(cfg)
    conv_dim = d_inner + 2 * g * n
    f32 = torch.float32
    return {
        "in_proj": init.normal((d, 2 * d_inner + 2 * g * n + nh), d ** -0.5, dt),
        "conv_w": init.normal((s.conv_kernel, conv_dim), 0.2, dt),
        "conv_b": init.full((conv_dim,), 0.0, dt),
        "a_log": init.full((nh,), 0.0, f32),        # A = exp(a_log) > 0
        "dt_bias": init.full((nh,), -2.0, f32),
        "d_skip": init.full((nh,), 1.0, f32),
        "norm_w": init.full((d_inner,), 1.0, f32),
        "out_proj": init.normal((d_inner, d), d_inner ** -0.5, dt),
    }


def init_mamba2_cache(init: Init, cfg, batch: int):
    d_inner, nh, g, n, ph = _mamba_dims(cfg)
    conv_dim = d_inner + 2 * g * n
    return {"conv": init.full((batch, cfg.ssm.conv_kernel - 1, conv_dim), 0.0, dtype_of(cfg)),
            "state": init.full((batch, nh, n, ph), 0.0, torch.float32)}


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv of kernel k by shifted adds.  x: (B, S, C);
    w: (k, C); tail: (B, k-1, C) carried for decode.  Returns (y, new_tail)."""
    k = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    y = sum(xp[:, i: i + x.shape[1], :] * w[i] for i in range(k)) + b
    return F.silu(y), xp[:, xp.shape[1] - (k - 1):, :]


def mamba2_forward(p, cfg, x, *, mode: str = "prefill", cache=None):
    """x: (B, S, d).  ``prefill`` runs the SSD scan and returns the cache
    (conv tail, final state); ``decode`` (S == 1) takes one recurrent step
    from ``cache``.  Returns (out, new_cache)."""
    d_inner, nh, g, n, ph = _mamba_dims(cfg)
    b, s, _ = x.shape

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * g * n]
    dt_raw = zxbcdt[..., zxbcdt.shape[-1] - nh:]

    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 cache["conv"] if mode == "decode" else None)
    xs = xbc[..., :d_inner].reshape(b, s, nh, ph)
    Bm = xbc[..., d_inner: d_inner + g * n].reshape(b, s, g, n)
    Cm = xbc[..., d_inner + g * n:].reshape(b, s, g, n)

    dt = torch.logaddexp(dt_raw.float() + p["dt_bias"], torch.zeros((), device=x.device))
    A = torch.exp(p["a_log"])

    if mode == "decode":
        a = torch.exp(-A * dt[:, 0])                                  # (b, nh)
        hpg = nh // g
        Bh = Bm[:, 0].repeat_interleave(hpg, dim=1)                   # (b, nh, n)
        Ch = Cm[:, 0].repeat_interleave(hpg, dim=1)
        dx = dt[:, 0, :, None] * xs[:, 0].float()                     # (b, nh, ph)
        h_new = a[..., None, None] * cache["state"] + Bh[..., None] * dx[:, :, None, :]
        y = torch.einsum("bhn,bhnp->bhp", Ch.float(), h_new).reshape(b, s, nh, ph)
        new_cache = {"conv": new_tail, "state": h_new}
    elif mode == "prefill":
        y, h_final = ssd_ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=cfg.ssm.chunk)
        new_cache = {"conv": new_tail, "state": h_final}
    else:
        raise ValueError(f"unknown mode {mode!r}")

    y = y.to(x.dtype) + (p["d_skip"].to(x.dtype)[:, None] * xs).to(x.dtype)
    y = y.reshape(b, s, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], new_cache
