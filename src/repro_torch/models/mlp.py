"""Dense SwiGLU MLP (``repro.models.mlp``), in the reference's default fused
(d, 2, f) gate+up layout.  MoE waits."""

from __future__ import annotations

import torch.nn.functional as F

from .common import Init, dtype_of

__all__ = ["init_mlp", "mlp_forward"]


def init_mlp(init: Init, cfg, d_ff: int | None = None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    return {"w13": init.normal((d, 2, f), d ** -0.5, dt),
            "w2": init.normal((f, d), f ** -0.5, dt)}


def mlp_forward(p, x):
    d, _, f = p["w13"].shape
    h13 = (x @ p["w13"].reshape(d, 2 * f)).reshape(*x.shape[:-1], 2, f)
    h = F.silu(h13[..., 0, :]) * h13[..., 1, :]
    return h @ p["w2"]
