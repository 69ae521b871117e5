"""Feed-forward layers (``repro.models.mlp``): the dense SwiGLU MLP, in the
fused (d, 2, f) gate+up layout or, with the ``fused_w13`` flag off, the
unfused ``w1``/``w3``/``w2`` (the layout of an MoE's shared expert), and the
top-k MoE.  ``mlp_axes`` / ``moe_axes`` are the logical-sharding trees of
the same structure (:mod:`repro_torch.parallel.sharding`).

The MoE keeps the reference's dispatch exactly: a float32 router, softmax
over every expert, top-k renormalized by the clamped sum; each routed slot's
position inside its expert is the count of earlier slots routed there in
the token-major (t * k, e) flattening (an exclusive cumsum, no sort), which
decides the slots dropped beyond ``capacity = max(int(t * k * cf / e), 1)``.
A dropped slot is sent, with weight 0, to the last buffer row: it adds an
exact zero, so the scatter gives the same buffer in any order of its adds.
The expert products are batched matmuls over the (e, capacity, d) buffer,
as in the reference (no kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import flags
from .common import Init, constrain, dtype_of

__all__ = ["init_mlp", "mlp_axes", "mlp_forward", "init_moe", "moe_axes", "moe_route",
           "moe_forward"]


def init_mlp(init: Init, cfg, d_ff: int | None = None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    if flags.get("fused_w13"):
        return {"w13": init.normal((d, 2, f), d ** -0.5, dt),
                "w2": init.normal((f, d), f ** -0.5, dt)}
    return {"w1": init.normal((d, f), d ** -0.5, dt),
            "w3": init.normal((d, f), d ** -0.5, dt),
            "w2": init.normal((f, d), f ** -0.5, dt)}


def mlp_axes(cfg):
    if flags.get("fused_w13"):
        return {"w13": ("embed", None, "mlp"), "w2": ("mlp", "embed")}
    return {"w1": ("embed", "mlp"), "w3": ("embed", "mlp"), "w2": ("mlp", "embed")}


def mlp_forward(p, x):
    if "w13" in p and hasattr(p["w13"], "device_mesh"):
        # sharded (a DTensor): flattening (2, f) would interleave the shards
        # of f, so the gate and up products run on the two slices
        h = F.silu(x @ p["w13"][:, 0]) * (x @ p["w13"][:, 1])
    elif "w13" in p:
        d, _, f = p["w13"].shape
        h13 = (x @ p["w13"].reshape(d, 2 * f)).reshape(*x.shape[:-1], 2, f)
        h = F.silu(h13[..., 0, :]) * h13[..., 1, :]
    else:
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return constrain(h, ("batch", "act_seq", "act_mlp")) @ p["w2"]


def init_moe(init: Init, cfg):
    d, m = cfg.d_model, cfg.moe
    e, f = m.n_experts, m.d_ff_expert
    dt = dtype_of(cfg)
    p = {"router": init.normal((d, e), d ** -0.5, torch.float32),
         "w1": init.normal((e, d, f), d ** -0.5, dt),
         "w3": init.normal((e, d, f), d ** -0.5, dt),
         "w2": init.normal((e, f, d), f ** -0.5, dt)}
    if m.n_shared_experts:
        sf = f * m.n_shared_experts
        p["shared"] = {"w1": init.normal((d, sf), d ** -0.5, dt),
                       "w3": init.normal((d, sf), d ** -0.5, dt),
                       "w2": init.normal((sf, d), sf ** -0.5, dt)}
    return p


def moe_axes(cfg):
    ax = {"router": ("embed", None),
          "w1": ("experts", "embed_nofsdp", "expert_mlp"),
          "w3": ("experts", "embed_nofsdp", "expert_mlp"),
          "w2": ("experts", "expert_mlp", "embed_nofsdp")}
    if cfg.moe.n_shared_experts:
        ax["shared"] = {"w1": ("embed", "mlp"), "w3": ("embed", "mlp"), "w2": ("mlp", "embed")}
    return ax


def moe_route(p, cfg, xf):
    """xf (t, d) -> (gates (t, e) float32, top_p (t, k) renormalized, top_e
    (t, k)): the router's softmax and its top-k."""
    gates = torch.softmax(xf.float() @ p["router"], dim=-1)
    top_p, top_e = torch.topk(gates, cfg.moe.top_k, dim=-1)
    return gates, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def moe_forward(p, cfg, x, capacity_factor: float | None = None):
    """x (B, S, d) -> (B, S, d) in x's dtype."""
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    b, s, d = x.shape
    t = b * s
    xf = constrain(x.reshape(t, d), ("batch", None))
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    capacity = max(int(t * k * cf / e), 1)
    _, top_p, top_e = moe_route(p, cfg, xf)

    # position of slot (t, j) within its expert: earlier slots routed there
    flat = (top_e.reshape(t * k, 1) == torch.arange(e, device=x.device)).long()
    pos = ((flat.cumsum(0) - flat) * flat).sum(1).reshape(t, k)
    keep = pos < capacity
    dest = torch.where(keep, top_e * capacity + pos, e * capacity).clamp(0, e * capacity - 1)
    dest = dest.reshape(t * k)
    src = (xf[:, None, :] * keep.to(xf.dtype)[..., None]).reshape(t * k, d)
    buf = xf.new_zeros((e * capacity, d)).index_add(0, dest, src).reshape(e, capacity, d)
    buf = constrain(buf, ("experts", None, None))

    h = F.silu(torch.bmm(buf, p["w1"])) * torch.bmm(buf, p["w3"])
    h = constrain(h, ("experts", None, "expert_mlp"))
    y = torch.bmm(h, p["w2"]).reshape(e * capacity, d)

    gathered = y[dest].reshape(t, k, d)
    out = (gathered * torch.where(keep, top_p, 0.0)[..., None].to(y.dtype)).sum(1)
    out = constrain(out, ("batch", None)).reshape(b, s, d)
    if m.n_shared_experts:
        out = out + mlp_forward(p["shared"], x)
    return out.to(x.dtype)
