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
as in the reference (no kernel).  On ``DTensor``s whose tokens are split a
rank's slot positions add the counts of the ranks before it
(``exclusive_cumsum``), and the dispatch and the combine run on each rank's
own slots (:func:`scatter_rows`, :func:`gather_rows`).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import flags
from .common import Init, _from_local, constrain, dtype_of, exclusive_cumsum

__all__ = ["init_mlp", "mlp_axes", "mlp_forward", "init_moe", "moe_axes", "moe_route",
           "slot_positions", "Route", "recorded_routes", "scatter_rows", "gather_rows", "moe_forward"]


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


def slot_positions(top_e, n_experts: int):
    """top_e (t, k) -> each routed slot's position within its expert: the
    count of earlier slots routed there in the token-major (t * k, e)
    flattening (the exclusive cumsum of its one-hot, with the counts of the
    ranks before this one where the tokens are split: the reference's
    prefix + correction, :func:`~repro_torch.models.common.exclusive_cumsum`)."""
    t, k = top_e.shape
    flat = (top_e.reshape(t * k, 1) == torch.arange(n_experts, device=top_e.device)).long()
    return (exclusive_cumsum(flat) * flat).sum(1).reshape(t, k)


class Route(NamedTuple):
    """One :func:`moe_forward` call's routing: the router's gates (t, e), the
    experts taken (t, k), each slot's position within its expert (t, k) and
    whether it is kept (t, k)."""
    gates: torch.Tensor
    top_e: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


#: the MoE layers' routes while :func:`recorded_routes` collects them
_ROUTES: contextvars.ContextVar = contextvars.ContextVar("moe_routes", default=None)


@contextlib.contextmanager
def recorded_routes():
    """Collect each :func:`moe_forward` call's :class:`Route` while the block
    runs, in call order."""
    routes: list = []
    token = _ROUTES.set(routes)
    try:
        yield routes
    finally:
        _ROUTES.reset(token)


def scatter_rows(src, dest, n: int):
    """``zeros((n, d)).index_add(0, dest, src)``: the dispatch of the routed
    slots into the experts' buffer.  On ``DTensor``s whose rows (the slots)
    are split, each rank adds its own rows into a whole buffer, a partial
    sum over the axes that split them (the positions are global, so no two
    ranks write one row); the gradient is each rank's rows of the whole
    buffer's gradient (:func:`gather_rows`'s forward)."""
    if not hasattr(src, "device_mesh"):
        return src.new_zeros((n, src.shape[1])).index_add(0, dest, src)
    return _ScatterRows.apply(src, dest, n)


def gather_rows(y, dest):
    """``y[dest]``: the combine of the experts' outputs back to the slots.
    On ``DTensor``s each rank reads the whole ``y`` at its own slots'
    ``dest`` (split as ``dest`` is); the gradient is :func:`scatter_rows`'s
    partial sums."""
    if not hasattr(y, "device_mesh"):
        return y[dest]
    return _GatherRows.apply(y, dest)


def _rows_placements(t) -> tuple:
    """``t``'s splits of its rows (dim 0); every other dim whole."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in t.placements)


def _local_rows(t, mesh, pl):
    return t.redistribute(mesh, pl).to_local()


def _summed(local, mesh, pl, shape):
    """A local buffer added into by each rank's rows: a partial sum over the
    axes that split the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return _from_local(local, mesh, tuple(Partial() if isinstance(p, Shard) else Replicate()
                                          for p in pl), shape)


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, dest, n):
        mesh, pl = src.device_mesh, _rows_placements(src)
        sl, dl = _local_rows(src, mesh, pl), _local_rows(dest, mesh, pl)
        ctx.save_for_backward(dl)
        ctx.meta = (mesh, pl, src.shape)
        return _summed(sl.new_zeros((n, sl.shape[1])).index_add_(0, dl, sl), mesh, pl,
                       (n, src.shape[1]))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        (dl,) = ctx.saved_tensors
        mesh, pl, shape = ctx.meta
        gl = g.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local()
        return _from_local(gl[dl], mesh, pl, shape), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dest):
        from torch.distributed.tensor import Replicate
        mesh = y.device_mesh
        pl = _rows_placements(dest)
        dl = _local_rows(dest, mesh, pl)
        yl = y.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local()
        ctx.save_for_backward(dl)
        # the gradient goes back at y's own placements (a partial sum's as
        # replicated), so that the expert products' backward stays on each
        # rank's experts
        ctx.meta = (mesh, pl, y.shape, tuple(Replicate() if p.is_partial() else p
                                             for p in y.placements))
        return _from_local(yl[dl], mesh, pl, (dest.shape[0], y.shape[1]))

    @staticmethod
    def backward(ctx, g):
        (dl,) = ctx.saved_tensors
        mesh, pl, shape, y_pl = ctx.meta
        gl = _local_rows(g, mesh, pl)
        dy = _summed(gl.new_zeros(shape).index_add_(0, dl, gl), mesh, pl, shape)
        return dy.redistribute(mesh, y_pl), None


def moe_forward(p, cfg, x, capacity_factor: float | None = None):
    """x (B, S, d) -> (B, S, d) in x's dtype."""
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    b, s, d = x.shape
    t = b * s
    xf = constrain(x.reshape(t, d), ("batch", None))
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    capacity = max(int(t * k * cf / e), 1)
    gates, top_p, top_e = moe_route(p, cfg, xf)
    pos = slot_positions(top_e, e)
    keep = pos < capacity
    if _ROUTES.get() is not None:
        _ROUTES.get().append(Route(gates, top_e, pos, keep))
    dest = torch.where(keep, top_e * capacity + pos, e * capacity).clamp(0, e * capacity - 1)
    dest = dest.reshape(t * k)
    src = (xf[:, None, :] * keep.to(xf.dtype)[..., None]).reshape(t * k, d)
    buf = scatter_rows(src, dest, e * capacity).reshape(e, capacity, d)
    buf = constrain(buf, ("experts", None, None))

    h = F.silu(torch.bmm(buf, p["w1"])) * torch.bmm(buf, p["w3"])
    h = constrain(h, ("experts", None, "expert_mlp"))
    y = torch.bmm(h, p["w2"]).reshape(e * capacity, d)

    gathered = gather_rows(y, dest).reshape(t, k, d)
    out = (gathered * torch.where(keep, top_p, 0.0)[..., None].to(y.dtype)).sum(1)
    out = constrain(out, ("batch", None)).reshape(b, s, d)
    if m.n_shared_experts:
        out = out + mlp_forward(p["shared"], x)
    return out.to(x.dtype)
