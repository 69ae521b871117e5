"""State-space blocks (``repro.models.ssm``).

* Mamba-2: in_proj packs [z | x | B | C | dt], a short depthwise causal
  conv over x/B/C, softplus dt, per-head decay a = exp(-A dt), the SSD scan
  (kernel B4 on the card), gated RMS norm and out_proj.  Decode carries
  (conv tail, state h) and costs O(1) a token.
* mLSTM (xLSTM's matrix memory): prefill is the SSD scan twice with the
  input gate as ``in_scale`` (decay -log f, B = k, C = q per head): once
  over v for the numerator, once over ones for the normalizer; decode
  updates the (C, n) memory by one step.
* sLSTM (xLSTM's scalar memory, stabilized exponential gating): a strictly
  recurrent cell, so prefill is a Python loop over the time steps (the
  reference's scan).  ``train`` runs the loop in :class:`SlstmScan`, the
  twin of the reference's ``_slstm_scan``: its cell is the reference's
  ``_cell_math`` (the stabilizer m a constant for the gradient, the
  normalizer floored by a strict ``where(n > 1)``), and its backward is the
  reference's deferred-weight-gradient recursion over the time steps,
  ending in one contraction for the recurrent weights' gradient.  Prefill
  and decode step the same cell.

``mode="train"`` runs the full sequence and writes no cache (every block
returns None as its cache).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import trace_hooks
from ..kernels.ssd import ops as ssd_ops
from .common import (Init, _from_local, constrain, dtype_of, flat_heads, on_local_shards,
                     rms_norm)

__all__ = ["init_mamba2", "mamba2_axes", "mamba2_forward", "init_mamba2_cache",
           "mamba2_cache_axes", "init_mlstm", "mlstm_axes", "mlstm_forward", "init_mlstm_cache",
           "mlstm_cache_axes", "init_slstm", "slstm_axes", "slstm_forward", "init_slstm_cache",
           "slstm_cache_axes", "SlstmScan", "slstm_scan"]


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


def mamba2_axes(cfg):
    return {"in_proj": ("embed", "mlp"), "conv_w": (None, "mlp"), "conv_b": ("mlp",),
            "a_log": (None,), "dt_bias": (None,), "d_skip": (None,), "norm_w": ("mlp",),
            "out_proj": ("mlp", "embed")}


def init_mamba2_cache(init: Init, cfg, batch: int):
    d_inner, nh, g, n, ph = _mamba_dims(cfg)
    conv_dim = d_inner + 2 * g * n
    return {"conv": init.full((batch, cfg.ssm.conv_kernel - 1, conv_dim), 0.0, dtype_of(cfg)),
            "state": init.full((batch, nh, n, ph), 0.0, torch.float32)}


def mamba2_cache_axes(cfg):
    return {"conv": ("batch", None, "act_mlp"), "state": ("batch", "cache_heads", None, None)}


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
    (conv tail, final state); ``train`` the same scan, with no cache;
    ``decode`` (S == 1) takes one recurrent step from ``cache``.  Returns
    (out, new_cache)."""
    d_inner, nh, g, n, ph = _mamba_dims(cfg)
    b, s, _ = x.shape

    zxbcdt = constrain(x @ p["in_proj"], ("batch", "act_seq", "act_mlp"))
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * g * n]
    dt_raw = zxbcdt[..., zxbcdt.shape[-1] - nh:]

    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 cache["conv"] if mode == "decode" else None)
    xs = xbc[..., :d_inner].reshape(b, s, nh, ph)
    Bm = xbc[..., d_inner: d_inner + g * n].reshape(b, s, g, n)
    Cm = xbc[..., d_inner + g * n:].reshape(b, s, g, n)
    # under DTensor the packed projection's slices come back whole: the heads
    # are split again, as the reference's layout has them
    xs = constrain(xs, ("batch", "act_seq", "act_heads", None))
    z = constrain(z, ("batch", "act_seq", "act_mlp"))
    dt_raw = constrain(dt_raw, ("batch", "act_seq", "act_heads"))

    dt = torch.logaddexp(dt_raw.float() + p["dt_bias"], torch.zeros((), device=x.device))
    A = torch.exp(p["a_log"])

    if mode == "decode":
        a = torch.exp(-A * dt[:, 0])                                  # (b, nh)
        hpg = nh // g
        Bh = Bm[:, 0].repeat_interleave(hpg, dim=1)                   # (b, nh, n)
        Ch = Cm[:, 0].repeat_interleave(hpg, dim=1)
        dx = dt[:, 0, :, None] * xs[:, 0].float()                     # (b, nh, ph)
        h_new = a[..., None, None] * cache["state"] + Bh[..., None] * dx[:, :, None, :]
        y = on_local_shards(lambda c, hh: torch.einsum("bhn,bhnp->bhp", c, hh),
                            Ch.float(), h_new).reshape(b, s, nh, ph)
        new_cache = {"conv": new_tail, "state": h_new}
    elif mode in ("prefill", "train"):
        y, h_final = ssd_ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=cfg.ssm.chunk)
        new_cache = {"conv": new_tail, "state": h_final} if mode == "prefill" else None
    else:
        raise ValueError(f"unknown mode {mode!r}")

    y = y.to(x.dtype) + (p["d_skip"].to(x.dtype)[:, None] * xs).to(x.dtype)
    y = y.reshape(b, s, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm_w"], cfg.norm_eps)
    y = constrain(y, ("batch", "act_seq", "act_mlp"))
    return y @ p["out_proj"], new_cache


# ===================================================================== #
# mLSTM
# ===================================================================== #
def _mlstm_dims(cfg):
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, cfg.n_heads, d_inner // cfg.n_heads


def init_mlstm(init: Init, cfg):
    d = cfg.d_model
    d_inner, nh, _ = _mlstm_dims(cfg)
    dt = dtype_of(cfg)

    def lin(i, o):
        return init.normal((i, o), i ** -0.5, dt)
    return {
        "up": lin(d, 2 * d_inner),              # [x_in | z gate]
        "wq": lin(d_inner, d_inner),
        "wk": lin(d_inner, d_inner),
        "wv": lin(d_inner, d_inner),
        "w_gates": lin(d_inner, 2 * nh),        # [i | f] per head
        "norm_w": init.full((d_inner,), 1.0, torch.float32),
        "down": lin(d_inner, d),
    }


def mlstm_axes(cfg):
    return {"up": ("embed", "mlp"), "wq": ("mlp", "heads"), "wk": ("mlp", "heads"),
            "wv": ("mlp", "heads"), "w_gates": ("mlp", None), "norm_w": ("mlp",),
            "down": ("mlp", "embed")}


def init_mlstm_cache(init: Init, cfg, batch: int):
    """Matrix memory C (B, nh, ph_k, ph_v) and normalizer n (B, nh, ph_k)."""
    _, nh, ph = _mlstm_dims(cfg)
    return {"C": init.full((batch, nh, ph, ph), 0.0, torch.float32),
            "n": init.full((batch, nh, ph), 0.0, torch.float32)}


def mlstm_cache_axes(cfg):
    return {"C": ("batch", "cache_heads", None, None), "n": ("batch", "cache_heads", None)}


def mlstm_forward(p, cfg, x, *, mode: str = "prefill", cache=None):
    """x: (B, S, d).  ``prefill`` runs the two SSD scans and returns the
    final (C, n); ``train`` the same scans, with no cache; ``decode``
    (S == 1) steps the memory in ``cache``.  Returns (out, new_cache)."""
    d_inner, nh, ph = _mlstm_dims(cfg)
    b, s, _ = x.shape
    # under DTensor, up, x_in and their gradients keep their columns split
    # over ``model``: the slice between x_in and z gathers them, and without
    # these pins every rank would compute the weight gradients of up, wq,
    # wk, wv and w_gates whole
    up = constrain(x @ p["up"], ("batch", "act_seq", "act_mlp"))
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    x_in = constrain(x_in, ("batch", "act_seq", "act_mlp"))
    q = (x_in @ p["wq"]).reshape(b, s, nh, ph)
    k = (x_in @ p["wk"]).reshape(b, s, nh, ph) * ph ** -0.5
    v = (x_in @ p["wv"]).reshape(b, s, nh, ph)
    gates = (x_in @ p["w_gates"]).float()
    i_g = torch.sigmoid(gates[..., :nh])                          # (b, s, nh)
    f_g = torch.sigmoid(gates[..., nh:] + 2.0)

    if mode == "decode":
        ig, fg = i_g[:, 0], f_g[:, 0]
        kf, vf, qf = k[:, 0].float(), v[:, 0].float(), q[:, 0].float()
        C_new = fg[..., None, None] * cache["C"] + ig[..., None, None] * (
            kf[..., :, None] * vf[..., None, :])
        n_new = fg[..., None] * cache["n"] + ig[..., None] * kf
        num = on_local_shards(lambda q_, c_: torch.einsum("bhk,bhkp->bhp", q_, c_), qf, C_new)
        den = on_local_shards(lambda q_, n_: torch.einsum("bhk,bhk->bh", q_, n_), qf,
                              n_new).abs().clamp_min(1.0)
        y = (num / den[..., None])[:, None]
        new_cache = {"C": C_new, "n": n_new}
    elif mode in ("prefill", "train"):
        dtv = -torch.log(f_g.clamp(1e-6, 1 - 1e-6))
        A = torch.ones((nh,), dtype=torch.float32, device=x.device)
        y_num, C_fin = ssd_ops.ssd_scan(v, dtv, A, k, q, chunk=cfg.ssm.chunk, in_scale=i_g)
        ones = torch.ones_like(dtv[..., None], dtype=v.dtype)   # dtv's shards under DTensor
        y_den, n_fin = ssd_ops.ssd_scan(ones, dtv, A, k, q, chunk=cfg.ssm.chunk, in_scale=i_g)
        den = y_den[..., 0].float().abs().clamp_min(1.0)
        y = y_num.float() / den[..., None]
        new_cache = {"C": C_fin, "n": n_fin[..., 0]} if mode == "prefill" else None
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = flat_heads(y).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm_w"], cfg.norm_eps)
    return y @ p["down"], new_cache


# ===================================================================== #
# sLSTM
# ===================================================================== #
def init_slstm(init: Init, cfg):
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    dt = dtype_of(cfg)
    return {
        "w_x": init.normal((d, 4 * d), d ** -0.5, dt),       # z, i, f, o pre-activations
        "r_h": init.normal((nh, dh, 4 * dh), dh ** -0.5, torch.float32),  # block-diagonal
        "b": init.full((4 * d,), 0.0, torch.float32),
        "norm_w": init.full((d,), 1.0, torch.float32),
        "down": init.normal((d, d), d ** -0.5, dt),
    }


def slstm_axes(cfg):
    return {"w_x": ("embed", None), "r_h": ("heads", None, None), "b": (None,),
            "norm_w": (None,), "down": (None, "embed")}


def init_slstm_cache(init: Init, cfg, batch: int):
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    z = (batch, nh, dh)
    return {"c": init.full(z, 0.0, torch.float32), "n": init.full(z, 0.0, torch.float32),
            "h": init.full(z, 0.0, torch.float32),
            "m": init.full((batch, nh), 0.0, torch.float32)}


def slstm_cache_axes(cfg):
    ax = ("batch", "cache_heads", None)
    return {"c": ax, "n": ax, "h": ax, "m": ("batch", "cache_heads")}


def _cell_math(xt, c, n, h, m, r_h, nh: int, dh: int):
    """One time step (the reference's ``_cell_math``): xt (B, 4d)
    pre-activations, (c, n, h) of (B, nh, dh) and the (B, nh) stabilizer m;
    float32 math.  The stabilizer ``m_new`` is detached and the normalizer
    floored by a strict ``where(n > 1)`` (``maximum`` would split the
    gradient at a tie n == 1, which happens whenever i_s == 1).  Returns
    (c, n, h, m)."""
    rec = torch.einsum("bhd,hdf->bhf", h, r_h)                       # (B, nh, 4dh)
    pre = xt.reshape(xt.shape[0], nh, 4 * dh).float() + rec
    z_, i_, f_, o_ = pre.split(dh, dim=-1)
    # per-head scalar gates (the mean over the head dim keeps them scalar)
    log_i = i_.mean(-1)
    log_f = F.logsigmoid(f_.mean(-1) + 1.0)
    m_new = torch.maximum(log_f + m, log_i).detach()
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s[..., None] * c + i_s[..., None] * torch.tanh(z_)
    n_new = f_s[..., None] * n + i_s[..., None]
    h_new = torch.sigmoid(o_) * (c_new / torch.where(n_new > 1.0, n_new, 1.0))
    return c_new, n_new, h_new, m_new


def _slstm_cell(p, cfg, xt, state):
    """One serving step of :func:`_cell_math` on a state dict."""
    nh = cfg.n_heads
    c, n, h, m = _cell_math(xt, state["c"], state["n"], state["h"], state["m"], p["r_h"],
                            nh, cfg.d_model // nh)
    return {"c": c, "n": n, "h": h, "m": m}


class SlstmScan(torch.autograd.Function):
    """(pre (B, S, 4d), r_h (nh, dh, 4 dh), nh) -> hs (B, S, nh, dh) float32
    from a zero state.  The forward runs :func:`_cell_math` over the steps
    and keeps every step's (c, n, h, m) — the reference recomputes them in
    its backward; they are the same values, so the backward here reads
    them instead.  The backward is the reference's ``_slstm_scan_bwd``:
    the sequential recursion over (dc, dn, dh) from the last step saves
    each step's pre-activation gradient, and the recurrent weights'
    gradient is one ``einsum`` over the whole history."""

    @staticmethod
    def forward(ctx, pre, r_h, nh: int):
        b, s = pre.shape[:2]
        dh = pre.shape[-1] // (4 * nh)
        c = torch.zeros((s + 1, b, nh, dh), dtype=torch.float32, device=pre.device)
        n, h = torch.zeros_like(c), torch.zeros_like(c)
        m = torch.zeros((s + 1, b, nh), dtype=torch.float32, device=pre.device)
        for t in _time_steps(s, reverse=False):
            c[t + 1], n[t + 1], h[t + 1], m[t + 1] = _cell_math(
                pre[:, t], c[t], n[t], h[t], m[t], r_h, nh, dh)
        ctx.save_for_backward(pre, r_h, c, n, h, m)
        ctx.nh = nh
        return h[1:].transpose(0, 1).contiguous()

    @staticmethod
    @once_differentiable
    def backward(ctx, dhs):
        pre, r_h, c, n, h, m = ctx.saved_tensors
        nh = ctx.nh
        b, s = pre.shape[:2]
        dh = pre.shape[-1] // (4 * nh)
        dc = torch.zeros((b, nh, dh), dtype=torch.float32, device=pre.device)
        dn, dh_carry = torch.zeros_like(dc), torch.zeros_like(dc)
        dpres = torch.empty((s, b, nh, 4 * dh), dtype=torch.float32, device=pre.device)
        dhs = dhs.float()
        for t in _time_steps(s, reverse=True):
            cp, np_, hp, mp = c[t], n[t], h[t], m[t]
            cn, nn, mn = c[t + 1], n[t + 1], m[t + 1]
            pre_t = pre[:, t].reshape(b, nh, 4 * dh).float() + torch.einsum("bhd,hdf->bhf", hp, r_h)
            z_, i_, f_, o_ = pre_t.split(dh, dim=-1)
            f_arg = f_.mean(-1) + 1.0
            i_s = torch.exp(i_.mean(-1) - mn)
            f_s = torch.exp(F.logsigmoid(f_arg) + mp - mn)
            z_v, o_v = torch.tanh(z_), torch.sigmoid(o_)
            denom = torch.clamp_min(nn, 1.0)
            dh_t = dhs[:, t] + dh_carry
            dc_t = dc + dh_t * o_v / denom
            dn_t = dn - torch.where(nn > 1.0, dh_t * o_v * cn / (denom * denom), 0.0)
            di_s = (dc_t * z_v).sum(-1) + dn_t.sum(-1)
            df_s = (dc_t * cp).sum(-1) + (dn_t * np_).sum(-1)
            dpre = dpres[t]
            dpre[..., :dh] = dc_t * i_s[..., None] * (1.0 - z_v * z_v)
            dpre[..., dh: 2 * dh] = (di_s * i_s / dh)[..., None]
            dpre[..., 2 * dh: 3 * dh] = (df_s * f_s * torch.sigmoid(-f_arg) / dh)[..., None]
            dpre[..., 3 * dh:] = dh_t * (cn / denom) * o_v * (1.0 - o_v)
            dh_carry = torch.einsum("bhf,hdf->bhd", dpre, r_h)
            dc, dn = dc_t * f_s[..., None], dn_t * f_s[..., None]
        dr_h = torch.einsum("sbhd,sbhf->hdf", h[:-1], dpres)
        return dpres.transpose(0, 1).reshape(pre.shape).to(pre.dtype), dr_h, None


def _time_steps(s: int, reverse: bool):
    """The scan's ``s`` time steps, last to first with ``reverse``, as the
    trace's loop (:func:`repro_torch.trace_hooks.loop`: ``range`` outside a
    trace; the dry run traces one step and counts it ``s`` times, as the
    reference's analyzer multiplies a scan body)."""
    steps = trace_hooks.loop("slstm.time", s)
    return (s - 1 - t for t in steps) if reverse else steps


def slstm_scan(pre, r_h, nh: int):
    """The sLSTM's training scan through :class:`SlstmScan`."""
    return SlstmScan.apply(pre, r_h, nh)


def _slstm_local(p, cfg, pre, mode: str):
    """The sLSTM's time loop over ``DTensor``s (real ranks, or the dry
    run's sharded trace): each device runs it on its local rows (the batch
    split as ``pre``'s, every head whole); a trace counts one step S times.
    Returns (y (B, S, nh, dh) float32, prefill's final state or
    None)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, nh = pre.device_mesh, cfg.n_heads
    dh = cfg.d_model // nh
    pl = tuple(q if isinstance(q, Shard) and q.dim == 0 else Replicate() for q in pre.placements)
    pre_l = pre.redistribute(mesh, pl).to_local()
    # each rank's recurrent-weight gradient sums its own rows only: a partial
    # sum along the axes that split the batch
    r_h = p["r_h"].redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=tuple(Partial() if isinstance(q, Shard) else q for q in pl))
    b_l, s = pre_l.shape[:2]
    if mode == "train":
        hs = slstm_scan(pre_l, r_h, nh)
        return _from_local(hs, mesh, pl, (pre.shape[0], s, nh, dh)), None
    state = init_slstm_cache(Init(pre_l.device), cfg, b_l)
    hs = pre_l.new_empty((b_l, s, nh, dh), dtype=torch.float32)
    for t in trace_hooks.loop("slstm.time", s):
        state = _slstm_cell({"r_h": r_h}, cfg, pre_l[:, t], state)
        hs[:, t] = state["h"]
    return (_from_local(hs, mesh, pl, (pre.shape[0], s, nh, dh)),
            {k: _from_local(v, mesh, pl, (pre.shape[0], *v.shape[1:])) for k, v in state.items()})


def slstm_forward(p, cfg, x, *, mode: str = "prefill", cache=None):
    """x: (B, S, d).  ``prefill`` runs the cell over the S steps from a zero
    state and returns the final state; ``train`` runs :class:`SlstmScan`,
    with no cache; ``decode`` (S == 1) steps the state in ``cache``.
    Returns (out, new_cache)."""
    b, s, d = x.shape
    pre = x @ p["w_x"] + p["b"].to(x.dtype)
    if mode != "decode" and hasattr(pre, "device_mesh"):
        y, new_cache = _slstm_local(p, cfg, pre, mode)
        y = flat_heads(y)
    elif mode == "decode":
        new_cache = _slstm_cell(p, cfg, pre[:, 0], cache)
        y = new_cache["h"].reshape(b, 1, d)
    elif mode == "prefill":
        state = init_slstm_cache(Init(x.device), cfg, b)
        hs = []
        for t in trace_hooks.loop("slstm.time", s):
            state = _slstm_cell(p, cfg, pre[:, t], state)
            hs.append(state["h"])
        y = torch.stack(hs, dim=1).reshape(b, s, d)
        new_cache = state
    elif mode == "train":
        y, new_cache = slstm_scan(pre, p["r_h"], cfg.n_heads).reshape(b, s, d), None
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = rms_norm(y.to(x.dtype), p["norm_w"], cfg.norm_eps)
    return y @ p["down"], new_cache
