"""Public SSD scan op: the CUDA kernel for CUDA tensors (or it raises), the
plain chunkwise version for CPU tensors, and on ``meta`` tensors (a
shapes-only ingest trace) the outputs' shapes as one kernel operation
(:func:`repro_torch.trace_hooks.kernel`).

In grad mode, with an input that requires grad, the scan goes through
:class:`SsdScan`: its forward is the same kernel or plain version, its
backward recomputes the plain chunkwise scan under autograd and
differentiates it — what the reference does off the TPU, where it trains
the SSD by autodiff of ``reference_ssd_chunked`` (the Pallas kernel has
no VJP).  The Function sits below the padding, so the padding is
differentiated by torch.  On ``DTensor``s over a real process group the
forward runs on each rank's local shards
(:func:`repro_torch.kernels.sharded.on_shards`: B4 on the card, the plain
version on the CPU), and so does the backward; in the dry run's trace
(shards on the ``meta`` device) the forward is one kernel operation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import trace_hooks
from .. import sharded
from .kernel import scan_flops, ssd_scan_cuda
from .ref import ssd_chunked

__all__ = ["ssd_scan", "SsdScan"]


class SsdScan(torch.autograd.Function):
    """(x, dt, A, B, C, in_scale, chunk) -> (y in x's dtype, h_final
    float32), S a multiple of ``chunk``; gradients to x, dt, A, B, C and
    in_scale (a None ``in_scale`` ties it to dt), each in its input's
    dtype.  A cotangent of None (an output the loss does not read) counts
    as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, in_scale, chunk: int):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, in_scale)
        ctx.chunk = chunk
        return _scan(x, dt, A, B, C, chunk, in_scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dhf):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:6]
        if hasattr(saved[0], "device_mesh"):
            return _sharded_backward(saved, need, dy, dhf, ctx.chunk) + (None,)
        return _backward(saved, need, dy, dhf, ctx.chunk) + (None,)


def _backward(saved, need, dy, dhf, chunk: int) -> tuple:
    """The inputs' gradients (None where not needed): autograd of the plain
    chunkwise scan, recomputed."""
    leaves = [None if t is None else t.detach().requires_grad_(n) for t, n in zip(saved, need)]
    outs = [(i, g) for i, g in enumerate((dy, dhf)) if g is not None]
    wanted = [t for t, n in zip(leaves, need) if n]
    if not outs or not wanted:
        return (None,) * 6
    x, dt, A, B, C, sc = leaves
    with torch.enable_grad():
        y, hf = ssd_chunked(x, dt, A, B, C, chunk=chunk, in_scale=sc)
        res = (y.to(x.dtype), hf)
        grads = iter(torch.autograd.grad([res[i] for i, _ in outs], wanted,
                                         [g for _, g in outs], allow_unused=True))
    return tuple(next(grads) if n else None for n in need)


def _sharded_backward(saved, need, dy, dhf, chunk: int) -> tuple:
    """:func:`_backward` of ``DTensor`` operands, run by each rank on its
    local shards: batch and heads keep x's shards (dt, in_scale and A follow
    the heads, B and C the batch); B and C stay whole along the heads' axis
    and a rank takes the groups its heads read
    (:func:`repro_torch.kernels.sharded.read_index`, from its coordinate).
    The gradients of A, B and C are partial sums over the axes a rank sums
    only its part of."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = saved[0]
    mesh = x.device_mesh

    def spread(dims_to, partial_on_heads=False, partial_on_batch=False):
        out = []
        for p in x.placements:
            d = getattr(p, "dim", None)
            if d == 0:
                out.append(Partial() if partial_on_batch else
                           (Shard(dims_to[0]) if dims_to[0] is not None else Replicate()))
            elif d == 2:
                out.append(Shard(dims_to[1]) if dims_to[1] is not None else
                           (Partial() if partial_on_heads else Replicate()))
            else:
                out.append(Replicate())
        return tuple(out)

    # (input placements, gradient placements) of x, dt, A, B, C, in_scale
    heads = (0, 2)
    plan = [(spread(heads), spread(heads)), (spread(heads), spread(heads)),
            (spread((None, 0)), spread((None, 0), partial_on_batch=True)),
            (spread((0, None)), spread((0, None), partial_on_heads=True)),
            (spread((0, None)), spread((0, None), partial_on_heads=True)),
            (spread(heads), spread(heads))]
    dts = [t.redistribute(mesh, pl) if hasattr(t, "device_mesh") else t
           for t, (pl, _) in zip(saved, plan)]        # a plain input is the same everywhere
    local = [t.to_local() if hasattr(t, "device_mesh") else t for t in dts]
    index = sharded.read_index(x.shape[2], saved[3].shape[2], sharded.shard_offset(dts[0], 2),
                               local[0].shape[2], 0)
    full_bc = local[3].shape, local[4].shape
    local[3], local[4] = (sharded.take_read(t, index, 2) for t in local[3:5])
    ydy = None if dy is None else dy.redistribute(mesh, spread(heads)).to_local()
    hdh = None if dhf is None else dhf.redistribute(mesh, spread((0, 1))).to_local()
    grads = list(_backward(local, need, ydy, hdh, chunk))
    for i, shape in zip((3, 4), full_bc):
        if grads[i] is not None:
            grads[i] = sharded.put_read(grads[i], index, 2, shape)
    out = []
    for g, t, (_, gpl) in zip(grads, saved, plan):
        if g is None or not hasattr(t, "device_mesh"):
            out.append(g)
            continue
        stride = [1]
        for n in reversed(tuple(t.shape)[1:]):
            stride.insert(0, stride[0] * n)
        out.append(DTensor.from_local(g.contiguous(), mesh, gpl, run_check=False,
                                      shape=t.shape, stride=tuple(stride)))
    return tuple(out)


def _meta_kernel(x, dt, A, B, C, chunk: int, in_scale):
    """The scan as one kernel operation of a shapes-only trace."""
    bt, s, h, p = x.shape
    n = B.shape[3]
    inputs = (x, dt, A, B, C) + (() if in_scale is None else (in_scale,))
    return trace_hooks.kernel(
        "ssd_scan", scan_flops(bt, s, h, p, n, chunk), inputs,
        lambda: (torch.empty_like(x), x.new_empty((bt, h, n, p), dtype=torch.float32)))


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64, in_scale=None):
    """Batched SSD scan: x (Bt, S, H, P); dt (Bt, S, H); A (H,); B, C
    (Bt, S, G, N).  Returns (y (Bt, S, H, P) in x's dtype, h_final
    (Bt, H, N, P) float32).

    ``in_scale`` (Bt, S, H) decouples the input gate from the decay (mLSTM);
    None ties it to dt (Mamba-2).  A sequence that does not divide the chunk
    is right-padded with identity steps (dt = 0: decay 1, zero input), so
    the carried state is unaffected.
    """
    s = x.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        def padded(t):   # zeros after the last step, on the sequence axis (1)
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        y, hf = ssd_scan(padded(x), padded(dt), A, padded(B), padded(C), chunk=chunk,
                         in_scale=None if in_scale is None else padded(in_scale))
        return y[:, :s], hf
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, A, B, C, in_scale)):
        return SsdScan.apply(x, dt, A, B, C, in_scale, chunk)
    return _scan(x, dt, A, B, C, chunk, in_scale)


def _scan(x, dt, A, B, C, chunk: int, in_scale):
    """The forward on one device's tensors: B4 on CUDA ones, one kernel
    operation of a shapes-only trace on meta ones, the plain chunked scan on
    CPU ones; on ``DTensor``s over a real group, the same on each rank's
    local shards."""
    if hasattr(x, "device_mesh") and not x.is_meta:
        ops = (x, dt, A, B, C) + (() if in_scale is None else (in_scale,))
        return sharded.on_shards("ssd_scan", lambda *a: _scan(
            *a[:5], chunk, a[5] if len(a) > 5 else None), *ops)
    if x.is_cuda:
        return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, in_scale=in_scale)
    if x.is_meta:
        return _meta_kernel(x, dt, A, B, C, chunk, in_scale)
    y, hf = ssd_chunked(x, dt, A, B, C, chunk=chunk, in_scale=in_scale)
    return y.to(x.dtype), hf
