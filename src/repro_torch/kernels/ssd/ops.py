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
differentiated by torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import trace_hooks
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
        if x.is_cuda:
            return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, in_scale=in_scale)
        y, hf = ssd_chunked(x, dt, A, B, C, chunk=chunk, in_scale=in_scale)
        return y.to(x.dtype), hf

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dhf):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:6]
        leaves = [None if t is None else t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        outs = [(i, g) for i, g in enumerate((dy, dhf)) if g is not None]
        wanted = [t for t, n in zip(leaves, need) if n]
        if not outs or not wanted:
            return (None,) * 7
        x, dt, A, B, C, sc = leaves
        with torch.enable_grad():
            y, hf = ssd_chunked(x, dt, A, B, C, chunk=ctx.chunk, in_scale=sc)
            res = (y.to(x.dtype), hf)
            grads = iter(torch.autograd.grad([res[i] for i, _ in outs], wanted,
                                             [g for _, g in outs], allow_unused=True))
        return tuple(next(grads) if n else None for n in need) + (None,)


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
    if x.is_cuda:
        return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, in_scale=in_scale)
    if x.is_meta:
        bt, _, h, p = x.shape
        n = B.shape[3]
        inputs = (x, dt, A, B, C) + (() if in_scale is None else (in_scale,))
        return trace_hooks.kernel(
            "ssd_scan", scan_flops(bt, s, h, p, n, chunk), inputs,
            lambda: (torch.empty_like(x), x.new_empty((bt, h, n, p), dtype=torch.float32)))
    y, hf = ssd_chunked(x, dt, A, B, C, chunk=chunk, in_scale=in_scale)
    return y.to(x.dtype), hf
