"""Public SSD scan op: the CUDA kernel for CUDA tensors (or it raises), the
plain chunkwise version for CPU tensors, and on ``meta`` tensors (a
shapes-only ingest trace) the outputs' shapes as one kernel operation
(:func:`repro_torch.trace_hooks.kernel`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import trace_hooks
from .kernel import scan_flops, ssd_scan_cuda
from .ref import ssd_chunked

__all__ = ["ssd_scan"]


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
