"""Plain PyTorch version of the fused pointer/glimpse decode step.

The counterpart of the reference's ``repro.kernels.ptr.ref
.reference_pointer_step``, batched over a leading graph dimension.  The
single-step CUDA kernel (:mod:`.kernel`) is held to it.
"""

from __future__ import annotations

import torch

__all__ = ["reference_pointer_step", "precompute_refs", "NEG_INF"]

NEG_INF = -1.0e9


def precompute_refs(net, C):
    """The decode-loop-invariant context projections (CWg, CWp) of C (..., n, H)."""
    return C @ net.glimpse.w_ref, C @ net.pointer.w_ref


def reference_pointer_step(C, CWg, CWp, h, w_q_g, v_g, w_q_p, v_p, mask):
    """One glimpse + pointer step.

    C, CWg, CWp: (B, n, H); h: (B, H); w_q_*: (H, H); v_*: (H,); mask:
    (B, n) bool, True = selectable.  Returns logits (B, n) with masked
    entries at ``NEG_INF``.
    """
    qg = h @ w_q_g
    sg = torch.tanh(CWg + qg[:, None, :]) @ v_g
    sg = torch.where(mask, sg, NEG_INF)
    attn = torch.softmax(sg, dim=-1)
    glimpse = (attn[:, None, :] @ C)[:, 0]
    qp = glimpse @ w_q_p
    logits = torch.tanh(CWp + qp[:, None, :]) @ v_p
    return torch.where(mask, logits, NEG_INF)
