"""Public attention ops.

``flash_attention`` launches the CUDA kernel for CUDA tensors (or raises)
and runs the plain PyTorch version for CPU tensors; on ``meta`` tensors (a
shapes-only ingest trace) it returns the output's shape as one kernel
operation (:func:`repro_torch.trace_hooks.kernel`).  ``decode_attention``
stays plain on both, as in the reference (a single query against the
cache is a memory-bound gather and reduction that needs no kernel of its
own).  The flash backward waits for training.
"""

from __future__ import annotations

from ... import trace_hooks
from .kernel import attention_flops, flash_attention_cuda
from .ref import reference_attention

__all__ = ["flash_attention", "decode_attention"]


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Multi-head attention, q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D[v]) ->
    (B, Hq, Sq, Dv) in q's dtype."""
    if scale is None:
        scale = float(q.shape[-1] ** -0.5)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    if q.is_meta:
        (b, hq, sq, d), sk, dv = q.shape, k.shape[2], v.shape[-1]
        return trace_hooks.kernel("flash_fwd", attention_flops(b, hq, sq, sk, d, dv, causal),
                                  (q, k, v), lambda: q.new_empty((b, hq, sq, dv)))
    return reference_attention(q, k, v, causal=causal, scale=scale)


def decode_attention(q, k_cache, v_cache, kv_len: int, *, scale: float | None = None):
    """Decode: q (B, Hq, Sq, D) against a (B, Hkv, S, D) cache of which the
    first ``kv_len`` entries are valid."""
    return reference_attention(q, k_cache, v_cache, causal=False, scale=scale, kv_len=kv_len)
