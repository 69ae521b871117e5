"""Public attention ops.

``flash_attention`` launches the CUDA kernel for CUDA tensors (or raises)
and runs the plain PyTorch version for CPU tensors; on ``meta`` tensors (a
shapes-only ingest trace) it returns the output's shape as one kernel
operation (:func:`repro_torch.trace_hooks.kernel`).  In grad mode, with an
input that requires grad, it goes through the flash backward's autograd
Function (:mod:`repro_torch.kernels.flash.vjp`) on both devices, with key
blocks of :data:`BLOCK_K`.  The block changes only the order of the sums
and the backward's peak memory; with more than 128 keys, 512 (the
reference's Pallas route's) runs the backward 1.3-4.9x faster than 128 on
the card (``chip_smoke.py`` times both at the training paths' shapes).
``decode_attention`` stays plain on both, as in the reference (a single
query against the cache is a memory-bound gather and reduction that needs
no kernel of its own).
"""

from __future__ import annotations

import torch

from ... import trace_hooks
from .kernel import attention_flops, flash_attention_cuda
from .ref import expand_kv, reference_attention
from .vjp import flash_mha

__all__ = ["flash_attention", "decode_attention", "BLOCK_K"]

BLOCK_K = 512


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Multi-head attention, q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D[v]) ->
    (B, Hq, Sq, Dv) in q's dtype."""
    if scale is None:
        scale = float(q.shape[-1] ** -0.5)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return flash_mha(q, k, v, causal, scale, min(BLOCK_K, k.shape[2]))
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
    if hasattr(q, "device_mesh"):
        return _sharded_decode(q, k_cache, v_cache, kv_len, scale)
    return reference_attention(q, k_cache, v_cache, causal=False, scale=scale, kv_len=kv_len)


def _sharded_decode(q, k, v, kv_len: int, scale: float | None):
    """:func:`decode_attention` of ``DTensor`` operands (the dry run's
    sharded trace): the plain version, with the softmax over a key axis the
    cache may split taken from each shard's max and sum (reduced across
    the shards; the scores stay split), and the weighted sum over the
    values split by heads along every mesh axis that splits neither the
    probabilities nor the values (the reference's layout for it: with a
    batch of one the ``data`` axis is idle)."""
    from torch.distributed.tensor import Replicate, Shard
    hq = q.shape[1]
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    k, v = expand_kv(k, hq), expand_kv(v, hq)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(torch.arange(k.shape[2], device=q.device) >= kv_len, float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    mesh = p.device_mesh
    free = [isinstance(a, Replicate) and isinstance(b, Replicate) and hq % n == 0
            for n, a, b in zip(mesh.shape, p.placements, v.placements)]
    if any(free):
        p = p.redistribute(mesh, tuple(Shard(1) if f else a for f, a in zip(free, p.placements)))
        v = v.redistribute(mesh, tuple(Shard(1) if f else b for f, b in zip(free, v.placements)))
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
