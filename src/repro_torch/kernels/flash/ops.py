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

On ``DTensor`` operands over a real process group each rank runs the same
dispatch on its local shards (:func:`repro_torch.kernels.sharded.on_shards`:
B3 on the card, the plain version on the CPU) and gets ``DTensor``
outputs; the dry run's shards live on the ``meta`` device and take the
trace's path.
"""

from __future__ import annotations

import torch

from ... import trace_hooks
from .. import sharded
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
    if hasattr(q, "device_mesh") and not q.is_meta:
        return sharded.on_shards("flash_fwd", lambda *a: flash_attention(
            *a, causal=causal, scale=scale), q, k, v)
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
    """:func:`decode_attention` of ``DTensor`` operands, each rank on its
    local shards: the batch split as the cache's; along an axis that splits
    the cache's sequence the query heads are whole and the softmax's max and
    sum, and the weighted sum over the values, are reduced across the ranks
    (the keys' positions from each rank's offset); along an axis that splits
    the key/value heads the query heads split with them; along an axis that
    splits none of these (an idle ``data`` axis under a batch of one) the
    weighted sum is split by heads, where no other axis splits the heads
    (the reference's layout for it)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = k.device_mesh
    b, hq = q.shape[:2]
    hkv = k.shape[1]
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    qp, kp, seq_axes, free_axes = [], [], [], []
    for i, (size, p) in enumerate(zip(mesh.shape, k.placements)):
        d = getattr(p, "dim", None)
        if d == 0 and b % size == 0:
            qp.append(Shard(0)), kp.append(p)
        elif d == 2:
            qp.append(Replicate()), kp.append(p)
            seq_axes.append(i)
        elif d == 1 and hq % size == 0 and hkv % size == 0:
            qp.append(Shard(1)), kp.append(p)
        else:
            qp.append(Replicate()), kp.append(Replicate())
            if hq % size == 0 and size > 1:
                free_axes.append(i)
    if any(isinstance(p, Shard) and p.dim == 1 for p in qp):
        free_axes = []

    def reduced(t, op, pl):     # t's partial values across the sequence's axes, reduced
        part = tuple(Partial(op) if i in seq_axes else p for i, p in enumerate(pl))
        full = tuple(Replicate() if i in seq_axes else p for i, p in enumerate(pl))
        return sharded.wrap(t, mesh, part).redistribute(mesh, full).to_local()

    kd = k.redistribute(mesh, tuple(kp))
    ql = q.redistribute(mesh, tuple(qp)).to_local()
    kl, vl = kd.to_local(), v.redistribute(mesh, tuple(kp)).to_local()
    ke, ve = expand_kv(kl, ql.shape[1]), expand_kv(vl, ql.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", ql.float(), ke.float()) * scale
    pos = sharded.shard_offset(kd, 2) + torch.arange(ke.shape[2], device=s.device)
    s = s.masked_fill(pos >= kv_len, float("-inf"))
    e = torch.exp(s - reduced(s.amax(-1, keepdim=True), "max", qp))
    p = e / reduced(e.sum(-1, keepdim=True), "sum", qp)
    op = list(qp)
    if free_axes:                 # this rank's block of heads, numbered by its coordinates
        block, n = 0, p.shape[1]
        for i in free_axes:
            n //= mesh.shape[i]
            block = block * mesh.shape[i] + mesh.get_local_rank(i)
            op[i] = Shard(1)
        p, ve = p[:, block * n: (block + 1) * n], ve[:, block * n: (block + 1) * n]
    out = reduced(torch.einsum("bhqk,bhkd->bhqd", p, ve.float()), "sum", op)
    return sharded.wrap(out.to(q.dtype), mesh, tuple(op))
