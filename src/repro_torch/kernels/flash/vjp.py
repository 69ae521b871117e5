"""Flash attention with a flash backward: the twin of the reference's
``flash_mha_vjp`` (``repro/kernels/flash/vjp.py``), as a
``torch.autograd.Function``.

The forward keeps only (q, k, v, out, lse) — O(S d) — and the backward
recomputes each key block's probabilities from the row log-sum-exp:

    delta = rowsum(dO * O)
    for each key block j:
        S_j  = Q K_j^T * scale          P_j = exp(S_j - lse)
        dV_j = P_j^T dO                 dP_j = dO V_j^T
        dS_j = P_j * (dP_j - delta)
        dQ  += dS_j K_j * scale         dK_j = dS_j^T Q * scale

Forward: kernel B3 with its lse output on CUDA tensors
(:func:`~repro_torch.kernels.flash.kernel.flash_attention_cuda`), the plain
version with its lse on CPU ones.  On ``DTensor``s both run on each rank's
local shards: the forward by :func:`repro_torch.kernels.sharded.on_shards`,
the backward by :func:`sharded_backward`, each rank taking the key and
value heads its query heads read.  Backward: plain PyTorch, as the
reference's is plain XLA (no Pallas kernel).  Its products take operands
rounded to the input dtype and sum in float32, as the reference's
``preferred_element_type=float32`` dots do; a GQA group's key and value
gradients are summed over the group's query heads; the queries sit at the
end of the keys (query i at key position i + Sk - Sq); the last key block
may be ragged.  The Function saves the caller's q, k and v, not the
kernel's aligned copies of them.
"""

from __future__ import annotations

import torch

from ... import trace_hooks
from .. import sharded
from .kernel import attention_flops, flash_attention_cuda
from .ref import attention_with_lse, expand_kv

__all__ = ["flash_mha", "forward_with_lse", "flash_backward", "sharded_backward",
           "FlashAttention"]


def forward_with_lse(q, k, v, causal: bool, scale: float):
    """(out, lse): B3 on CUDA tensors (the kernel writes the lse), one kernel
    operation of a shapes-only trace on meta ones, the plain version on CPU
    ones; on ``DTensor``s over a real group, the same on each rank's local
    shards."""
    if hasattr(q, "device_mesh") and not q.is_meta:
        return sharded.on_shards("flash_fwd", lambda *a: forward_with_lse(*a, causal, scale),
                                 q, k, v)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale, return_lse=True)
    if q.is_meta:
        (b, hq, sq, d), sk, dv = q.shape, k.shape[2], v.shape[-1]
        return trace_hooks.kernel(
            "flash_fwd", attention_flops(b, hq, sq, sk, d, dv, causal), (q, k, v),
            lambda: (q.new_empty((b, hq, sq, dv)), q.new_empty((b, hq, sq), dtype=torch.float32)))
    return attention_with_lse(q, k, v, causal=causal, scale=scale)


def flash_backward(q, k, v, out, lse, dout, *, causal: bool, scale: float, block_k: int):
    """(dq, dk, dv) in the dtypes of q, k, v: the reference's ``_vjp_bwd``
    over key blocks of ``block_k``."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dt = q.dtype

    def rounded(t):   # an operand of a product: the input dtype, summed in float32
        return t.to(dt).float()

    qf, dof = rounded(q), rounded(dout)
    ke, ve = expand_kv(k, hq), expand_kv(v, hq)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    delta = (dout.float() * out.float()).sum(-1)                     # (b, hq, sq)
    dq = torch.zeros_like(q, dtype=torch.float32)                    # (b, hq, sq, d)
    dks, dvs = [], []
    for j0 in range(0, sk, block_k):
        kj, vj = rounded(ke[:, :, j0: j0 + block_k]), rounded(ve[:, :, j0: j0 + block_k])
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kj) * scale
        if causal and sq > 1:
            k_pos = torch.arange(j0, j0 + kj.shape[2], device=q.device)
            s = s.masked_fill(k_pos[None, :] > q_pos, float("-inf"))
        p = torch.exp(s - lse[..., None])                            # (b, hq, sq, bk)
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", rounded(p), dof))
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vj)
        ds = rounded(p * (dp - delta[..., None]))
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kj) * scale
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale)
    dk, dv = torch.cat(dks, dim=2), torch.cat(dvs, dim=2)
    if hkv != hq:
        dk = dk.reshape(b, hkv, hq // hkv, sk, d).sum(2)
        dv = dv.reshape(b, hkv, hq // hkv, sk, v.shape[-1]).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _contiguous_strides(shape) -> tuple:
    out = [1]
    for n in reversed(tuple(shape)[1:]):
        out.insert(0, out[0] * n)
    return tuple(out)


def sharded_backward(q, k, v, out, lse, dout, *, causal: bool, scale: float, block_k: int):
    """:func:`flash_backward` of ``DTensor`` operands, run by each rank on its
    local shards, as the forward runs: batch and query heads keep the
    queries' shards; key and value heads that the mesh axis does not divide
    stay whole, and a rank takes the ones its query heads read
    (:func:`repro_torch.kernels.sharded.read_index`, from its coordinate);
    its key and value gradients are then partial sums over that axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    hkv = k.shape[1]
    qp, kvp, kv_grad = [], [], []
    for size, p in zip(mesh.shape, q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            qp.append(p), kvp.append(p), kv_grad.append(p)
        elif isinstance(p, Shard) and p.dim == 1 and hkv % size == 0:
            qp.append(p), kvp.append(p), kv_grad.append(p)
        elif isinstance(p, Shard) and p.dim == 1:
            qp.append(p), kvp.append(Replicate()), kv_grad.append(Partial())
        else:
            qp.append(Replicate()), kvp.append(Replicate()), kv_grad.append(Replicate())

    qp, kvp = tuple(qp), tuple(kvp)
    q, k = sharded.placed(q, qp), sharded.placed(k, kvp)
    lq, lk, lv = q.to_local(), k.to_local(), sharded.placed(v, kvp).to_local()
    lout, ldout, llse = (sharded.placed(t, qp).to_local() for t in (out, dout, lse))
    index = sharded.read_index(q.shape[1], hkv, sharded.shard_offset(q, 1), lq.shape[1],
                               sharded.shard_offset(k, 1))
    dq, dk, dv = flash_backward(lq, sharded.take_read(lk, index, 1),
                                sharded.take_read(lv, index, 1), lout, llse, ldout,
                                causal=causal, scale=scale, block_k=block_k)
    dk, dv = sharded.put_read(dk, index, 1, lk.shape), sharded.put_read(dv, index, 1, lv.shape)

    def wrap(t, like, pl):         # t is contiguous: its global strides are too
        return DTensor.from_local(t.contiguous(), mesh, tuple(pl), run_check=False,
                                  shape=like.shape, stride=_contiguous_strides(like.shape))
    return wrap(dq, q, qp), wrap(dk, k, kv_grad), wrap(dv, v, kv_grad)


class FlashAttention(torch.autograd.Function):
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D[v]) -> (B, Hq, Sq, Dv)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, block_k: int):
        out, lse = forward_with_lse(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.block_k = causal, scale, block_k
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        backward = sharded_backward if hasattr(q, "device_mesh") else flash_backward
        dq, dk, dv = backward(q, k, v, out, lse, dout, causal=ctx.causal,
                              scale=ctx.scale, block_k=ctx.block_k)
        return dq, dk, dv, None, None, None


def flash_mha(q, k, v, causal: bool, scale: float, block_k: int):
    """Differentiable attention through :class:`FlashAttention`."""
    return FlashAttention.apply(q, k, v, causal, scale, block_k)
