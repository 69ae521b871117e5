"""Whole-decode pointer kernel (``csrc/ptr_decode.cu``) and its plain version.

The counterpart of the reference's ``repro.kernels.ptr.decode``: the whole
greedy or sampled pointing decode of a padded batch in one launch, one
thread block per graph.  :func:`decode_batch` launches the kernel for CUDA
tensors and runs :func:`decode_batch_reference` — the plain PyTorch decode
loop of :class:`repro_torch.core.ptrnet.PointerNet` — for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .kernel import MAX_SMEM_BYTES, THREADS, _WARPS, hidden_ok
from .ref import precompute_refs

__all__ = ["decode_batch", "decode_batch_reference", "decode_kernel_supported"]


def decode_smem_bytes(n: int, hidden: int, max_deg: int) -> int:
    """Dynamic shared memory of one block (mirrors ``ptr_decode_smem_bytes``)."""
    return (4 * (16 * hidden + THREADS + _WARPS + 2 * n)
            + 4 * (n + _WARPS + n * max_deg + 1) + n)


def decode_kernel_supported(bucket_n: int, hidden: int, max_deg: int = 6) -> bool:
    """True when the whole-decode kernel takes a (bucket_n, hidden) graph:
    its per-graph state (h, c, the decoder input, gates, per-node flags,
    lists and the parent indices) fits one block's shared memory."""
    return hidden_ok(hidden) and decode_smem_bytes(bucket_n, hidden, max_deg) <= MAX_SMEM_BYTES


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 20 + [_I] * 6 + [_P]


def decode_batch_reference(net, C, emb, h0, c0, parent_mat, n_valid, uniforms=None):
    """Plain PyTorch whole decode with the kernel's contract (see
    :func:`decode_batch`)."""
    return net.decode(C, emb, (h0, c0), parent_mat, n_valid=n_valid, uniforms=uniforms)


def decode_batch(net, C, emb, h0, c0, parent_mat, n_valid, uniforms=None):
    """Whole decode over a padded batch of encoded graphs.

    C, emb: (B, n, H) contexts and projected embeddings; h0, c0: (B, H)
    final encoder state; parent_mat: (B, n, D) int (-1 padded); n_valid:
    (B,) int; uniforms: (B, n) per-step draws for a sampled decode, None for
    greedy.  A node is selectable once every parent is visited.  Returns
    order (B, n) int64 and logp, entropy (B, n) float32, drained padded
    steps at zero logp and entropy.
    """
    if not C.is_cuda:
        return decode_batch_reference(net, C, emb, h0, c0, parent_mat, n_valid, uniforms)
    B, n, H = C.shape
    D = parent_mat.shape[-1]
    if not decode_kernel_supported(n, H, D):
        raise ValueError(f"ptr_decode kernel cannot take n={n}, hidden={H}, max_deg={D}")
    dev = C.device
    f32 = torch.float32
    CWg, CWp = precompute_refs(net, C)
    f = lambda x: x.to(device=dev, dtype=f32).contiguous()
    args = [f(C), f(CWg), f(CWp), f(emb), f(net.start_token()), f(h0), f(c0), f(net.dec.wx),
            f(net.dec.wh), f(net.dec.b), f(net.glimpse.w_q), f(net.glimpse.v),
            f(net.pointer.w_q), f(net.pointer.v)]
    pm = parent_mat.to(device=dev, dtype=torch.int32).contiguous()
    nv = n_valid.to(device=dev, dtype=torch.int32).contiguous()
    unif = None if uniforms is None else f(uniforms)
    if unif is not None and tuple(unif.shape) != (B, n):
        raise ValueError(f"uniforms: expected {(B, n)}, got {tuple(unif.shape)}")
    order = torch.empty((B, n), dtype=torch.int32, device=dev)
    logp = torch.empty((B, n), dtype=f32, device=dev)
    ent = torch.empty((B, n), dtype=f32, device=dev)
    fn = build.load_function("ptr_decode", "ptr_decode_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*(a.data_ptr() for a in args), pm.data_ptr(), nv.data_ptr(),
            None if unif is None else unif.data_ptr(),
            order.data_ptr(), logp.data_ptr(), ent.data_ptr(),
            B, n, H, D, int(unif is not None), dev.index or 0, stream)
    build.check("ptr_decode", rc)
    build.LAUNCHES["ptr_decode"] += 1
    return order.long(), logp, ent

