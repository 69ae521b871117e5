"""Whole-decode pointer kernel (``csrc/ptr_decode.cu``) and its plain version.

The counterpart of the reference's ``repro.kernels.ptr.decode``: the whole
greedy or sampled pointing decode of a padded batch in one launch.
:func:`decode_batch` launches the kernel for CUDA tensors and runs
:func:`decode_batch_reference` — the plain PyTorch decode loop of
:class:`repro_torch.core.ptrnet.PointerNet` — for CPU tensors.

The kernel has two templates, chosen by shape (:func:`decode_template`):
``ptr_decode_cluster`` runs a graph on a cluster of four blocks that keep
the decoder's gate weights in their shared memory (hidden widths up to 128
at the release's buckets); ``ptr_decode_block`` runs a graph on one block
that reads them from L2 every step (any other width that fits, e.g. the
default 256).  Each template counts its own launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import build
from .kernel import MAX_SMEM_BYTES, THREADS, _WARPS, refuse_grad
from .ref import precompute_refs

__all__ = ["decode_batch", "decode_batch_reference", "decode_kernel_supported",
           "decode_smem_bytes", "decode_template", "launch", "step_uniforms", "TEMPLATES",
           "ARGTYPES"]

#: blocks a graph of the cluster template runs on (PTR_CLUSTER in ptr_decode.cu)
CLUSTER = 4
#: the kernel's templates, by the value its launcher reports
TEMPLATES = {1: "ptr_decode_cluster", 0: "ptr_decode_block"}


def hidden_ok(hidden: int) -> bool:
    """The block's thread groups split the hidden width evenly (both
    templates' matrix-vector products assume it)."""
    return 0 < hidden <= THREADS and THREADS % hidden == 0


def decode_smem_bytes(n: int, hidden: int, max_deg: int, template: str) -> int:
    """Dynamic shared memory of one block of ``template`` (mirrors
    ``ptr_decode_{cluster,block}_smem_bytes``): the per-graph state both keep
    (decoder input, query and score vectors, per-node scores, lists, flags
    and parent indices), plus h, c, gates and bias for the block template,
    or the block's Wx and Wh columns (2 hidden^2 floats), h by step parity,
    bias and c for the cluster template."""
    state = (4 * (6 * hidden + THREADS + _WARPS + 2 * n)
             + 4 * (n + _WARPS + n * max_deg + 1) + n)
    if template == "ptr_decode_block":
        return 4 * 10 * hidden + state
    if template == "ptr_decode_cluster":
        return 4 * (2 * hidden * hidden + 4 * hidden) + state
    raise ValueError(f"unknown template {template!r}")


def decode_template(bucket_n: int, hidden: int, max_deg: int = 6) -> str:
    """The template the launcher runs for a (bucket_n, hidden, max_deg)
    batch on a card that holds a four-block cluster (every Hopper card):
    the cluster template when hidden splits four ways and its shared memory
    fits 227 KB, else the block template when its own fits.  Raises
    ``ValueError`` when neither takes the shape."""
    if hidden_ok(hidden):
        if (hidden % CLUSTER == 0
                and decode_smem_bytes(bucket_n, hidden, max_deg, TEMPLATES[1]) <= MAX_SMEM_BYTES):
            return TEMPLATES[1]
        if decode_smem_bytes(bucket_n, hidden, max_deg, TEMPLATES[0]) <= MAX_SMEM_BYTES:
            return TEMPLATES[0]
    raise ValueError(f"ptr_decode kernel cannot take n={bucket_n}, hidden={hidden}, "
                     f"max_deg={max_deg}")


def decode_kernel_supported(bucket_n: int, hidden: int, max_deg: int = 6) -> bool:
    """True when one of the whole-decode kernel's templates takes a
    (bucket_n, hidden) graph (see :func:`decode_template`)."""
    try:
        decode_template(bucket_n, hidden, max_deg)
    except ValueError:
        return False
    return True


def step_uniforms(key, n: int) -> torch.Tensor:
    """The per-step uniforms of a sampled decode of ``n`` steps, float32 on
    the CPU: step ``i`` draws ``uniform(fold_in(key, i), ())``, the
    reference's stream (``repro.kernels.ptr.decode.step_uniforms``), so it
    does not depend on the padded length.  ``key`` is one (2,) uint32 key,
    giving (n,), or a batch of keys (B, 2), giving (B, n)."""
    from ...core import prng     # here: the core package imports this module
    key = np.asarray(key)
    return torch.from_numpy(prng.uniform(prng.fold_in(key[..., None, :], np.arange(n)), ()))


_P, _I = ctypes.c_void_p, ctypes.c_int
#: argument types of ``ptr_decode_launch``
ARGTYPES = [_P] * 20 + [_I] * 6 + [_P, ctypes.POINTER(ctypes.c_int)]


def decode_batch_reference(net, C, emb, h0, c0, parent_mat, n_valid, uniforms=None):
    """Plain PyTorch whole decode with the kernel's contract (see
    :func:`decode_batch`)."""
    return net.decode(C, emb, (h0, c0), parent_mat, n_valid=n_valid, uniforms=uniforms)


def load_launcher():
    """``ptr_decode_launch`` of the kernel's library, built and loaded at the
    first call."""
    return build.load_function("ptr_decode", "ptr_decode_launch", ARGTYPES)


def decode_batch(net, C, emb, h0, c0, parent_mat, n_valid, uniforms=None):
    """Whole decode over a padded batch of encoded graphs.

    C, emb: (B, n, H) contexts and projected embeddings; h0, c0: (B, H)
    final encoder state; parent_mat: (B, n, D) int (-1 padded); n_valid:
    (B,) int; uniforms: (B, n) per-step draws for a sampled decode, None for
    greedy.  A node is selectable once every parent is visited.  Returns
    order (B, n) int64 and logp, entropy (B, n) float32, drained padded
    steps at zero logp and entropy.  Forward only: raises on a
    grad-requiring input (or parameter) in grad mode, on the CPU too
    (:func:`~repro_torch.kernels.ptr.kernel.refuse_grad`).
    """
    refuse_grad("decode_batch", C, emb, h0, c0, *net.parameters())
    if not C.is_cuda:
        return decode_batch_reference(net, C, emb, h0, c0, parent_mat, n_valid, uniforms)
    fn = load_launcher()
    *out, template = launch(fn, net, C, emb, h0, c0, parent_mat, n_valid, uniforms)
    build.LAUNCHES[template] += 1
    return tuple(out)


def launch(fn, net, C, emb, h0, c0, parent_mat, n_valid, uniforms=None):
    """Launches ``fn`` — ``ptr_decode_launch`` of the kernel's library, or of
    an instrumented variant of it — on CUDA tensors with the contract of
    :func:`decode_batch`; returns order, logp, entropy and the name of the
    template that ran.  Counts nothing."""
    B, n, H = C.shape
    D = parent_mat.shape[-1]
    decode_template(n, H, D)          # raises on a shape neither template takes
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(-1)
    rc = fn(*(a.data_ptr() for a in args), pm.data_ptr(), nv.data_ptr(),
            None if unif is None else unif.data_ptr(),
            order.data_ptr(), logp.data_ptr(), ent.data_ptr(),
            B, n, H, D, int(unif is not None), dev.index or 0, stream, ctypes.byref(launched))
    build.check("ptr_decode", rc)
    return order.long(), logp, ent, TEMPLATES[launched.value]
