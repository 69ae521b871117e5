"""Public entry to the pointer ops: the single-step and whole-decode
kernels, their shape gates, the build helper and the launch counters.

On CPU tensors every op runs its plain PyTorch version; on CUDA tensors it
launches its kernel or raises.  The gates test the CUDA kernels' own limits
and nothing of the TPU's tiling: the single step and the whole decode take
any hidden width whose block fits the 227 KB of shared memory a block may
use (the whole decode's cluster templates take fewer widths and shapes:
see ``decode.decode_template``).
"""

from __future__ import annotations

from ..build import BUILD_DIR, LAUNCHES, build_kernels
from . import decode, kernel
from .decode import decode_kernel_supported, decode_template
from .kernel import (MAX_SMEM_BYTES, pointer_step_cuda, refuse_grad, step_cluster_size,
                     step_kernel_supported)
from .ref import precompute_refs, reference_pointer_step

__all__ = [
    "precompute_refs",
    "pointer_step",
    "make_logits_fn",
    "step_kernel_supported",
    "step_cluster_size",
    "decode_kernel_supported",
    "decode_template",
    "build_kernels",
    "load_kernels",
    "LAUNCHES",
    "BUILD_DIR",
    "MAX_SMEM_BYTES",
]


def pointer_step(net, C, CWg, CWp, h, mask):
    """One glimpse + pointer step for a batch: C, CWg, CWp (B, n, H); h
    (B, H); mask (B, n) bool.  The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; raises on a grad-requiring input in grad mode
    (:func:`~repro_torch.kernels.ptr.kernel.refuse_grad`) on both."""
    g, p = net.glimpse, net.pointer
    refuse_grad("pointer_step", C, CWg, CWp, h, g.w_q, g.v, p.w_q, p.v)
    fn = pointer_step_cuda if C.is_cuda else reference_pointer_step
    return fn(C, CWg, CWp, h, g.w_q, g.v, p.w_q, p.v, mask)


def make_logits_fn(net, C):
    """``logits_fn(h, mask)`` for :meth:`PointerNet.decode`: hoists the
    context projections once per batch, then runs :func:`pointer_step`
    every decode step."""
    CWg, CWp = precompute_refs(net, C)
    return lambda h, mask: pointer_step(net, C, CWg, CWp, h, mask)


def load_kernels() -> None:
    """Build the whole-decode and single-step kernels where no current build
    exists (one ``nvcc`` each, in parallel) and load both libraries, so that
    neither kernel's first launch pays for it."""
    build_kernels(["ptr_decode", "ptr_step"])
    decode.load_launcher()
    kernel.load_launcher()
