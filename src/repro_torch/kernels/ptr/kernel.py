"""Wrapper of the single-step pointer/glimpse CUDA kernel (``csrc/ptr_step.cu``).

The counterpart of the reference's ``pointer_step_pallas``: one fused
glimpse + pointer step per graph of a batch, each graph on a cluster of
:func:`step_cluster_size` blocks that split its rows and its query columns.
On CUDA tensors it launches the kernel on PyTorch's current stream; it takes
nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

__all__ = ["pointer_step_cuda", "refuse_grad", "step_kernel_supported", "step_cluster_size",
           "step_smem_bytes", "THREADS", "MAX_SMEM_BYTES"]

THREADS = 512      # PTR_THREADS in csrc/ptr_common.cuh
_WARPS = THREADS // 32
#: dynamic shared memory one block may use on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
#: PTR_STEP_MAX_CLUSTER and PTR_STEP_ROWS_PER_BLOCK in csrc/ptr_step.cu
MAX_CLUSTER = 8
ROWS_PER_BLOCK = 128


def step_cluster_size(n: int) -> int:
    """Blocks a graph of ``n`` rows runs on (mirrors ``ptr_step_cluster_size``):
    one per 128 rows, at most 8, the largest portable cluster."""
    return min(MAX_CLUSTER, max(1, -(-n // ROWS_PER_BLOCK)))


def step_smem_bytes(n: int, hidden: int) -> int:
    """Dynamic shared memory of one block (mirrors ``ptr_step_smem_bytes``):
    six hidden-wide vectors, the block-reduction scratch, K exchange slots
    of hidden + 2 floats, and a score and a list entry per owned row."""
    k = step_cluster_size(n)
    rows = -(-n // k)
    return 4 * (6 * hidden + THREADS + _WARPS + k * (hidden + 2) + rows) + 4 * (rows + _WARPS)


def step_kernel_supported(n: int, hidden: int) -> bool:
    """True when the single-step kernel takes a (n, hidden) graph: any width
    and any n whose block fits the 227 KB of shared memory."""
    return n > 0 and hidden > 0 and step_smem_bytes(n, hidden) <= MAX_SMEM_BYTES


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 4 + [_P, ctypes.POINTER(ctypes.c_int)]


def _f32(x: torch.Tensor, name: str, shape: tuple) -> torch.Tensor:
    if x.dtype != torch.float32 or tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected float32 {shape}, got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def refuse_grad(name: str, *tensors) -> None:
    """:func:`repro_torch.kernels.build.refuse_grad` for the pointer
    kernels: their wrappers (and, for the same contract on the CPU, their
    plain routes) refuse grad-requiring inputs; differentiate through the
    plain PyTorch decode (:meth:`repro_torch.core.ptrnet.PointerNet.decode`
    with its default ``logits_fn``) and call the kernels under
    ``torch.no_grad()``."""
    build.refuse_grad(name, "differentiate through PointerNet.decode's plain logits_fn, or call "
                      "it under torch.no_grad()", *tensors)


def load_launcher():
    """``ptr_step_launch`` of the kernel's library, built and loaded at the
    first call."""
    return build.load_function("ptr_step", "ptr_step_launch", _ARGTYPES)


def pointer_step_cuda(C, CWg, CWp, h, w_q_g, v_g, w_q_p, v_p, mask) -> torch.Tensor:
    """C, CWg, CWp: (B, n, H) float32; h: (B, H); w_q_*: (H, H); v_*: (H,);
    mask: (B, n) bool, True = selectable.  Returns logits (B, n) float32,
    masked entries at -1e9."""
    if not C.is_cuda:
        raise ValueError("pointer_step_cuda takes CUDA tensors")
    refuse_grad("pointer_step_cuda", C, CWg, CWp, h, w_q_g, v_g, w_q_p, v_p)
    B, n, H = C.shape
    if not step_kernel_supported(n, H):
        raise ValueError(f"ptr_step kernel cannot take n={n}, hidden={H}")
    args = [_f32(C, "C", (B, n, H)), _f32(CWg, "CWg", (B, n, H)), _f32(CWp, "CWp", (B, n, H)),
            _f32(h, "h", (B, H)), _f32(w_q_g, "w_q_g", (H, H)), _f32(v_g, "v_g", (H,)),
            _f32(w_q_p, "w_q_p", (H, H)), _f32(v_p, "v_p", (H,))]
    if tuple(mask.shape) != (B, n):
        raise ValueError(f"mask: expected {(B, n)}, got {tuple(mask.shape)}")
    for a in args:
        if a.device != C.device:
            raise ValueError("all operands must be on one device")
    mask_i = mask.to(device=C.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, n), dtype=torch.float32, device=C.device)
    fn = load_launcher()
    stream = torch.cuda.current_stream(C.device).cuda_stream
    launched = ctypes.c_int(0)
    rc = fn(*(a.data_ptr() for a in args), mask_i.data_ptr(), out.data_ptr(),
            B, n, H, C.device.index or 0, stream, ctypes.byref(launched))
    build.check("ptr_step", rc)
    if launched.value != step_cluster_size(n):
        raise build.KernelError(f"ptr_step launched clusters of {launched.value} blocks, "
                                f"expected {step_cluster_size(n)}")
    build.LAUNCHES["ptr_step"] += 1
    return out
