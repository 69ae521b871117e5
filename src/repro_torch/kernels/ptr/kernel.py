"""Wrapper of the single-step pointer/glimpse CUDA kernel (``csrc/ptr_step.cu``).

The counterpart of the reference's ``pointer_step_pallas``: one fused
glimpse + pointer step per graph of a batch.  On CUDA tensors it launches
the kernel on PyTorch's current stream; it takes nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

__all__ = ["pointer_step_cuda", "step_kernel_supported", "THREADS", "MAX_SMEM_BYTES"]

THREADS = 512      # PTR_THREADS in csrc/ptr_common.cuh
_WARPS = THREADS // 32
#: dynamic shared memory one block may use on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024


def step_smem_bytes(n: int, hidden: int) -> int:
    """Dynamic shared memory of one block (mirrors ``ptr_step_smem_bytes``)."""
    return 4 * (6 * hidden + THREADS + _WARPS + n) + 4 * (n + _WARPS)


def hidden_ok(hidden: int) -> bool:
    """The block's thread groups split the hidden width evenly."""
    return 0 < hidden <= THREADS and THREADS % hidden == 0


def step_kernel_supported(n: int, hidden: int) -> bool:
    """True when the single-step kernel takes a (n, hidden) block."""
    return hidden_ok(hidden) and step_smem_bytes(n, hidden) <= MAX_SMEM_BYTES


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 4 + [_P]


def _f32(x: torch.Tensor, name: str, shape: tuple) -> torch.Tensor:
    if x.dtype != torch.float32 or tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected float32 {shape}, got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def pointer_step_cuda(C, CWg, CWp, h, w_q_g, v_g, w_q_p, v_p, mask) -> torch.Tensor:
    """C, CWg, CWp: (B, n, H) float32; h: (B, H); w_q_*: (H, H); v_*: (H,);
    mask: (B, n) bool, True = selectable.  Returns logits (B, n) float32,
    masked entries at -1e9."""
    if not C.is_cuda:
        raise ValueError("pointer_step_cuda takes CUDA tensors")
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
    fn = build.load_function("ptr_step", "ptr_step_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(C.device).cuda_stream
    rc = fn(*(a.data_ptr() for a in args), mask_i.data_ptr(), out.data_ptr(),
            B, n, H, C.device.index or 0, stream)
    build.check("ptr_step", rc)
    build.LAUNCHES["ptr_step"] += 1
    return out
