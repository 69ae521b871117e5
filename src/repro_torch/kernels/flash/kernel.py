"""Wrapper of the flash-attention forward CUDA kernel (``csrc/flash_fwd.cu``).

The counterpart of the reference's ``flash_attention_pallas``.  It takes
any Sq <= Sk and any head dims D, Dv <= 256 — the ragged edges are masked
inside the kernel, so no length rule of the TPU's tiling carries over.  On
CUDA tensors it launches the kernel on PyTorch's current stream; it takes
nothing else.  bfloat16 inputs go to the kernel's tensor-core template,
whose TMA loads need 16-byte aligned bases and strides: an operand that
is not so laid out is first copied (zero-padded to 8 columns) into one
that is.  float32 inputs go to the CUDA-core template as they are.

For training the kernel also writes each row's log-sum-exp
(``return_lse=True``), the residual of the backward in
:mod:`repro_torch.kernels.flash.vjp`.  The wrapper refuses inputs that
require grad in grad mode: its output carries no autograd history, so
differentiable calls go through ``ops.flash_attention``, which routes them
through that module's ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

__all__ = ["flash_attention_cuda", "attention_flops", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256      # FL_MAX_D in csrc/flash_fwd.cu
_DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 8 + [ctypes.c_float, _I, _I, _P]


def attention_flops(b: int, hq: int, sq: int, sk: int, d: int, dv: int, causal: bool) -> float:
    """The two products' operations over the (query, key) pairs the mask
    keeps: every pair, or (causal, queries at the end of the keys) the pairs
    on and below the diagonal."""
    pairs = sq * (sk - sq + 1) + sq * (sq - 1) // 2 if causal else sq * sk
    return 2.0 * b * hq * pairs * (d + dv)


def _inner_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` if TMA can load it (base 16-byte aligned, every stride of a
    dimension longer than 1 a multiple of 8 bf16 elements), else a copy
    padded with zero columns to a multiple of 8; the kernel still reads only
    the columns the caller's D (or Dv) names."""
    if x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st, n in zip(x.stride()[:3], x.shape[:3])
                                      if n > 1):
        return x
    d = x.shape[-1]
    out = x.new_zeros(x.shape[:3] + (-(-d // 8) * 8,))
    out[..., :d] = x
    return out


def flash_attention_cuda(q, k, v, *, causal: bool = True, scale: float | None = None,
                         return_lse: bool = False):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv), one dtype
    (float32 or bfloat16), any strides with the last dimension contiguous.
    Returns (B, Hq, Sq, Dv) in q's dtype, laid out (B, Sq, Hq, Dv) in memory
    so that the caller's transpose back to (B, Sq, Hq, Dv) is free; with
    ``return_lse`` also each row's log-sum-exp of the scaled scores, (B, Hq,
    Sq) float32 (-inf for a row with every key masked)."""
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    build.refuse_dtensor("flash_attention_cuda", q, k, v)
    build.refuse_grad("flash_attention_cuda", "call ops.flash_attention, whose autograd "
                      "Function has the backward, or run under torch.no_grad()", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be 4-D (B, H, S, D)")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dk = k.shape
    Dv = v.shape[-1]
    if (k.shape[0], v.shape[0]) != (B, B) or tuple(v.shape[1:3]) != (Hkv, Sk) or Dk != D:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if Hq % Hkv:
        raise ValueError("Hq must be a multiple of Hkv")
    if Sq > Sk:
        raise ValueError(f"the kernel takes Sq <= Sk, got Sq={Sq}, Sk={Sk}")
    if not (0 < D <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM):
        raise ValueError(f"the kernel takes head dims up to {MAX_HEAD_DIM}, got D={D}, Dv={Dv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    q, k, v = (_inner_contiguous(t) for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(t) for t in (q, k, v))
    o = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    fn = build.load_function("flash_fwd", "flash_fwd_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), strides,
            B, Hq, Hkv, Sq, Sk, D, Dv, int(causal), scale, int(q.dtype == torch.bfloat16),
            q.device.index or 0, stream)
    build.check("flash_fwd", rc)
    build.LAUNCHES["flash_fwd"] += 1
    return (o, lse) if return_lse else o
