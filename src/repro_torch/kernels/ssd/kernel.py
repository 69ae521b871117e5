"""Wrapper of the SSD chunked-scan CUDA kernel (``csrc/ssd_scan.cu``).

The counterpart of the reference's ``ssd_scan_pallas``.  On CUDA tensors it
launches the kernel on PyTorch's current stream; it takes nothing else.
For N and P up to :data:`MAX_DIM`, bfloat16 inputs go to the kernel's
tensor-core template, float32 inputs to its CUDA-core template.  N or P
above it (up to :data:`MAX_TILED_DIM`: the mLSTM's 512) go to a tiled
template: bfloat16 inputs to ``ssd_scan_tiled_bf16_kernel`` (tensor cores,
a thread-block cluster of the blocks of a (head, batch) that computes each
chunk's scores once; P above :data:`TILED_N_SPLIT_MAX_P` is split over the
cluster's blocks, smaller P splits N), float32 inputs to
``ssd_scan_tiled_kernel`` (CUDA cores).  Each has its own shared-memory
layout (:func:`smem_bytes`).  The wrapper refuses inputs that require grad in
grad mode: its outputs carry no autograd history, so differentiable calls
go through ``ops.ssd_scan``, whose autograd Function has the backward.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

__all__ = ["ssd_scan_cuda", "scan_flops", "smem_bytes", "MAX_DIM", "MAX_TILED_DIM",
           "MAX_SMEM_BYTES"]

MAX_DIM = 128                 # SSD_MAX_DIM in csrc/ssd_scan.cu: chunk, and N, P untiled
MAX_TILED_DIM = 512           # ST_MAX_DIM: N and P of the tiled template
MAX_SMEM_BYTES = 227 * 1024   # dynamic shared memory one block may use on Hopper
_DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 9 + [_P]


#: columns of P one block of the bfloat16 template owns (SB_PB in csrc/ssd_scan.cu)
P_SLICE = 32
#: columns of P (ST_PB) and rows of N in a tile (ST_NT) of the float32 tiled template
TILED_P_SLICE, TILED_N_TILE = 32, 64
#: the bfloat16 tiled template: P up to this splits N (TB_NSPLIT_MAX_P), into blocks of
#: TILED_N_SLICE state rows (TB_NB); larger P splits P, TILED_P_SLICE columns a block (TB_PB).
#: Its chunk tile is TILED_CHUNK (TB_QT): a longer chunk runs as its largest divisor up to it
TILED_N_SPLIT_MAX_P, TILED_N_SLICE, TILED_CHUNK = 8, 64, 64


def scan_flops(bt: int, s: int, h: int, p: int, n: int, chunk: int) -> float:
    """The scan's operations: per chunk and head, the lower triangle of
    C B^T and of its product with x, and the two (N, P) state products
    (C h and the state update)."""
    chunks = -(-s // chunk)
    tri = chunk * (chunk + 1) // 2
    return 2.0 * bt * h * chunks * (tri * n + tri * p + 2 * chunk * n * p)


def smem_bytes(chunk: int, n: int, p: int, bf16: bool = False) -> int:
    """Dynamic shared memory of one block, mirroring ``csrc/ssd_scan.cu``:

    * N or P above :data:`MAX_DIM`, bfloat16 (any chunk: the layouts are
      sized for :data:`TILED_CHUNK`): P above :data:`TILED_N_SPLIT_MAX_P`
      takes ``TpLayout::ALLOC`` (a two-stage ring of B and C tiles of 256
      rows of N; three chunk buffers of the x slice, dt and in_scale; the
      transposed update operand's bf16 halves; each warp's la; the
      lower-triangle 16 x 16 tiles of M = S o L o sc as bf16 hi and lo, two
      buffers; four partial slabs of e o C h; 1024 bytes to align the base
      for TMA's 128-byte swizzle), smaller P ``TnLayout::BYTES`` (a double
      buffer of the block's 64 columns of C and B, x, dt and in_scale; the
      state's bf16 halves; each warp's decay arrays; two buffers of the
      partial scores and C h the cluster reads; the block's gathered
      rows);
    * N or P above it, float32: ``st_smem_floats`` (the (N, 32) state
      slice, the x slice, a tile of C and of B, the masked scores and the
      decay arrays);
    * float32 otherwise: ``ssd_smem_floats``;
    * bfloat16 otherwise: ``SbLayout<QT, NT>::BYTES`` (chunk and N rounded
      up to 64 or 128, a double buffer of C, B, the x slice, dt and
      in_scale, the state slice's bf16 halves and each warp's decay
      arrays)."""
    if max(n, p) > MAX_DIM and bf16:
        qt = TILED_CHUNK
        if p <= TILED_N_SPLIT_MAX_P:
            px, lds, rb = 8, qt + 4, qt // 4
            return (2 * 2 * qt * TILED_N_SLICE * 2 + 2 * qt * (px + 8) * 2 + 2 * 2 * qt * 4
                    + 2 * px * (TILED_N_SLICE + 8) * 2 + (qt // 16) * 2 * qt * 4
                    + 2 * (qt * lds * 4 + qt * px * 4) + rb * lds * 4 + rb * px * 4)
        ntl, stages, nqt = 256, 2, qt // 16
        return (stages * 2 * qt * ntl * 2 + (stages + 1) * (qt * (TILED_P_SLICE + 8) * 2 + 2 * qt * 4)
                + 2 * TILED_P_SLICE * (qt + 8) * 2 + 8 * qt * 4 + 2 * (nqt * (nqt + 1) // 2) * 1024
                + 4 * qt * (TILED_P_SLICE + 2) * 4 + 1024)
    if max(n, p) > MAX_DIM:
        return 4 * (n * (TILED_P_SLICE + 1) + chunk * (TILED_P_SLICE + 1)
                    + 2 * chunk * (TILED_N_TILE + 1) + chunk * (chunk + 1) + 2 * chunk)
    if not bf16:
        return 4 * (n * (p + 1) + chunk * (p + 1) + 2 * chunk * (n + 1)
                    + chunk * (chunk + 1) + 2 * chunk)
    qt, nt = (64 if chunk <= 64 else 128), (64 if n <= 64 else 128)
    buffers = 2 * (2 * qt * nt * 2 + qt * (P_SLICE + 8) * 2 + 2 * qt * 4)
    return buffers + 2 * P_SLICE * (nt + 8) * 2 + (qt // 16) * 2 * qt * 4


def ssd_scan_cuda(x, dt, A, B, C, *, chunk: int, in_scale=None):
    """x: (Bt, S, H, P); dt, in_scale: (Bt, S, H); A: (H,); B, C:
    (Bt, S, G, N), with x, B and C of one dtype (float32 or bfloat16) and S a
    multiple of ``chunk``.  Any strides with the last dimension contiguous.
    Returns y (Bt, S, H, P) in x's dtype and h_final (Bt, H, N, P) float32."""
    if not x.is_cuda:
        raise ValueError("ssd_scan_cuda takes CUDA tensors")
    build.refuse_dtensor("ssd_scan_cuda", x, dt, A, B, C, in_scale)
    build.refuse_grad("ssd_scan_cuda", "call ops.ssd_scan, whose autograd Function has the "
                      "backward, or run under torch.no_grad()", x, dt, A, B, C, in_scale)
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(B.shape) != (bt, s, g, n) or tuple(C.shape) != (bt, s, g, n):
        raise ValueError(f"B, C must be {(bt, s, g, n)}, got {tuple(B.shape)}, {tuple(C.shape)}")
    sc = dt if in_scale is None else in_scale
    if tuple(dt.shape) != (bt, s, h) or tuple(sc.shape) != (bt, s, h) or tuple(A.shape) != (h,):
        raise ValueError("dt and in_scale must be (Bt, S, H) and A (H,)")
    if h % g:
        raise ValueError("H must be a multiple of G")
    if s % chunk:
        raise ValueError(f"S={s} must be a multiple of the chunk {chunk}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B, C must share one dtype of {_DTYPES}, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    smem = smem_bytes(chunk, n, p, bf16=x.dtype == torch.bfloat16)
    if chunk > MAX_DIM or max(n, p) > MAX_TILED_DIM or smem > MAX_SMEM_BYTES:
        raise ValueError(f"the kernel takes chunk <= {MAX_DIM} and N, P <= {MAX_TILED_DIM} "
                         f"within {MAX_SMEM_BYTES} bytes of shared memory; got chunk={chunk}, "
                         f"N={n}, P={p} ({smem} bytes, {x.dtype})")
    for t in (dt, sc, A, B, C):
        if t.device != x.device:
            raise ValueError("all operands must be on one device")
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    dt, sc = (t.float() if t.stride(-1) == 1 else t.float().contiguous() for t in (dt, sc))
    A = A.float().contiguous()
    y = torch.empty((bt, s, h, p), dtype=x.dtype, device=x.device)
    hout = torch.empty((bt, h, n, p), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 18)(*(st for t in (x, dt, sc, B, C, y) for st in t.stride()[:3]))
    fn = build.load_function("ssd_scan", "ssd_scan_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), dt.data_ptr(), sc.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), hout.data_ptr(), strides, bt, s, h, g, n, p, chunk,
            int(x.dtype == torch.bfloat16), x.device.index or 0, stream)
    build.check("ssd_scan", rc)
    build.LAUNCHES["ssd_scan"] += 1
    return y, hout
