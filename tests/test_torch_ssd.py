"""The port's SSD scan against the reference's, and the CUDA kernel against
its plain version.

On the CPU, ``ssd_scan`` runs its plain chunkwise version; it is held to the
reference's Pallas kernel in interpret mode on the same numpy inputs — y and
the final state, with B/C groups (G > 1), a decoupled ``in_scale`` and
sequences that do not divide the chunk (right-padded with identity steps):

* float32 at atol = rtol = 2e-5 (float32 sums and exps in another order);
* bfloat16 inputs at atol = rtol = 2e-2 for y (one rounding to bfloat16)
  and 2e-4 for the float32 state.

The per-timestep and chunkwise plain versions are held to the reference's
``reference_ssd``/``reference_ssd_chunked`` at 2e-5.  The kernel itself runs
only on the card: the ``cuda`` tests skip here.  There float32 inputs run the
kernel's CUDA-core templates and bfloat16 inputs its tensor-core ones (N or P
above 128: ``ssd_scan_tiled_bf16_kernel``, its N split at P <= 8 and its P
split above); all hold the float32 state at 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd.ref import reference_ssd as jax_reference_ssd
from repro.kernels.ssd.ref import reference_ssd_chunked as jax_reference_ssd_chunked
from repro_torch.kernels import build
from repro_torch.kernels.ssd.kernel import smem_bytes, ssd_scan_cuda
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.kernels.ssd.ref import reference_ssd, reference_ssd_chunked, ssd_chunked

torch.set_num_threads(1)


def _inputs(bt, s, h, p, g, n, seed=0, in_scale=False):
    rng = np.random.default_rng(seed)
    out = {
        "x": rng.standard_normal((bt, s, h, p)).astype(np.float32),
        "dt": (np.abs(rng.standard_normal((bt, s, h))) * 0.1 + 0.01).astype(np.float32),
        "A": (np.abs(rng.standard_normal((h,))) + 0.5).astype(np.float32),
        "B": rng.standard_normal((bt, s, g, n)).astype(np.float32),
        "C": rng.standard_normal((bt, s, g, n)).astype(np.float32),
    }
    out["in_scale"] = rng.uniform(0, 1, (bt, s, h)).astype(np.float32) if in_scale else None
    return out


CASES = [
    # (bt, s, h, p, g, n, chunk, in_scale, dtype, tol_y, tol_h)
    (2, 64, 4, 16, 2, 8, 16, False, "float32", 2e-5, 2e-5),
    (1, 50, 4, 8, 2, 4, 16, False, "float32", 2e-5, 2e-5),     # 50 = 3 chunks + 2
    (2, 40, 6, 8, 3, 8, 16, True, "float32", 2e-5, 2e-5),      # in_scale != dt, G = 3
    (2, 40, 2, 16, 2, 8, 16, False, "bfloat16", 2e-2, 2e-4),
    # above N = 128, the shapes of the tiled templates: P = 1 (N split), P above 128
    (1, 64, 2, 1, 2, 160, 32, True, "bfloat16", 2e-2, 2e-4),
    (1, 64, 2, 136, 1, 160, 32, True, "float32", 2e-5, 2e-5),
]


@pytest.mark.parametrize("bt,s,h,p,g,n,chunk,use_scale,dtype,tol_y,tol_h", CASES)
def test_plain_matches_pallas_interpret(bt, s, h, p, g, n, chunk, use_scale, dtype, tol_y, tol_h):
    a = _inputs(bt, s, h, p, g, n, in_scale=use_scale)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jh = jax_ssd_scan(jnp.asarray(a["x"], jdt), jnp.asarray(a["dt"]), jnp.asarray(a["A"]),
                          jnp.asarray(a["B"], jdt), jnp.asarray(a["C"], jdt), chunk=chunk,
                          impl="interpret",
                          in_scale=None if a["in_scale"] is None else jnp.asarray(a["in_scale"]))
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    before = dict(build.LAUNCHES)
    y, hf = ssd_scan(t["x"].to(tdt), t["dt"], t["A"], t["B"].to(tdt), t["C"].to(tdt),
                     chunk=chunk, in_scale=t["in_scale"])
    assert build.LAUNCHES == before          # nothing launched on the CPU
    assert y.dtype == tdt and y.shape == (bt, s, h, p) and hf.shape == (bt, h, n, p)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               atol=tol_y, rtol=tol_y)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jh), atol=tol_h, rtol=tol_h)


@pytest.mark.parametrize("use_scale", [False, True])
def test_sequence_references_match(use_scale):
    a = _inputs(1, 32, 4, 8, 2, 4, seed=1, in_scale=use_scale)
    one = {k: None if v is None else v[0] for k, v in a.items() if k != "A"}
    jargs = [jnp.asarray(one[k]) for k in ("x", "dt")] + [jnp.asarray(a["A"])] + \
        [jnp.asarray(one[k]) for k in ("B", "C")]
    targs = [torch.from_numpy(one[k]) for k in ("x", "dt")] + [torch.from_numpy(a["A"])] + \
        [torch.from_numpy(one[k]) for k in ("B", "C")]
    jsc = None if one["in_scale"] is None else jnp.asarray(one["in_scale"])
    tsc = None if one["in_scale"] is None else torch.from_numpy(one["in_scale"])
    for jfn, tfn, kw in ((jax_reference_ssd, reference_ssd, {}),
                         (jax_reference_ssd_chunked, reference_ssd_chunked, {"chunk": 8})):
        jy, jh = jfn(*jargs, in_scale=jsc, **kw)
        ty, th = tfn(*targs, in_scale=tsc, **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5, rtol=2e-5)


def test_kernel_wrapper_takes_only_cuda_tensors_and_gates_shapes():
    a = {k: torch.from_numpy(v) for k, v in _inputs(1, 16, 2, 8, 1, 4).items() if v is not None}
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(a["x"], a["dt"], a["A"], a["B"], a["C"], chunk=16)
    # float32 template: the path's shapes take 83.7 KB; 128^3 does not fit
    assert smem_bytes(64, 64, 64) == 4 * (64 * 65 * 5 + 128)
    assert smem_bytes(128, 128, 128) > 227 * 1024
    # bfloat16 template: 54 KB at the path's shapes (four blocks an SM), the
    # same for any chunk and N up to 64, and 175 KB at the limit of 128
    assert smem_bytes(64, 64, 64, bf16=True) == 55296 == smem_bytes(16, 8, 128, bf16=True)
    assert smem_bytes(128, 128, 128, bf16=True) == 179200 <= 227 * 1024
    # tiled float32 template (N or P above 128): the (N, 32) state slice, two
    # (chunk, 64) tiles; 124 KB at the mLSTM's N = 512
    assert smem_bytes(64, 512, 512) == 126464
    # tiled bfloat16 template, the same at any chunk (a chunk above 64 runs as its
    # largest divisor up to 64): N split at P <= 8 (84 KB: a block's 64 columns of
    # B and C, two buffers of the partials the cluster reads), P split above (210.5
    # KB: a 2-stage ring of (64, 256) TMA tiles, two buffers of M)
    assert smem_bytes(64, 512, 1, bf16=True) == smem_bytes(128, 512, 8, bf16=True) == 86016
    assert (smem_bytes(64, 512, 512, bf16=True) == smem_bytes(128, 512, 512, bf16=True)
            == smem_bytes(64, 512, 9, bf16=True) == 215552 <= 227 * 1024)


# ---------------------------------------------------------------------- #
# on the card only
# ---------------------------------------------------------------------- #
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("bt,s,h,p,g,n,chunk,use_scale,dtype", [
    (2, 256, 8, 64, 2, 64, 64, False, "float32"),     # the path's head shape
    (1, 300, 6, 24, 3, 40, 64, True, "float32"),      # ragged S, in_scale, odd dims
    (2, 128, 4, 128, 1, 32, 128, False, "float32"),   # chunk and P at the limit
    (2, 512, 16, 64, 2, 64, 64, False, "bfloat16"),
    (1, 300, 6, 24, 3, 40, 64, True, "bfloat16"),     # ragged S, in_scale, odd dims
    (2, 128, 4, 128, 1, 32, 128, False, "bfloat16"),  # chunk and P at the limit
    (1, 256, 2, 128, 1, 128, 128, False, "bfloat16"),  # chunk, N and P at the limit
    # the tiled template: xlstm-350m's mLSTM (H = G = 4, N = P = 512, and P = 1)
    (2, 256, 4, 512, 4, 512, 64, True, "bfloat16"),    # numerator
    (2, 256, 4, 1, 4, 512, 64, True, "bfloat16"),      # normalizer
    (1, 200, 4, 512, 4, 512, 64, True, "float32"),     # numerator, ragged S
    (1, 128, 4, 1, 4, 512, 64, True, "float32"),       # normalizer
    (1, 96, 2, 200, 1, 40, 32, True, "bfloat16"),      # P alone above 128, ragged slices
    # the bf16 tiled template's edges
    (2, 1024, 4, 1, 4, 512, 64, True, "bfloat16"),     # the served normalizer (N split)
    (1, 128, 2, 130, 1, 200, 64, True, "bfloat16"),    # N, P not multiples of a tile
    (1, 256, 8, 256, 2, 256, 64, False, "bfloat16"),   # G < H
    (1, 256, 2, 512, 2, 512, 32, True, "bfloat16"),    # chunk 32
    (1, 256, 2, 512, 2, 512, 128, True, "bfloat16"),   # chunk 128 (run as 2 x 64)
    (1, 256, 2, 1, 2, 512, 128, True, "bfloat16"),     # chunk 128, N split
    (1, 200, 4, 512, 4, 512, 64, True, "bfloat16"),    # numerator, ragged S
    (1, 300, 2, 1, 2, 320, 64, True, "bfloat16"),      # normalizer, ragged S, empty N slices
    (1, 128, 2, 24, 1, 256, 64, True, "bfloat16"),     # P split, one part-filled slice
    # the plain loads the dispatch takes for shapes TMA or 16-byte copies cannot
    (1, 128, 2, 130, 1, 132, 64, True, "bfloat16"),    # P split, N % 8 != 0: no TMA
    (1, 128, 2, 1, 2, 300, 64, True, "bfloat16"),      # N split, N % 8 != 0: no cp.async
    (1, 128, 2, 131, 1, 256, 64, True, "bfloat16"),    # odd P: y by single stores, x plain
])
def test_kernel_matches_plain_on_cuda(bt, s, h, p, g, n, chunk, use_scale, dtype):
    _need_cuda()
    tdt = getattr(torch, dtype)
    a = {k: None if v is None else torch.from_numpy(v).cuda()
         for k, v in _inputs(bt, s, h, p, g, n, seed=s, in_scale=use_scale).items()}
    x, B, C = a["x"].to(tdt), a["B"].to(tdt), a["C"].to(tdt)
    before = build.LAUNCHES["ssd_scan"]
    y, hf = ssd_scan(x, a["dt"], a["A"], B, C, chunk=chunk, in_scale=a["in_scale"])
    pad = (-s) % chunk
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) if t is not None
              else None for t in (x, a["dt"], B, C, a["in_scale"])]
    wy, wh = ssd_chunked(padded[0], padded[1], a["A"], padded[2], padded[3], chunk=chunk,
                         in_scale=padded[4])
    torch.cuda.synchronize()
    assert build.LAUNCHES["ssd_scan"] == before + 1
    tol_y = 1e-4 if dtype == "float32" else 2e-2       # float32 order / one bf16 rounding
    torch.testing.assert_close(y.float(), wy[:, :s].to(tdt).float(), atol=tol_y, rtol=tol_y)
    torch.testing.assert_close(hf, wh, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("p", [512, 1])
def test_tiled_bf16_takes_strided_views_on_cuda(p, offset):
    """B and C as the mLSTM's k and q views of one (Bt, S, 2, H, N) tensor
    (chip_smoke.py's layout): strided; at offset 0 16-byte aligned, through
    TMA (P = 512) or 16-byte cp.async (P = 1), at offset 2 elements past an
    aligned base, through the plain loads; held to the plain version at the
    file's tolerances."""
    _need_cuda()
    bt, s, h, n, chunk = 1, 256, 4, 512, 64
    rng = np.random.default_rng(p)
    size = bt * s * 2 * h * n
    flat = torch.from_numpy(rng.standard_normal(size + offset).astype(np.float32)).cuda()
    kq = flat.to(torch.bfloat16)[offset:].view(bt, s, 2, h, n)
    B, C = kq[:, :, 0], kq[:, :, 1]
    assert not B.is_contiguous() and not C.is_contiguous()
    assert (B.data_ptr() % 16 == 0) == (offset == 0)
    x = torch.from_numpy(rng.standard_normal((bt, s, h, p)).astype(np.float32)).cuda()
    x = x.to(torch.bfloat16)
    dt = torch.from_numpy((np.abs(rng.standard_normal((bt, s, h))) * 0.1 + 0.01)
                          .astype(np.float32)).cuda()
    sc = torch.from_numpy(rng.uniform(0, 1, (bt, s, h)).astype(np.float32)).cuda()
    A = torch.ones((h,), device="cuda")
    y, hf = ssd_scan(x, dt, A, B, C, chunk=chunk, in_scale=sc)
    wy, wh = ssd_chunked(x, dt, A, B, C, chunk=chunk, in_scale=sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), wy.to(torch.bfloat16).float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(hf, wh, atol=1e-4, rtol=1e-4)
