#!/usr/bin/env python3
"""B4's bfloat16 tiled template of this tree against an earlier tree's, in
turns, in one process on one NVIDIA GPU.

Run from the repository root:

    python3 scripts/ssd_tiled_ab.py --parent DIR

DIR holds an earlier tree of the repository (for example a ``git archive``
of the parent commit, unpacked).  Its
``src/repro_torch/kernels/ssd/csrc/ssd_scan.cu`` is built with nvcc beside
this tree's; it must export ``ssd_scan_launch`` with this tree's arguments.
Both sides run through this tree's wrapper (``ssd_scan_cuda``: the same
strides, outputs and stream), each with its own library.

At xlstm-350m's mLSTM shapes (H = G = 4, N = 512, chunk 64, bfloat16, a
decoupled in_scale; k and q the strided halves of one (Bt, S, 2, H, N)
tensor, as ``chip_smoke.py`` makes them) the script holds both sides to the
plain chunked scan (y within ``chip_smoke.TOL_BF16_OUT``, the final state
within ``TOL_SSD_STATE``), then, for the sides in the order parent, change,
change, parent, takes each side's device time under the profiler (the mean
of 10 launches, by the side's kernel name) of the numerator (P = 512) and the
normalizer (P = 1) at the served prefill (Bt = 2, S = 1024) and the training
microbatch (Bt = 1, S = 256), each beside its bound.

It also builds a probe that includes this tree's ``ssd_scan.cu`` and prints
how many clusters of 2, 4, 8 and 16 blocks of its P-split template can be
resident at once (``cudaOccupancyMaxActiveClusters``): why the template's
blocks go in pairs.  Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the occupancy query, compiled with the kernel source it includes
PROBE = r"""
#include "{src}"
extern "C" int ssd_tiled_max_clusters(int k, int device, int* out) {{
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  auto kern = ssd_scan_tiled_bf16_kernel<false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TpLayout::ALLOC);
  if (e == cudaSuccess && k > 8)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {{}};
  cfg.gridDim = dim3(16 * k, 1, 1);
  cfg.blockDim = dim3(TB_THREADS);
  cfg.dynamicSmemBytes = TpLayout::ALLOC;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}}
"""
SHAPES = {"served prefill": (2, 1024), "training microbatch": (1, 256)}
H, N, CHUNK = 4, 512, 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the earlier tree whose ssd_scan.cu is compared")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_tiled_ab: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import kernel
    from repro_torch.kernels.ssd.ref import ssd_chunked

    card = cs.card_line()
    print(card, flush=True)
    build.build_kernels(["ssd_scan"])
    lib_path = build.BUILD_DIR / "ab" / "libssd_scan_parent.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(args.parent / "src/repro_torch/kernels/ssd/csrc/ssd_scan.cu")], check=True)
    probe_src = lib_path.parent / "ssd_tiled_probe.cu"
    probe_src.write_text(PROBE.format(src=ROOT / "src/repro_torch/kernels/ssd/csrc/ssd_scan.cu"))
    probe_path = lib_path.parent / "libssd_tiled_probe.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(probe_path), str(probe_src)],
                   check=True)
    import ctypes
    occ = ctypes.CDLL(str(probe_path)).ssd_tiled_max_clusters
    occ.argtypes, occ.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fits = []
    for k in (2, 4, 8, 16):
        n = ctypes.c_int(-1)
        build.check("ssd_scan", occ(k, 0, ctypes.byref(n)))
        fits.append(f"{k}: {n.value} clusters ({k * n.value} blocks)")
    print(f"change: the P-split template (one block an SM) on {card}, {sms} SMs: at most "
          f"{', '.join(fits)} resident by cudaOccupancyMaxActiveClusters", flush=True)
    parent_lib = ctypes.CDLL(str(lib_path))
    parent_fn = parent_lib.ssd_scan_launch
    parent_fn.argtypes = kernel._ARGTYPES
    parent_fn.restype = ctypes.c_int
    load_function = build.load_function

    @contextlib.contextmanager
    def side(name):
        """This tree's wrapper, launching the parent's library for 'parent'."""
        if name == "parent":
            build.load_function = lambda *a, **kw: parent_fn
        try:
            yield
        finally:
            build.load_function = load_function

    kernel_name = {"parent": cs.SSD_TILED_F32, "change": cs.SSD_TILED_BF16}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for label, (bt, s) in SHAPES.items():
        gates = torch.randn((bt, s, 2 * H), generator=gen, device="cuda")
        i_g, f_g = torch.sigmoid(gates[..., :H]), torch.sigmoid(gates[..., H:] + 2.0)
        dt = -torch.log(f_g.clamp(1e-6, 1 - 1e-6))
        A = torch.ones((H,), device="cuda")
        kq = torch.randn((bt, s, 2, H, N), generator=gen, device="cuda").to(torch.bfloat16)
        k, q = kq[:, :, 0] * N ** -0.5, kq[:, :, 1]
        for kind, p in (("numerator", N), ("normalizer", 1)):
            x = (torch.randn((bt, s, H, p), generator=gen, device="cuda").to(torch.bfloat16)
                 if p > 1 else torch.ones((bt, s, H, 1), dtype=torch.bfloat16, device="cuda"))
            cases[(label, kind)] = (bt, s, p, (x, dt, A, k, q, i_g))

    def call(ins):
        x, dt, A, k, q, i_g = ins
        return kernel.ssd_scan_cuda(x, dt, A, k, q, chunk=CHUNK, in_scale=i_g)

    def within(got, want, tol):
        atol, rtol = tol
        d = (got.float() - want.float()).abs()
        return bool((d <= atol + rtol * want.float().abs()).all()), float(d.max())

    for nm in ("parent", "change"):
        for (label, kind), (bt, s, p, ins) in cases.items():
            with side(nm), torch.no_grad():
                y, hf = call(ins)
                names = set(cs.ssd_templates(lambda: call(ins), calls=2))
            wy, wh = ssd_chunked(*ins[:5], chunk=CHUNK, in_scale=ins[5])
            ok_y, err_y = within(y, wy.to(torch.bfloat16), cs.TOL_BF16_OUT)
            ok_h, err_h = within(hf, wh, cs.TOL_SSD_STATE)
            cs.check(ok_y and ok_h, f"{nm} {kind} {label}: y {err_y:.3e}, state {err_h:.3e} "
                     "outside the tolerances of the plain version")
            cs.check(bool(names) and all(kernel_name[nm] in n for n in names),
                     f"{nm} {kind} {label}: ran {sorted(names)}, expected {kernel_name[nm]}")
            print(f"{nm} {kind} {label} (Bt={bt} S={s} H=G={H} N={N} P={p}) on {card}: "
                  f"{sorted(names)}; max |err| y {err_y:.3e} (tolerance atol, rtol "
                  f"{cs.TOL_BF16_OUT}), state {err_h:.3e} (tolerance {cs.TOL_SSD_STATE})",
                  flush=True)

    for rnd, nm in enumerate(("parent", "change", "change", "parent")):
        for (label, kind), (bt, s, p, ins) in cases.items():
            with side(nm), torch.no_grad():
                dev = cs.device_ms(lambda: call(ins), kernel_name[nm], iters=10)
            b_ms, b_by = cs.bound(*cs.ssd_work(bt, s, H, p, H, N, CHUNK, 2, True),
                                  cs.BF16_FLOPS_PER_S)
            print(f"[{rnd}] {nm} {kind} {label} (Bt={bt} S={s} P={p}) on {card}: device "
                  f"{dev:.5f} ms, bound {b_ms:.5f} ms ({b_by}; {b_ms / dev:.4f} of the device "
                  f"time)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
