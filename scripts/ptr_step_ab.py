#!/usr/bin/env python3
"""The single-step kernel B2 of this tree against an earlier tree's, in
turns, in one process on one NVIDIA GPU.

Run from the repository root:

    python3 scripts/ptr_step_ab.py --parent DIR

DIR holds an earlier tree of the repository (for example a ``git archive``
of the parent commit, unpacked).  Its
``src/repro_torch/kernels/ptr/csrc/ptr_step.cu`` is built with nvcc beside
this tree's; it must export ``ptr_step_launch`` with the arguments of this
tree's launcher less the last one (the cluster size it reports), as the
one-block kernel ``ptr_step_kernel`` did.

The script records every step's (h, mask) of the heterogeneous batch's scan
decode (``chip_smoke.record_scan``: the release's policy, the batch and
system of ``chip_smoke.py``), holds both sides to the plain version on every
recorded step, then runs, for the sides in the order parent, change,
change, parent:

* the batch's time split (``chip_smoke.scan_split``) with that side's
  kernel as the scan's step;
* that side's device time over the recorded steps of each bucket (a batch,
  and the median launch);
* that side's device time at a seeded half-dense mask at bucket 1024, B = 4
  (the four largest Table-I graphs), the shape of ``chip_smoke.py``.

Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the earlier tree whose ptr_step.cu is compared")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ptr_step_ab: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core import PipelineSystem, RespectScheduler, build_model_graph, sample_batch
    from repro_torch.core.batching import bucketize, pack_padded
    from repro_torch.kernels import build
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.kernel import pointer_step_cuda
    from repro_torch.kernels.ptr.ref import reference_pointer_step

    card = cs.card_line()
    print(card, flush=True)
    build.build_kernels(["ptr_step"])
    lib_path = build.BUILD_DIR / "ab" / "libptr_step_parent.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(args.parent / "src/repro_torch/kernels/ptr/csrc/ptr_step.cu")], check=True)
    parent_fn = ctypes.CDLL(str(lib_path)).ptr_step_launch
    parent_fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    parent_fn.restype = ctypes.c_int

    def parent_step(C, CWg, CWp, h, w_q_g, v_g, w_q_p, v_p, mask):
        B, n, H = C.shape
        ins = [x.contiguous() for x in (C, CWg, CWp, h, w_q_g, v_g, w_q_p, v_p)]
        mask_i = mask.to(torch.int32).contiguous()
        out = torch.empty((B, n), dtype=torch.float32, device=C.device)
        rc = parent_fn(*(x.data_ptr() for x in ins), mask_i.data_ptr(), out.data_ptr(), B, n, H,
                       C.device.index or 0, torch.cuda.current_stream(C.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent ptr_step launch failed: CUDA error {rc}")
        return out

    sides = {"parent": (parent_step, "ptr_step_kernel"),
             "change": (pointer_step_cuda, "ptr_step_cluster")}

    def factory(launch):
        def make(net, C):
            CWg, CWp = ops.precompute_refs(net, C)
            g, p = net.glimpse, net.pointer
            return lambda h, mask: launch(C, CWg, CWp, h, g.w_q, g.v, p.w_q, p.v, mask)
        return make

    names = list(json.loads(cs.GOLDEN.read_text())["models"])
    table1 = [build_model_graph(nm) for nm in names]
    synth = sample_batch(np.random.default_rng(0), 64, n=30)
    graphs = [table1[names.index("InceptionResNetv2")], table1[names.index("ResNet50")]]
    graphs += synth[:16]
    hsys = PipelineSystem(**cs.HETERO)
    sched = RespectScheduler.from_release()
    net, D = sched.net, sched.max_deg
    steps = sum(bucketize(graphs))
    recs = cs.record_scan(net, graphs, hsys, D)

    big = [table1[i] for i in bucketize(table1)[1024]][-4:]
    packed = pack_padded(big, max_deg=D).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        C, (h0, _), _ = net.encode(packed.feats, packed.n_valid)
        valid = (torch.arange(packed.bucket_n, device="cuda")[None, :]
                 < packed.n_valid[:, None].long())
        mask = (torch.rand(valid.shape, generator=gen, device="cuda") < 0.5) & valid
        step_args = (C, *ops.precompute_refs(net, C), h0, net.glimpse.w_q, net.glimpse.v,
                     net.pointer.w_q, net.pointer.v, mask)

    for side, (launch, _) in sides.items():
        err = rel = 0.0
        with torch.inference_mode():
            for rec in recs:
                got = cs.replay(net, rec, launch)
                want = cs.replay(net, rec, reference_pointer_step)
                for (_, m_t), k, p in zip(rec["steps"], got, want):
                    same, e, rl = cs.compare_logits(k, p, m_t)
                    cs.check(same and rl <= cs.TOL_LOGITS,
                             f"{side}: bucket {rec['bucket_n']}: logits differ ({e:.3e})")
                    err, rel = max(err, e), max(rel, rl)
        print(f"{side}: all {steps} recorded steps held to the plain version, max |err| "
              f"{err:.2e}, relative {rel:.2e} (tolerance {cs.TOL_LOGITS})", flush=True)

    for rnd, side in enumerate(("parent", "change", "change", "parent")):
        launch, kname = sides[side]
        res = cs.scan_split(net, graphs, hsys, D, factory(launch), kname, steps)
        print(f"[{rnd}] " + cs.split_line(f"heterogeneous batch, {side} B2", card, res),
              flush=True)
        for rec in recs:
            dev = cs.replay_device_ms(net, rec, launch, kname)
            print(f"[{rnd}] {side} B2, heterogeneous bucket {rec['bucket_n']} (B={rec['B']}, "
                  f"{len(dev)} recorded steps) on {card}: device {sum(dev):.4f} ms a batch, "
                  f"{statistics.median(dev):.5f} ms a launch (median)", flush=True)
        with torch.inference_mode():
            dev_ms = cs.device_ms(lambda: launch(*step_args), kname, iters=50)
        print(f"[{rnd}] {side} B2, bucket 1024, B=4, half-dense ({int(mask.sum())} selectable "
              f"rows) on {card}: device {dev_ms:.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
