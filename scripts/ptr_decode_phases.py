#!/usr/bin/env python3
"""Where the whole-decode kernel B1 spends its time, phase by phase, on one
NVIDIA GPU, in both of its templates at the same shape.

Run from the repository root:  python3 scripts/ptr_decode_phases.py [--bf16]

Builds three variants of src/repro_torch/kernels/ptr/csrc/ptr_decode.cu
beside the kernel's own build: one with the cluster template switched off
(-DPTR_DECODE_FORCE_BLOCK), and two instrumented ones (-DPTR_DECODE_PHASES,
with and without the cluster template), whose thread 0 of each graph's
writing block sums the SM clock cycles of each phase of the decode.  Then,
with the released policy (checkpoints/respect-v1, hidden 128) on the
batches chip_smoke.py times — the four largest Table-I graphs (bucket
1024), the largest alone, and 64 synthetic graphs of 30 nodes (bucket 32),
and the first 30 and 60 of those (how many waves of clusters a batch
takes):

* times the cluster and the block template at the same shape, in turns
  (cluster, block, block, cluster), by the profiler's kernel durations;
* checks that the two give equal orders and the same logp/entropy bits
  (both sum each gate element in one order);
* prints, per template, each phase's cycles per entry and share, and the
  cycles a microsecond the largest graph ran at (its cycles over its
  device time);
* prints how many clusters of the cluster template the card holds at once,
  and how many of its blocks an SM holds, clusters aside (the occupancy
  API's numbers).

With --bf16 the same runs use the bf16 storage templates
(ptr_decode_cluster_bf16, ptr_decode_block_bf16: decode_batch(bf16=True)).

Exits non-zero without CUDA or if the templates disagree.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("setup", "compact", "drain", "gates", "cell+exchange", "glimpse", "pointer", "pick",
          "next input")
VARIANTS = {   # name -> (-D defines, the template it must run)
    "cluster": ((), "ptr_decode_cluster"),
    "block": (("PTR_DECODE_FORCE_BLOCK",), "ptr_decode_block"),
    "cluster, clocked": (("PTR_DECODE_PHASES",), "ptr_decode_cluster"),
    "block, clocked": (("PTR_DECODE_PHASES", "PTR_DECODE_FORCE_BLOCK"), "ptr_decode_block"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true", help="the bf16 storage templates")
    bf16 = ap.parse_args().bf16
    suffix = "_bf16" if bf16 else ""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ptr_decode_phases: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms   # the profiler's kernel durations
    from repro_torch.core import RespectScheduler, build_model_graph, sample_batch
    from repro_torch.core.batching import bucketize, pack_padded
    from repro_torch.kernels import build
    from repro_torch.kernels.ptr.decode import ARGTYPES, launch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:   # one nvcc a variant, all at once
        list(pool.map(lambda d: build.build_kernels(["ptr_decode"], d),
                      [d for d, _ in VARIANTS.values()]))
    fns = {v: build.load_function("ptr_decode", "ptr_decode_launch", ARGTYPES, d)
           for v, (d, _) in VARIANTS.items()}
    read = {}
    for v in ("cluster, clocked", "block, clocked"):
        read[v] = build.load_function("ptr_decode", "ptr_decode_phases_read",
                                      [ctypes.POINTER(ctypes.c_ulonglong)], VARIANTS[v][0])
    max_clusters, max_blocks = (
        build.load_function("ptr_decode", f"ptr_decode_max_{what}",
                            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)],
                            VARIANTS["cluster"][0]) for what in ("clusters", "blocks"))

    sched = RespectScheduler.from_release()
    net, D = sched.net, sched.max_deg
    golden = json.loads((ROOT / "tests" / "golden" / "dnn_schedules.json").read_text())
    table1 = [build_model_graph(nm) for nm in golden["models"]]
    big = [table1[i] for i in bucketize(table1)[1024]][-4:]
    synth = sample_batch(np.random.default_rng(0), 64, n=30)
    cases = (("bucket 1024, B=4", big),
             ("bucket 1024, B=1 (largest Table-I graph)", [max(table1, key=lambda g: g.n)]),
             ("bucket 32, B=64", synth), ("bucket 32, B=30", synth[:30]),
             ("bucket 32, B=60", synth[:60]))
    ok = True
    for label, graphs in cases:
        batch = pack_padded(graphs, max_deg=D).to("cuda")
        with torch.inference_mode():
            C, (h0, c0), emb = net.encode(batch.feats, batch.n_valid)
        args = (net, C, emb, h0, c0, batch.parent_mat, batch.n_valid)
        n, H = batch.bucket_n, net.hidden
        got = {}
        with torch.inference_mode():
            for v, fn in fns.items():
                *out, ran = launch(fn, *args, bf16=bf16)
                torch.cuda.synchronize()
                if ran != VARIANTS[v][1] + suffix:
                    raise RuntimeError(f"variant {v} ran {ran}")
                got[v] = out
            ms = {}
            for v in ("cluster", "block", "block", "cluster"):
                ms.setdefault(v, []).append(
                    device_ms(lambda: launch(fns[v], *args, bf16=bf16), VARIANTS[v][1] + suffix,
                              iters=5))
        same = {v: all(torch.equal(a, b) for a, b in zip(got["cluster"], got[v])) for v in got}
        ok &= all(same.values())
        nc, nb = ctypes.c_int(0), ctypes.c_int(0)
        build.check("ptr_decode", max_clusters(n, H, D, int(bf16), ctypes.byref(nc)))
        build.check("ptr_decode", max_blocks(n, H, D, int(bf16), ctypes.byref(nb)))
        real = sum(g.n for g in graphs)
        print(f"\n{label}, H={H}, n={n}{', bf16 storage' if bf16 else ''}: {real} real steps, "
              f"{len(graphs) * n - real} drained; "
              f"the card holds {nc.value} clusters of the cluster template at once, an SM "
              f"{nb.value} of its blocks (clusters aside)", flush=True)
        print(f"  device time (profiler, turns cluster/block/block/cluster on {card}): "
              + ", ".join(f"{v} {' '.join(f'{t:.4f}' for t in ts)} ms" for v, ts in ms.items()),
              flush=True)
        print(f"  outputs equal to the cluster template's, bit for bit: {same}", flush=True)
        for v in ("cluster, clocked", "block, clocked"):
            buf = (ctypes.c_ulonglong * (2 * len(PHASES)))()
            build.check("ptr_decode", read[v](buf))            # clears the counters
            with torch.inference_mode():
                launch(fns[v], *args, bf16=bf16)
            torch.cuda.synchronize()
            build.check("ptr_decode", read[v](buf))
            cyc, ent = list(buf[: len(PHASES)]), list(buf[len(PHASES):])
            total = sum(cyc)
            line = ", ".join(f"{p} {c / max(e, 1):.0f} x {e} ({100 * c / total:.1f}%)"
                             for p, c, e in zip(PHASES, cyc, ent))
            extra = ""
            if len(graphs) == 1:
                t = device_ms(lambda: launch(fns[v], *args, bf16=bf16), VARIANTS[v][1] + suffix,
                              iters=5)
                extra = (f"; {total} cycles in {t:.4f} ms of device time = "
                         f"{total / t / 1e3:.0f} cycles a microsecond")
            print(f"  {v}: cycles per entry x entries (share), summed over graphs: {line}{extra}",
                  flush=True)
    if not ok:
        print("ptr_decode_phases: the templates' outputs differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
