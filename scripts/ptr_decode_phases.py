#!/usr/bin/env python3
"""Where the whole-decode kernel B1 spends its time, phase by phase, on one
NVIDIA GPU, in two of its templates at the same shape.

Run from the repository root:  python3 scripts/ptr_decode_phases.py [--bf16] [--wide]

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

With --wide the script compares the wide template (ptr_decode_wide_f32, or
ptr_decode_wide_bf16 with --bf16) with the block template instead, on
RespectScheduler.init(seed=0)'s hidden 256 and on hidden 384: builds the
variants -DPTR_DECODE_FORCE_WIDE (the wide template at any batch) and
-DPTR_DECODE_FORCE_BLOCK, each also clocked; then at bucket 1024 with
B = 1, 2, 4, 8, 16 (the five bucket-1024 Table-I graphs, the largest first,
repeated), at bucket 32 with B = 8, 14, 16, 32, 64, 128 (synthetic graphs
of 30 nodes; 14 is two waves of 7 clusters, 128 the paper-scale training
batch) and, at hidden 384, bucket 512 with B = 1 (the largest bucket-512
Table-I graph):

* times the two templates in turns (block, wide, wide, block) and names the
  template the kernel's own build picks for the shape;
* checks that both give orders equal to each other's (and, at B = 1, to
  the plain version's, logp and entropy within 1e-3) and says whether
  their logp and entropy are equal bit for bit;
* prints each phase's cycles per entry at B = 1;
* prints how many 16-block clusters of the wide template the card holds at
  once and how many of its blocks an SM holds (the occupancy API);
* and, once, the register budgets (the block template ran faster
  instrumented than plain while ptxas gave its plain build 32 registers):
  the registers, stack and spills of the block, four-block cluster and
  wide kernels in the plain and the -DPTR_DECODE_PHASES build (nvcc
  -Xptxas -v, and cuobjdump -res-usage of each variant's library), and the
  block and wide templates' device times in turns of the two builds at
  bucket 1024, B = 1, each build's outputs bit for bit the plain one's.

Exits non-zero without CUDA or if the templates disagree.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import time
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
    ap.add_argument("--wide", action="store_true",
                    help="the wide template against the block template, at hidden 256 and 384")
    opts = ap.parse_args()
    bf16 = opts.bf16
    suffix = "_bf16" if bf16 else ""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ptr_decode_phases: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    if opts.wide:
        return wide_main(bf16)
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
    max_clusters, max_blocks = probes(build, VARIANTS["cluster"][0])

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
        build.check("ptr_decode", max_clusters(n, H, D, int(bf16), 4, ctypes.byref(nc)))
        build.check("ptr_decode", max_blocks(n, H, D, int(bf16), 4, ctypes.byref(nb)))
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
            line, total = phase_line(build, read[v], fns[v], (args, {"bf16": bf16}))
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


def probes(build, defines: tuple):
    """ptr_decode_max_clusters and ptr_decode_max_blocks of a build: (n, H,
    D, bf16, cluster size, out)."""
    return (build.load_function("ptr_decode", f"ptr_decode_max_{what}",
                                [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)], defines)
            for what in ("clusters", "blocks"))


def phase_line(build, read, fn, launch_args) -> tuple[str, int]:
    """Each phase's cycles per entry, entries and share for one launch of the
    clocked variant ``fn`` (its counters read and cleared by ``read``), and
    the launch's cycles summed over its graphs."""
    import torch
    from repro_torch.kernels.ptr.decode import launch
    buf = (ctypes.c_ulonglong * (2 * len(PHASES)))()
    build.check("ptr_decode", read(buf))            # clears the counters
    with torch.inference_mode():
        launch(fn, *launch_args[0], **launch_args[1])
    torch.cuda.synchronize()
    build.check("ptr_decode", read(buf))
    cyc, ent = list(buf[: len(PHASES)]), list(buf[len(PHASES):])
    total = sum(cyc)
    return ", ".join(f"{p} {c / max(e, 1):.0f} x {e} ({100 * c / total:.1f}%)"
                     for p, c, e in zip(PHASES, cyc, ent)), total


KERNELS = ("ptr_decode_block", "ptr_decode_cluster", "ptr_decode_wide_f32")


def resource_usage(build, variants: dict) -> None:
    """Prints ptxas's registers, stack and spills of the float32 block,
    cluster and wide kernels of the plain and the clocked build, and
    cuobjdump's resource usage of each variant's library."""
    import shutil
    import tempfile
    nvcc = build._nvcc()
    src = build._csrc("ptr_decode") / "ptr_decode.cu"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    builds = {"plain": (), "clocked": ("PTR_DECODE_PHASES",)}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(builds)) as pool:
        def ptxas(item):
            label, defines = item
            cmd = [nvcc, *flags, *(f"-D{d}" for d in defines), "-Xptxas", "-v", "-c",
                   "-o", str(Path(tmp) / f"{label}.o"), str(src)]
            return subprocess.run(cmd, capture_output=True, text=True).stderr
        outs = list(pool.map(ptxas, builds.items()))
    for label, out in zip(builds, outs):
        lines = out.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and any(f"{k}'" in ln for k in KERNELS):
                info = " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                                  if "ptxas info" in x or "bytes stack" in x)
                print(f"  ptxas, {label} build, {ln.split(chr(39))[1]}: {info}", flush=True)
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    for v, (defines, _) in variants.items():
        res = subprocess.run([cuobjdump, "-res-usage", str(build.library_path("ptr_decode",
                                                                               defines))],
                             capture_output=True, text=True).stdout.splitlines()
        for i, ln in enumerate(res):
            if any(f"Function {k}:" in ln for k in KERNELS):
                print(f"  cuobjdump -res-usage, {v} build, {ln.split()[1].rstrip(':')}: "
                      f"{res[i + 1].strip()}", flush=True)


def wide_main(bf16: bool) -> int:
    """The --wide comparison; see the module's docstring."""
    import numpy as np
    import torch
    from chip_smoke import device_ms, turns_ms
    from repro_torch.core import RespectScheduler, build_model_graph, sample_batch
    from repro_torch.core.batching import bucketize, pack_padded
    from repro_torch.kernels import build
    from repro_torch.kernels.ptr.decode import (ARGTYPES, MAX_SMEM_BYTES, WIDE,
                                                decode_batch_reference, decode_smem_bytes,
                                                decode_template, launch)

    block_name = "ptr_decode_block_bf16" if bf16 else "ptr_decode_block"
    wide_name = "ptr_decode_wide_bf16" if bf16 else "ptr_decode_wide_f32"
    variants = {   # name -> (-D defines, the template it must run)
        "plain": ((), None),
        "block": (("PTR_DECODE_FORCE_BLOCK",), block_name),
        "wide": (("PTR_DECODE_FORCE_WIDE",), wide_name),
        "block, clocked": (("PTR_DECODE_PHASES", "PTR_DECODE_FORCE_BLOCK"), block_name),
        "wide, clocked": (("PTR_DECODE_PHASES", "PTR_DECODE_FORCE_WIDE"), wide_name),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(variants)) as pool:   # one nvcc a variant, all at once
        list(pool.map(lambda d: build.build_kernels(["ptr_decode"], d),
                      [d for d, _ in variants.values()]))
    print(f"built {len(variants)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    fns = {v: build.load_function("ptr_decode", "ptr_decode_launch", ARGTYPES, d)
           for v, (d, _) in variants.items()}
    read = {v: build.load_function("ptr_decode", "ptr_decode_phases_read",
                                   [ctypes.POINTER(ctypes.c_ulonglong)], variants[v][0])
            for v in ("block, clocked", "wide, clocked")}
    max_clusters, max_blocks = probes(build, ())

    golden = json.loads((ROOT / "tests" / "golden" / "dnn_schedules.json").read_text())
    table1 = [build_model_graph(nm) for nm in golden["models"]]
    by_bucket = bucketize(table1)
    big = sorted((table1[i] for i in by_bucket[1024]), key=lambda g: -g.n)
    mid = max((table1[i] for i in by_bucket[512]), key=lambda g: g.n)
    synth = sample_batch(np.random.default_rng(0), 128, n=30)
    nets = {H: RespectScheduler.init(seed=0, hidden=H).net for H in (256, 384)}
    cases = [(256, f"bucket 1024, B={b}", [big[i % len(big)] for i in range(b)])
             for b in (1, 2, 4, 8, 16)]
    cases += [(256, f"bucket 32, B={b}", synth[:b]) for b in (8, 14, 16, 32, 64, 128)]
    cases.append((384, f"bucket 512, B=1 ({mid.n} nodes)", [mid]))
    ok = True
    with torch.inference_mode():
        for H, label, graphs in cases:
            net = nets[H]
            D = 6
            batch = pack_padded(graphs, max_deg=D).to("cuda")
            C, (h0, c0), emb = net.encode(batch.feats, batch.n_valid)
            args = (net, C, emb, h0, c0, batch.parent_mat, batch.n_valid)
            B, n = len(graphs), batch.bucket_n
            kw = {"bf16": bf16}
            # the forced-wide build runs the block template where the wide
            # one's shared memory does not fit (hidden 384 in float32)
            wide_fits = decode_smem_bytes(n, H, D, wide_name) <= MAX_SMEM_BYTES
            nc, nb = ctypes.c_int(0), ctypes.c_int(0)
            if wide_fits:
                build.check("ptr_decode", max_clusters(n, H, D, int(bf16), WIDE,
                                                       ctypes.byref(nc)))
                build.check("ptr_decode", max_blocks(n, H, D, int(bf16), WIDE, ctypes.byref(nb)))
            tmpls = ("block", "wide") if wide_fits else ("block",)
            got = {}
            for v in ("plain",) + tmpls:
                *out, ran = launch(fns[v], *args, **kw)
                torch.cuda.synchronize()
                if variants[v][1] is not None and ran != variants[v][1]:
                    raise RuntimeError(f"variant {v} ran {ran} at {label}, H={H}")
                got[v] = out
            *_, ran_plain = launch(fns["plain"], *args, **kw)
            picked = decode_template(n, H, D, bf16, batch=B, clusters=nc.value)
            ok &= ran_plain == picked
            real = sum(g.n for g in graphs)
            print(f"\n{label}, H={H}{', bf16 storage' if bf16 else ''}: {real} real steps, "
                  f"{B * n - real} drained; the card holds {nc.value} clusters of 16 wide blocks "
                  f"at once, an SM {nb.value} of its blocks; the plain build ran {ran_plain} "
                  f"(decode_template: {picked})", flush=True)
            names = {"block": block_name, "wide": wide_name}
            order = ("block", "wide", "wide", "block") if wide_fits else ("block", "block")
            ms = turns_ms({names[v]: functools.partial(launch, fns[v], *args, **kw)
                           for v in tmpls}, tuple(names[v] for v in order), iters=3)
            wide_bytes = decode_smem_bytes(n, H, D, wide_name)
            ratio = (f" (wide / block {sum(ms[wide_name]) / sum(ms[block_name]):.3f})"
                     if wide_fits else f" (the wide template's {wide_bytes} bytes of shared "
                     "memory do not fit a block)")
            print(f"  device time (profiler, turns {'/'.join(order)} on {card}): "
                  + ", ".join(f"{v} {' '.join(f'{t:.4f}' for t in ts)} ms" for v, ts in ms.items())
                  + ratio, flush=True)
            if wide_fits:
                same_order = torch.equal(got["block"][0], got["wide"][0])
                same_bits = all(torch.equal(a, b) for a, b in zip(got["block"], got["wide"]))
                ok &= same_order
                print(f"  wide and block: orders equal {same_order}, logp and entropy equal bit "
                      f"for bit {same_bits}", flush=True)
            if B == 1:
                want = decode_batch_reference(*args, bf16=bf16)
                valid = torch.arange(n, device="cuda")[None, :] < batch.n_valid[:, None].long()
                for v in tmpls:
                    o, lp, en = got[v]
                    eq = torch.equal(torch.where(valid, o, -1), torch.where(valid, want[0], -1))
                    err = max(float((lp - want[1]).abs().max()), float((en - want[2]).abs().max()))
                    ok &= eq and err <= 1e-3
                    print(f"  {v} against the plain version: orders equal {eq}, max |err| "
                          f"logp/entropy {err:.2e}", flush=True)
                for v in tmpls:
                    vc = f"{v}, clocked"
                    line, _ = phase_line(build, read[vc], fns[vc], (args, kw))
                    t = device_ms(functools.partial(launch, fns[vc], *args, **kw), names[v],
                                  iters=3)
                    print(f"  {vc}: cycles per entry x entries (share): {line}; device "
                          f"{t:.4f} ms", flush=True)
            if H == 256 and label == "bucket 1024, B=1":
                # the register budgets: the plain and the clocked build,
                # each build's outputs bit for bit the plain one's
                resource_usage(build, {v: variants[v] for v in variants if v != "plain"})
                for t in ("block", "wide"):
                    calls = {b: functools.partial(launch, fns[f"{t}{sfx}"], *args, **kw)
                             for b, sfx in (("plain", ""), ("clocked", ", clocked"))}
                    same = {}
                    for b, fn in calls.items():
                        out = fn()[:3]
                        torch.cuda.synchronize()
                        same[b] = all(torch.equal(x, y) for x, y in zip(out, got[t]))
                    turns = {b: [] for b in calls}
                    for b in ("plain", "clocked", "clocked", "plain"):
                        turns[b].append(device_ms(calls[b], names[t], iters=3))
                    ok &= all(same.values())
                    print(f"  {names[t]}, device time in turns of the plain and clocked builds "
                          f"on {card}: "
                          + ", ".join(f"{b} {' '.join(f'{x:.4f}' for x in ts)} ms"
                                      for b, ts in turns.items())
                          + f"; outputs equal the plain build's bit for bit {same}", flush=True)
    if not ok:
        print("ptr_decode_phases: the templates disagree, or the rule's mirror does",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
