#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds both pointer kernels from src/repro_torch/kernels/ptr/csrc;
3. drives the serving miss path through the public API — the released
   policy (checkpoints/respect-v1) on the ten Table-I graphs plus 64
   synthetic graphs (uniform system, whole-decode kernel), then a
   heterogeneous system (scan decode with the single-step kernel) — with
   the launch counters reset just before and read just after;
4. checks the ten golden order/assignment digests
   (tests/golden/dnn_schedules.json) and holds the synthetic and
   heterogeneous results to the plain PyTorch path on the CPU;
5. holds each kernel to its plain PyTorch version on the card at the main
   path's shapes, times both with CUDA events, computes each kernel's bound
   and the end-to-end cold-miss rate.

Exits non-zero, printing no result, without CUDA or outside a checkout of
the repository.  The last line is the JSON device record.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "dnn_schedules.json"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
STAGES = 4
TOL_LOGITS = 1e-4              # single step: float32 sums in another order
TOL_LOGP = 1e-3                # whole decode: drift carried through n LSTM steps
HETERO = dict(n_stages=STAGES, compute_rate=(4e12, 2e12, 4e12, 8e12),
              link_bw=(320e6, 160e6, 320e6, 640e6))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.asarray(a, dtype=np.int64).tobytes()).hexdigest()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def frontier_sizes(graph, order) -> list[int]:
    """Selectable-node count before each real step of a decode (the rows the
    kernels read that step)."""
    remaining = [len(p) for p in graph.parents]
    frontier = sum(1 for r in remaining if r == 0)
    sizes = []
    for v in order[: graph.n]:
        sizes.append(frontier)
        frontier -= 1
        for c in graph.children[v]:
            remaining[c] -= 1
            frontier += remaining[c] == 0
    return sizes


def decode_work(graphs, orders, n: int, H: int, D: int) -> tuple[float, float]:
    """(bytes, flops) a whole decode of ``graphs`` padded to ``n`` needs:
    every real row of C, CWg, CWp and emb read once, the weights once, the
    outputs written once; per real step the gate products, the two query
    products and the frontier rows' scores, softmax and glimpse."""
    w_bytes = 4 * (2 * H * 4 * H + 4 * H + 4 * H * H + 3 * H)   # wx, wh, b, 4 HxH, v, v, dec0
    nbytes, flops = float(w_bytes), 0.0
    for g, o in zip(graphs, orders):
        nbytes += 4 * (4 * g.n * H + 2 * H + n * D + 1) + 3 * 4 * n
        flops += g.n * 2 * 2 * H * H              # C @ W_ref of both heads
        for m in frontier_sizes(g, o):
            flops += 2 * 2 * H * 4 * H + 10 * H    # gates (x and h halves) + cell
            flops += 2 * 2 * H * H                 # qg, qp
            flops += m * (3 * H * 2 + 2 * H + 8)   # two heads' tanh-dot, glimpse, softmaxes
    return nbytes, flops


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def first_divergence(net_cpu, graph, kernel_order, max_deg: int) -> str:
    """First step where the card's order leaves the CPU plain decode, with
    the CPU's top-2 logit margin there."""
    import torch
    from repro_torch.core.batching import pack_padded
    batch = pack_padded([graph], max_deg=max_deg)
    with torch.inference_mode():
        C, (h0, c0), emb = net_cpu.encode(batch.feats, batch.n_valid)
        plain = net_cpu.plain_logits_fn(C)
        seen = []

        def recording(h, mask):
            seen.append(plain(h, mask))
            return seen[-1]

        order, _, _ = net_cpu.decode(C, emb, (h0, c0), batch.parent_mat, n_valid=batch.n_valid,
                                     logits_fn=recording)
    order = order[0, : graph.n].numpy()
    diff = [t for t in range(graph.n) if order[t] != kernel_order[t]]
    if not diff:
        return "orders agree; the assignment differs"
    t = diff[0]
    top2 = torch.topk(seen[t][0], 2).values
    return (f"first diverging step {t}: card picked {kernel_order[t]}, CPU {order[t]}; "
            f"CPU top-2 logit margin {float(top2[0] - top2[1]):.3e}")


def run() -> dict:
    import numpy as np
    import torch

    from repro_torch.core import (PipelineSystem, RespectScheduler, build_model_graph,
                                  sample_batch, validate_monotone)
    from repro_torch.core.batching import bucketize, pack_padded
    from repro_torch.core.segment import repair, rho_dp
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.decode import decode_batch, decode_batch_reference
    from repro_torch.kernels.ptr.kernel import pointer_step_cuda
    from repro_torch.kernels.ptr.ref import reference_pointer_step

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t_build = ops.build_kernels()
    print(f"build: both kernels in {t_build:.2f} s (nvcc, sm_90a, in parallel)", flush=True)

    golden = json.loads(GOLDEN.read_text())
    names = list(golden["models"])
    table1 = [build_model_graph(nm) for nm in names]
    synth = sample_batch(np.random.default_rng(0), 64, n=30)
    sched = RespectScheduler.from_release()            # device: cuda
    check(sched.device.type == "cuda", "scheduler is not on the card")
    check(sched.release is not None
          and sched.release["params_sha256"] == golden["meta"]["params_sha256"],
          "release did not load or is not the golden one")
    hsys = PipelineSystem(**HETERO)
    hetero_graphs = [table1[names.index("InceptionResNetv2")], table1[names.index("ResNet50")]]
    hetero_graphs += synth[:16]

    # ---- the main path, counted ------------------------------------- #
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = sched.schedule_many(table1 + synth, STAGES, use_cache=False)
    torch.cuda.synchronize()
    t_uniform = time.perf_counter() - t0
    uniform_launches = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    res_h = sched.schedule_many(hetero_graphs, STAGES, hsys, use_cache=False)
    torch.cuda.synchronize()
    t_hetero = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"main path: uniform {len(table1) + len(synth)} graphs {t_uniform:.3f} s "
          f"(first call), hetero {len(hetero_graphs)} graphs {t_hetero:.3f} s; "
          f"launches {launches}", flush=True)
    check(uniform_launches["ptr_decode"] > 0, "uniform batch never launched ptr_decode")
    check(launches["ptr_step"] > 0, "heterogeneous batch never launched ptr_step")

    # ---- outputs: golden digests and the CPU plain path --------------- #
    cpu = RespectScheduler.from_release(device="cpu")
    bad = []
    for nm, g, r in zip(names, table1, res):
        want = golden["models"][nm]
        ok = (digest(r["order"]) == want["order_sha256"]
              and digest(r["assignment"]) == want["assign_sha256"])
        check(r["assignment"].shape == (g.n,) and validate_monotone(g, r["assignment"], STAGES),
              f"{nm}: invalid schedule")
        if not ok:
            bad.append(f"{nm}: {first_divergence(cpu.net, g, r['order'], cpu.max_deg)}")
    check(not bad, "golden digests differ on the card:\n  " + "\n  ".join(bad))
    print(f"golden: all {len(names)} Table-I order and assignment digests match", flush=True)
    res_cpu = cpu.schedule_many(synth, STAGES, use_cache=False)
    for r, rc in zip(res[len(table1):], res_cpu):
        check(np.array_equal(r["order"], rc["order"])
              and np.array_equal(r["assignment"], rc["assignment"]),
              "synthetic batch: card and CPU plain path disagree")
    res_hc = cpu.schedule_many(hetero_graphs, STAGES, hsys, use_cache=False)
    for r, rc in zip(res_h, res_hc):
        check(np.array_equal(r["order"], rc["order"])
              and np.array_equal(r["assignment"], rc["assignment"]),
              "heterogeneous batch: card and CPU plain path disagree")
    print(f"outputs: {len(synth)} synthetic and {len(hetero_graphs)} heterogeneous schedules "
          "equal the CPU plain path", flush=True)

    # ---- kernels against their plain versions, at the path's shapes --- #
    net = sched.net
    H, D = net.hidden, sched.max_deg
    by_bucket = bucketize(table1)
    big = [table1[i] for i in by_bucket[1024]][-4:]
    kernels = []
    gen = torch.Generator(device="cuda").manual_seed(0)

    def encoded(graphs):
        batch = pack_padded(graphs, max_deg=D).to("cuda")
        with torch.inference_mode():
            C, (h0, c0), emb = net.encode(batch.feats, batch.n_valid)
        return batch, C, h0, c0, emb

    decode_rows = []
    for label, graphs in (("bucket 1024, B=4", big), ("bucket 32, B=64", synth)):
        batch, C, h0, c0, emb = encoded(graphs)
        B, n = batch.n_valid.shape[0], batch.bucket_n
        args = (net, C, emb, h0, c0, batch.parent_mat, batch.n_valid)
        unif = torch.rand((B, n), generator=gen, device="cuda")
        with torch.inference_mode():
            k_out = decode_batch(*args)
            p_out = decode_batch_reference(*args)
            k_smp = decode_batch(*args, unif)
            p_smp = decode_batch_reference(*args, unif)
        torch.cuda.synchronize()
        valid = torch.arange(n, device="cuda")[None, :] < batch.n_valid[:, None].long()
        for what, (ko, kl, ke), (po, pl_, pe) in (("greedy", k_out, p_out),
                                                  ("sampled", k_smp, p_smp)):
            check(torch.equal(torch.where(valid, ko, -1), torch.where(valid, po, -1)),
                  f"ptr_decode {label} {what}: orders differ from the plain version")
            err = max(float((kl - pl_).abs().max()), float((ke - pe).abs().max()))
            check(err <= TOL_LOGP, f"ptr_decode {label} {what}: logp/entropy error {err:.3e}")
            decode_rows.append((label, what, err))
        with torch.inference_mode():
            ms = cuda_ms(lambda: decode_batch(*args), iters=5)
            refs_ms = cuda_ms(lambda: ops.precompute_refs(net, C), iters=20)
            plain_ms = cuda_ms(lambda: decode_batch_reference(*args), iters=2)
        nbytes, flops = decode_work(graphs, k_out[0].cpu().numpy(), n, H, D)
        b_ms, b_by = bound(nbytes, flops)
        err = max(e for lb, _, e in decode_rows if lb == label)
        print(f"ptr_decode {label} H={H} on {card}: kernel {ms:.3f} ms (the wrapper's two "
              f"C @ W_ref products alone {refs_ms:.4f} ms), plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), max |err| logp/ent {err:.2e}", flush=True)
        if label.startswith("bucket 1024"):
            kernels.append({
                "name": "ptr_decode", "route": "cuda",
                "source": "src/repro_torch/kernels/ptr/csrc/ptr_decode.cu",
                "replaces": "src/repro/kernels/ptr/decode.py:84",
                "launches": launches["ptr_decode"], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # single step at bucket 1024, B=4: a seeded half-dense mask
    batch, C, h0, c0, emb = encoded(big)
    B, n = C.shape[:2]
    with torch.inference_mode():
        CWg, CWp = ops.precompute_refs(net, C)
        valid = torch.arange(n, device="cuda")[None, :] < batch.n_valid[:, None].long()
        mask = (torch.rand((B, n), generator=gen, device="cuda") < 0.5) & valid
        g, p = net.glimpse, net.pointer
        step_args = (C, CWg, CWp, h0, g.w_q, g.v, p.w_q, p.v, mask)
        k_log = pointer_step_cuda(*step_args)
        p_log = reference_pointer_step(*step_args)
        torch.cuda.synchronize()
        sel = mask
        check(torch.equal(k_log[~sel], p_log[~sel]), "ptr_step: masked logits differ")
        err = float((k_log[sel] - p_log[sel]).abs().max())
        rel = float(((k_log[sel] - p_log[sel]).abs() / p_log[sel].abs().clamp_min(1.0)).max())
        check(rel <= TOL_LOGITS, f"ptr_step: logits error {err:.3e}")
        ms = cuda_ms(lambda: pointer_step_cuda(*step_args), iters=50, warmup=3)
        plain_ms = cuda_ms(lambda: reference_pointer_step(*step_args), iters=50, warmup=3)
    m_rows = int(sel.sum())
    nbytes = 4 * (3 * m_rows * H + B * n + B * H + 2 * H * H + 2 * H + B * n)
    flops = B * 2 * 2 * H * H + m_rows * (3 * H * 2 + 2 * H + 8)
    b_ms, b_by = bound(nbytes, flops)
    print(f"ptr_step bucket 1024, B=4, {m_rows} selectable rows, H={H} on {card}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
          f"max |err| {err:.2e}", flush=True)
    kernels.append({
        "name": "ptr_step", "route": "cuda",
        "source": "src/repro_torch/kernels/ptr/csrc/ptr_step.cu",
        "replaces": "src/repro/kernels/ptr/kernel.py:42",
        "launches": launches["ptr_step"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # ---- end to end: cold-miss rate and where a Table-I batch's time goes #
    def rate(graphs, system=None):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            sched.schedule_many(graphs, STAGES, system, use_cache=False)
            times.append(time.perf_counter() - t0)
        return len(graphs) / statistics.median(times), statistics.median(times)

    for label, graphs, system in (("Table-I (10 graphs)", table1, None),
                                  ("synthetic n=30 (64 graphs)", synth, None),
                                  ("heterogeneous (18 graphs)", hetero_graphs, hsys)):
        gps, sec = rate(graphs, system)
        print(f"cold-miss {label} on {card}: {gps:.2f} graphs/s ({sec:.4f} s a batch, "
              "median of 3)", flush=True)

    split = {"pack": 0.0, "encode": 0.0, "decode": 0.0, "rho": 0.0, "repair": 0.0}
    usys = PipelineSystem(STAGES)
    for bucket_n, idxs in bucketize(table1).items():
        gs = [table1[i] for i in idxs]

        def timed(key, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            return out

        with torch.inference_mode():
            batch = timed("pack", lambda: pack_padded(gs, bucket_n, D).to("cuda"))
            C, (h0, c0), emb = timed("encode", lambda: net.encode(batch.feats, batch.n_valid))
            order = timed("decode", lambda: decode_batch(net, C, emb, h0, c0, batch.parent_mat,
                                                         batch.n_valid)[0])
            assign = timed("rho", lambda: rho_dp(order, batch.flops, batch.param_bytes,
                                                 batch.out_bytes, batch.parent_mat, STAGES,
                                                 usys, batch.n_valid).cpu().numpy())
            timed("repair", lambda: [repair(g, assign[r, : g.n], STAGES)
                                     for r, g in enumerate(gs)])
    total = sum(split.values())
    print(f"time split, Table-I batch on {card} (host clock, synchronized): "
          + ", ".join(f"{k} {v * 1e3:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items()),
          flush=True)
    return {"kernels": kernels, "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "card": card}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.exists():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        out = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": out["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": out["device"],
                                             "count": out["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
