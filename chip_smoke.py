#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds all four kernel libraries from src/repro_torch/kernels/*/csrc;
3. drives the serving miss path through the public API — the released
   policy (checkpoints/respect-v1, hidden 128) on the ten Table-I graphs
   plus 64 synthetic graphs (uniform system, whole-decode kernel B1 in its
   cluster template), a seeded RespectScheduler.init (the default hidden
   256) on the synthetic graphs (B1 in its block template), then a
   heterogeneous system (scan decode with the single-step kernel) — with
   the launch counters reset just before and read just after;
4. checks the ten golden order/assignment digests
   (tests/golden/dnn_schedules.json) and holds the synthetic and
   heterogeneous results to the plain PyTorch path on the CPU (at the
   release's width, and with seeded schedulers at hidden 96 and 640, widths
   the whole-decode kernel refuses, through the single-step kernel B2);
5. holds each kernel (B1's two templates apart) to its plain PyTorch
   version on the card at the main path's shapes, times both with CUDA
   events (and, for each kernel, its device time from the profiler's kernel
   durations: a kernel under 0.2 ms is reported by that time, which leaves
   out the host's enqueue), computes each kernel's bound and the end-to-end
   cold-miss rate; B2 at a half-dense mask at bucket 1024 at hidden 128, 96
   and 640;
6. the LM zoo's serving path: the full zamba2-7b (81 layers, d_model 3584,
   bf16, seeded random weights) serves a batch of 2 x 2048-token prompts and
   a ragged 1 x 1000 one (prefill, then 16 greedy decode steps each), with
   the launch counters reset just before and read just after (13 flash and
   68 SSD launches a prefill, none in decode); prints prefill and decode
   tokens/s and where a prefill's device time goes, and checks there that
   every B3 and B4 launch of the bf16 model ran the kernels' bfloat16
   (tensor-core) templates;
7. holds the flash-attention and SSD-scan kernels to their plain versions
   at the path's shapes (and a GQA, a Dv != D, an Sq < Sk and an
   in_scale != dt case), times kernel, plain version and — for flash —
   PyTorch's scaled_dot_product_attention as a yardstick, with their bounds;
8. runs one full-width mmmmmA unit in float32 through the kernels and
   through the plain versions on the card, and compares the logits;
9. the heterogeneous batch's scan: records every step's (h, mask) of each
   bucket, holds B2 to its plain version on each recorded step and times it
   over them (device time a batch and a launch, bound over the same steps),
   then a time split of the batch's cold miss (pack, encode, scan decode,
   rho, repair) with B2's device time and the device's idle share in the
   decode, checking by kernel name that every step ran ptr_step_cluster;
10. checks from the profiler's kernel names that every B1 launch of the
   respect-v1 path (one a bucket) ran the cluster template;
11. (between 4 and 5) the seeded and sampled path, with the launch counters
   reset just before and read just after: seeded weights drawn on the host
   for seed 0 at hidden 256, 128 and 96, their leaves (read back from the
   card) against tests/golden/torch_seeded_schedules.json, then those
   schedulers on the 64 synthetic graphs (B1 block template, B1 cluster
   template, the scan with B2) and on the heterogeneous batch (the scan with
   B2, a start token conditioned through w_sys), digests against the golden
   file (hidden 256 on the synthetic graphs and hidden 96 on the
   heterogeneous ones are the main path's runs of 1 and 3, held to the file
   there); B1's sampled decode of respect-v1 (graph i keyed
   fold_in(PRNGKey(1), i)) on the synthetic and Table-I graphs, orders
   against the golden file, logp and entropy against the plain version, and
   B1's device time sampled against greedy; fallback_schedule_many on
   respect-v1 (digests, served_by, the cache untouched); a save/load round
   trip of the hidden-256 scheduler;
12. (after 11) the serving front end, repro_torch.serving.SchedulerService,
   over a fresh RespectScheduler.from_release() on the card: warmup
   (synthetic n = 30 at batch 1 and 16, the Table-I graphs, one
   heterogeneous graph), after which live traffic builds and loads no kernel
   library; clean traffic from eight submitter threads (the Table-I,
   synthetic and heterogeneous graphs at k = 4 and 16 synthetic ones at
   k = 3, each twice), with the launch counters reset just before and read
   just after, held to schedule_many and the golden digests with nothing
   degraded, failed, retried or restarted ("service clean traffic":
   requests/s, p50/p99); the seeded fault replay of tests/test_faults.py's
   soak over the same traffic, every rung's results held to the clean
   phase, the seeded golden file and the host heuristic, and the fallback
   rung's first call timed apart from the later ones; the deadline checks;
13. (after 12) the RL training engine, repro_torch.core.rl.RLTrainer, on
   the card at respect-v1's training configuration (hidden 128, lr 3e-4,
   stage counts 2, 3, 4, 6, 8) with the launch counters reset just before
   and read just after: the labelled packs of DagSampler(seed=0, n=(5,
   50)).packed_stream(64, 4) for three draws (buckets 8-64), the first three
   steps held to tests/golden/torch_train_steps.json (labels, sampled and
   baseline orders, assignments and per-graph rewards equal; metrics and
   parameters within the TOL_TRAIN_* tolerances) and B1's sampled rollout
   to the same orders; one B1 launch a step in the greedy baseline; one
   draw at each other stage count; a heterogeneous step (B2 in the
   baseline's scan, w_sys moves) held to the same step from a CPU copy of
   the trainer's state (metrics and every parameter within the TOL_TRAIN_*
   tolerances); a step at the paper's scale (hidden 256,
   batch 128, |V| = 30); a held-out eval of 128 graphs per stage count
   (B1, equal to the CPU plain path); a save/restore round trip, bit for
   bit; ms a step and training graphs/s per bucket and, from one profiled
   bucket-64 step, its split over the trainer's rl.* profiler ranges, the
   device's idle share and B1's device time;
14. (after 13) the gap-to-optimal eval, repro_torch.eval, on the card: the
   smoke uniform grid, the smoke heterogeneous grid and the smoke
   generalization tier with RespectScheduler.from_release() and a CUDA
   ExactOracle (bb_max_n 12, bb budget 2 s), the launch counters reset just
   before and read just after each tier (B1 cluster template: two launches a
   bucket a grid scenario, one a generalization scenario; B2: two a step of
   each heterogeneous/memcap bucket), held to BENCH_eval.json in every
   non-timing field (integers and flags equal, floats within EVAL_RTOL
   relative; on a difference the first respect schedule that leaves the CPU
   plain path is printed) and to check_results, check_hetero and
   check_generalization; the card's solve-time ratios beside the artifact's
   (the JAX package's CPU numbers); then python -m repro_torch.train_release
   run in-process for 6 steps into build/, its release verified by sha256
   and loaded on the card and on the CPU, which schedule the Table-I and
   synthetic graphs identically.

Exits non-zero, printing no result, without CUDA or outside a checkout of
the repository.  The last line is the JSON device record.
"""

from __future__ import annotations

import copy
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "dnn_schedules.json"
SEEDED_GOLDEN = ROOT / "tests" / "golden" / "torch_seeded_schedules.json"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
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


def device_ms(fn, name: str, iters: int, attempts: int = 3) -> float:
    """Mean device time, in ms, of the kernels whose name holds ``name``:
    the profiler's kernel durations of the last ``iters`` of ``2 iters + 2``
    calls of ``fn`` (one such kernel a call), without the host's enqueue
    between launches.  The profiler may miss the first kernels of a window
    (it has missed three 0.3 ms ones in a row); a window that still shows
    fewer than ``iters`` is profiled again, up to ``attempts`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2 * iters + 2):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                       if e.device_type == DeviceType.CUDA and name in e.name)
        if len(spans) >= iters:
            return sum(us for _, us in spans[-iters:]) / iters / 1e3
        seen.append(len(spans))
    raise SmokeFailure(f"profiler saw {seen} {name} kernels in {attempts} windows of "
                       f"{2 * iters + 2} calls")


def profile_kernels(fn) -> list[tuple[str, float, float]]:
    """(name, start, end), in microseconds and by start, of every device
    kernel one profiled call of ``fn`` ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA), key=lambda k: k[1])


def kernel_names(fn) -> list[str]:
    """The names of the device kernels one profiled call of ``fn`` ran."""
    return [name for name, _, _ in profile_kernels(fn)]


def busy_window(spans) -> tuple[float, float]:
    """(busy, window) of (start, end) spans: the length of their union, and
    first start to last end."""
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for st, en in spans[1:]:
        if st > cur_e:
            busy, cur_s = busy + cur_e - cur_s, st
        cur_e = max(cur_e, en)
    return busy + cur_e - cur_s, max(en for _, en in spans) - spans[0][0]


def reported_ms(event_ms: float, dev_ms: float) -> float:
    """The time a kernel row reports: CUDA events around back-to-back calls,
    or, for a kernel under 0.2 ms, where the host's enqueue between launches
    is a visible share of that, its device time."""
    return dev_ms if event_ms < 0.2 else event_ms


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


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def first_divergence(net_cpu, graph, kernel_order, max_deg: int, system=None) -> str:
    """First step where the card's order leaves the CPU plain decode (under
    ``system``'s profile, if any), with the CPU's top-2 logit margin there."""
    import torch
    from repro_torch.core.batching import pack_padded
    batch = pack_padded([graph], max_deg=max_deg)
    sys_feat = None if system is None else scan_profile(system, "cpu", system.n_stages)[0]
    with torch.inference_mode():
        C, (h0, c0), emb = net_cpu.encode(batch.feats, batch.n_valid)
        plain = net_cpu.plain_logits_fn(C)
        seen = []

        def recording(h, mask):
            seen.append(plain(h, mask))
            return seen[-1]

        order, _, _ = net_cpu.decode(C, emb, (h0, c0), batch.parent_mat, n_valid=batch.n_valid,
                                     logits_fn=recording, sys_feat=sys_feat)
    order = order[0, : graph.n].numpy()
    diff = [t for t in range(graph.n) if order[t] != kernel_order[t]]
    if not diff:
        return "orders agree; the assignment differs"
    t = diff[0]
    top2 = torch.topk(seen[t][0], 2).values
    return (f"first diverging step {t}: card picked {kernel_order[t]}, CPU {order[t]}; "
            f"CPU top-2 logit margin {float(top2[0] - top2[1]):.3e}")


# ---------------------------------------------------------------------- #
# the single-step kernel B2 on the heterogeneous batch's scan decode
# ---------------------------------------------------------------------- #
def step_work(mask, H: int) -> tuple[float, float]:
    """(bytes, flops) of one single-step launch over a (B, n) mask: the
    selectable rows of C, CWg and CWp, h, the int32 mask, the query weights
    and vectors read once, the logits written once; both query products of
    every graph and, per selectable row, both heads' tanh-dots, its share of
    the glimpse and of the softmax."""
    B, n = mask.shape
    m = int(mask.sum())
    nbytes = 4 * (3 * m * H + B * n + B * H + 2 * H * H + 2 * H + B * n)
    return nbytes, B * 2 * 2 * H * H + m * (3 * H * 2 + 2 * H + 8)


def compare_logits(got, want, mask) -> tuple[bool, float, float]:
    """(masked logits byte-equal, max |err| and max |err| / max(1, |want|)
    over the selectable ones) of a single step's kernel and plain logits."""
    same = bool((got[~mask] == want[~mask]).all())
    if not bool(mask.any()):
        return same, 0.0, 0.0
    d = (got[mask] - want[mask]).abs()
    return same, float(d.max()), float((d / want[mask].abs().clamp_min(1.0)).max())


def scan_profile(system, device, n_stages: int = STAGES):
    """(sys_feat, system with ``n_stages`` stages, capacities) as the scan of
    ``BucketedDecoder.fused_schedules`` takes them."""
    import torch
    system = system.with_stages(n_stages)
    profile = system.profile_features()
    sys_feat = torch.from_numpy(profile).to(device) if profile.any() else None
    return sys_feat, system, system.capacity_vector()


def scan_split(net, graphs, system, max_deg: int, logits_factory, kname: str, expect: int,
               attempts: int = 3) -> dict:
    """A cold miss of ``graphs`` under ``system`` on the scan path, bucket by
    bucket: the host clock around each stage (pack, encode, scan decode with
    ``logits_factory(net, C)`` as the step, rho, repair), synchronized; then
    one profiled pass of every bucket's scan decode: the device time of the
    ``expect`` kernels named ``kname`` it launches, the names of all
    single-step kernels it ran, and the device's busy time in the decode's
    window (a pass whose profile shows fewer is profiled again, as in
    device_ms)."""
    import torch
    from repro_torch.core.batching import bucketize, pack_padded
    from repro_torch.core.segment import repair, rho_dp
    sys_feat, system, caps = scan_profile(system, "cuda")
    split = dict.fromkeys(("pack", "encode", "decode", "rho", "repair"), 0.0)

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[key] += time.perf_counter() - t0
        return out

    decodes = []
    with torch.inference_mode():
        for bucket_n, idxs in bucketize(graphs).items():
            gs = [graphs[i] for i in idxs]
            batch = timed("pack", lambda: pack_padded(gs, bucket_n, max_deg).to("cuda"))
            C, (h0, c0), emb = timed("encode", lambda: net.encode(batch.feats, batch.n_valid))

            def decode(C=C, emb=emb, h0=h0, c0=c0, batch=batch):
                return net.decode(C, emb, (h0, c0), batch.parent_mat, n_valid=batch.n_valid,
                                  logits_fn=logits_factory(net, C), sys_feat=sys_feat)[0]

            order = timed("decode", decode)
            assign = timed("rho", lambda: rho_dp(order, batch.flops, batch.param_bytes,
                                                 batch.out_bytes, batch.parent_mat, STAGES,
                                                 system, batch.n_valid).cpu().numpy())
            timed("repair", lambda: [repair(g, assign[r, : g.n], STAGES, mem_capacity=caps)
                                     for r, g in enumerate(gs)])
            decodes.append(decode)
        seen = []
        for _ in range(attempts):   # a sleep (spin_kernel) first, as in replay_device_ms
            kern = profile_kernels(lambda: [torch.cuda._sleep(20_000_000)]
                                   + [d() for d in decodes])
            b2 = [(st, en) for nm, st, en in kern if kname in nm]
            if len(b2) == expect:
                break
            seen.append(len(b2))
        else:
            raise SmokeFailure(f"profiler saw {seen} {kname} kernels in {attempts} scan decodes "
                               f"of {expect} steps")
    busy, window = busy_window([(st, en) for nm, st, en in kern if "spin_kernel" not in nm])
    return {"split": split, "b2_ms": sum(en - st for st, en in b2) / 1e3, "b2_count": expect,
            "step_names": sorted({nm for nm, _, _ in kern if "ptr_step" in nm}),
            "busy_ms": busy / 1e3, "window_ms": window / 1e3}


def split_line(label: str, card: str, res: dict) -> str:
    split = res["split"]
    total = sum(split.values())
    share = 100 * res["b2_ms"] / (split["decode"] * 1e3)
    idle = 100 * (1 - res["busy_ms"] / res["window_ms"])
    return (f"time split, {label} on {card} (host clock, synchronized): "
            + ", ".join(f"{k} {v * 1e3:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
            + f"; a profiled pass of the scan decode: B2 {res['b2_count']} launches, "
            f"{res['b2_ms']:.3f} ms of device time ({share:.1f}% of the decode stage's host "
            f"time), device busy {res['busy_ms']:.2f} ms of a {res['window_ms']:.2f} ms window "
            f"(idle {idle:.1f}%)")


def record_scan(net, graphs, system, max_deg: int) -> list[dict]:
    """Per bucket of ``graphs``: the encoded contexts C, their hoisted
    projections and every step's (h, mask) of the scan decode under
    ``system``, recorded on the card around the path's own single-step
    logits_fn."""
    import torch
    from repro_torch.core.batching import bucketize, pack_padded
    from repro_torch.kernels.ptr import ops
    sys_feat = scan_profile(system, "cuda")[0]
    recs = []
    with torch.inference_mode():
        for bucket_n, idxs in bucketize(graphs).items():
            batch = pack_padded([graphs[i] for i in idxs], bucket_n, max_deg).to("cuda")
            C, (h0, c0), emb = net.encode(batch.feats, batch.n_valid)
            step, steps = ops.make_logits_fn(net, C), []

            def recording(h, mask, step=step, steps=steps):
                steps.append((h.clone(), mask.clone()))
                return step(h, mask)

            net.decode(C, emb, (h0, c0), batch.parent_mat, n_valid=batch.n_valid,
                       logits_fn=recording, sys_feat=sys_feat)
            CWg, CWp = ops.precompute_refs(net, C)
            recs.append({"bucket_n": bucket_n, "B": len(idxs), "C": C, "CWg": CWg, "CWp": CWp,
                         "steps": steps})
    return recs


def replay(net, rec: dict, launch):
    """Calls ``launch`` (a single-step function with the kernel's arguments)
    on every recorded step of one bucket, back to back; returns the logits."""
    g, p = net.glimpse, net.pointer
    return [launch(rec["C"], rec["CWg"], rec["CWp"], h, g.w_q, g.v, p.w_q, p.v, mask)
            for h, mask in rec["steps"]]


def replay_device_ms(net, rec: dict, launch, kname: str, attempts: int = 3) -> list[float]:
    """Device time (ms) of each launch of a replay of one bucket's recorded
    steps, by the profiler's kernel durations.  The profiler may miss the
    first kernels of a window (see device_ms; up to 32 of 40 in one run), so
    a window opens with a 10 ms sleep on the device and eight launches of
    the first step, and the last kernels are taken; a window that still
    shows too few is profiled again."""
    import torch
    first = {**rec, "steps": rec["steps"][:1] * 8}

    def window():
        torch.cuda._sleep(20_000_000)   # cycles: about 10 ms
        replay(net, first, launch)
        replay(net, rec, launch)

    n = len(rec["steps"])
    with torch.inference_mode():
        window()
        seen = []
        for _ in range(attempts):
            kern = [(en - st) / 1e3 for nm, st, en in profile_kernels(window) if kname in nm]
            if len(kern) >= n:
                return kern[-n:]
            seen.append(len(kern))
    raise SmokeFailure(f"profiler saw {seen} {kname} kernels in {attempts} replays of "
                       f"{len(rec['steps'])} steps")


def steps_bound(net, rec: dict) -> tuple[float, str]:
    """The sum over a bucket's recorded steps of each launch's bound (ms),
    and what bounds most of it."""
    H = net.hidden
    t_b = t_f = total = 0.0
    for _, mask in rec["steps"]:
        nbytes, flops = step_work(mask, H)
        total += max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
        t_b += nbytes / HBM_BYTES_PER_S
        t_f += flops / F32_FLOPS_PER_S
    return total * 1e3, "bytes" if t_b >= t_f else "operations"


# ---------------------------------------------------------------------- #
# the seeded and sampled path: threefry weights and uniforms, the fallback
# rung, save/load
# ---------------------------------------------------------------------- #
SEEDED_ROUTES = {256: "ptr_decode_block", 128: "ptr_decode_cluster", 96: "ptr_step"}


def schedule_digests(results) -> dict:
    return {"order_sha256": [digest(r["order"]) for r in results],
            "assign_sha256": [digest(r["assignment"]) for r in results]}


def digest_misses(got: dict, want: dict) -> list[int]:
    return [i for i, pair in enumerate(zip(got["order_sha256"], got["assign_sha256"],
                                           want["order_sha256"], want["assign_sha256"]))
            if pair[:2] != pair[2:]]


def seeded_phase(card: str, sched, seeded: dict, table1, names, synth, hetero_graphs,
                 hsys) -> None:
    """The seeded and sampled path on the card (docstring item 11); raises
    SmokeFailure on any difference from the golden file.  ``seeded`` holds
    the main path's seeded schedulers at hidden 256 and 96."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import flatten_leaves
    from repro_torch.core import RespectScheduler, prng, ptrnet
    from repro_torch.core.batching import bucketize, pack_padded, sample_order
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.decode import decode_batch, decode_batch_reference, step_uniforms

    gold = json.loads(SEEDED_GOLDEN.read_text())
    check(gold["meta"]["table1"] == names, "seeded golden: Table-I graphs differ")
    D = sched.max_deg
    synth_steps = sum(bucketize(synth))
    hetero_steps = sum(bucketize(hetero_graphs))
    t_phase = time.perf_counter()

    def delta(before):
        torch.cuda.synchronize()
        return {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}

    def expect(label, ran, **want):
        full = {k: want.get(k, 0) for k in ran}
        check(ran == full, f"{label}: launches {ran}, expected {full}")

    def leaf_digests(net) -> dict:
        return {n: hashlib.sha256(np.ascontiguousarray(a, "<f4").tobytes()).hexdigest()
                for n, a in flatten_leaves(ptrnet.params_to_numpy(net))}

    # ---- the path, counted ------------------------------------------- #
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    seeded = {**seeded, 128: RespectScheduler.init(seed=0, hidden=128)}  # on the host; cuda
    t_init = time.perf_counter() - t0
    batches = {"synthetic": (synth, None), "hetero": (hetero_graphs, hsys)}
    # what the main path has not run: it ran hidden 256 on the synthetic
    # batch and hidden 96 on the heterogeneous one
    todo = {256: ("hetero",), 128: ("synthetic", "hetero"), 96: ("synthetic",)}
    for H, route in SEEDED_ROUTES.items():
        check(leaf_digests(seeded[H].net) == gold["leaves"][str(H)],
              f"hidden {H}: the seeded leaves on the card differ from the golden file")
        for label in todo[H]:
            graphs, system = batches[label]
            before = dict(ops.LAUNCHES)
            got = schedule_digests(seeded[H].schedule_many(graphs, STAGES, system,
                                                           use_cache=False))
            if label == "hetero":
                expect(f"seeded hidden {H}, {label}", delta(before), ptr_step=hetero_steps)
            else:
                expect(f"seeded hidden {H}, {label}", delta(before),
                       **{route: synth_steps if route == "ptr_step" else 1})
            bad = digest_misses(got, gold["seeded"][str(H)][label])
            check(not bad, f"seeded hidden {H}, {label}: graphs {bad} differ from the golden "
                  "file")
        print(f"seeded init hidden {H}: 16 leaves equal to the golden file on the card; "
              f"{len(synth)} synthetic graphs ({route}) and {len(hetero_graphs)} heterogeneous "
              "ones (scan + B2, w_sys-conditioned start token): order and assignment digests "
              f"equal the golden file (here: {', '.join(todo[H])}; the rest on the main path)",
              flush=True)
    print(f"seeded init hidden 128: drawn on the host in {t_init:.2f} s", flush=True)

    sampled = {}                 # bucket_n -> (graphs, keys) of the sampled batches
    root = prng.PRNGKey(gold["meta"]["sample_seed"])
    for label, graphs in (("synthetic", synth), ("table1", table1)):
        keys = prng.fold_in(root, np.arange(len(graphs)))
        want = gold["sample_order"][label]
        want = [want[nm] for nm in names] if label == "table1" else want
        for bucket_n, idxs in bucketize(graphs).items():
            batch = pack_padded([graphs[i] for i in idxs], bucket_n, D)
            before = dict(ops.LAUNCHES)
            order, logp, ent = sample_order(sched.net, batch.feats, batch.parent_mat,
                                            keys[idxs], n_valid=batch.n_valid, decode="kernel")
            expect(f"sampled {label}, bucket {bucket_n}", delta(before), ptr_decode_cluster=1)
            order = order.cpu().numpy()
            bad = [i for r, i in enumerate(idxs)
                   if digest(order[r, : graphs[i].n]) != want[i]]
            check(not bad, f"sampled {label}: graphs {bad} differ from JAX's sample_order")
            sampled[(label, bucket_n)] = ([graphs[i] for i in idxs], keys[idxs], logp, ent)
    print(f"sampled decode (respect-v1, B1 cluster template): {len(synth)} synthetic and "
          f"{len(table1)} Table-I orders equal JAX's sample_order digests", flush=True)

    sched.clear_cache()
    sched.schedule_many(synth[:3], STAGES)
    stats = sched.cache_stats()
    before = dict(ops.LAUNCHES)
    fb = sched.fallback_schedule_many(table1 + synth, STAGES,
                                      fallback_seed=gold["meta"]["fallback_seed"])
    expect("fallback", delta(before), ptr_decode_cluster=len(bucketize(table1 + synth)))
    check(all(r["served_by"] == "fallback" and not r["cache_hit"] for r in fb),
          "fallback results are not stamped served_by='fallback'")
    check(sched.cache_stats() == stats, f"fallback touched the cache: {stats} -> "
          f"{sched.cache_stats()}")
    got = schedule_digests(fb)
    want = {k: [gold["fallback"]["table1"][nm][k] for nm in names]
            + gold["fallback"]["synthetic"][k] for k in ("order_sha256", "assign_sha256")}
    bad = digest_misses(got, want)
    check(not bad, f"fallback: graphs {bad} differ from the golden file")
    print(f"fallback: {len(fb)} schedules (Table-I and synthetic) equal the golden file, all "
          f"served_by='fallback', cache {stats} unchanged", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        seeded[256].save(Path(tmp) / "seeded-256")
        back = RespectScheduler.load(Path(tmp) / "seeded-256")
        check(leaf_digests(back.net) == gold["leaves"]["256"], "save/load: leaves differ")
        before = dict(ops.LAUNCHES)
        got = schedule_digests(back.schedule_many(synth, STAGES, use_cache=False))
        expect("save/load", delta(before), ptr_decode_block=1)
    bad = digest_misses(got, gold["seeded"]["256"]["synthetic"])
    check(not bad, f"save/load: graphs {bad} differ from the golden file")
    ran = delta(dict.fromkeys(ops.LAUNCHES, 0))
    print(f"save/load round trip of the hidden-256 scheduler: digests equal; the seeded path "
          f"launched {ran} in {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(all(ran[k] > 0 for k in ("ptr_decode_block", "ptr_decode_cluster", "ptr_step")),
          f"the seeded path left a kernel unlaunched: {ran}")

    # ---- B1 sampled against its plain version, and against greedy ----- #
    err = 0.0
    for (label, bucket_n), (graphs, keys, logp, ent) in sampled.items():
        batch = pack_padded(graphs, bucket_n, D).to("cuda")
        with torch.inference_mode():
            C, (h0, c0), emb = sched.net.encode(batch.feats, batch.n_valid)
            args = (sched.net, C, emb, h0, c0, batch.parent_mat, batch.n_valid,
                    step_uniforms(keys, bucket_n).cuda())
            po, pl_, pe = decode_batch_reference(*args)
            ko, kl, ke = decode_batch(*args)
        valid = torch.arange(bucket_n, device="cuda")[None, :] < batch.n_valid[:, None].long()
        check(torch.equal(torch.where(valid, ko, -1), torch.where(valid, po, -1)),
              f"sampled {label} bucket {bucket_n}: kernel and plain orders differ")
        e = max(float((kl - pl_).abs().max()), float((ke - pe).abs().max()),
                float((logp - pl_).abs().max()), float((ent - pe).abs().max()))
        check(e <= TOL_LOGP, f"sampled {label} bucket {bucket_n}: logp/entropy error {e:.3e}")
        err = max(err, e)
    print(f"sampled decode against the plain version on the card: orders equal, max |err| "
          f"logp/entropy {err:.2e} (tolerance {TOL_LOGP})", flush=True)

    big = [i for i in bucketize(table1)[1024]][-4:]
    for label, graphs, keys in (
            ("bucket 32, B=64", synth, prng.fold_in(root, np.arange(len(synth)))),
            ("bucket 1024, B=4", [table1[i] for i in big], prng.fold_in(root, np.array(big)))):
        batch = pack_padded(graphs, max_deg=D).to("cuda")
        with torch.inference_mode():
            C, (h0, c0), emb = sched.net.encode(batch.feats, batch.n_valid)
            args = (sched.net, C, emb, h0, c0, batch.parent_mat, batch.n_valid)
            unif = step_uniforms(keys, batch.bucket_n).cuda()
            t = {"greedy": [], "sampled": []}
            for mode in ("greedy", "sampled", "sampled", "greedy"):
                extra = (unif,) if mode == "sampled" else ()
                t[mode].append(device_ms(lambda: decode_batch(*args, *extra),
                                         "ptr_decode_cluster", iters=5))
            # the rows a step reads depend on the order, so the two modes'
            # work differs by their orders' frontiers as well as by the pick
            rows = [sum(sum(frontier_sizes(gr, o)) for gr, o in zip(graphs, out[0].cpu().numpy()))
                    for out in (decode_batch(*args), decode_batch(*args, unif))]
        g, smp = t["greedy"], t["sampled"]
        print(f"ptr_decode_cluster {label} on {card}, device time (profiler, greedy, sampled, "
              f"sampled, greedy): greedy {min(g):.4f} - {max(g):.4f} ms, sampled "
              f"{min(smp):.4f} - {max(smp):.4f} ms (sampled / greedy "
              f"{statistics.mean(smp) / statistics.mean(g):.3f}); selectable rows summed over "
              f"the real steps: greedy {rows[0]}, sampled {rows[1]}", flush=True)
    del seeded


# ---------------------------------------------------------------------- #
# the serving front end: SchedulerService over respect-v1 on the card
# ---------------------------------------------------------------------- #
SERVICE_THREADS = 8     # submitter threads
SERVICE_WINDOW = 8      # requests each submitter keeps in flight
K3_GRAPHS = 16          # synthetic graphs also requested at k = 3
SOAK = dict(seed=0, n_calls=40, p_crash=0.08, p_error=0.15, p_slow=0.05, p_corrupt=0.08,
            slow_s=0.005, rungs=("policy", "fallback"))   # tests/test_faults.py's soak


class FallbackTimer:
    """Delegates to a scheduler, recording each ``fallback_schedule_many``
    call's wall time, arguments and kernel launches (only the service's
    worker calls it, so each launch delta is that call's own)."""

    def __init__(self, inner):
        self._inner = inner
        self.calls: list[tuple[float, tuple, dict]] = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def fallback_schedule_many(self, graphs, *args, **kw):
        from repro_torch.kernels.build import LAUNCHES
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        out = self._inner.fallback_schedule_many(graphs, *args, **kw)
        self.calls.append((time.perf_counter() - t0, (graphs, *args),
                           {k: LAUNCHES[k] - before[k] for k in LAUNCHES}))
        return out


def drive(svc, requests) -> tuple[list, float]:
    """Sends ``(key, graph, k, system)`` requests from SERVICE_THREADS
    threads, each keeping SERVICE_WINDOW in flight; returns ``(key,
    result)`` pairs and the wall time from the first submit to the last
    result."""
    out: list[list] = [[] for _ in range(SERVICE_THREADS)]
    errors: list[BaseException] = []

    def submitter(tid):
        try:
            mine = requests[tid::SERVICE_THREADS]
            for i in range(0, len(mine), SERVICE_WINDOW):
                futs = [(key, svc.submit(g, k, system))
                        for key, g, k, system in mine[i:i + SERVICE_WINDOW]]
                out[tid] += [(key, f.result(timeout=300)) for key, f in futs]
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(SERVICE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a submitter thread did not finish")
    check(not errors, f"submitters raised: {errors[:3]}")
    return [kr for rs in out for kr in rs], wall


def drained(st) -> bool:
    return (st.completed + st.failed == st.requests
            and st.cache_hits + st.cache_misses + st.dedup_hits + st.degraded + st.failed
            == st.requests and st.queue_depth == 0 and st.inflight_keys == 0)


def service_phase(card: str, golden: dict, names, table1, synth, hetero_graphs, hsys,
                  res_uniform, res_hetero, cpu) -> None:
    """SchedulerService over a fresh ``from_release()`` on the card: warmup,
    clean traffic from eight threads, the seeded fault replay and the
    deadline checks; raises SmokeFailure on any difference.
    ``res_uniform``/``res_hetero`` are the main path's ``schedule_many``
    results of ``table1 + synth`` and of the heterogeneous batch; ``cpu`` is
    the release on the CPU, whose plain path witnesses the fallback rung
    where the seeded golden file has no digests."""
    import numpy as np
    import torch

    from repro_torch.core import RespectScheduler, heuristic_schedule_many, validate_monotone
    from repro_torch.kernels import build
    from repro_torch.serving import DegradeConfig, FaultPlan, FaultyScheduler, SchedulerService

    t_phase = time.perf_counter()
    sched = RespectScheduler.from_release()            # device: cuda, fresh caches
    fb_gold = json.loads(SEEDED_GOLDEN.read_text())["fallback"]
    groups = {"table1": (table1, STAGES, None), "synth": (synth, STAGES, None),
              "hetero": (hetero_graphs, STAGES, hsys), "k3": (synth[:K3_GRAPHS], 3, None)}
    graph_of = {(label, i): g for label, (gs, _, _) in groups.items() for i, g in enumerate(gs)}
    setting = {label: (k, system) for label, (_, k, system) in groups.items()}
    requests = [(key, g, *setting[key[0]]) for key, g in graph_of.items()] * 2
    requests = [requests[i] for i in np.random.default_rng(0).permutation(len(requests))]

    def same(r, order, assign) -> bool:
        return np.array_equal(r["order"], order) and np.array_equal(r["assignment"], assign)

    def numpy_only(r) -> bool:
        return (isinstance(r["order"], np.ndarray) and isinstance(r["assignment"], np.ndarray)
                and not any(isinstance(v, torch.Tensor) for v in r.values()))

    # ---- 1. warmup: then live traffic builds and loads nothing --------- #
    svc = SchedulerService(sched)
    t0 = time.perf_counter()
    keys = svc.warmup([(30, 1), (30, 16), *table1], n_stages=STAGES)
    keys += svc.warmup([hetero_graphs[0]], n_stages=STAGES, system=hsys)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    libs = set(build._libs)
    check(sched.cache_stats() == {"hits": 0, "misses": 0, "size": 0},
          f"warmup filled the schedule cache: {sched.cache_stats()}")
    check({("ptr_decode", ()), ("ptr_step", ())} <= libs, f"warmup left {libs} loaded")
    print(f"service warmup on {card}: {t_warm:.3f} s for {len(keys)} (bucket_n, bucket_b, impl) "
          f"keys {[(k[0], k[1], k[-1]) for k in keys]} (the kernels were built at the start of "
          "the script); schedule cache empty", flush=True)

    # ---- 2. clean traffic, counted ------------------------------------ #
    want = {("table1", i): r for i, r in enumerate(res_uniform[:len(table1)])}
    want.update({("synth", i): r for i, r in enumerate(res_uniform[len(table1):])})
    want.update({("hetero", i): r for i, r in enumerate(res_hetero)})
    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
    got, wall = drive(svc, requests)
    check(svc.close(timeout=300), "the clean service did not drain")
    torch.cuda.synchronize()
    ran = dict(build.LAUNCHES)
    st = svc.stats()
    check(build.build_kernels(["ptr_decode", "ptr_step"]) == 0.0 and set(build._libs) == libs,
          f"live traffic built or loaded a kernel library: {set(build._libs) - libs}")
    want.update({("k3", i): r for i, r in enumerate(
        sched.schedule_many(groups["k3"][0], 3, use_cache=False))})
    check(len(got) == len(requests) and st.requests == len(requests) and drained(st),
          f"clean traffic: {len(got)} results of {len(requests)}, stats {st.as_dict()}")
    check(st.degraded == st.failed == st.retries == st.worker_restarts == 0
          and all(r["served_by"] == "policy" for _, r in got),
          f"clean traffic left the policy rung: degraded {st.degraded}, failed {st.failed}, "
          f"retries {st.retries}, worker restarts {st.worker_restarts}")
    check(ran["ptr_decode_cluster"] > 0 and ran["ptr_step"] > 0 and ran["ptr_decode_block"] == 0,
          f"clean traffic launched {ran}: expected ptr_decode_cluster (uniform requests) and "
          "ptr_step (heterogeneous ones) and no ptr_decode_block")
    check(st.dedup_hits > 0 and st.cache_hits > 0,
          f"clean traffic: dedup hits {st.dedup_hits}, cache hits {st.cache_hits}")
    bad = [key for key, r in got if not (numpy_only(r) and same(r, want[key]["order"],
                                                                 want[key]["assignment"]))]
    check(not bad, f"clean traffic: results {bad[:5]} differ from schedule_many's")
    bad = [names[i] for (label, i), r in got if label == "table1"
           and (digest(r["order"]), digest(r["assignment"]))
           != tuple(golden["models"][names[i]][h] for h in ("order_sha256", "assign_sha256"))]
    check(not bad, f"clean traffic: Table-I results {bad} differ from the golden digests")
    clean = {key: r for key, r in got}
    print(f"service clean traffic on {card}: {len(requests)} requests ({len(graph_of)} distinct, "
          f"each twice; {SERVICE_THREADS} threads, {SERVICE_WINDOW} in flight each, max_batch 16, "
          f"max_wait_ms 2) in {wall:.3f} s: {len(requests) / wall:.2f} requests/s, p50 "
          f"{st.p50_ms:.2f} ms, p99 {st.p99_ms:.2f} ms, mean {st.mean_ms:.2f} ms; {st.batches} "
          f"batches (full {st.flush_full}, max_wait {st.flush_deadline}, drain {st.flush_drain}, "
          f"largest {st.max_batch_observed}); misses {st.cache_misses}, hits {st.cache_hits}, "
          f"dedups {st.dedup_hits}; all served by the policy rung, 0 degraded / failed / retried "
          f"/ restarted; results equal schedule_many's and the ten golden digests; launches "
          f"{ran}; no kernel built or loaded after warmup", flush=True)

    # ---- 3. the seeded fault replay ------------------------------------ #
    sched.clear_cache()
    timer = FallbackTimer(sched)
    faulty = FaultyScheduler(timer, FaultPlan.random(**SOAK))
    cfg = DegradeConfig(retry_attempts=1, retry_backoff_s=0.001, retry_backoff_max_s=0.002,
                        restart_backoff_s=0.01, restart_backoff_max_s=0.05)
    svc = SchedulerService(faulty, max_batch=4, max_wait_ms=1, degrade=cfg)
    got, wall = drive(svc, requests)
    check(svc.close(timeout=300), "the fault replay did not drain")
    st = svc.stats()
    check(len(got) == len(requests) and st.requests == len(requests) and drained(st)
          and st.failed == 0, f"fault replay: {len(got)} results of {len(requests)}, "
          f"stats {st.as_dict()}")
    check(len(faulty.fired) > 0, "fault replay: no fault fired")
    by_rung: dict = {}
    for key, r in got:
        by_rung.setdefault(r["served_by"], []).append((key, r))
    check(set(by_rung) <= {"policy", "fallback", "heuristic"}, f"rungs {set(by_rung)}")
    bad = [key for key, r in got if not (numpy_only(r) and validate_monotone(
        graph_of[key], r["assignment"], setting[key[0]][0]))]
    check(not bad, f"fault replay: results {bad[:5]} are not valid monotone schedules")
    bad = [key for key, r in by_rung.get("policy", [])
           if not same(r, clean[key]["order"], clean[key]["assignment"])]
    check(not bad, f"fault replay: policy results {bad[:5]} differ from the clean phase's")
    fb_want = {}
    for key, _ in by_rung.get("fallback", []):
        label, i = key
        if label == "table1":
            fb_want[key] = tuple(fb_gold["table1"][names[i]][h]
                                 for h in ("order_sha256", "assign_sha256"))
        elif label == "synth":
            fb_want[key] = tuple(fb_gold["synthetic"][h][i]
                                 for h in ("order_sha256", "assign_sha256"))
    # no golden digests for the heterogeneous and k = 3 requests: the CPU
    # plain path's fallback rung, once per group that reached the rung
    for label in {key[0] for key, _ in by_rung.get("fallback", [])} - {"table1", "synth"}:
        gs, k, system = groups[label]
        for i, r in enumerate(cpu.fallback_schedule_many(gs, k, system)):
            fb_want[(label, i)] = (digest(r["order"]), digest(r["assignment"]))
    bad = [key for key, r in by_rung.get("fallback", [])
           if (digest(r["order"]), digest(r["assignment"])) != fb_want[key]]
    check(not bad, f"fault replay: fallback results {bad[:5]} differ from the seeded golden "
          "file or the CPU plain path's fallback rung")
    fb_cpu = sorted({key[0] for key, _ in by_rung.get("fallback", [])} - {"table1", "synth"})
    bad = [key for key, r in by_rung.get("heuristic", [])
           if not same(r, *heuristic_schedule_many([graph_of[key]], *setting[key[0]])[0])]
    check(not bad, f"fault replay: heuristic results {bad[:5]} differ from "
          "heuristic_schedule_many on the host")
    fb_launches = {k: sum(c[2][k] for c in timer.calls) for k in build.LAUNCHES}
    check(timer.calls and fb_launches["ptr_decode_cluster"] > 0,
          f"fault replay: the fallback rung ran {len(timer.calls)} calls launching {fb_launches}; "
          "expected B1 (ptr_decode_cluster) on the card")
    kinds = {kind: sum(f[2] == kind for f in faulty.fired) for kind in ("crash", "error", "slow",
                                                                         "corrupt")}
    (t_first, first_args, _), later = timer.calls[0], timer.calls[1:]
    n_first = len(first_args[0])
    t0 = time.perf_counter()
    sched.fallback_schedule_many(*first_args)          # the same call, weights drawn
    t_again = time.perf_counter() - t0
    later_pg = [t / len(args[0]) for t, args, _ in later]
    est = svc._estimator.snapshot()
    print(f"service fault replay on {card} (FaultPlan.random(seed=0, n_calls=40, p_crash 0.08, "
          f"p_error 0.15, p_slow 0.05, p_corrupt 0.08), max_batch 4, max_wait_ms 1): "
          f"{len(requests)} requests in {wall:.3f} s, 100% completed, {len(faulty.fired)} faults "
          f"fired {kinds}; served policy {len(by_rung.get('policy', []))}, fallback "
          f"{len(by_rung.get('fallback', []))}, heuristic {len(by_rung.get('heuristic', []))}; "
          f"retries {st.retries}, worker restarts {st.worker_restarts}, degraded for error "
          f"{st.degrade_error}, crash {st.degrade_crash}; policy results equal the clean "
          "phase's, fallback results the seeded golden file (Table-I, synthetic) or the CPU "
          f"plain path's fallback rung ({', '.join(fb_cpu) or 'none reached it'}), heuristic "
          "results the host's; the fallback rung launched "
          f"{fb_launches}", flush=True)
    print(f"fallback rung on {card}: first call {t_first:.4f} s for {n_first} graphs of "
          f"{sorted(g.n for g in first_args[0])} nodes ({t_first / n_first:.4f} s a graph; it "
          f"draws the seeded weights on the host), the same call again {t_again:.4f} s; the "
          f"{len(later)} later calls "
          + (f"{min(later_pg):.4f} - {max(later_pg):.4f} s a graph (median "
             f"{statistics.median(later_pg):.4f})" if later else "none")
          + f"; cost estimator after the replay (s a graph): "
          + ", ".join(f"{k} {v:.5f}" for k, v in sorted(est.items())), flush=True)

    # ---- 4. deadlines -------------------------------------------------- #
    sched.clear_cache()
    svc = SchedulerService(sched)
    roomy = table1 + synth[:16]
    res_roomy = [f.result(timeout=300)
                 for f in [svc.submit(g, STAGES, deadline_ms=60_000.0) for g in roomy]]
    late = synth[16:24]
    res_late = [f.result(timeout=300)
                for f in [svc.submit(g, STAGES, deadline_ms=0.001) for g in late]]
    check(svc.close(timeout=300), "the deadline service did not drain")
    st = svc.stats()
    wants = res_uniform[:len(table1)] + res_uniform[len(table1):len(table1) + 16]
    check(all(r["served_by"] == "policy" and r["deadline_met"] and same(r, w["order"],
                                                                        w["assignment"])
              for r, w in zip(res_roomy, wants)),
          "a generous deadline left the policy rung or changed a result")
    check(all(r["served_by"] == "heuristic" and not r["deadline_met"] for r in res_late)
          and st.degrade_deadline == len(late) == st.deadline_missed and drained(st),
          f"expired budgets: rungs {[r['served_by'] for r in res_late]}, stats {st.as_dict()}")
    print(f"service deadlines on {card}: {len(roomy)} requests with a 60 s budget stayed on the "
          f"policy rung, results unchanged; {len(late)} with an expired one went to the "
          f"heuristic floor (degrade_deadline {st.degrade_deadline}, deadline_missed "
          f"{st.deadline_missed}); the service phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del sched


# ---------------------------------------------------------------------- #
# the RL training engine: respect-v1's training configuration on the card
# ---------------------------------------------------------------------- #
TRAIN_GOLDEN = ROOT / "tests" / "golden" / "torch_train_steps.json"
TOL_TRAIN_REWARD = 1e-6   # reward means: exact per graph, summed over graphs in another order
TOL_TRAIN_REL = 1e-5      # loss, entropy, advantage, grad_norm, leaf norms: float32 sums
TOL_TRAIN_PARAM = 1e-5    # parameter entries: float32 gradient sums through Adam's lr / eps
TRAIN_DRAWS = 3           # uniform draws at k = 4 (the golden steps are the first draw's)
PAPER = dict(hidden=256, batch=128, n=30)   # the paper's scale


def int_digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.asarray(a, dtype=np.int64).tobytes()).hexdigest()


def f32_digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a, dtype="<f4").tobytes()).hexdigest()


def golden_errors(want: dict, got: dict, after: dict) -> dict:
    """Checks one training step against its golden record (integers and
    per-graph rewards equal, floats within the TOL_TRAIN_* tolerances);
    returns the largest error of each kind."""
    import numpy as np
    for k, v in want.items():
        if k.endswith("sha256") or k in ("bucket_n", "batch"):
            check(got[k] == v, f"train golden: {k} differs")
    err = {"reward": 0.0, "rel": 0.0, "param": 0.0, "norm": 0.0}
    for k, v in want["metrics"].items():
        d = abs(got["metrics"][k] - v)
        if k.startswith("reward"):
            err["reward"] = max(err["reward"], d)
        else:
            err["rel"] = max(err["rel"], d / max(1.0, abs(v)))
    for k, v in want["leaf_norms"].items():
        err["norm"] = max(err["norm"], abs(np.linalg.norm(after[k].astype(np.float64)) - v) / v)
    for e in want["entries"]:
        err["param"] = max(err["param"], abs(float(after[e["leaf"]].reshape(-1)[e["index"]])
                                             - e["value"]))
    check(err["reward"] <= TOL_TRAIN_REWARD and err["rel"] <= TOL_TRAIN_REL
          and err["norm"] <= TOL_TRAIN_REL and err["param"] <= TOL_TRAIN_PARAM,
          f"train golden: errors {err} beyond rewards {TOL_TRAIN_REWARD}, metrics and norms "
          f"{TOL_TRAIN_REL} (relative), parameters {TOL_TRAIN_PARAM}")
    return err


def profile_ranges(fn, prefix: str):
    """One profiled call of ``fn``: its device kernels as (name, start, end)
    and its host ranges whose name starts with ``prefix`` (the trainer's
    ``record_function`` ranges) as (name, start, end), microseconds, by
    start.  The ranges' device-side annotations are not kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, ranges = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.name.startswith(prefix):
            if e.device_type == DeviceType.CPU:
                ranges.append(span)
        elif e.device_type == DeviceType.CUDA:
            kernels.append(span)
    return sorted(kernels, key=lambda k: k[1]), sorted(ranges, key=lambda k: k[1])


def same_step(got: dict, want: dict, got_net, want_net) -> dict:
    """The largest error of one train step's metrics and parameters against
    another run of it, checked at the TOL_TRAIN_* tolerances."""
    import numpy as np
    from repro_torch.checkpoint.manager import flatten_leaves
    from repro_torch.core.ptrnet import param_tree
    err = {"reward": 0.0, "rel": 0.0, "param": 0.0}
    for k, v in want.items():
        d = abs(got[k] - v)
        if k.startswith("reward"):
            err["reward"] = max(err["reward"], d)
        else:
            err["rel"] = max(err["rel"], d / max(1.0, abs(v)))
    a, b = flatten_leaves(param_tree(got_net)), flatten_leaves(param_tree(want_net))
    check([n for n, _ in a] == [n for n, _ in b], "parameter trees differ")
    for (_, x), (_, y) in zip(a, b):
        err["param"] = max(err["param"], float(np.abs(x - y).max()))
    return err


def train_phase(card: str) -> None:
    """Drives the port's RLTrainer on the card at respect-v1's training
    configuration (see the module docstring, item 13) with the launch
    counters reset just before and read just after."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.core import DagSampler, PipelineSystem, prng
    from repro_torch.core import rl
    from repro_torch.checkpoint.manager import flatten_leaves
    from repro_torch.core.batching import bucketize
    from repro_torch.core.ptrnet import param_tree
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.decode import decode_template

    gold = json.loads(TRAIN_GOLDEN.read_text())
    c = gold["meta"]["config"]
    system = PipelineSystem(c["n_stages"])
    hsys = PipelineSystem(**HETERO)
    root = prng.PRNGKey(c["key_seed"])
    t_phase = time.perf_counter()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    tt = rl.RLTrainer(system=system, hidden=c["hidden"], lr=c["lr"], seed=c["seed"],
                      stage_counts=tuple(c["stage_counts"]))
    check(tt.device.type == "cuda" and tt.params.dec0.is_cuda, "trainer is not on the card")
    sampler = DagSampler(seed=c["seed"], n=tuple(c["n"]))
    stream = sampler.packed_stream(c["batch"], c["n_stages"], system=system,
                                   batches_per_epoch=TRAIN_DRAWS, epochs=1)

    # ---- the uniform feed: the golden steps, then the rest of the draws #
    errs = {"reward": 0.0, "rel": 0.0, "param": 0.0, "norm": 0.0}
    by_bucket: dict[int, list[tuple[float, float]]] = {}
    step = 0
    for pack in stream:
        key = prng.fold_in(root, step)
        if step < len(gold["steps"]):
            want = gold["steps"][step]
            got = {"bucket_n": pack.bucket_n, "batch": pack.batch,
                   "n_valid_sha256": int_digest(pack.n_valid),
                   "label_assign_sha256": int_digest(pack.label_assign)}
            keys = rl._split(key, pack.batch)
            with torch.no_grad():
                sampled = rl._policy_rewards(tt.params, pack, keys, c["n_stages"], system, True)
                impl = rl._resolve(tt.baseline_params, pack.to("cuda"), False)
                base = rl._policy_rewards(tt.baseline_params, pack, keys, c["n_stages"], system,
                                          False, impl)
                b1_sampled = rl.make_rollout_fn(c["n_stages"], system, sample=True,
                                                decode_impl="kernel")(tt.params, pack, key)
            valid = pack.valid_mask().to("cuda")
            for prefix, (r, _, _, o, a) in (("sample", sampled), ("baseline", base)):
                got[f"{prefix}_order_sha256"] = int_digest(torch.where(valid, o, -1).cpu())
                got[f"{prefix}_assign_sha256"] = int_digest(a.cpu())
                got[f"{prefix}_rewards_sha256"] = f32_digest(r.cpu())
            check(int_digest(torch.where(valid, b1_sampled[3], -1).cpu())
                  == want["sample_order_sha256"],
                  f"train golden step {step}: B1's sampled rollout differs from the scan's orders")
        before = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tt.train_step(pack, key, n_stages=c["n_stages"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ran = {t: ops.LAUNCHES[t] - before[t] for t in ops.LAUNCHES}
        check(ran["ptr_decode_cluster"] == 1 and ran["ptr_step"] == 0,
              f"train step {step} (bucket {pack.bucket_n}): launches {ran}, expected one "
              "ptr_decode_cluster in the baseline pass")
        by_bucket.setdefault(pack.bucket_n, []).append((dt, m["n_graphs"]))
        if step < len(gold["steps"]):
            got["metrics"] = m
            after = dict(flatten_leaves(param_tree(tt.params)))
            e = golden_errors(gold["steps"][step], got, after)
            errs = {k2: max(errs[k2], e[k2]) for k2 in errs}
        step += 1
    check(step > len(gold["steps"]), "the uniform feed ran no step past the golden ones")
    print(f"train golden on {card}: the first {len(gold['steps'])} steps of respect-v1's training "
          f"configuration (hidden {c['hidden']}, batch {c['batch']}, lr {c['lr']}, |V| "
          f"{c['n'][0]}-{c['n'][1]}) equal tests/golden/torch_train_steps.json: labels, sampled "
          "and baseline orders, assignments and per-graph rewards; B1's sampled rollout equals "
          f"the scan's orders; max error reward means {errs['reward']:.2e} (tolerance "
          f"{TOL_TRAIN_REWARD}), loss/entropy/advantage/grad_norm {errs['rel']:.2e} relative "
          f"({TOL_TRAIN_REL}), leaf norms {errs['norm']:.2e} relative ({TOL_TRAIN_REL}), "
          f"parameter entries {errs['param']:.2e} ({TOL_TRAIN_PARAM})", flush=True)
    for bn in sorted(by_bucket):
        ts = [dt for dt, _ in by_bucket[bn]]
        gps = [g / dt for dt, g in by_bucket[bn]]
        print(f"train steps bucket {bn} on {card}: {len(ts)} steps, "
              f"{statistics.median(ts) * 1e3:.2f} ms a step (median; min {min(ts) * 1e3:.2f}, "
              f"max {max(ts) * 1e3:.2f}), {statistics.median(gps):.1f} training graphs/s "
              "(median, real graphs only)", flush=True)

    # ---- one draw at each other stage count ---------------------------- #
    for i, k in enumerate(kk for kk in c["stage_counts"] if kk != c["n_stages"]):
        other = DagSampler(seed=c["seed"], n=tuple(c["n"]))
        other.restore({"seed": c["seed"], "count": TRAIN_DRAWS + i})
        for pack in other.packed_stream(c["batch"], k, system=system, batches_per_epoch=1,
                                        epochs=1):
            m = tt.train_step(pack, prng.fold_in(root, step), n_stages=k)
            check(all(np.isfinite(v) for v in m.values()), f"k = {k}: metrics {m}")
            step += 1
    print(f"train stage counts on {card}: one draw at each of k = "
          f"{[kk for kk in c['stage_counts'] if kk != c['n_stages']]} ({step} steps in all), "
          "metrics finite", flush=True)

    # ---- a heterogeneous step: B2 in the baseline, w_sys learns ------- #
    # the same step from a CPU copy of the trainer's state (the plain path)
    # holds the card's B2 baseline, advantage, gradient and update
    hpack = DagSampler(seed=7, n=tuple(c["n"])).next_packed_batch(c["batch"], c["n_stages"],
                                                                  system=hsys)
    w_sys = tt.params.w_sys.detach().clone()
    o = tt.state.opt_state
    cpu = lambda t: None if t is None else t.cpu()
    cpu_state = (copy.deepcopy(tt.params).to("cpu"), rl._frozen_copy(tt.baseline_params).to("cpu"),
                 optim.OptState(step=o.step.cpu(), mu=optim.tree_map(cpu, o.mu),
                                nu=optim.tree_map(cpu, o.nu),
                                master=None if o.master is None else optim.tree_map(cpu, o.master)))
    hkey = prng.fold_in(root, step)
    before = dict(ops.LAUNCHES)
    hstep = rl.make_train_step(c["n_stages"], hsys, tt.optimizer)
    _, tt.state.opt_state, hm = hstep(tt.params, tt.baseline_params, tt.state.opt_state, hpack,
                                      hkey)
    torch.cuda.synchronize()
    ran = {t: ops.LAUNCHES[t] - before[t] for t in ops.LAUNCHES}
    check(ran["ptr_step"] == hpack.bucket_n and ran["ptr_decode_cluster"] == 0,
          f"heterogeneous train step: launches {ran}, expected {hpack.bucket_n} ptr_step (one a "
          "step of the baseline's scan) and no B1")
    moved = float((tt.params.w_sys.detach() - w_sys).abs().max())
    check(moved > 0, "heterogeneous train step: w_sys did not move")
    hm = {k: float(v) for k, v in hm.items()}
    cpu_net = cpu_state[0]
    _, _, cm = hstep(*cpu_state, hpack, hkey)
    herr = same_step(hm, {k: float(v) for k, v in cm.items()}, tt.params, cpu_net)
    check(herr["reward"] <= TOL_TRAIN_REWARD and herr["rel"] <= TOL_TRAIN_REL
          and herr["param"] <= TOL_TRAIN_PARAM,
          f"heterogeneous train step: card against the CPU plain path, errors {herr} beyond "
          f"rewards {TOL_TRAIN_REWARD}, metrics {TOL_TRAIN_REL} (relative), parameters "
          f"{TOL_TRAIN_PARAM}; card {hm}, CPU {cm}")
    print(f"train heterogeneous step on {card}: bucket {hpack.bucket_n}, B={hpack.batch}, "
          f"{ran['ptr_step']} ptr_step launches in the baseline's scan, reward sample "
          f"{hm['reward_sample']:.4f} baseline {hm['reward_baseline']:.4f}, advantage "
          f"{hm['advantage']:.4f}, w_sys moved by up to {moved:.3e}; held to the same step from "
          f"a CPU copy of the state (plain path): reward means {herr['reward']:.2e} "
          f"({TOL_TRAIN_REWARD}), loss/entropy/advantage/grad_norm {herr['rel']:.2e} relative "
          f"({TOL_TRAIN_REL}), every parameter {herr['param']:.2e} ({TOL_TRAIN_PARAM})",
          flush=True)
    del cpu_state, cpu_net

    # ---- the paper's scale: hidden 256, batch 128, |V| = 30 ------------ #
    wide = rl.RLTrainer(system=system, hidden=PAPER["hidden"], lr=c["lr"], seed=c["seed"])
    ppack = DagSampler(seed=c["seed"], n=PAPER["n"]).next_packed_batch(PAPER["batch"],
                                                                       c["n_stages"])
    impl = rl._resolve(wide.baseline_params, ppack.to("cuda"), False)
    tmpl = decode_template(ppack.bucket_n, PAPER["hidden"]) if impl == "kernel" else "ptr_step"
    before = dict(ops.LAUNCHES)
    times = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pm = wide.train_step(ppack, prng.fold_in(root, 1000 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ran = {t: ops.LAUNCHES[t] - before[t] for t in ops.LAUNCHES}
    check(ran[tmpl] == (2 if impl == "kernel" else 2 * ppack.bucket_n),
          f"paper-scale step: launches {ran}, expected {tmpl}")
    print(f"train paper scale on {card}: hidden {PAPER['hidden']}, B={ppack.batch}, |V| = "
          f"{PAPER['n']} (bucket {ppack.bucket_n}, dense {ppack.dense}): baseline decode {impl} "
          f"({tmpl}); {times[0] * 1e3:.2f} ms the first step, {times[1] * 1e3:.2f} ms the second "
          f"({ppack.batch / times[1]:.1f} training graphs/s), loss {pm['loss']:.4f}", flush=True)
    del wide

    # ---- held-out eval: 128 graphs per stage count, against the CPU ---- #
    cpu_net = rl._frozen_copy(tt.params).to("cpu")
    evals = []
    for k in c["stage_counts"]:
        epack = DagSampler(seed=c["seed"] + 1, n=tuple(c["n"])).next_packed_batch(128, k)
        before = ops.LAUNCHES["ptr_decode_cluster"]
        got = tt.evaluate(epack, n_stages=k)
        check(ops.LAUNCHES["ptr_decode_cluster"] - before == 1, f"eval k = {k}: no B1 launch")
        want = rl.make_eval_fn(k, system)(cpu_net, epack)
        check(got["exact_match"] == float(want["exact_match"])
              and abs(got["reward_greedy"] - float(want["reward_greedy"])) <= TOL_TRAIN_REWARD,
              f"eval k = {k}: card {got}, CPU plain path {want}")
        evals.append(f"k={k} reward {got['reward_greedy']:.4f} exact-match "
                     f"{got['exact_match']:.4f}")
    print(f"train held-out eval on {card} (128 graphs a stage count, bucket {epack.bucket_n}, B1; "
          f"equal to the CPU plain path): " + "; ".join(evals), flush=True)

    # ---- save and restore: bit for bit --------------------------------- #
    ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    tt.consider_baseline(0.5)
    tt.save(ckpt)
    back = rl.RLTrainer(system=system, hidden=c["hidden"], lr=c["lr"], seed=c["seed"] + 1,
                        stage_counts=tuple(c["stage_counts"]))
    check(back.restore(ckpt) == tt.step_count, "restore returned another step")
    a, b = flatten_leaves(tt.state.tree()), flatten_leaves(back.state.tree())
    same = all(x.dtype == y.dtype and x.tobytes() == y.tobytes() for (_, x), (_, y) in zip(a, b))
    check(len(a) == 67 and [n for n, _ in a] == [n for n, _ in b] and same,
          "save/restore: the restored trainer state differs")
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"train save/restore on {card}: {len(a)} leaves (the reference's names) bit-equal after "
          f"a round trip at step {tt.step_count}", flush=True)
    launches = dict(ops.LAUNCHES)
    t_phase = time.perf_counter() - t_phase
    print(f"train phase launches: {launches}", flush=True)

    # ---- where a bucket-64 step's time goes; the device's idle share --- #
    # one profiled pack and train_step: the trainer's rl.* ranges on the
    # host clock (not synchronized: a range that waits on the device holds
    # the wait), the step's kernels on the device
    graphs = DagSampler(seed=c["seed"], n=tuple(c["n"])).next_batch(c["batch"])
    big = [graphs[i] for i in bucketize(graphs)[64]]

    def pack_and_step():
        spack = rl.pack_graphs(big, c["n_stages"], system).to("cuda")
        tt.train_step(spack, prng.fold_in(root, 2001), n_stages=c["n_stages"])

    kernels, ranges = profile_ranges(pack_and_step, "rl.")
    step_ranges = [r for r in ranges if r[0] == "rl.train_step"]
    names = {r[0][3:] for r in ranges}
    check(len(step_ranges) == 1 and names <= set(rl.SPANS),
          f"profiled train step: ranges {sorted(names)} (expected one train_step, of {rl.SPANS})")
    _, s0, s1 = step_ranges[0]
    kernels = [k for k in kernels if k[1] >= s0]
    split: dict[str, float] = {}
    for name, st, en in ranges:
        if name != "rl.train_step":
            split[name[3:]] = split.get(name[3:], 0.0) + (en - st) / 1e3
    total = (s1 - s0) / 1e3
    label = split.pop("label")
    split["other"] = total - sum(split.values())
    busy, window = busy_window([(st, en) for _, st, en in kernels])
    b1_ms = sum(en - st for nm, st, en in kernels if "ptr_decode" in nm) / 1e3
    check(any("ptr_decode_cluster" in nm for nm, _, _ in kernels),
          "profiled train step ran no ptr_decode_cluster kernel")
    print(f"train step split, bucket 64 (B={len(big)}, hidden {c['hidden']}) on {card}, from one "
          f"profiled train_step (the trainer's rl.* ranges, host clock): step {total:.2f} ms = "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
          + f"; label (pack_graphs, before the step) {label:.2f} ms; device: {len(kernels)} "
          f"kernels, busy {busy / 1e3:.2f} ms of a {window / 1e3:.2f} ms window (idle "
          f"{100 * (1 - busy / window):.1f}%), B1 (baseline) {b1_ms:.4f} ms of device time",
          flush=True)
    print(f"train phase on {card}: {t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------- #
# the gap-to-optimal eval and the release trainer
# ---------------------------------------------------------------------- #
EVAL_BENCH = ROOT / "BENCH_eval.json"
EVAL_RTOL = 1e-12   # float64 re-derivations from equal integer assignments
# the size ramp off: inside it the first draws hold 5-6 nodes, every reward is
# 1.0 and the weights would not move
RELEASE_ARGS = ["--max-steps", "6", "--eval-every", "3", "--batch", "16", "--n-max", "20",
                "--stage-counts", "2,4", "--ramp-batches", "1"]


def eval_divergence(card, cpu) -> str:
    """The first graph of the eval tiers whose respect schedule from the
    scheduler ``card`` differs from the CPU plain path's (``cpu``), with
    :func:`first_divergence` there."""
    import numpy as np
    from repro_torch.core import PipelineSystem
    from repro_torch.eval import generalization_grid, hetero_grid, scenario_grid
    for sc in (scenario_grid(smoke=True) + hetero_grid(smoke=True)
               + generalization_grid(smoke=True)):
        graphs = sc.build()
        system = (sc.resolve_system(graphs) if hasattr(sc, "resolve_system")
                  else PipelineSystem(sc.n_stages))
        got = card.schedule_many(graphs, sc.n_stages, system, use_cache=False)
        want = cpu.schedule_many(graphs, sc.n_stages, system, use_cache=False)
        for i, (g, r, w) in enumerate(zip(graphs, got, want)):
            if not (np.array_equal(r["order"], w["order"])
                    and np.array_equal(r["assignment"], w["assignment"])):
                cond = None if system.is_uniform else system
                return (f"{sc.name} graph {i} (n = {g.n}): "
                        f"{first_divergence(cpu.net, g, r['order'], cpu.max_deg, cond)}")
    return "every respect schedule equals the CPU plain path's"


def eval_phase(card: str, table1, synth) -> None:
    """The three smoke eval tiers on the card, held to BENCH_eval.json, with
    the launch counters reset just before and read just after each; then a
    short run of the release trainer on the card (see the module docstring,
    item 14)."""
    import numpy as np
    import torch
    from repro_torch import train_release
    from repro_torch.checkpoint import params_sha256, verify_release
    from repro_torch.core import RespectScheduler
    from repro_torch.core.batching import bucketize
    from repro_torch.core.ptrnet import param_tree
    from repro_torch.eval import (ExactOracle, check_generalization, check_hetero,
                                  check_results, diff_results, generalization_grid, hetero_grid,
                                  run_generalization, run_grid, scenario_grid, summarize,
                                  summarize_hetero)
    from repro_torch.eval.__main__ import BB_BUDGET_S, BB_MAX_N
    from repro_torch.kernels.ptr import ops

    bench = json.loads(EVAL_BENCH.read_text())
    t_phase = time.perf_counter()
    sched = RespectScheduler.from_release()
    oracle = ExactOracle()
    check(sched.device.type == "cuda" and oracle.device.type == "cuda",
          "eval: scheduler or oracle is not on the card")
    uniform, hetero, gen = (scenario_grid(smoke=True), hetero_grid(smoke=True),
                            generalization_grid(smoke=True))

    def buckets(scs):
        return [bn for sc in scs for bn in bucketize(sc.build())]

    # respect runs twice a grid scenario (an untimed warm call, then the timed
    # one), once a generalization scenario: one B1 launch a bucket a call on
    # a uniform system, one B2 launch a step (bucket_n) on a conditioned one
    runs = {
        "uniform": (lambda: run_grid(uniform, sched, oracle, bb_max_n=BB_MAX_N,
                                     bb_budget_s=BB_BUDGET_S),
                    {"ptr_decode_cluster": 2 * len(buckets(uniform)), "ptr_step": 0}),
        "hetero": (lambda: run_grid(hetero, sched, oracle, bb_max_n=BB_MAX_N,
                                    bb_budget_s=BB_BUDGET_S),
                   {"ptr_decode_cluster": 0, "ptr_step": 2 * sum(buckets(hetero))}),
        "gen": (lambda: run_generalization(sched, gen),
                {"ptr_decode_cluster": len(buckets(gen)), "ptr_step": 0}),
    }
    tiers, times = {}, {}
    for label, (fn, want) in runs.items():
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        tiers[label] = fn()
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        ran = dict(ops.LAUNCHES)
        check(ran["ptr_decode_block"] == 0
              and all(ran[k] == v for k, v in want.items()) and sum(want.values()) > 0,
              f"eval {label} tier: launches {ran}, expected {want} and no ptr_decode_block")
        print(f"eval {label} tier on {card}: {times[label]:.2f} s; B1 (ptr_decode_cluster) "
              f"{ran['ptr_decode_cluster']} launches, B2 (ptr_step) {ran['ptr_step']} launches",
              flush=True)

    meta = {"smoke": True, "trained_agent": sched.release is not None, "bb_max_n": BB_MAX_N,
            "n_scenarios": len(uniform)}
    summary = summarize(tiers["uniform"], meta, generalization=tiers["gen"])
    summary.update(summarize_hetero(tiers["hetero"]))
    diffs = diff_results(json.loads(json.dumps(summary)), bench, rtol=EVAL_RTOL)
    problems = (check_results(tiers["uniform"]) + check_hetero(tiers["hetero"])
                + check_generalization(tiers["gen"]))
    if diffs or problems:
        print("eval: " + "; ".join(diffs[:10] + problems[:10]), flush=True)
        print("eval first_divergence: "
              + eval_divergence(sched, RespectScheduler.from_release(device="cpu")), flush=True)
    check(not problems, f"eval checks failed: {problems}")
    check(not diffs, f"eval tiers differ from BENCH_eval.json in {len(diffs)} fields")
    print(f"eval on {card}: the three smoke tiers equal BENCH_eval.json in every non-timing "
          f"field (floats within {EVAL_RTOL} relative): match_rate_respect "
          f"{summary['match_rate_respect']!r}, table1_matches_k4 {summary['table1_matches_k4']}, "
          f"hetero_match_rate_respect {summary['hetero_match_rate_respect']!r}, "
          f"gen_gap_mean_respect {summary['gen_gap_mean_respect']!r}; check_results, "
          "check_hetero and check_generalization find no problem", flush=True)
    for label in ("uniform", "hetero"):
        res = tiers[label]
        print(f"eval {label} speedups on {card}: speedup_oracle_batched "
              f"{res['speedup_oracle_batched']!r} (host exact_dp {res['t_exact_host_s']:.4f} s, "
              f"oracle on the card {res['t_exact_device_s']:.4f} s), speedup_respect_vs_exact "
              f"{res['speedup_respect_vs_exact']!r} (respect "
              f"{res['aggregate']['respect']['t_s']:.4f} s); BENCH_eval.json's (the JAX "
              f"package on a CPU): {bench['speedup_oracle_batched']!r}, "
              f"{bench['speedup_respect_vs_exact']!r}", flush=True)

    # ---- a short run of the release trainer on the card ----------------- #
    out = ROOT / "build" / "chip_smoke_release"
    shutil.rmtree(out, ignore_errors=True)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    rc = train_release.main(RELEASE_ARGS + ["--out", str(out / "rel"), "--ckpt-dir",
                                            str(out / "ckpt"), "--label-cache",
                                            str(out / "labels")])
    torch.cuda.synchronize()
    t_rel = time.perf_counter() - t0
    ran = dict(ops.LAUNCHES)
    check(rc == 0, f"release trainer exited {rc}")
    check(ran["ptr_decode_cluster"] > 0 and ran["ptr_step"] == 0,
          f"release trainer: launches {ran}, expected B1 in its baselines and evals")
    _, manifest = verify_release(out / "rel")        # the port's reader: the sha256 check
    check(manifest["train"]["steps"] == 6, f"release trainer: {manifest['train']['steps']} steps")
    init = RespectScheduler.init(seed=0, hidden=128, device="cpu").net
    check(manifest["params_sha256"] != params_sha256(param_tree(init)),
          "release trainer: the weights did not move off their seeded init")
    on_card = RespectScheduler.from_release(out / "rel")
    on_cpu = RespectScheduler.from_release(out / "rel", device="cpu")
    check(on_card.device.type == "cuda"
          and on_card.release["params_sha256"] == on_cpu.release["params_sha256"]
          == manifest["params_sha256"], "release: the card and the CPU loaded other weights")
    for label, graphs in (("Table-I", table1), ("synthetic", synth)):
        got = on_card.schedule_many(graphs, STAGES, use_cache=False)
        want = on_cpu.schedule_many(graphs, STAGES, use_cache=False)
        bad = [f"{i}: {first_divergence(on_cpu.net, g, r['order'], on_cpu.max_deg)}"
               for i, (g, r, w) in enumerate(zip(graphs, got, want))
               if not (np.array_equal(r["order"], w["order"])
                       and np.array_equal(r["assignment"], w["assignment"]))]
        check(not bad, f"release, {label}: card and CPU differ:\n  " + "\n  ".join(bad))
    shutil.rmtree(out, ignore_errors=True)
    print(f"release trainer on {card}: {' '.join(RELEASE_ARGS)} in {t_rel:.2f} s (B1 "
          f"{ran['ptr_decode_cluster']} launches), sha256 verified, loaded on the card and the "
          f"CPU, the {len(table1)} Table-I and {len(synth)} synthetic schedules equal", flush=True)
    print(f"eval phase on {card}: {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------- #
# the LM zoo's serving path: zamba2-7b, kernels B3 (flash) and B4 (SSD)
# ---------------------------------------------------------------------- #
ZOO_ARCH = "zamba2-7b"
ZOO_PARAMS = 5_768_654_656     # count_params of the full config (the JAX package's count)
SERVE = ((2, 2048), (1, 1000))  # (batch, prompt tokens) of the served run; 1000: ragged
DECODE_STEPS = 16
PER_PREFILL = {"flash_fwd": 13, "ssd_scan": 68}   # 13 "A" sites, 13 x 5 + 3 "m" layers
# |got - want| <= atol + rtol * |want|.  A bf16 output of the kernel and of its
# plain version round float32 sums taken in another order, so they may differ
# by one bf16 step, 2^-7 = 7.8e-3 of the value (measured: one step, 1.95e-3 at
# most for flash and 0.25 at |y| >= 32 for the SSD scan, on an H100); rtol 8e-3
# holds exactly that one step at any magnitude, atol 4e-3 the values near 0.
TOL_BF16_OUT = (4e-3, 8e-3)
TOL_SSD_STATE = (1e-4, 1e-4)   # float32 state, sums in another order (measured <= 1.05e-5)
TOL_ZOO_F32 = 1e-4             # x max(1, |logits|): float32 logits through a full-width unit
                               # (measured 1.35e-5 at |logits| <= 4; a bf16 slip is ~1e-3)


def flash_work(b, hq, hkv, sq, sk, d, dv, itemsize) -> tuple[float, float]:
    """(bytes, flops) of a causal attention: q, k, v read once, o written
    once; the two products over the (query, key) pairs the mask keeps."""
    pairs = sq * (sk - sq + 1) + sq * (sq - 1) // 2
    flops = 2.0 * b * hq * pairs * (d + dv)
    return itemsize * b * (hq * sq * d + hkv * sk * (d + dv) + hq * sq * dv), flops


def ssd_work(bt, s, h, p, g, n, q, itemsize, in_scale: bool) -> tuple[float, float]:
    """(bytes, flops) of an SSD scan: x, B, C, dt (and in_scale) read once, y
    and the final state written once; per chunk the lower triangle of
    C B^T and of its product with x, and the two (N, P) state products."""
    chunks = -(-s // q)
    tri = q * (q + 1) // 2
    flops = 2.0 * bt * h * chunks * (tri * n + tri * p + 2 * q * n * p)
    nbytes = (itemsize * bt * s * (2 * h * p + 2 * g * n) + 4 * bt * s * h * (2 if in_scale else 1)
              + 4 * h + 4 * bt * h * n * p)
    return nbytes, flops


def device_split(label: str, card: str, fn) -> list[str]:
    """Profile one call of ``fn`` and print where its device time goes (the
    two zoo kernels, cuBLAS matmuls, everything else, and the largest of the
    rest), with the device's busy and idle share of the kernels' window.
    Returns the names of the device kernels it ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        print(f"{label} time split: the profiler saw no device time (not measured)", flush=True)
        return []
    split = {"flash (B3)": 0.0, "ssd scan (B4)": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    other: dict[str, float] = {}
    spans = []
    for e in kern:
        name, us = e.name, e.time_range.elapsed_us()
        low = name.lower()
        spans.append((e.time_range.start, e.time_range.end))
        key = ("flash (B3)" if "flash_fwd" in low else "ssd scan (B4)" if "ssd_scan" in low
               else "matmul (cuBLAS)" if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass",
                                                                "cublas", "matmul"))
               else "other")
        split[key] += us
        if key == "other":
            other[name[:60]] = other.get(name[:60], 0.0) + us
    busy, window = busy_window(spans)
    total = sum(split.values())
    top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
    print(f"{label} time split on {card} (torch.profiler, device time): "
          + ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
          + f"; {len(kern)} kernels, device busy {busy / 1e3:.2f} ms of a {window / 1e3:.2f} ms "
          f"window (idle {100 * (1 - busy / window):.1f}%), host {host * 1e3:.1f} ms profiled; "
          "largest other: " + ", ".join(f"{n} {v / 1e3:.2f} ms" for n, v in top), flush=True)
    return [e.name for e in kern]


def zoo_phase(card: str) -> list[dict]:
    import contextlib
    from unittest import mock

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash.ref import reference_attention
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked
    from repro_torch.models.model import build_model, count_params

    def plain_flash(q, k, v, *, causal=True, scale=None):
        return reference_attention(q, k, v, causal=causal, scale=scale)

    def plain_ssd(x, dt, A, B, C, *, chunk, in_scale=None):
        y, hf = ssd_chunked(x, dt, A, B, C, chunk=chunk, in_scale=in_scale)
        return y.to(x.dtype), hf

    @contextlib.contextmanager
    def plain_kernels():
        """The ops' plain versions in place of their CUDA launches (same
        padding and layout code around them), for comparison only."""
        with mock.patch.object(flash_ops, "flash_attention_cuda", plain_flash), \
                mock.patch.object(ssd_ops, "ssd_scan_cuda", plain_ssd):
            yield

    def wall(fn, reps: int) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    cfg = get_config(ZOO_ARCH)
    model = build_model(cfg)                                   # device: cuda
    check(count_params(model) == ZOO_PARAMS, f"{ZOO_ARCH}: parameter count differs")
    t0 = time.perf_counter()
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    print(f"zoo: {ZOO_ARCH} full config ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, {ZOO_PARAMS} parameters) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = {shape: torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).cuda()
               for shape in SERVE}

    # ---- the zoo's main path, counted: prefill then greedy decode ------- #
    for k in kbuild.LAUNCHES:
        kbuild.LAUNCHES[k] = 0
    for (b, s), tokens in prompts.items():
        before = dict(kbuild.LAUNCHES)
        logits, cache = model.prefill(params, {"tokens": tokens},
                                      max_len=s + DECODE_STEPS)
        torch.cuda.synchronize()
        mid = dict(kbuild.LAUNCHES)
        seq, tok = [logits], logits.argmax(-1)
        for t in range(DECODE_STEPS):
            logits, cache = model.decode_step(params, tok, cache, s + t)
            seq.append(logits)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        after = dict(kbuild.LAUNCHES)
        pre = {k: mid[k] - before[k] for k in PER_PREFILL}
        dec = {k: after[k] - mid[k] for k in PER_PREFILL}
        out = torch.cat(seq, dim=1).float()
        print(f"zoo served B={b} S={s}: prefill launches {pre}, {DECODE_STEPS} decode steps "
              f"launches {dec}; logits {tuple(out.shape)}", flush=True)
        check(pre == PER_PREFILL, f"prefill B={b} S={s}: launches {pre}, expected {PER_PREFILL}")
        check(not any(dec.values()), f"decode launched kernels {dec}")
        check(out.shape == (b, DECODE_STEPS + 1, cfg.vocab_size) and bool(torch.isfinite(out).all()),
              f"served B={b} S={s}: logits not finite or of the wrong shape")
        del cache, logits, seq
    launches = dict(kbuild.LAUNCHES)

    # ---- throughput, and where a prefill's device time goes ------------- #
    for (b, s), tokens in prompts.items():
        t_pre = wall(lambda: model.prefill(params, {"tokens": tokens}, max_len=s + DECODE_STEPS),
                     reps=3)
        logits, cache = model.prefill(params, {"tokens": tokens}, max_len=s + DECODE_STEPS)

        def decode(logits=logits, cache=cache):
            tok = logits.argmax(-1)
            for t in range(DECODE_STEPS):
                logits, _ = model.decode_step(params, tok, cache, s + t)
                tok = logits.argmax(-1)
        t_dec = wall(decode, reps=1)
        print(f"zoo serve B={b} S={s} on {card}: prefill {t_pre * 1e3:.1f} ms = "
              f"{b * s / t_pre:.0f} tokens/s (median of 3); decode {DECODE_STEPS} steps "
              f"{t_dec * 1e3:.1f} ms = {b * DECODE_STEPS / t_dec:.1f} tokens/s "
              f"({t_dec / DECODE_STEPS * 1e3:.2f} ms a step)", flush=True)
        del cache, logits
    b, s = SERVE[0]
    names = device_split(f"zoo prefill B={b} S={s}", card, lambda: model.prefill(
        params, {"tokens": prompts[(b, s)]}, max_len=s + DECODE_STEPS))
    if names:   # bf16 inputs run the tensor-core templates, and only those
        ran = {k: sum(k in n for n in names) for k in ("flash_fwd_bf16", "flash_fwd_f32",
                                                       "ssd_scan_bf16", "ssd_scan_f32")}
        print(f"zoo prefill B={b} S={s}: kernel templates launched {ran}", flush=True)
        check(ran == {"flash_fwd_bf16": PER_PREFILL["flash_fwd"], "flash_fwd_f32": 0,
                      "ssd_scan_bf16": PER_PREFILL["ssd_scan"], "ssd_scan_f32": 0},
              f"bf16 prefill ran {ran}, expected only the bf16 templates")
    logits, cache = model.prefill(params, {"tokens": prompts[(b, s)]}, max_len=s + DECODE_STEPS)
    device_split(f"zoo decode step B={b} kv_len={s}", card,
                 lambda: model.decode_step(params, logits.argmax(-1), cache, s))
    del cache, logits
    del params, prompts
    torch.cuda.empty_cache()

    # ---- each kernel against its plain version, at the path's shapes ---- #
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def within(got, want, tol):
        atol, rtol = tol
        got, want = got.float(), want.float()
        return bool(((got - want).abs() <= atol + rtol * want.abs()).all()), \
            float((got - want).abs().max())

    rows = []
    flash_err, flash_t = 0.0, None
    for label, b, hq, hkv, sq, sk, d, dv in (
            ("path", 2, 32, 32, 2048, 2048, 112, 112),
            ("GQA group 4, ragged", 1, 32, 8, 1000, 1000, 112, 112),
            ("Dv != D", 2, 32, 32, 1000, 1000, 112, 64),
            ("Sq < Sk", 2, 32, 32, 128, 2048, 112, 112)):
        # the path's layout: (B, S, H, D) activations viewed as (B, H, S, D)
        q = randn(b, sq, hq, d).transpose(1, 2)
        k = randn(b, sk, hkv, d).transpose(1, 2)
        v = randn(b, sk, hkv, dv).transpose(1, 2)
        got = flash_ops.flash_attention(q, k, v, causal=True)
        with plain_kernels():
            want = flash_ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        ok, err = within(got, want, TOL_BF16_OUT)
        check(ok, f"flash {label}: kernel and plain version differ (max |err| {err:.3e})")
        flash_err = max(flash_err, err)
        print(f"flash {label} B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} D={d} Dv={dv} bf16: "
              f"max |err| {err:.3e} (tolerance atol, rtol {TOL_BF16_OUT})", flush=True)
        if label == "path":
            ev_ms = cuda_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True), iters=10)
            dev_ms = device_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True),
                               "flash_fwd_bf16", iters=10)
            ms = reported_ms(ev_ms, dev_ms)
            with plain_kernels():
                plain_ms = cuda_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True),
                                   iters=3)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                             iters=10)
            b_ms, b_by = bound(*flash_work(b, hq, hkv, sq, sk, d, dv, 2), BF16_FLOPS_PER_S)
            flash_t = (ms, plain_ms, b_ms, b_by, lib_ms)
            print(f"flash_fwd path shape on {card}: kernel {ev_ms:.4f} ms (CUDA events; device "
                  f"{dev_ms:.4f} ms), plain {plain_ms:.3f} ms, "
                  f"scaled_dot_product_attention {lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
    rows.append({"name": "flash_fwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/flash/csrc/flash_fwd.cu",
                 "replaces": "src/repro/kernels/flash/kernel.py:43",
                 "launches": launches["flash_fwd"], "max_abs_err": flash_err, "ms": flash_t[0],
                 "plain_ms": flash_t[1], "bound_ms": flash_t[2], "bound_by": flash_t[3],
                 "library_ms": flash_t[4]})

    ssd_err, ssd_t = 0.0, None
    d_inner, nh, g, n, p, chunk = 7168, 112, 2, 64, 64, 64
    for label, bt, s, scaled in (("path", 2, 2048, False), ("in_scale != dt", 2, 2048, True),
                                 ("ragged", 1, 1000, False)):
        # the path's layout: x, B and C are views into the conv output
        xbc = randn(bt, s, d_inner + 2 * g * n)
        x = xbc[..., :d_inner].reshape(bt, s, nh, p)
        Bm = xbc[..., d_inner: d_inner + g * n].reshape(bt, s, g, n)
        Cm = xbc[..., d_inner + g * n:].reshape(bt, s, g, n)
        dt = F.softplus(torch.randn((bt, s, nh), generator=gen, device="cuda") * 0.5 - 2.0)
        A = torch.exp(0.2 * torch.randn((nh,), generator=gen, device="cuda"))
        sc = (torch.rand((bt, s, nh), generator=gen, device="cuda") if scaled else None)
        args = (x, dt, A, Bm, Cm)
        y, hf = ssd_ops.ssd_scan(*args, chunk=chunk, in_scale=sc)
        with plain_kernels():
            wy, wh = ssd_ops.ssd_scan(*args, chunk=chunk, in_scale=sc)
        torch.cuda.synchronize()
        ok_y, err_y = within(y, wy, TOL_BF16_OUT)
        ok_h, err_h = within(hf, wh, TOL_SSD_STATE)
        check(ok_y and ok_h, f"ssd {label}: kernel and plain version differ "
              f"(y {err_y:.3e}, state {err_h:.3e})")
        ssd_err = max(ssd_err, err_y, err_h)
        print(f"ssd {label} Bt={bt} S={s} H={nh} P={p} N={n} G={g} chunk {chunk} bf16: max |err| "
              f"y {err_y:.3e} (tolerance atol, rtol {TOL_BF16_OUT}), state {err_h:.3e} "
              f"(tolerance {TOL_SSD_STATE})", flush=True)
        if label == "path":
            ev_ms = cuda_ms(lambda: ssd_ops.ssd_scan(*args, chunk=chunk), iters=10)
            dev_ms = device_ms(lambda: ssd_ops.ssd_scan(*args, chunk=chunk), "ssd_scan_bf16",
                               iters=10)
            ms = reported_ms(ev_ms, dev_ms)
            with plain_kernels():
                plain_ms = cuda_ms(lambda: ssd_ops.ssd_scan(*args, chunk=chunk), iters=2)
            b_ms, b_by = bound(*ssd_work(bt, s, nh, p, g, n, chunk, 2, False), BF16_FLOPS_PER_S)
            ssd_t = (ms, plain_ms, b_ms, b_by)
            print(f"ssd_scan path shape on {card}: kernel {ev_ms:.4f} ms (CUDA events; device "
                  f"{dev_ms:.4f} ms), plain {plain_ms:.3f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    rows.append({"name": "ssd_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/ssd/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd/kernel.py:41",
                 "launches": launches["ssd_scan"], "max_abs_err": ssd_err, "ms": ssd_t[0],
                 "plain_ms": ssd_t[1], "bound_ms": ssd_t[2], "bound_by": ssd_t[3],
                 "library_ms": None})

    # ---- one full-width unit in float32: kernels against plain versions  #
    cfg6 = cfg.scaled(n_layers=6, dtype="float32")
    m6 = build_model(cfg6)
    p6 = m6.init_params(seed=1)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 1000))).cuda()
    before = dict(kbuild.LAUNCHES)
    got, _ = m6.prefill(p6, {"tokens": tokens})
    mid = dict(kbuild.LAUNCHES)
    with plain_kernels():
        want, _ = m6.prefill(p6, {"tokens": tokens})
    torch.cuda.synchronize()
    check(mid["flash_fwd"] - before["flash_fwd"] == 1 and mid["ssd_scan"] - before["ssd_scan"] == 5
          and kbuild.LAUNCHES == mid, "f32 unit: unexpected kernel launches")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(err <= TOL_ZOO_F32 * max(1.0, scale) and torch.equal(got.argmax(-1), want.argmax(-1)),
          f"f32 unit: kernel path and plain path differ (max |err| {err:.3e}, |logits| {scale:.3f})")
    print(f"zoo f32 unit ({cfg6.pattern()}, d_model {cfg.d_model}), B=1 S=1000: kernel path vs "
          f"plain path on the card, logits max |err| {err:.3e} (|logits| up to {scale:.3f}, "
          f"tolerance {TOL_ZOO_F32} x max(1, |logits|)), greedy tokens equal", flush=True)
    del m6, p6
    torch.cuda.empty_cache()
    return rows


def run() -> dict:
    import numpy as np
    import torch

    from repro_torch.core import (PipelineSystem, RespectScheduler, build_model_graph,
                                  sample_batch, validate_monotone)
    from repro_torch.core.batching import bucketize, pack_padded
    from repro_torch.core.segment import repair, rho_dp
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.decode import TEMPLATES, decode_batch, decode_batch_reference
    from repro_torch.kernels.ptr.kernel import pointer_step_cuda, step_cluster_size
    from repro_torch.kernels.ptr.ref import reference_pointer_step

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t_build = ops.build_kernels()
    print(f"build: all four kernels in {t_build:.2f} s (nvcc, sm_90a, in parallel)", flush=True)

    golden = json.loads(GOLDEN.read_text())
    seeded_gold = json.loads(SEEDED_GOLDEN.read_text())["seeded"]
    names = list(golden["models"])
    table1 = [build_model_graph(nm) for nm in names]
    synth = sample_batch(np.random.default_rng(0), 64, n=30)
    sched = RespectScheduler.from_release()            # device: cuda
    check(sched.device.type == "cuda", "scheduler is not on the card")
    check(sched.release is not None
          and sched.release["params_sha256"] == golden["meta"]["params_sha256"],
          "release did not load or is not the golden one")
    wide = RespectScheduler.init(seed=0)               # default width 256, seeded; cuda
    check(wide.hidden == 256, "RespectScheduler.init's default width is not 256")
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
    res_w = wide.schedule_many(synth, STAGES, use_cache=False)
    torch.cuda.synchronize()
    wide_launches = {k: ops.LAUNCHES[k] - uniform_launches[k] for k in ops.LAUNCHES}
    t0 = time.perf_counter()
    res_h = sched.schedule_many(hetero_graphs, STAGES, hsys, use_cache=False)
    torch.cuda.synchronize()
    t_hetero = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"main path: uniform {len(table1) + len(synth)} graphs {t_uniform:.3f} s "
          f"(first call), hetero {len(hetero_graphs)} graphs {t_hetero:.3f} s; "
          f"launches {launches}", flush=True)
    n_buckets = len(bucketize(table1 + synth))
    check(uniform_launches["ptr_decode_cluster"] == n_buckets
          and uniform_launches["ptr_decode_block"] == 0,
          f"respect-v1 uniform batch: B1 launches {uniform_launches}, expected "
          f"{n_buckets} ptr_decode_cluster (one a bucket) and no ptr_decode_block")
    check(wide_launches["ptr_decode_block"] == 1 and wide_launches["ptr_decode_cluster"] == 0,
          f"width-256 batch: B1 launches {wide_launches}, expected one ptr_decode_block")
    check(all(r["assignment"].shape == (g.n,) and validate_monotone(g, r["assignment"], STAGES)
              for g, r in zip(synth, res_w)), "width-256 batch: invalid schedule")
    bad = digest_misses(schedule_digests(res_w), seeded_gold["256"]["synthetic"])
    check(not bad, f"width-256 batch: graphs {bad} differ from the seeded golden file")
    hetero_steps = sum(bucketize(hetero_graphs))   # one B2 launch a step of each bucket
    check(launches["ptr_step"] == hetero_steps,
          f"heterogeneous batch: {launches['ptr_step']} ptr_step launches, expected "
          f"{hetero_steps} (the sum of its buckets' n)")

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

    def same_as_cpu(label, got, cpu_sched):
        want = cpu_sched.schedule_many(hetero_graphs, STAGES, hsys, use_cache=False)
        bad = [f"{i}: {first_divergence(cpu_sched.net, g, r['order'], D, hsys)}"
               for i, (g, r, rc) in enumerate(zip(hetero_graphs, got, want))
               if not (np.array_equal(r["order"], rc["order"])
                       and np.array_equal(r["assignment"], rc["assignment"]))]
        check(not bad, f"{label}: card and CPU plain path disagree:\n  " + "\n  ".join(bad))

    D = sched.max_deg
    same_as_cpu("heterogeneous batch", res_h, cpu)
    print(f"outputs: {len(synth)} synthetic and {len(hetero_graphs)} heterogeneous schedules "
          "equal the CPU plain path", flush=True)

    # widths the whole-decode kernel refuses: the heterogeneous batch at
    # hidden 96 and 640 runs the scan, B2 at every step, as on the CPU
    widths = {}
    for Hw in (96, 640):
        widths[Hw] = RespectScheduler.init(seed=0, hidden=Hw)
        before = ops.LAUNCHES["ptr_step"]
        got = widths[Hw].schedule_many(hetero_graphs, STAGES, hsys, use_cache=False)
        torch.cuda.synchronize()
        ran = ops.LAUNCHES["ptr_step"] - before
        check(ran == hetero_steps,
              f"hidden {Hw}: {ran} ptr_step launches, expected {hetero_steps}")
        same_as_cpu(f"heterogeneous batch at hidden {Hw}", got,
                    RespectScheduler.init(seed=0, hidden=Hw, device="cpu"))
        if str(Hw) in seeded_gold:
            bad = digest_misses(schedule_digests(got), seeded_gold[str(Hw)]["hetero"])
            check(not bad, f"hidden {Hw}: graphs {bad} differ from the seeded golden file")
        print(f"hidden {Hw}: the heterogeneous batch ran {ran} ptr_step launches and its "
              f"{len(hetero_graphs)} schedules equal the CPU plain path", flush=True)

    # ---- the seeded and sampled path (its own counted run) ------------ #
    seeded_phase(card, sched, {256: wide, 96: widths[96]}, table1, names, synth,
                 hetero_graphs, hsys)

    # ---- the serving front end (its own counted runs) ----------------- #
    service_phase(card, golden, names, table1, synth, hetero_graphs, hsys, res, res_h, cpu)

    # ---- the RL training engine (its own counted run) ----------------- #
    train_phase(card)

    # ---- the gap-to-optimal eval and the release trainer (counted) ----- #
    eval_phase(card, table1, synth)

    # ---- kernels against their plain versions, at the path's shapes --- #
    net = sched.net
    by_bucket = bucketize(table1)
    big = [table1[i] for i in by_bucket[1024]][-4:]
    kernels = []
    gen = torch.Generator(device="cuda").manual_seed(0)

    def encoded(graphs, dnet=net):
        batch = pack_padded(graphs, max_deg=D).to("cuda")
        with torch.inference_mode():
            C, (h0, c0), emb = dnet.encode(batch.feats, batch.n_valid)
        return batch, C, h0, c0, emb

    def decode_case(label, dnet, graphs, template):
        """Holds B1 to its plain version on the card (greedy and sampled,
        orders equal, logp/entropy within TOL_LOGP), checks that the batch
        ran ``template``, and times kernel and plain version."""
        batch, C, h0, c0, emb = encoded(graphs, dnet)
        B, n, Hd = batch.n_valid.shape[0], batch.bucket_n, dnet.hidden
        args = (dnet, C, emb, h0, c0, batch.parent_mat, batch.n_valid)
        unif = torch.rand((B, n), generator=gen, device="cuda")
        before = dict(ops.LAUNCHES)
        with torch.inference_mode():
            k_out = decode_batch(*args)
            p_out = decode_batch_reference(*args)
            k_smp = decode_batch(*args, unif)
            p_smp = decode_batch_reference(*args, unif)
        torch.cuda.synchronize()
        ran = {t: ops.LAUNCHES[t] - before[t] for t in TEMPLATES.values()}
        check(ran == {t: 2 * (t == template) for t in ran},
              f"ptr_decode {label} H={Hd}: launched {ran}, expected two {template}")
        valid = torch.arange(n, device="cuda")[None, :] < batch.n_valid[:, None].long()
        err = 0.0
        for what, (ko, kl, ke), (po, pl_, pe) in (("greedy", k_out, p_out),
                                                  ("sampled", k_smp, p_smp)):
            check(torch.equal(torch.where(valid, ko, -1), torch.where(valid, po, -1)),
                  f"ptr_decode {label} H={Hd} {what}: orders differ from the plain version")
            e = max(float((kl - pl_).abs().max()), float((ke - pe).abs().max()))
            check(e <= TOL_LOGP, f"ptr_decode {label} H={Hd} {what}: logp/entropy error {e:.3e}")
            err = max(err, e)
        with torch.inference_mode():
            ev_ms = cuda_ms(lambda: decode_batch(*args), iters=5)
            dev_ms = device_ms(lambda: decode_batch(*args), template, iters=5)
            ms = reported_ms(ev_ms, dev_ms)
            refs_ms = cuda_ms(lambda: ops.precompute_refs(dnet, C), iters=20)
            plain_ms = cuda_ms(lambda: decode_batch_reference(*args), iters=2)
        b_ms, b_by = bound(*decode_work(graphs, k_out[0].cpu().numpy(), n, Hd, D))
        print(f"ptr_decode {label} H={Hd} ({template}) on {card}: kernel {ev_ms:.4f} ms (CUDA "
              f"events; device {dev_ms:.4f} ms; the wrapper's two C @ W_ref products alone "
              f"{refs_ms:.4f} ms), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"orders equal greedy and sampled, max |err| logp/ent {err:.2e} "
              f"(tolerance {TOL_LOGP})", flush=True)
        return {"name": template, "route": "cuda",
                "source": "src/repro_torch/kernels/ptr/csrc/ptr_decode.cu",
                "replaces": "src/repro/kernels/ptr/decode.py:84",
                "launches": launches[template], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    # the release's width: the cluster template at both buckets
    kernels.append(decode_case("bucket 1024, B=4", net, big, "ptr_decode_cluster"))
    decode_case("bucket 32, B=64", net, synth, "ptr_decode_cluster")
    # RespectScheduler.init's default width, 256: the block template
    kernels.append(decode_case("bucket 32, B=64", wide.net, synth, "ptr_decode_block"))

    # single step at bucket 1024, B=4, a seeded half-dense mask: the release's
    # width, then the same graphs and mask at hidden 96 and 640
    packed = pack_padded(big, max_deg=D)
    B, n = packed.batch, packed.bucket_n
    valid = torch.arange(n, device="cuda")[None, :] < packed.n_valid.to("cuda")[:, None].long()
    mask = (torch.rand((B, n), generator=gen, device="cuda") < 0.5) & valid

    def half_dense(dnet):
        """Holds B2 to its plain version at the half-dense mask and times
        both; returns (max |err|, ms, plain ms, bound ms, bound by)."""
        _, C, h0, _, _ = encoded(big, dnet)
        Hd = dnet.hidden
        with torch.inference_mode():
            CWg, CWp = ops.precompute_refs(dnet, C)
            g, p = dnet.glimpse, dnet.pointer
            step_args = (C, CWg, CWp, h0, g.w_q, g.v, p.w_q, p.v, mask)
            same, err, rel = compare_logits(pointer_step_cuda(*step_args),
                                            reference_pointer_step(*step_args), mask)
            check(same and rel <= TOL_LOGITS, f"ptr_step bucket 1024, B=4, H={Hd}: masked logits "
                  f"equal: {same}; logits error {err:.3e}, relative {rel:.3e}")
            ev_ms = cuda_ms(lambda: pointer_step_cuda(*step_args), iters=50, warmup=3)
            dev_ms = device_ms(lambda: pointer_step_cuda(*step_args), "ptr_step", iters=50)
            plain_ms = cuda_ms(lambda: reference_pointer_step(*step_args), iters=50, warmup=3)
        b_ms, b_by = bound(*step_work(mask, Hd))
        print(f"ptr_step bucket 1024, B=4, {int(mask.sum())} selectable rows, H={Hd}, clusters of "
              f"{step_cluster_size(n)} blocks on {card}: kernel {ev_ms:.4f} ms (CUDA events around "
              f"50 calls, the host's enqueue included), device {dev_ms:.5f} ms (profiler), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), max |err| {err:.2e}, relative "
              f"{rel:.2e} (tolerance {TOL_LOGITS}), masked logits equal", flush=True)
        return err, reported_ms(ev_ms, dev_ms), plain_ms, b_ms, b_by

    err, ms, plain_ms, b_ms, b_by = half_dense(net)
    step_row = {
        "name": "ptr_step", "route": "cuda",
        "source": "src/repro_torch/kernels/ptr/csrc/ptr_step.cu",
        "replaces": "src/repro/kernels/ptr/kernel.py:42",
        "launches": launches["ptr_step"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    kernels.append(step_row)
    for Hw in (96, 640):
        half_dense(widths[Hw].net)
    del widths

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
    del net, wide
    kernels += zoo_phase(card)

    # ---- the heterogeneous batch: B2 at the path's own masks, time split  #
    # after the zoo, with the other profiles of whole batches (see below)
    net = sched.net
    recs = record_scan(net, hetero_graphs, hsys, D)
    check(sum(len(rec["steps"]) for rec in recs) == hetero_steps,
          f"recorded {[len(rec['steps']) for rec in recs]} steps, expected {hetero_steps}")
    dev_total = bound_total = 0.0
    for rec in recs:
        bn = rec["bucket_n"]
        with torch.inference_mode():
            got = replay(net, rec, pointer_step_cuda)
            want = replay(net, rec, reference_pointer_step)
        torch.cuda.synchronize()
        err = rel = 0.0
        for t, ((_, m_t), k_log, p_log) in enumerate(zip(rec["steps"], got, want)):
            same, e, rl = compare_logits(k_log, p_log, m_t)
            check(same and rl <= TOL_LOGITS, f"ptr_step heterogeneous bucket {bn}, step {t}: "
                  f"masked logits equal: {same}; logits error {e:.3e}, relative {rl:.3e}")
            err, rel = max(err, e), max(rel, rl)
        step_row["max_abs_err"] = max(step_row["max_abs_err"], err)
        dev = replay_device_ms(net, rec, pointer_step_cuda, "ptr_step")
        with torch.inference_mode():
            plain_ms = cuda_ms(lambda: replay(net, rec, reference_pointer_step), iters=1)
        b_ms, b_by = steps_bound(net, rec)
        dev_total, bound_total = dev_total + sum(dev), bound_total + b_ms
        sizes = [int(m_t.sum()) for _, m_t in rec["steps"]]
        print(f"ptr_step heterogeneous batch, bucket {bn} (B={rec['B']}, {len(dev)} launches, "
              f"clusters of {step_cluster_size(bn)} blocks; selectable rows a launch "
              f"{min(sizes)}-{max(sizes)}, median {statistics.median(sizes)}) on {card}: device "
              f"{sum(dev):.4f} ms a batch, {statistics.median(dev):.5f} ms a launch (median), "
              f"plain {plain_ms:.3f} ms a batch, bound {b_ms:.5f} ms a batch ({b_by}); every step "
              f"held to the plain version: masked logits equal, max |err| {err:.2e}, relative "
              f"{rel:.2e} (tolerance {TOL_LOGITS})", flush=True)
    print(f"ptr_step heterogeneous batch on {card}: {hetero_steps} launches, device "
          f"{dev_total:.4f} ms, bound {bound_total:.5f} ms", flush=True)
    res = scan_split(net, hetero_graphs, hsys, D, ops.make_logits_fn, "ptr_step", hetero_steps)
    print(split_line(f"heterogeneous batch ({len(hetero_graphs)} graphs, scan + B2)", card, res),
          flush=True)
    check(res["step_names"] == ["ptr_step_cluster"],
          f"heterogeneous scan ran single-step kernels {res['step_names']}, expected only "
          "ptr_step_cluster")

    # ---- which B1 template the respect-v1 path ran, by kernel name ----- #
    # last: after a profile of a whole batch (the encoder's thousands of
    # launches), the zoo's timing windows lost their first kernels
    before = dict(ops.LAUNCHES)
    names_run = kernel_names(lambda: sched.schedule_many(table1 + synth, STAGES, use_cache=False))
    counted = {t: ops.LAUNCHES[t] - before[t] for t in TEMPLATES.values()}
    ran = {t: sum(t in nm for nm in names_run) for t in TEMPLATES.values()}
    print(f"respect-v1 path, {n_buckets} buckets: B1 kernels by profiler name {ran}, "
          f"counted {counted}", flush=True)
    check(ran == counted == {"ptr_decode_cluster": n_buckets, "ptr_decode_block": 0},
          f"respect-v1 path ran B1 templates {ran} (counted {counted}), expected only "
          f"{n_buckets} ptr_decode_cluster")
    del sched
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
    if not ((ROOT / "src" / "repro_torch").is_dir() and GOLDEN.exists()
            and SEEDED_GOLDEN.exists() and TRAIN_GOLDEN.exists() and EVAL_BENCH.exists()):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    try:
        out = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": out["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": out["device"],
                                             "count": out["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
