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
   heterogeneous results to the plain PyTorch path on the CPU;
5. holds each kernel (B1's two templates apart) to its plain PyTorch
   version on the card at the main path's shapes, times both with CUDA
   events (and, for each kernel, its device time from the profiler's kernel
   durations: a kernel under 0.2 ms is reported by that time, which leaves
   out the host's enqueue), computes each kernel's bound and the end-to-end
   cold-miss rate;
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
9. checks from the profiler's kernel names that every B1 launch of the
   respect-v1 path (one a bucket) ran the cluster template.

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


def kernel_names(fn) -> list[str]:
    """The names of the device kernels one profiled call of ``fn`` ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


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
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for st, en in spans[1:]:
        if st > cur_e:
            busy, cur_s = busy + cur_e - cur_s, st
        cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
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
    from repro_torch.kernels.ptr.kernel import pointer_step_cuda
    from repro_torch.kernels.ptr.ref import reference_pointer_step

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t_build = ops.build_kernels()
    print(f"build: all four kernels in {t_build:.2f} s (nvcc, sm_90a, in parallel)", flush=True)

    golden = json.loads(GOLDEN.read_text())
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
        ev_ms = cuda_ms(lambda: pointer_step_cuda(*step_args), iters=50, warmup=3)
        dev_ms = device_ms(lambda: pointer_step_cuda(*step_args), "ptr_step", iters=50)
        ms = reported_ms(ev_ms, dev_ms)
        plain_ms = cuda_ms(lambda: reference_pointer_step(*step_args), iters=50, warmup=3)
    m_rows = int(sel.sum())
    nbytes = 4 * (3 * m_rows * H + B * n + B * H + 2 * H * H + 2 * H + B * n)
    flops = B * 2 * 2 * H * H + m_rows * (3 * H * 2 + 2 * H + 8)
    b_ms, b_by = bound(nbytes, flops)
    print(f"ptr_step bucket 1024, B=4, {m_rows} selectable rows, H={H} on {card}: kernel "
          f"{ev_ms:.4f} ms (CUDA events around 50 calls, the host's enqueue included), device "
          f"{dev_ms:.5f} ms (profiler), plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
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
    del net, wide
    kernels += zoo_phase(card)

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
