"""RESPECT partitions a pod-scale LM across pipeline stages, then the cut runs:
the port's twin of ``examples/pipeline_partition_demo.py``.

Builds the block-level CompGraph of an architecture at a ``SHAPES`` cell,
partitions it with the compiler emulation, the list scheduler, the exact DP
and RESPECT (B1 on the card) onto a ``PodSystem`` ring, and prints each stage
map with its bottleneck and the speedups over the compiler.  Then it executes
a cut on :class:`~repro_torch.parallel.pipeline.PipelineRunner` and holds the
pipelined forward to the sequential one:

* by default the reference's reduced execution: the arch's SMOKE config (a
  hybrid falls back to internlm2-1.8b's) cut to 8 layers, partitioned by the
  exact DP at ``train_4k``, 4 microbatches of 2 x 16 tokens in bf16;
* ``--full``: the full config at full width in bf16 with seeded random
  weights, cut by the winning partition of the table (the smallest
  bottleneck; respect on a tie), 4 microbatches of 1 x 2048 tokens.

A cut that leaves a stage empty falls back to an even split, as the
reference's demo does.

    python -m repro_torch.pipeline_demo --arch qwen3-32b
    python -m repro_torch.pipeline_demo --arch qwen3-14b --full

Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .configs import SHAPES, get_config, get_smoke_config
from .core.costmodel import PodSystem
from .core.partitioner import partition_model, stage_assignment_to_layers
from .core.respect import RespectScheduler
from .device import resolve_device
from .parallel.pipeline import PipelineRunner

__all__ = ["METHODS", "partition_table", "winning_stages", "layer_stages", "run_cut", "main"]

METHODS = ("compiler", "list", "exact", "respect")
N_MICRO = 4
#: (microbatch, tokens) of the reduced execution and of --full
REDUCED_MB, FULL_MB = (2, 16), (1, 2048)


def partition_table(cfg, shape, n_stages: int, scheduler, mesh_slice: int = 64) -> list[tuple]:
    """``(method, assignment, ScheduleEval)`` of each of :data:`METHODS` on
    ``cfg``'s block graph at ``shape``, on a ``PodSystem`` of ``n_stages``."""
    rows = []
    for method in METHODS:
        assign, ev, _ = partition_model(cfg, shape, n_stages, method=method,
                                        scheduler=scheduler if method == "respect" else None,
                                        mesh_slice=mesh_slice, system=PodSystem(n_stages))
        rows.append((method, assign, ev))
    return rows


def layer_stages(cfg, assign, n_stages: int) -> list[list[int]]:
    """Per-stage layer lists of a graph assignment; an even split where the
    cut leaves a stage empty (the runner needs a block in every stage)."""
    stages = stage_assignment_to_layers(cfg, assign)
    if len(stages) != n_stages or any(len(s) == 0 for s in stages):
        stages = [list(map(int, r)) for r in np.array_split(np.arange(cfg.n_layers), n_stages)]
    return stages


def winning_stages(cfg, rows, n_stages: int) -> tuple[str, list[list[int]]]:
    """The method with the smallest bottleneck (respect on a tie) and its
    per-stage layer lists."""
    best = min(rows, key=lambda r: (r[2].bottleneck_s, r[0] != "respect"))
    return best[0], layer_stages(cfg, best[1], n_stages)


def print_table(rows, n_stages: int) -> None:
    for method, assign, ev in rows:
        sizes = [int((np.asarray(assign) == s).sum()) for s in range(n_stages)]
        print(f"{method:9s} bottleneck={ev.bottleneck_s * 1e3:8.2f} ms  stage sizes={sizes}  "
              f"stage params GB={[round(float(p) / 1e9, 1) for p in ev.stage_params]}",
              flush=True)
    base = rows[0][2].bottleneck_s
    for method, _, ev in rows[1:]:
        print(f"  {method} speedup over compiler: {base / ev.bottleneck_s:.2f}x", flush=True)


def run_cut(cfg, stages, n_micro: int, x: torch.Tensor, *, seed: int = 0, device=None):
    """Run ``x`` (n_micro, B_mb, S, d) through ``cfg``'s blocks cut into
    ``stages`` with seeded weights on ``device``: ``(runner, params,
    pipelined output, sequential output, pipelined seconds, sequential
    seconds)``, forward only."""
    dev = resolve_device(device)
    runner = PipelineRunner(cfg, stages, n_micro=n_micro, remat=False,
                            devices=[dev] * len(stages))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = runner.init_params(gen)

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            y = fn(params, x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return y, time.perf_counter() - t0

    y_pipe, t_pipe = timed(runner.forward)
    y_seq, t_seq = timed(runner.sequential_forward)
    return runner, params, y_pipe, y_seq, t_pipe, t_seq


def _scheduler(agent: Path, device) -> RespectScheduler:
    if agent.exists():
        return RespectScheduler.load(agent, device=device)
    return RespectScheduler.init(seed=0, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.pipeline_demo")
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--agent", default="artifacts/respect_agent",
                    help="scheduler checkpoint (train_respect's --out); seed 0 without one")
    ap.add_argument("--full", action="store_true",
                    help="run the winning cut of the full config at full width")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    sched = _scheduler(Path(args.agent), device)
    print(f"== partitioning {args.arch} @ {shape.name} into {args.stages} stages "
          "(PodSystem) ==", flush=True)
    rows = partition_table(cfg, shape, args.stages, sched)
    print_table(rows, args.stages)

    if args.full:
        if cfg.block_pattern is not None:
            raise SystemExit(f"{args.arch}: the pipeline runner takes uniform attention "
                             "patterns only")
        method, stages = winning_stages(cfg, rows, args.stages)
        (b_mb, seq), run_cfg = FULL_MB, cfg
        print(f"\n== executing the {method} cut of the full config, stage sizes "
              f"{[len(s) for s in stages]}, {N_MICRO} microbatches of {b_mb} x {seq} ==",
              flush=True)
    else:
        run_cfg = get_smoke_config(args.arch)
        if run_cfg.block_pattern is not None:
            print("(hybrid pattern: pipeline runner demo uses the dense path)")
            run_cfg = get_smoke_config("internlm2-1.8b")
        run_cfg = run_cfg.scaled(n_layers=8)
        assign, _, _ = partition_model(run_cfg, SHAPES["train_4k"], args.stages, method="exact")
        stages = layer_stages(run_cfg, assign, args.stages)
        b_mb, seq = REDUCED_MB
        print(f"\n== executing the reduced config, stage sizes {[len(s) for s in stages]}, "
              f"{N_MICRO} microbatches of {b_mb} x {seq} ==", flush=True)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((N_MICRO, b_mb, seq, run_cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    runner, _, y_pipe, y_seq, t_pipe, t_seq = run_cut(run_cfg, stages, N_MICRO, x,
                                                      device=device)
    err = float((y_pipe.float() - y_seq.float()).abs().max())
    print(f"pipelined vs sequential max |err| = {err:.2e}  "
          f"({'OK' if err < 1e-3 else 'MISMATCH'}); pipelined {t_pipe * 1e3:.1f} ms, "
          f"sequential {t_seq * 1e3:.1f} ms, bubble share {runner.bubble_fraction:.3f} "
          f"({runner.ticks} ticks)", flush=True)
    return 0 if err < 1e-3 else 1


if __name__ == "__main__":
    raise SystemExit(main())
