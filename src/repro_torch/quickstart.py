"""Quickstart: schedule ResNet50 onto a 4-stage pipelined Edge TPU system —
the port's twin of ``examples/quickstart.py``.

Runs the full Fig. 1a flow — graph extraction, embedding, pointer-network
decode (B1 on the card), rho, post-inference repair — beside the exact
solver and the commercial-compiler emulation, and reports each schedule's
simulated on-chip inference runtime on the Coral cost model and RESPECT's
per-stage parameter placement.

The agent is ``--agent`` (default ``artifacts/respect_agent.npz``) if that
exists, else ``RespectScheduler.init(seed=0)`` (the reference's weights bit
for bit).  :func:`quickstart` returns the rows as data; ``main`` prints them
as the reference does.

    python -m repro_torch.quickstart [--model ResNet50] [--stages 4] [--device cpu]

Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import time

from .core import (EDGETPU, build_model_graph, compiler_partition, evaluate_schedule, exact_dp,
                   validate_monotone)
from .device import resolve_device
from .edge_pipeline_deploy import AGENT, assignment_sha256, load_agent

__all__ = ["quickstart", "print_quickstart", "main"]


def quickstart(sched, model: str = "ResNet50", stages: int = 4) -> dict:
    """The three schedulers on ``model`` at ``stages``: the graph's
    (|V|, in-degree, depth, parameter bytes), per scheduler its solve time
    (host clock), assignment sha256, ``bottleneck_s`` and speedup over the
    compiler and whether it is monotone, and RESPECT's per-stage ops, parameter bytes and whether a
    stage spills its 8 MiB on-chip cache."""
    g = build_model_graph(model)
    sys_ = EDGETPU.with_stages(stages)

    t0 = time.perf_counter()
    res = sched.schedule(g, stages, sys_, return_timing=True)
    t_rl = time.perf_counter() - t0
    if not validate_monotone(g, res.assignment, stages):
        raise RuntimeError(f"{model} k={stages}: RESPECT's schedule is not monotone")
    ev_rl = evaluate_schedule(g, res.assignment, sys_)

    t0 = time.perf_counter()
    a_exact, _ = exact_dp(g, stages, sys_)
    t_exact = time.perf_counter() - t0
    ev_exact = evaluate_schedule(g, a_exact, sys_)

    t0 = time.perf_counter()
    a_comp = compiler_partition(g, stages, sys_)
    t_comp = time.perf_counter() - t0
    ev_comp = evaluate_schedule(g, a_comp, sys_)

    base = ev_comp.bottleneck_s
    rows = [{"scheduler": name, "solve_s": t, "assign_sha256": assignment_sha256(a),
             "bottleneck_s": float(ev.bottleneck_s), "vs_compiler": base / ev.bottleneck_s,
             "monotone": bool(validate_monotone(g, a, stages))}
            for name, t, a, ev in (("compiler", t_comp, a_comp, ev_comp),
                                   ("exact", t_exact, a_exact, ev_exact),
                                   ("RESPECT", t_rl, res.assignment, ev_rl))]
    placement = [{"stage": s, "ops": int((res.assignment == s).sum()),
                  "param_bytes": float(ev_rl.stage_params[s]),
                  "over_cache": bool(ev_rl.off_cache_bytes[s] > 0)} for s in range(stages)]
    return {"model": model, "stages": stages, "n": g.n, "max_in_degree": g.max_in_degree,
            "depth": g.depth, "param_bytes": float(g.param_bytes.sum()), "rows": rows,
            "placement": placement}


def print_quickstart(out: dict) -> None:
    print(f"\n{'scheduler':12s} {'solve (ms)':>10s} {'runtime (ms)':>13s} {'vs compiler':>12s}")
    for r in out["rows"]:
        print(f"{r['scheduler']:12s} {r['solve_s'] * 1e3:10.2f} {r['bottleneck_s'] * 1e3:13.3f} "
              f"{r['vs_compiler']:11.2f}x")
    print("\nper-stage parameter placement (RESPECT):")
    for p in out["placement"]:
        flag = " (over 8 MiB SRAM!)" if p["over_cache"] else ""
        print(f"  stage {p['stage']}: {p['ops']:4d} ops, {p['param_bytes'] / 2**20:6.2f} MiB "
              f"params{flag}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.quickstart")
    ap.add_argument("--model", default="ResNet50")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--agent", default=AGENT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    sched, trained = load_agent(args.agent, resolve_device(args.device))
    out = quickstart(sched, args.model, args.stages)
    print(f"model {args.model}: |V|={out['n']} deg={out['max_in_degree']} depth={out['depth']} "
          f"params={out['param_bytes'] / 2**20:.1f} MiB")
    print(f"[agent] loaded {args.agent}" if trained else
          "[agent] untrained weights (run python -m repro_torch.train_respect for the "
          "trained agent)")
    print_quickstart(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
