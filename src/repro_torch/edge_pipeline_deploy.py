"""Deployment-flow simulation for all ten ImageNet models (paper §IV): the
port's twin of ``examples/edge_pipeline_deploy.py``.

For every Table-I model and every pipeline depth in {4, 5, 6}: schedule with
the commercial-compiler emulation, the exact solver and RESPECT (the pointer
network's decode on the card: B1, one graph a launch, in its wide template
at the default hidden 256); check that RESPECT's schedule is deployable (monotone,
repaired); and simulate each schedule's steady-state pipeline throughput on
the Coral cost model (``EDGETPU``).

The agent is ``--agent`` (default ``artifacts/respect_agent.npz``, the
reference's path) if that exists, else ``RespectScheduler.init(seed=0)``,
whose weights are the reference's bit for bit.  :func:`deploy_table` returns
the rows as data (each method's assignment sha256, its ``bottleneck_s`` and
its monotone flag); ``main`` prints them as the reference does.

    python -m repro_torch.edge_pipeline_deploy [--agent PATH] [--device cpu]

Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import hashlib
from pathlib import Path

import numpy as np

from .core import (EDGETPU, MODEL_SPECS, RespectScheduler, build_model_graph,
                   compiler_partition, evaluate_schedule, exact_dp, validate_monotone)
from .device import resolve_device

__all__ = ["AGENT", "DEPTHS", "METHODS", "load_agent", "assignment_sha256", "deploy_row",
           "deploy_table", "print_table", "main"]

AGENT = "artifacts/respect_agent.npz"
DEPTHS = (4, 5, 6)
METHODS = ("compiler", "exact", "respect")


def load_agent(path, device) -> tuple[RespectScheduler, bool]:
    """(scheduler, trained): the checkpoint at ``path`` if it exists, else
    the seeded untrained agent of the default width."""
    path = Path(path)
    if path.exists():
        return RespectScheduler.load(path, device=device), True
    return RespectScheduler.init(seed=0, device=device), False


def assignment_sha256(a) -> str:
    return hashlib.sha256(np.asarray(a, dtype=np.int64).tobytes()).hexdigest()


def _record(g, a, k: int, ev) -> dict:
    return {"assign_sha256": assignment_sha256(a), "bottleneck_s": float(ev.bottleneck_s),
            "monotone": bool(validate_monotone(g, a, k))}


def deploy_row(sched: RespectScheduler, name: str, g, k: int) -> dict:
    """One (model, depth) of the loop: each method's record and RESPECT's
    speedup over the compiler emulation.  A RESPECT schedule that is not
    monotone raises, as the reference's assertion does."""
    sys_ = EDGETPU.with_stages(k)
    a_c = compiler_partition(g, k, sys_)
    a_e, _ = exact_dp(g, k, sys_)
    res = sched.schedule(g, k, sys_)
    if not validate_monotone(g, res.assignment, k):
        raise RuntimeError(f"{name} k={k}: RESPECT's schedule is not monotone")
    row = {"model": name, "k": k, "n": g.n}
    for method, a in zip(METHODS, (a_c, a_e, res.assignment)):
        row[method] = _record(g, a, k, evaluate_schedule(g, a, sys_))
    row["speedup"] = row["compiler"]["bottleneck_s"] / row["respect"]["bottleneck_s"]
    return row


def deploy_table(sched: RespectScheduler, models=None, depths=DEPTHS) -> list[dict]:
    """The §IV loop over ``models`` (default: all ten Table-I models) and
    ``depths``, one :func:`deploy_row` each, in the reference's order."""
    rows = []
    for name in models or MODEL_SPECS:
        g = build_model_graph(name)
        rows += [deploy_row(sched, name, g, k) for k in depths]
    return rows


def print_table(rows: list[dict]) -> None:
    print(f"{'model':20s} {'k':>2s} {'compiler':>9s} {'exact':>9s} "
          f"{'RESPECT':>9s} {'RL-speedup':>10s}")
    for r in rows:
        c, e, p = (r[m]["bottleneck_s"] * 1e3 for m in METHODS)
        print(f"{r['model']:20s} {r['k']:2d} {c:8.3f}m {e:8.3f}m {p:8.3f}m {r['speedup']:9.2f}x")
    speedups = [r["speedup"] for r in rows]
    print(f"\nmean RESPECT speedup over compiler emulation: "
          f"{np.mean(speedups):.2f}x (max {np.max(speedups):.2f}x)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.edge_pipeline_deploy")
    ap.add_argument("--agent", default=AGENT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    sched, trained = load_agent(args.agent, resolve_device(args.device))
    print(f"agent: {'trained' if trained else 'untrained'}\n")
    print_table(deploy_table(sched))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
