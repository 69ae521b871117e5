"""Heuristic scheduler baselines (host numpy); a copy of the reference's
``repro.core.heuristic``.

:func:`compiler_partition` emulates the Edge TPU compiler's pipeline
partitioner: greedy contiguous cuts that balance **parameter bytes** and
ignore compute and the activations crossing each boundary.
:func:`list_schedule` is the classic list-scheduling baseline: topological
greedy filling against a compute-balance target.
:func:`heuristic_schedule_many` is the serving ladder's last rung.
"""

from __future__ import annotations

import numpy as np

from .costmodel import PipelineSystem
from .graph import CompGraph

__all__ = ["compiler_partition", "list_schedule", "heuristic_schedule_many"]


def compiler_partition(
    graph: CompGraph,
    n_stages: int,
    system: PipelineSystem | None = None,
    order: np.ndarray | None = None,
) -> np.ndarray:
    """Greedy contiguous cuts that equalize per-segment parameter bytes
    (the Edge TPU compiler emulation).  Deterministic."""
    n = graph.n
    order = np.arange(n) if order is None else np.asarray(order)
    total = float(graph.param_bytes.sum())
    target = total / n_stages
    assign_pos = np.zeros(n, dtype=np.int64)
    acc = 0.0
    stage = 0
    for p in range(n):
        node = order[p]
        # never strand later stages without nodes; the p > 0 guard keeps
        # stage 0 non-empty, so graphs with n < n_stages simply leave the
        # trailing stages empty (still a valid assignment).
        must_cut = (n - p) <= (n_stages - 1 - stage)
        if stage < n_stages - 1 and (acc >= target or must_cut) and p > 0:
            stage += 1
            acc = 0.0
        assign_pos[p] = stage
        acc += float(graph.param_bytes[node])
    assign = np.empty(n, dtype=np.int64)
    assign[order] = assign_pos
    return assign


def list_schedule(
    graph: CompGraph,
    n_stages: int,
    system: PipelineSystem | None = None,
) -> np.ndarray:
    """List scheduling: walk nodes in topological order, filling stage after
    stage against a compute-balance target (flops/k)."""
    n = graph.n
    target = float(graph.flops.sum()) / n_stages
    assign = np.zeros(n, dtype=np.int64)
    acc = 0.0
    stage = 0
    for v in range(n):
        lo = max((assign[u] for u in graph.parents[v]), default=0)
        if stage < lo:
            stage, acc = lo, 0.0
        must_cut = (n - v) <= (n_stages - 1 - stage)
        if stage < n_stages - 1 and (acc >= target or must_cut) and v > 0:
            stage += 1
            acc = 0.0
        assign[v] = stage
        acc += float(graph.flops[v])
    return assign


def heuristic_schedule_many(
    graphs: list[CompGraph],
    n_stages: int,
    system: PipelineSystem | None = None,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Last-rung serving entry point: ``(order, assignment)`` per graph via
    :func:`list_schedule` on the node order itself.

    This is the degradation ladder's floor
    (:mod:`repro_torch.serving.degrade`): pure host numpy, no device dispatch, no
    compile, no shared mutable state — it cannot time out, cannot be hit
    by the fault-injection seam (which wraps the *scheduler*), and its
    per-graph loop gives per-request isolation for free.  Output is
    dependency-monotone by construction (``list_schedule`` never places a
    node before its parents' stage).
    """
    out = []
    for g in graphs:
        assign = list_schedule(g, n_stages, system)
        out.append((np.arange(g.n, dtype=np.int64), assign.astype(np.int64)))
    return out
