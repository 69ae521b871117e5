"""Post-inference processing (paper §III-B, last paragraph).

The raw RL output need not satisfy the Edge TPU deployment rules.  The paper
applies a deterministic repair at deployment time:

1. **dependency repair** — "corrects the dependency violation by simply
   pushing the involved node forward": in topological order, raise each
   node's stage to at least the maximum of its parents' stages;
2. **co-consumer rule** — "Edge TPU hardware requires children nodes of any
   node to be in the same pipeline, where the post-inference procedure
   assigns these nodes to the earliest predicted stage": a tensor leaving a
   segment is routed to exactly one next segment, so all consumers of a
   multi-consumer tensor are pulled to the earliest consumer stage that is
   still dependency-feasible.

The two rules can re-trigger each other, so :func:`repair` alternates them to
a fixed point (bounded iterations; termination is tested on random graphs)
and always finishes with a final dependency pass — monotonicity is the hard
constraint, the co-consumer rule is best-effort (matching the paper's
"minimum changes to the RL solution").

The port's serving path repairs through :func:`repro_torch.core.segment.repair`,
the host twin of the reference's device repair: it tracks capacity loads in
float32 and always applies the co-consumer rule.  This module is the
reference's host repair as it is — loads in float64, ``enforce_co_consumer``
— for the callers that use it (the generalization tier's baselines); at a
budget boundary the two can make different moves.

The co-consumer rule is also where a hard per-stage ``mem_capacity``
(:class:`repro_torch.core.costmodel.PipelineSystem`) is enforced during repair: a
child is never pulled onto a stage whose parameter load would exceed its
budget (the move is skipped; dependency monotonicity still always holds).
On a capacity-feasible monotone input — which the capacity-penalized DP
produces — every co-consumer move lowers a stage and is capacity-guarded,
so repair preserves feasibility end to end.
"""

from __future__ import annotations

import numpy as np

from .graph import CompGraph, validate_monotone

__all__ = ["repair", "dependency_repair", "co_consumer_repair"]


def dependency_repair(graph: CompGraph, assign: np.ndarray, n_stages: int) -> np.ndarray:
    out = np.asarray(assign, dtype=np.int64).copy()
    np.clip(out, 0, n_stages - 1, out=out)
    for v in range(graph.n):           # node order is topological
        for u in graph.parents[v]:
            if out[u] > out[v]:
                out[v] = out[u]
    return out


def co_consumer_repair(
    graph: CompGraph, assign: np.ndarray, mem_capacity: np.ndarray | None = None
) -> np.ndarray:
    """Pull all children of each multi-consumer node to the earliest child
    stage that still dominates each child's parents.

    ``mem_capacity`` (per-stage byte budget, optional) makes the rule
    capacity-aware: a move that would push the target stage's parameter
    load past its budget is skipped, leaving the child where it is.  Loads
    are recomputed from the incoming assignment and tracked incrementally
    across moves (the device twin mirrors this exact update order).
    """
    out = np.asarray(assign, dtype=np.int64).copy()
    caps = None
    if mem_capacity is not None:
        caps = np.asarray(mem_capacity, dtype=np.float64)
        loads = np.zeros(len(caps))
        np.add.at(loads, out, graph.param_bytes)
    for u in range(graph.n):
        ch = graph.children[u]
        if len(ch) < 2:
            continue
        earliest = min(out[v] for v in ch)
        for v in ch:
            lo = max((out[p] for p in graph.parents[v]), default=0)
            tgt = max(earliest, lo)
            if caps is not None and tgt != out[v]:
                pb = graph.param_bytes[v]
                if loads[tgt] + pb > caps[tgt]:
                    continue        # over budget: leave v on its stage
                loads[tgt] += pb
                loads[out[v]] -= pb
            out[v] = tgt
    return out


def repair(
    graph: CompGraph,
    assign: np.ndarray,
    n_stages: int,
    max_iters: int = 8,
    enforce_co_consumer: bool = True,
    mem_capacity: np.ndarray | None = None,
) -> np.ndarray:
    """Deterministic deployment repair; output always satisfies monotonicity."""
    out = dependency_repair(graph, assign, n_stages)
    if enforce_co_consumer:
        for _ in range(max_iters):
            nxt = dependency_repair(
                graph, co_consumer_repair(graph, out, mem_capacity), n_stages
            )
            if np.array_equal(nxt, out):
                break
            out = nxt
    out = dependency_repair(graph, out, n_stages)
    if not validate_monotone(graph, out, n_stages):
        raise AssertionError("repair produced a non-monotone schedule")
    return out
