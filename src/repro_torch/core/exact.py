"""Exact schedulers on the host (numpy): the imitation targets of the RL
agent and the oracles of the tests.  A copy of the reference's
``repro.core.exact``, which the port cannot import (it pulls in JAX).

* :func:`exact_dp` — optimal *contiguous segmentation* of a fixed
  topological order into ``n_stages`` segments, an O(|V|^2 n) dynamic
  program with a banded lexicographic tie-break (relative band 1e-12);
* :func:`exact_bb` — branch-and-bound over *all* monotone stage
  assignments (the ILP's feasible set), seeded with the DP's incumbent and
  cut off after ``time_budget_s``;
* :func:`brute_force_monotone` / :func:`brute_force_contiguous` —
  exhaustive test oracles for tiny graphs.

Objective: lexicographic (pipeline bottleneck time, end-to-end latency) under
:mod:`repro_torch.core.costmodel`; a ``mem_capacity`` budget enters as
:data:`~repro_torch.core.costmodel.CAPACITY_PENALTY_S`.
"""

from __future__ import annotations

import time

import numpy as np

from .costmodel import CAPACITY_PENALTY_S, PipelineSystem, evaluate_schedule
from .graph import CompGraph

__all__ = [
    "segment_cost_table",
    "segment_cost_tables",
    "boundary_bytes",
    "exact_dp",
    "exact_bb",
    "brute_force_monotone",
    "brute_force_contiguous",
    "order_from_assignment",
]


def boundary_bytes(graph: CompGraph, order: np.ndarray) -> np.ndarray:
    """bytes[b] crossing boundary ``b`` (between order positions b-1 and b)
    for contiguous segmentations of ``order``: every tensor produced at
    position < b whose last consumer sits at position >= b.

    Computed as a direct masked sum (not a diff/cumsum sweep): summing only
    positive terms leaves no cancellation residue, so boundaries nothing
    crosses are EXACTLY zero and boundaries crossed by the same tensor set
    are bit-equal.  The DP's lexicographic tie-break depends on this — with
    the old cumsum sweep, ~1e-19 rounding residue silently decided which of
    two equal-cost segmentations won, which no fixed-shape device twin
    (the device DP, :func:`repro_torch.core.segment.rho_dp`) could reproduce."""
    n = graph.n
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    # last consumer position of each produced tensor (-1 for sinks)
    hi = np.full(n, -1, dtype=np.int64)
    for u in range(n):
        for v in graph.children[u]:
            hi[u] = max(hi[u], pos[v])
    b_idx = np.arange(n + 1)[:, None]
    crossing = (b_idx > pos[None, :]) & (b_idx <= hi[None, :])
    return np.where(crossing, graph.out_bytes[None, :], 0.0).sum(axis=1)


def segment_cost_tables(
    graph: CompGraph, order: np.ndarray, system: PipelineSystem
) -> list[np.ndarray]:
    """Per-stage segment cost tables: ``tables[s][i, j]`` = time of stage
    ``s`` holding order positions [i, j).  ``tables[s][i, i]`` is the pure
    forwarding cost of an empty stage; entries with j < i are +inf.

    When every stage shares the same constants, all ``n_stages`` entries
    alias ONE table built with exactly the scalar arithmetic this function
    replaced — so the uniform DP runs the identical op sequence and stays
    bitwise back-compatible.  A stage's ``mem_capacity`` (if set) adds
    :data:`CAPACITY_PENALTY_S` to every over-budget segment.
    """
    n = graph.n
    flops = np.concatenate([[0.0], np.cumsum(graph.flops[order])])
    params = np.concatenate([[0.0], np.cumsum(graph.param_bytes[order])])
    bbytes = boundary_bytes(graph, order)

    seg_flops = flops[None, :] - flops[:, None]              # [i, j]
    seg_params = params[None, :] - params[:, None]
    occupied = (np.arange(n + 1)[None, :] - np.arange(n + 1)[:, None]) > 0

    rate_eff = system.stage_vector("compute_rate") * system.stage_vector("compute_eff")
    bw = system.stage_vector("link_bw")
    cache = system.stage_vector("cache_bytes")
    cap = system.capacity_vector()

    def one(re_s: float, bw_s: float, cache_s: float, cap_s: float | None) -> np.ndarray:
        off_cache = np.maximum(0.0, seg_params - cache_s)
        cost = (
            bbytes[:, None] / bw_s
            + seg_flops / re_s
            + off_cache / bw_s
            + np.where(occupied, system.fixed_overhead_s, 0.0)
        )
        if cap_s is not None:
            cost = cost + np.where(seg_params > cap_s, CAPACITY_PENALTY_S, 0.0)
        cost[seg_flops < 0] = np.inf
        return cost

    k = system.n_stages
    same_cost = bool(
        np.all(rate_eff == rate_eff[0]) and np.all(bw == bw[0]) and np.all(cache == cache[0])
    )
    if same_cost and cap is None:
        return [one(rate_eff[0], bw[0], cache[0], None)] * k
    if same_cost and bool(np.all(cap == cap[0])):
        return [one(rate_eff[0], bw[0], cache[0], cap[0])] * k
    return [
        one(rate_eff[s], bw[s], cache[s], None if cap is None else cap[s])
        for s in range(k)
    ]


def segment_cost_table(
    graph: CompGraph, order: np.ndarray, system: PipelineSystem, stage: int = 0
) -> np.ndarray:
    """The cost table of one stage (see :func:`segment_cost_tables`); kept
    for callers that predate heterogeneous systems, where every stage's
    table is the same array."""
    return segment_cost_tables(graph, order, system)[stage]


def exact_dp(
    graph: CompGraph,
    n_stages: int,
    system: PipelineSystem | None = None,
    order: np.ndarray | None = None,
) -> tuple[np.ndarray, float]:
    """Optimal contiguous segmentation of ``order`` into ``n_stages`` stages.

    Returns ``(assignment, bottleneck_seconds)``; assignment is per *node*
    (not per position).  ``order`` defaults to the node index order, which is
    topological by CompGraph construction (ASAP-compatible).

    Heterogeneous systems make the recurrence stage-indexed — stage ``s``
    reads its own cost table ``C_s`` — and a ``mem_capacity`` budget shows up
    as :data:`CAPACITY_PENALTY_S` inside the tables, so a returned bottleneck
    ``>= CAPACITY_PENALTY_S`` means no capacity-feasible segmentation of this
    order exists (the returned split is then the least-violating one).
    """
    if system is None:
        system = PipelineSystem(n_stages=n_stages)
    system = system.with_stages(n_stages)
    n = graph.n
    order = np.arange(n) if order is None else np.asarray(order)
    tables = segment_cost_tables(graph, order, system)

    k = n_stages
    # f_b[j], f_l[j]: best (bottleneck, latency) covering positions [0, j)
    # with the current number of stages; arg[s][j]: split point.  The
    # per-j lex-argmin is vectorized over the whole (i, j) plane; C[i, j]
    # is +inf for i > j, which excludes those split points exactly like
    # the old per-column [: j + 1] slicing did.
    f_b = tables[0][0].copy()
    f_l = tables[0][0].copy()
    args = np.zeros((k, n + 1), dtype=np.int64)
    cols = np.arange(n + 1)
    with np.errstate(invalid="ignore"):
        for s in range(1, k):
            C = tables[s]
            b = np.maximum(f_b[:, None], C)              # (i, j)
            l = f_l[:, None] + C
            m = b.min(axis=0)
            elig = b <= m[None, :] * (1 + 1e-12) + 1e-30
            l_el = np.where(elig, l, np.inf)
            lmin = l_el.min(axis=0)
            # first split whose latency ties the minimum, at the same
            # relative tolerance as the bottleneck eligibility — the banded
            # lex-argmin the device DP (repro_torch.core.segment.rho_dp)
            # mirrors at f32 scale, so tie resolution is rounding-robust
            # and implementation-independent.
            arg = (l_el <= lmin[None, :] * (1 + 1e-12) + 1e-30).argmax(axis=0)
            args[s] = arg
            f_b, f_l = b[arg, cols], l_el[arg, cols]

    # backtrack
    assign_pos = np.empty(n, dtype=np.int64)
    j = n
    for s in range(k - 1, -1, -1):
        i = int(args[s, j]) if s > 0 else 0
        assign_pos[i:j] = s
        j = i
    assign = np.empty(n, dtype=np.int64)
    assign[order] = assign_pos
    return assign, float(f_b[n])


def order_from_assignment(assign: np.ndarray) -> np.ndarray:
    """The imitation-target sequence gamma: nodes in (stage, index) order —
    the order in which the exact algorithm commits nodes to the pipeline."""
    assign = np.asarray(assign)
    return np.lexsort((np.arange(len(assign)), assign))


def exact_bb(
    graph: CompGraph,
    n_stages: int,
    system: PipelineSystem | None = None,
    time_budget_s: float = 10.0,
) -> tuple[np.ndarray, float]:
    """Branch-and-bound over all monotone stage assignments.

    Nodes are committed in topological (index) order; a node may go to any
    stage in [max(parent stages), n_stages).  All three cost terms are
    monotone non-decreasing in the partial assignment, so the partial
    bottleneck is an admissible lower bound.  Seeded with the DP incumbent.
    """
    if system is None:
        system = PipelineSystem(n_stages=n_stages)
    system = system.with_stages(n_stages)
    k = n_stages
    n = graph.n

    inc_assign, _ = exact_dp(graph, k, system)
    inc_eval = evaluate_schedule(graph, inc_assign, system)
    best = [inc_eval.bottleneck_s, inc_eval.latency_s, inc_assign.copy()]
    if not inc_eval.capacity_ok:
        # never let an infeasible incumbent prune feasible completions; if
        # nothing feasible exists either, the DP's least-violating split is
        # still returned.
        best[0] = np.inf
        best[1] = np.inf

    # (k,) per-stage constants; for scalar systems every entry is the same
    # double, so stage_time() computes the exact pre-vector arithmetic.
    rate = system.stage_vector("compute_rate") * system.stage_vector("compute_eff")
    bw = system.stage_vector("link_bw")
    cache = system.stage_vector("cache_bytes")
    cap = system.capacity_vector()
    ovh = system.fixed_overhead_s

    stage_flops = np.zeros(k)
    stage_params = np.zeros(k)
    boundary = np.zeros(k + 1)      # bytes crossing each boundary (1..k-1)
    occupied = np.zeros(k, dtype=np.int64)
    assign = np.full(n, -1, dtype=np.int64)
    maxcons = np.zeros(n, dtype=np.int64)   # furthest consumer stage so far
    parents = graph.parents
    flops_arr = graph.flops
    params_arr = graph.param_bytes
    out_arr = graph.out_bytes
    deadline = time.monotonic() + time_budget_s

    def stage_time(s: int) -> float:
        off = stage_params[s] - cache[s]
        return (
            boundary[s] / bw[s]
            + stage_flops[s] / rate[s]
            + (off / bw[s] if off > 0 else 0.0)
            + (ovh if occupied[s] else 0.0)
        )

    def dfs(v: int, cur_bound: float):
        if time.monotonic() > deadline:
            return
        if v == n:
            lat = sum(stage_time(s) for s in range(k))
            better_b = cur_bound < best[0] * (1 - 1e-12)
            tie_b = abs(cur_bound - best[0]) <= best[0] * 1e-12 + 1e-30
            if better_b or (tie_b and lat < best[1] - 1e-30):
                best[0], best[1], best[2] = cur_bound, lat, assign.copy()
            return
        lo = 0
        for u in parents[v]:
            lo = max(lo, assign[u])
        for s in range(lo, k):
            if cap is not None and stage_params[s] + params_arr[v] > cap[s]:
                continue    # hard memory budget: stage s cannot take v
            # apply node v -> stage s
            stage_flops[s] += flops_arr[v]
            stage_params[s] += params_arr[v]
            occupied[s] += 1
            maxcons[v] = s      # a tensor starts crossing after its producer
            touched_b: list[tuple[int, float]] = []    # boundary increments
            touched_m: list[tuple[int, int]] = []      # maxcons restores
            for u in parents[v]:
                if s > maxcons[u]:
                    for b in range(maxcons[u] + 1, s + 1):
                        boundary[b] += out_arr[u]
                        touched_b.append((b, out_arr[u]))
                    touched_m.append((u, maxcons[u]))
                    maxcons[u] = s
            assign[v] = s
            # boundary b feeds stage b; only stages with changed terms can
            # raise the bound (all terms are monotone in the assignment).
            affected = {s} | {b for b, _ in touched_b if b < k}
            nb = max([cur_bound] + [stage_time(t) for t in affected])
            if nb <= best[0] * (1 + 1e-12):
                dfs(v + 1, nb)
            # undo
            assign[v] = -1
            for u, old in touched_m:
                maxcons[u] = old
            for b, val in touched_b:
                boundary[b] -= val
            occupied[s] -= 1
            stage_params[s] -= params_arr[v]
            stage_flops[s] -= flops_arr[v]

    dfs(0, 0.0)
    return best[2], float(best[0])


def brute_force_monotone(
    graph: CompGraph, n_stages: int, system: PipelineSystem | None = None
) -> tuple[np.ndarray, float]:
    """Exhaustive test oracle (use only for |V| <= ~10)."""
    if system is None:
        system = PipelineSystem(n_stages=n_stages)
    system = system.with_stages(n_stages)
    n = graph.n
    best = (np.inf, np.inf, None)
    assign = np.zeros(n, dtype=np.int64)

    def rec(v: int):
        nonlocal best
        if v == n:
            ev = evaluate_schedule(graph, assign, system)
            if not ev.capacity_ok:
                return
            key = (ev.bottleneck_s, ev.latency_s)
            if key < best[:2]:
                best = (key[0], key[1], assign.copy())
            return
        lo = max((assign[u] for u in graph.parents[v]), default=0)
        for s in range(lo, n_stages):
            assign[v] = s
            rec(v + 1)
        assign[v] = 0

    rec(0)
    return best[2], float(best[0])


def brute_force_contiguous(
    graph: CompGraph,
    n_stages: int,
    system: PipelineSystem | None = None,
    order: np.ndarray | None = None,
) -> tuple[np.ndarray, float, float]:
    """Exhaustive lexicographic minimum over ALL contiguous segmentations of
    ``order`` — the C(n+k-1, k-1) test oracle for :func:`exact_dp` (use for
    |V| <= ~10).  Scores segmentations on the same per-stage cost tables the
    DP reads (capacity penalty included), so a mismatch isolates the DP
    recurrence/backtrack rather than cost-model arithmetic.

    Returns ``(assignment, bottleneck_seconds, latency_seconds)``.
    """
    import itertools

    if system is None:
        system = PipelineSystem(n_stages=n_stages)
    system = system.with_stages(n_stages)
    n = graph.n
    k = n_stages
    order = np.arange(n) if order is None else np.asarray(order)
    tables = segment_cost_tables(graph, order, system)

    best_key = (np.inf, np.inf)
    best_bounds: tuple[int, ...] | None = None
    for cuts in itertools.combinations_with_replacement(range(n + 1), k - 1):
        bounds = (0, *cuts, n)
        costs = [float(tables[s][bounds[s], bounds[s + 1]]) for s in range(k)]
        key = (max(costs), sum(costs))
        if key < best_key:
            best_key = key
            best_bounds = bounds

    assert best_bounds is not None
    assign_pos = np.empty(n, dtype=np.int64)
    for s in range(k):
        assign_pos[best_bounds[s] : best_bounds[s + 1]] = s
    assign = np.empty(n, dtype=np.int64)
    assign[order] = assign_pos
    return assign, float(best_key[0]), float(best_key[1])
