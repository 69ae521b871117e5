"""The scheduling tail after the decode: segmentation DP and repair.

* :func:`rho_dp` — the optimal contiguous segmentation of a batch of decode
  orders into ``k`` stages, as batched float32 tensor ops on the decode's
  device.  The counterpart of the reference's ``segment.rho_dp_jax``: the
  same per-stage cost tables (stage-indexed for heterogeneous systems, with
  the capacity penalty), the same ``n_valid``-aware dispatch-overhead count,
  and the same banded lexicographic (bottleneck, latency) argmin with
  ``tol = 1e-6`` and ``+1e-30``, taking the first split inside the band.
* :func:`exact_dp_batch` — the exact solver's contiguous DP
  (``core.exact.exact_dp``) for a padded batch: :func:`rho_dp` on the
  identity order (node indices are topological), with the DP objective; the
  counterpart of ``segment.exact_dp_batch``, and the training labeller.
* :func:`repair` — the deployment repair on the host: a numpy twin of
  ``segment.repair_jax`` (equivalently ``postprocess.repair``), run per
  graph on its real nodes.  Integer arithmetic, except the capacity guard,
  which adds parameter bytes in float32 as the reference's device twin does.
"""

from __future__ import annotations

import numpy as np
import torch

from .costmodel import CAPACITY_PENALTY_S, PipelineSystem
from .graph import CompGraph, validate_monotone

__all__ = ["rho_dp", "exact_dp", "exact_dp_batch", "repair", "dependency_repair",
           "co_consumer_repair"]

_TOL = 1e-6


def rho_dp(order, flops, param_bytes, out_bytes, parent_mat, n_stages: int,
           system: PipelineSystem, n_valid=None) -> torch.Tensor:
    """Per-node stage assignment (B, n) int64 of the best contiguous
    segmentation of each ``order``; see :func:`_segment`."""
    return _segment(order, flops, param_bytes, out_bytes, parent_mat, n_stages, system,
                    n_valid)[0]


def exact_dp_batch(flops, param_bytes, out_bytes, parent_mat, n_stages: int,
                   system: PipelineSystem, n_valid=None):
    """The exact contiguous segmentation of each graph of a padded batch:
    :func:`rho_dp` on the identity order.  Returns the assignment (B, n)
    int64 (the real prefix equals host ``exact_dp``'s, tie-break included)
    and the float32 DP bottleneck (B,)."""
    B, n = flops.shape
    order = torch.arange(n, device=flops.device).expand(B, n)
    return _segment(order, flops, param_bytes, out_bytes, parent_mat, n_stages, system, n_valid)


def exact_dp(flops, param_bytes, out_bytes, parent_mat, n_stages: int,
             system: PipelineSystem, n_valid=None):
    """:func:`exact_dp_batch` of one graph: flops etc. (n,), parent_mat
    (n, D); returns the assignment (n,) and the bottleneck ()."""
    nv = None if n_valid is None else torch.as_tensor(n_valid).reshape(1)
    assign, bott = exact_dp_batch(flops[None], param_bytes[None], out_bytes[None],
                                  parent_mat[None], n_stages, system, nv)
    return assign[0], bott[0]


def _segment(order, flops, param_bytes, out_bytes, parent_mat, n_stages: int,
             system: PipelineSystem, n_valid=None):
    """The segmentation DP: the assignment (B, n) int64 and the float32
    bottleneck (B,) of the best contiguous segmentation of each ``order``.

    order: (B, n) node indices; flops, param_bytes, out_bytes: (B, n)
    float32, zero on padded slots; parent_mat: (B, n, D) int, -1 padded;
    n_valid: (B,) real-node counts (padded slots hold the trailing order
    positions and carry no cost, so a padded graph segments as its unpadded
    self).
    """
    B, n = order.shape
    dev = order.device
    f32 = torch.float32
    k = n_stages
    order = order.long()
    nv = (torch.full((B,), n, device=dev, dtype=torch.long) if n_valid is None
          else n_valid.to(device=dev, dtype=torch.long))
    ar = torch.arange(n, device=dev)
    pos = torch.zeros(B, n, dtype=torch.long, device=dev).scatter_(
        1, order, ar.expand(B, n).contiguous())

    zero = torch.zeros(B, 1, dtype=f32, device=dev)
    cf = torch.cat([zero, torch.cumsum(flops.gather(1, order), 1)], 1)       # (B, n+1)
    cp = torch.cat([zero, torch.cumsum(param_bytes.gather(1, order), 1)], 1)

    # boundary bytes: node u crosses boundaries (pos[u], last_child_pos[u]]
    pm = parent_mat.to(device=dev, dtype=torch.long)
    safe_parent = torch.where(pm >= 0, pm, n).reshape(B, -1)
    child_pos = pos[:, :, None].expand(pm.shape).reshape(B, -1)
    lc = torch.full((B, n + 1), -1, dtype=torch.long, device=dev).scatter_reduce_(
        1, safe_parent, child_pos, reduce="amax")[:, :n]
    b_idx = torch.arange(n + 1, device=dev)[None, :, None]
    crossing = (b_idx > pos[:, None, :]) & (b_idx <= lc[:, None, :])        # (B, n+1, n)
    bbytes = torch.where(crossing, out_bytes[:, None, :], 0.0).sum(-1)       # (B, n+1)

    i_idx = torch.arange(n + 1, device=dev)
    seg_flops = cf[:, None, :] - cf[:, :, None]                              # [b, i, j]
    seg_params = cp[:, None, :] - cp[:, :, None]
    # a segment pays the dispatch overhead iff it holds a REAL node
    cnt = torch.minimum(i_idx[None, :], nv[:, None])
    occ = (cnt[:, None, :] - cnt[:, :, None]) > 0
    upper = i_idx[:, None] <= i_idx[None, :]

    # constants as float32 device tensors: true division and float32
    # comparisons, as the reference's weak-typed scalars give
    def c32(x):
        return torch.tensor(float(x), dtype=f32, device=dev)

    re_np = system.stage_vector("compute_rate") * system.stage_vector("compute_eff")
    bw_np = system.stage_vector("link_bw")
    cache_np = system.stage_vector("cache_bytes")
    cap_np = system.capacity_vector()
    overhead = c32(system.fixed_overhead_s)
    penalty = c32(CAPACITY_PENALTY_S)
    inf = c32(float("inf"))

    def one_table(s: int) -> torch.Tensor:
        bw = c32(bw_np[s])
        off = torch.clamp_min(seg_params - c32(cache_np[s]), 0.0)
        c = (bbytes[:, :, None] / bw + seg_flops / c32(re_np[s]) + off / bw
             + torch.where(occ, overhead, 0.0))
        if cap_np is not None:
            c = c + torch.where(seg_params > c32(cap_np[s]), penalty, 0.0)
        return torch.where(upper, c, inf)

    same = (np.all(re_np == re_np[0]) and np.all(bw_np == bw_np[0])
            and np.all(cache_np == cache_np[0])
            and (cap_np is None or np.all(cap_np == cap_np[0])))
    tables = [one_table(0)] * k if same else [one_table(s) for s in range(k)]

    # f_b[j], f_l[j]: best (bottleneck, latency) covering positions [0, j)
    band = c32(1.0 + _TOL)
    tiny = c32(1e-30)
    f_b = tables[0][:, 0, :]
    f_l = tables[0][:, 0, :]
    splits = []
    for s in range(1, k):
        cost = tables[s]
        b = torch.maximum(f_b[:, :, None], cost)                            # [b, i, j]
        lat = f_l[:, :, None] + cost
        m = b.amin(dim=1)
        elig = b <= (m * band + tiny)[:, None, :]
        l_el = torch.where(elig, lat, inf)
        lmin = l_el.amin(dim=1)
        # first split whose latency is inside the band of the minimum
        arg = torch.argmax((l_el <= (lmin * band + tiny)[:, None, :]).to(torch.int32), dim=1)
        splits.append(arg)
        f_b = b.gather(1, arg[:, None, :])[:, 0]
        f_l = l_el.gather(1, arg[:, None, :])[:, 0]

    assign_pos = torch.zeros(B, n, dtype=torch.long, device=dev)
    j = torch.full((B,), n, dtype=torch.long, device=dev)
    for s in range(k - 1, 0, -1):
        i = splits[s - 1].gather(1, j[:, None])[:, 0]
        inside = (ar[None, :] >= i[:, None]) & (ar[None, :] < j[:, None])
        assign_pos = torch.where(inside, s, assign_pos)
        j = i
    assign = torch.zeros(B, n, dtype=torch.long, device=dev).scatter_(1, order, assign_pos)
    return assign, f_b[:, n]


def dependency_repair(graph: CompGraph, assign: np.ndarray, n_stages: int) -> np.ndarray:
    """Raise each node's stage to at least its parents' (topological order)."""
    out = np.clip(np.asarray(assign, dtype=np.int64), 0, n_stages - 1)
    for v in range(graph.n):
        for u in graph.parents[v]:
            if out[u] > out[v]:
                out[v] = out[u]
    return out


def co_consumer_repair(graph: CompGraph, assign: np.ndarray,
                       mem_capacity: np.ndarray | None = None) -> np.ndarray:
    """Pull all children of each multi-consumer node to the earliest child
    stage that still dominates each child's parents.  With
    ``mem_capacity`` a move that would push the target stage's float32
    parameter load past its float32 budget is skipped."""
    out = np.asarray(assign, dtype=np.int64).copy()
    caps = loads = pb = None
    if mem_capacity is not None:
        caps = np.asarray(mem_capacity, dtype=np.float32)
        pb = np.asarray(graph.param_bytes, dtype=np.float32)
        loads = np.zeros(len(caps), dtype=np.float32)
        np.add.at(loads, out, pb)
    for u in range(graph.n):
        ch = graph.children[u]
        if len(ch) < 2:
            continue
        earliest = min(out[v] for v in ch)
        for v in ch:
            lo = max((out[p] for p in graph.parents[v]), default=0)
            tgt = max(earliest, lo)
            if caps is not None and tgt != out[v]:
                if loads[tgt] + pb[v] > caps[tgt]:
                    continue        # over budget: leave v on its stage
                loads[tgt] += pb[v]
                loads[out[v]] -= pb[v]
            out[v] = tgt
    return out


def repair(graph: CompGraph, assign: np.ndarray, n_stages: int, max_iters: int = 8,
           mem_capacity: np.ndarray | None = None) -> np.ndarray:
    """Deployment repair: the two rules alternated to a fixed point (at most
    ``max_iters`` rounds), then a final dependency pass.  The result is
    always monotone along every edge."""
    out = dependency_repair(graph, assign, n_stages)
    for _ in range(max_iters):
        nxt = dependency_repair(graph, co_consumer_repair(graph, out, mem_capacity), n_stages)
        if np.array_equal(nxt, out):
            break
        out = nxt
    out = dependency_repair(graph, out, n_stages)
    if not validate_monotone(graph, out, n_stages):
        raise AssertionError("repair produced a non-monotone schedule")
    return out
