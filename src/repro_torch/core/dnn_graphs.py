"""Builders for the ten ImageNet DNN computational graphs of Table I.

Each builder reconstructs a model's graph structure to match Table I
(|V|, max in-degree, depth) and dresses the nodes with the published
parameter and MAC counts spread along a standard CNN profile.  The
attribute draw is seeded with crc32 of the model name, so every process
builds the same graph — the same graphs as the reference's
``repro.core.dnn_graphs``, node for node and byte for byte.
"""

from __future__ import annotations

import zlib

import numpy as np

from .graph import CompGraph

__all__ = ["build_model_graph", "MODEL_SPECS", "all_model_graphs"]

# model: (V, deg, depth, params_int8_bytes, mac_ops, input_hw)
MODEL_SPECS: dict[str, tuple[int, int, int, float, float, int]] = {
    "Xception":          (134, 2, 125, 22.9e6, 8.4e9, 299),
    "ResNet50":          (177, 2, 168, 25.6e6, 4.1e9, 224),
    "ResNet101":         (347, 2, 338, 44.7e6, 7.8e9, 224),
    "ResNet152":         (517, 2, 508, 60.4e6, 11.5e9, 224),
    "DenseNet121":       (429, 2, 428, 8.1e6, 2.9e9, 224),
    "ResNet101v2":       (379, 2, 371, 44.7e6, 7.8e9, 224),
    "ResNet152v2":       (566, 2, 558, 60.4e6, 11.5e9, 224),
    "DenseNet169":       (597, 2, 596, 14.3e6, 3.4e9, 224),
    "DenseNet201":       (709, 2, 708, 20.2e6, 4.3e9, 224),
    "InceptionResNetv2": (782, 4, 571, 55.9e6, 13.2e9, 299),
}


def _stage_profile(pos: float, input_hw: int) -> tuple[int, int]:
    """(spatial, channels) at relative depth ``pos`` in [0, 1]."""
    stage = min(int(pos * 5), 4)
    hw = max(input_hw // 2 ** (stage + 1), 7)
    ch = 64 * 2**stage
    return hw, ch


def _plan_branches(v: int, deg: int, depth: int) -> list[tuple[int, list[int]]]:
    """Off-chain branches as (merge_chain_pos, branch_lengths): they use up
    exactly v - depth extra nodes without changing the graph depth."""
    extra = v - depth
    plans: list[tuple[int, list[int]]] = []
    if extra <= 0:
        return plans
    if deg <= 2:
        step = max((depth - 4) // extra, 1)
        for i in range(extra):
            merge = min(3 + i * step, depth - 1)
            plans.append((merge, [1]))
        return plans
    lengths_cycle = [1, 2, 2, 3][: deg - 1]
    per_module = sum(lengths_cycle)
    n_modules = extra // per_module
    rem = extra - n_modules * per_module
    step = max((depth - 8) // max(n_modules + rem, 1), 1)
    merge = 5
    for _ in range(n_modules):
        plans.append((min(merge, depth - 1), list(lengths_cycle)))
        merge += step
    for _ in range(rem):
        plans.append((min(merge, depth - 1), [1]))
        merge += step
    return plans


def build_model_graph(name: str) -> CompGraph:
    if name not in MODEL_SPECS:
        raise KeyError(f"unknown model {name!r}; choose from {sorted(MODEL_SPECS)}")
    v, deg, depth, total_params, total_macs, input_hw = MODEL_SPECS[name]

    plans = _plan_branches(v, deg, depth)
    branches_at: dict[int, list[int]] = {}
    for merge, lengths in plans:
        branches_at.setdefault(merge, []).extend(lengths)
    # cap merges at deg - 1 branches (the chain parent takes one slot)
    for merge in list(branches_at):
        while len(branches_at[merge]) > deg - 1:
            ln = branches_at[merge].pop()
            alt = merge
            while alt in branches_at and len(branches_at[alt]) >= deg - 1:
                alt = alt + 1 if alt + 1 < depth else 3
            branches_at.setdefault(alt, []).append(ln)

    parents: list[list[int]] = []
    names: list[str] = []
    kind: list[str] = []
    pos_of: list[float] = []
    chain_idx: list[int] = []

    # crc32, not hash(): str hash is randomized per process
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for p in range(depth):
        rel = p / max(depth - 1, 1)
        branch_parents: list[int] = []
        for ln in branches_at.get(p, []):
            anchor_pos = max(p - ln - 1, 0)
            prev = chain_idx[anchor_pos] if chain_idx else 0
            for b in range(ln):
                parents.append([prev] if p > 0 else [])
                names.append(f"{name}/branch{p}_{b}_conv")
                kind.append("branch")
                pos_of.append(rel)
                prev = len(parents) - 1
            branch_parents.append(prev)
        ps = ([chain_idx[p - 1]] if p > 0 else []) + branch_parents
        parents.append(ps)
        is_merge = len(ps) > 1
        names.append(f"{name}/{'merge' if is_merge else 'conv'}_{p}")
        kind.append("merge" if is_merge else "conv")
        pos_of.append(rel)
        chain_idx.append(len(parents) - 1)

    n = len(parents)
    if n != v:
        raise AssertionError((n, v))

    # residual identity skips (no new nodes, no depth change)
    if deg == 2:
        budget = depth // 8
        for p in range(4, depth - 3, max(depth // max(budget, 1), 1)):
            tgt = chain_idx[p]
            if len(parents[tgt]) < deg:
                src = chain_idx[p - 2]
                if src not in parents[tgt]:
                    parents[tgt].append(src)

    hw = np.empty(n)
    ch = np.empty(n)
    for i, rel in enumerate(pos_of):
        h, c = _stage_profile(rel, input_hw)
        hw[i], ch[i] = h, c
    out_bytes = hw * hw * ch
    is_merge = np.array([k == "merge" for k in kind])
    pweight = np.where(is_merge, 0.0, ch**2 * (0.2 + rng.random(n)))
    param_bytes = pweight / max(pweight.sum(), 1) * total_params
    fweight = np.where(is_merge, out_bytes * 1.0, param_bytes * hw * hw)
    flops = fweight / max(fweight.sum(), 1) * total_macs

    for ps in parents:
        ps.sort()
    return CompGraph(parents=parents, flops=flops, param_bytes=param_bytes,
                     out_bytes=out_bytes, names=names, model_name=name)


def all_model_graphs() -> dict[str, CompGraph]:
    return {name: build_model_graph(name) for name in MODEL_SPECS}
