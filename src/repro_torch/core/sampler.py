"""Synthetic DAG sampler: the paper's random computational graphs.

A dominant backbone chain, skip and branch edges that create merge nodes up
to the requested max in-degree, and lognormal byte attributes shaped like
CNN profiles.  From the same ``numpy`` generator state the draws — and so
the graphs — are those of the reference's ``repro.core.sampler``.
"""

from __future__ import annotations

import numpy as np

from .graph import CompGraph

__all__ = ["sample_dag", "sample_batch"]


def sample_dag(rng: np.random.Generator, n: int = 30, deg: int = 2,
               chain_frac_range: tuple[float, float] = (0.55, 0.95)) -> CompGraph:
    """Draw one synthetic computational graph whose max in-degree is ``deg``."""
    if n < 3:
        raise ValueError("need at least 3 nodes")
    if deg < 1:
        raise ValueError("deg >= 1")

    chain_frac = rng.uniform(*chain_frac_range)
    parents: list[list[int]] = [[] for _ in range(n)]
    indeg = np.zeros(n, dtype=np.int64)

    for v in range(1, n):
        if rng.random() < chain_frac or v == 1:
            parents[v].append(v - 1)
        else:
            parents[v].append(int(rng.integers(0, v)))
        indeg[v] = 1

    # skip edges create merge nodes; one node is forced to in-degree deg
    n_extra = int(rng.integers(n // 6, n // 2 + 1))
    candidates = list(range(2, n))
    rng.shuffle(candidates)
    forced = None
    for v in candidates:
        if forced is None and v >= deg:
            forced = v
            want = deg
        else:
            want = int(rng.integers(1, deg + 1))
            if n_extra <= 0:
                continue
        while indeg[v] < want:
            u = int(rng.integers(0, v))
            if u in parents[v]:
                if indeg[v] >= v:
                    break
                continue
            parents[v].append(u)
            indeg[v] += 1
            n_extra -= 1

    depth_pos = np.arange(n) / max(n - 1, 1)
    out_bytes = np.exp(rng.normal(0.0, 0.6, n)) * 3e5 * (1.0 - 0.85 * depth_pos)
    param_bytes = np.exp(rng.normal(0.0, 0.9, n)) * 3e5 * (0.3 + 1.7 * depth_pos)
    param_free = rng.random(n) < 0.3
    param_bytes[param_free] = 0.0
    flops = param_bytes * rng.uniform(30, 120, n) + out_bytes * rng.uniform(1, 8, n)

    for ps in parents:
        ps.sort()
    return CompGraph(parents=parents, flops=flops, param_bytes=param_bytes,
                     out_bytes=out_bytes, names=[f"op_{i}" for i in range(n)],
                     model_name=f"synthetic_n{n}_deg{deg}")


def sample_batch(rng: np.random.Generator, batch: int, n=30,
                 degs=(2, 3, 4, 5, 6)) -> list[CompGraph]:
    """A batch with the paper's uniform mixture over deg(V) in {2..6}; ``n``
    is an int or an inclusive ``(lo, hi)`` range drawn per graph."""
    return [sample_dag(rng, n=_draw_n(rng, n), deg=int(rng.choice(degs)))
            for _ in range(batch)]


def _draw_n(rng: np.random.Generator, n) -> int:
    if isinstance(n, (tuple, list)):
        return int(rng.integers(int(n[0]), int(n[1]) + 1))
    return int(n)
