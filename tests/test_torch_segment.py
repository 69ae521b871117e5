"""The port's segmentation DP and repair against the reference's device twins.

``repro_torch.core.segment.rho_dp`` (batched torch) is held integer-equal
to ``repro.core.segment.rho_dp_jax`` and the port's host ``repair`` to
``repro.core.segment.repair_jax``, on random DAGs, tie-heavy uniform-cost
graphs, heterogeneous and memory-capped systems, in padded packs with mixed
``n_valid``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sample_dag
from repro.core import segment as jseg
from repro.core.batching import pack_padded as jpack_padded
from repro.core.costmodel import PipelineSystem as JSystem
from repro_torch.core import segment as tseg
from repro_torch.core.costmodel import PipelineSystem as TSystem
from repro_torch.core.graph import CompGraph as TGraph

# one intra-op thread: the suite runs in several worker processes at once,
# and per-process thread pools would oversubscribe the cores
torch.set_num_threads(1)

MAX_DEG = 6
PAD_N = 32
_rho_batch = jax.jit(jseg.rho_dp_batch, static_argnums=(5, 6))


def _uniform_costs(g):
    n = g.n
    return dataclasses.replace(g, flops=np.full(n, 1.0e9), param_bytes=np.full(n, 1.0e6),
                               out_bytes=np.full(n, 1.0e5))


def _topo_order(g, rng):
    indeg = np.array([len(p) for p in g.parents])
    ready = [i for i in range(g.n) if indeg[i] == 0]
    order = []
    while ready:
        v = ready.pop(int(rng.integers(0, len(ready))))
        order.append(v)
        for c in g.children[v]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    return np.asarray(order, dtype=np.int64)


def _to_port(g) -> TGraph:
    return TGraph([list(p) for p in g.parents], g.flops, g.param_bytes, g.out_bytes,
                  list(g.names), g.model_name)


def _system_kw(kind: str, k: int, graphs, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    jitter = lambda x: tuple(float(x * 2.0 ** rng.uniform(-1.0, 1.0)) for _ in range(k))
    if kind in ("uniform", "ties"):
        return {"n_stages": k}
    kw = {"n_stages": k, "compute_rate": jitter(4.0e12), "link_bw": jitter(320e6),
          "cache_bytes": jitter(8.0 * 2**20)}
    if kind == "memcap":
        # budgets around one stage's share of a typical graph: some graphs
        # of the pack fit, some only with the penalty
        total = float(np.median([g.param_bytes.sum() for g in graphs]))
        mx = float(max(g.param_bytes.max() for g in graphs))
        base = max(total / k + mx, 1.3 * mx)
        kw["mem_capacity"] = tuple(float(base * 2.0 ** rng.uniform(-0.3, 0.5))
                                   for _ in range(k))
    return kw


def _corpus(kind: str, k: int, seed: int, batch: int = 8):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(batch):
        n = int(rng.integers(6, PAD_N + 1))
        g = sample_dag(rng, n=n, deg=int(rng.integers(1, 5)))
        graphs.append(_uniform_costs(g) if kind == "ties" else g)
    orders = np.zeros((batch, PAD_N), np.int32)
    attrs = np.zeros((3, batch, PAD_N), np.float32)
    pmat = np.full((batch, PAD_N, MAX_DEG), -1, np.int32)
    for i, g in enumerate(graphs):
        orders[i, : g.n] = _topo_order(g, rng)
        orders[i, g.n:] = np.arange(g.n, PAD_N)       # pads hold the trailing positions
        attrs[:, i, : g.n] = (g.flops, g.param_bytes, g.out_bytes)
        pmat[i, : g.n] = g.parent_matrix(MAX_DEG)
    n_valid = np.array([g.n for g in graphs], np.int32)
    return graphs, orders, attrs, pmat, n_valid, _system_kw(kind, k, graphs, seed)


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("kind", ["uniform", "ties", "hetero", "memcap"])
def test_rho_dp_matches_rho_dp_jax(kind, k):
    seed = {"uniform": 0, "ties": 1, "hetero": 2, "memcap": 3}[kind] * 10 + k
    graphs, orders, attrs, pmat, n_valid, kw = _corpus(kind, k, seed)
    want = np.asarray(_rho_batch(jnp.asarray(orders), *map(jnp.asarray, attrs),
                                 jnp.asarray(pmat), k, JSystem(**kw), jnp.asarray(n_valid))[0])
    got = tseg.rho_dp(torch.from_numpy(orders), *map(torch.from_numpy, attrs),
                      torch.from_numpy(pmat), k, TSystem(**kw),
                      torch.from_numpy(n_valid)).numpy()
    for i, g in enumerate(graphs):
        assert np.array_equal(got[i, : g.n], want[i, : g.n]), f"graph {i} (n={g.n})"


@pytest.mark.parametrize("kind", ["uniform", "hetero", "memcap"])
def test_rho_dp_padded_equals_unpadded(kind):
    graphs, orders, attrs, pmat, n_valid, kw = _corpus(kind, 4, seed=77)
    system = TSystem(**kw)
    padded = tseg.rho_dp(torch.from_numpy(orders), *map(torch.from_numpy, attrs),
                         torch.from_numpy(pmat), 4, system, torch.from_numpy(n_valid)).numpy()
    for i, g in enumerate(graphs):
        n = g.n
        alone = tseg.rho_dp(torch.from_numpy(orders[i: i + 1, :n].copy()),
                            *(torch.from_numpy(a[i: i + 1, :n].copy()) for a in attrs),
                            torch.from_numpy(pmat[i: i + 1, :n].copy()), 4, system).numpy()
        assert np.array_equal(alone[0], padded[i, :n])


def _jax_repair_pack(graphs, assigns, k, caps):
    pack = jpack_padded(graphs, PAD_N, MAX_DEG)
    a = np.zeros((len(graphs), PAD_N), np.int32)
    for i, g in enumerate(graphs):
        a[i, : g.n] = assigns[i]

    def one(p, c, anc, x, pb):
        return jseg.repair_jax(p, c, anc, x, k, param_bytes=pb, mem_capacity=caps)

    return np.asarray(jax.jit(jax.vmap(one))(pack.parent_mat, pack.child_mat,
                                             pack.ancestor_mat, jnp.asarray(a),
                                             pack.param_bytes))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity", [False, True])
def test_repair_matches_repair_jax(capacity, seed):
    k = 2 + seed
    graphs, *_, kw = _corpus("memcap" if capacity else "hetero", k, seed=100 + seed)
    rng = np.random.default_rng(seed)
    assigns = [rng.integers(0, k, size=g.n) for g in graphs]
    caps = np.asarray(kw["mem_capacity"]) if capacity else None
    want = _jax_repair_pack(graphs, assigns, k, caps)
    for i, g in enumerate(graphs):
        got = tseg.repair(_to_port(g), assigns[i], k, mem_capacity=caps)
        assert np.array_equal(got, want[i, : g.n]), f"graph {i}"
