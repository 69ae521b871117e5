"""The port's host deployment repair (``repro_torch.core.postprocess``)
against the JAX package's ``repro.core.postprocess``, on the CPU.

``repair``, ``co_consumer_repair`` and ``dependency_repair`` equal the
reference's on seeded random graphs and random (often non-monotone)
assignments: with and without a per-stage ``mem_capacity`` budget, and with
``enforce_co_consumer=False``.  A hand-built graph puts a stage's float32
load and its float64 load on opposite sides of its budget: the port's
postprocess keeps the reference's float64 move, and the serving path's
``segment.repair`` (float32, the device twin's arithmetic) moves otherwise —
so the two are different functions and ``postprocess`` is not an alias.
"""

import numpy as np
import pytest

import repro.core as jcore
from repro.core import postprocess as jpost
from repro_torch.core import CompGraph, sample_dag, segment, validate_monotone
from repro_torch.core import postprocess as tpost
from repro_torch.eval import layered_dag

N_GRAPHS = 40


def jgraph(g):
    return jcore.CompGraph(parents=[list(p) for p in g.parents], flops=g.flops.copy(),
                           param_bytes=g.param_bytes.copy(), out_bytes=g.out_bytes.copy(),
                           model_name=g.model_name)


def _case(i: int):
    """(graph, stage count, a random assignment, per-stage budgets)."""
    rng = np.random.default_rng((21, i))
    n = int(rng.integers(5, 40))
    g = (layered_dag(rng, n) if i % 4 == 0
         else sample_dag(rng, n=n, deg=int(rng.integers(2, 6))))
    k = int(rng.integers(2, 7))
    assign = rng.integers(-1, k + 1, size=n)          # out of range on purpose
    total = float(g.param_bytes.sum())
    caps = total / k * rng.uniform(0.6, 1.6, size=k)   # some moves over budget
    return g, k, assign, caps


@pytest.mark.parametrize("mode", ["plain", "capacity", "no_co_consumer", "capacity_no_co"])
def test_repair_matches_reference(mode):
    moved = capped = 0
    for i in range(N_GRAPHS):
        g, k, assign, caps = _case(i)
        kw = {}
        if "capacity" in mode:
            kw["mem_capacity"] = caps
        if "no_co" in mode:
            kw["enforce_co_consumer"] = False
        got = tpost.repair(g, assign, k, **kw)
        want = jpost.repair(jgraph(g), assign, k, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), (mode, i)
        assert validate_monotone(g, got, k)
        moved += not np.array_equal(got, tpost.dependency_repair(g, assign, k))
        if mode == "capacity":
            capped += not np.array_equal(got, tpost.repair(g, assign, k))
    if "no_co" in mode:
        assert moved == 0
    else:
        assert moved > 0          # the co-consumer rule changed something
    if mode == "capacity":
        assert capped > 0         # and a budget skipped a move somewhere


@pytest.mark.parametrize("capped", [False, True])
def test_co_consumer_and_dependency_repair_match_reference(capped):
    for i in range(N_GRAPHS):
        g, k, assign, caps = _case(i)
        mono = tpost.dependency_repair(g, assign, k)
        assert np.array_equal(mono, jpost.dependency_repair(jgraph(g), assign, k)), i
        cap = caps if capped else None
        assert np.array_equal(tpost.co_consumer_repair(g, mono, cap),
                              jpost.co_consumer_repair(jgraph(g), mono, cap)), i


def test_float64_budget_is_not_the_serving_repair():
    # node 0 feeds nodes 1 and 2 (a multi-consumer tensor); 2 sits a stage later
    big = float(2 ** 24)
    g = CompGraph(parents=[[], [0], [0]], flops=np.ones(3), param_bytes=[big, 1.0, 1.0],
                  out_bytes=np.ones(3))
    assign = np.array([0, 0, 1])
    caps = np.array([big + 1.0, 1e9])
    # float64: stage 0 holds 2**24 + 1, pulling node 2 makes 2**24 + 2 > budget
    want = jpost.repair(jgraph(g), assign, 2, mem_capacity=caps)
    assert want.tolist() == [0, 0, 1]
    assert np.array_equal(tpost.repair(g, assign, 2, mem_capacity=caps), want)
    # float32: 2**24 + 1 rounds to 2**24, as does the budget, so the move fits
    assert segment.repair(g, assign, 2, mem_capacity=caps).tolist() == [0, 0, 0]
    # without a budget both pull node 2 forward
    assert tpost.repair(g, assign, 2).tolist() == [0, 0, 0]
