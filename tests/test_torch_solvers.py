"""The port's host solvers and DAG sampler against the reference's.

Graphs come from the same numpy seeds on both sides (the samplers draw the
same graphs), as in ``tests/test_scheduler_core.py`` (n 4-12, in-degree up
to 4), ``tests/test_segment.py`` (n 5-16) and ``tests/test_hetero.py``
(per-stage systems from ``hetero_system`` and feasible ``mem_capacity``
budgets).  Integer outputs (assignments, orders) must be equal; objectives
equal to within 1e-12 relative.  ``exact_bb`` is compared only on graphs
whose search completes well inside its time budget (checked).
"""

import dataclasses
import time

import numpy as np
import pytest

import repro.core as jc
import repro_torch.core as tc
from repro.core import exact as jexact
from repro.eval.scenarios import hetero_system
from repro_torch.core import exact as texact

REL = 1e-12


def _graphs(seed: int):
    """The same graph from both samplers, in the corpus shape of
    tests/test_scheduler_core.py and tests/test_segment.py; every other
    seed gets the tie-heavy uniform costs of tests/test_decode_parity.py,
    where the DP's tie-break decides."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 17))
    deg = int(rng.integers(1, 5))
    kw = dict(n=n, deg=min(deg, n - 2))
    jg = jc.sample_dag(np.random.default_rng(10_000 + seed), **kw)
    tg = tc.sample_dag(np.random.default_rng(10_000 + seed), **kw)
    if seed % 2:
        costs = dict(flops=np.full(n, 1e9), param_bytes=np.full(n, 1e6),
                     out_bytes=np.full(n, 1e5))
        jg, tg = dataclasses.replace(jg, **costs), dataclasses.replace(tg, **costs)
    assert tg.content_hash() == jg.content_hash()
    return jg, tg


def _feasible_caps(g, k: int, seed: int) -> tuple[float, ...]:
    """tests/test_hetero.py's budgets: total / k + the largest node, times
    seeded multipliers >= 1, so a feasible contiguous split exists."""
    total, mx = float(g.param_bytes.sum()), float(g.param_bytes.max())
    base = max(total / k + mx, 1.3 * mx, 1.0)
    rng = np.random.default_rng(seed)
    return tuple(float(base * 2.0 ** rng.uniform(0.05, 0.5)) for _ in range(k))


def _systems(kind: str, k: int, seed: int, g):
    if kind == "uniform":
        jsys = jc.PipelineSystem(n_stages=k)
    else:
        jsys = hetero_system(k, seed)
        if kind == "memcap":
            jsys = dataclasses.replace(jsys, mem_capacity=_feasible_caps(g, k, seed))
        elif kind == "tight":     # budgets nothing fits: the least-violating split
            jsys = dataclasses.replace(jsys, mem_capacity=(float(g.param_bytes.max()) * 0.5,) * k)
    return jsys, tc.PipelineSystem(**dataclasses.asdict(jsys))


KINDS = ["uniform", "hetero", "memcap", "tight"]


@pytest.mark.parametrize("kind", KINDS)
def test_exact_dp_and_rho_match_reference(kind):
    for seed in range(30):
        jg, tg = _graphs(seed)
        k = 2 + seed % 4
        jsys, tsys = _systems(kind, k, seed, jg)
        ja, jb = jexact.exact_dp(jg, k, jsys)
        ta, tb = texact.exact_dp(tg, k, tsys)
        assert np.array_equal(ta, ja), seed
        assert tb == pytest.approx(jb, rel=REL)
        # a random topological-compatible order: rho over it
        order = np.random.default_rng(seed).permutation(tg.n)
        assert np.array_equal(tc.rho(tg, order, k, tsys), jc.rho(jg, order, k, jsys))
        assert np.array_equal(texact.boundary_bytes(tg, order), jexact.boundary_bytes(jg, order))
        for t, j in zip(texact.segment_cost_tables(tg, order, tsys),
                        jexact.segment_cost_tables(jg, order, jsys)):
            assert np.array_equal(t, j)
        assert np.array_equal(texact.segment_cost_table(tg, order, tsys, k - 1),
                              jexact.segment_cost_table(jg, order, jsys, k - 1))
        assert np.array_equal(tc.order_from_assignment(ta), jc.order_from_assignment(ja))
    with pytest.raises(ValueError, match="permutation"):
        tc.rho(tg, np.zeros(tg.n, dtype=np.int64), 2)


@pytest.mark.parametrize("kind", ["uniform", "hetero", "memcap"])
def test_exact_bb_matches_reference_where_it_completes(kind):
    budget = 30.0
    for seed in range(12):
        jg, tg = _graphs(seed)
        if tg.n > 10:
            continue
        k = 2 + seed % 2
        jsys, tsys = _systems(kind, k, seed, jg)
        t0 = time.monotonic()
        ta, tb = tc.exact_bb(tg, k, tsys, time_budget_s=budget)
        assert time.monotonic() - t0 < budget / 3      # the search ran to its end
        ja, jb = jc.exact_bb(jg, k, jsys, time_budget_s=budget)
        assert np.array_equal(ta, ja), seed
        assert tb == pytest.approx(jb, rel=REL)


@pytest.mark.parametrize("kind", ["uniform", "hetero", "memcap"])
def test_brute_force_oracles_match_reference(kind):
    for seed in range(40):
        jg, tg = _graphs(seed)
        if tg.n > 8:
            continue
        k = 2 + seed % 2
        jsys, tsys = _systems(kind, k, seed, jg)
        ta, tb = tc.brute_force_monotone(tg, k, tsys)
        ja, jb = jc.brute_force_monotone(jg, k, jsys)
        assert np.array_equal(ta, ja) and tb == pytest.approx(jb, rel=REL)
        ta, tb, tl = texact.brute_force_contiguous(tg, k, tsys)
        ja, jb, jl = jexact.brute_force_contiguous(jg, k, jsys)
        assert np.array_equal(ta, ja)
        assert tb == pytest.approx(jb, rel=REL) and tl == pytest.approx(jl, rel=REL)


def test_heuristics_match_reference():
    for seed in range(30):
        jg, tg = _graphs(seed)
        k = 2 + seed % 4
        order = np.random.default_rng(seed).permutation(tg.n)
        assert np.array_equal(tc.compiler_partition(tg, k), jc.compiler_partition(jg, k))
        assert np.array_equal(tc.compiler_partition(tg, k, order=order),
                              jc.compiler_partition(jg, k, order=order))
        assert np.array_equal(tc.list_schedule(tg, k), jc.list_schedule(jg, k))
    jgs = [_graphs(s)[0] for s in range(6)]
    tgs = [_graphs(s)[1] for s in range(6)]
    for (to, ta), (jo, ja) in zip(tc.heuristic_schedule_many(tgs, 3),
                                  jc.heuristic_schedule_many(jgs, 3)):
        assert np.array_equal(to, jo) and np.array_equal(ta, ja)
        assert to.dtype == ta.dtype == np.int64


def test_dag_sampler_stream_state_and_prefetch():
    for n in (30, (10, 50)):
        js, ts = jc.DagSampler(seed=3, n=n), tc.DagSampler(seed=3, n=n)
        for _ in range(3):
            assert ([g.content_hash() for g in ts.next_batch(5)]
                    == [g.content_hash() for g in js.next_batch(5)])
        assert ts.state() == js.state() == {"seed": 3, "count": 3}
    state = ts.state()
    after = [g.content_hash() for g in ts.next_batch(4)]
    resumed = tc.DagSampler(seed=99, n=(10, 50))
    resumed.restore(state)
    assert [g.content_hash() for g in resumed.next_batch(4)] == after

    assert list(tc.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def failing():
        yield 1
        raise KeyError("producer")

    it = tc.prefetch(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer"):
        next(it)
