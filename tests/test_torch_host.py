"""The port's host modules against the reference's, byte for byte: graph
IR and content hash, embedding, Table-I builders, synthetic sampler, cost
model and system profile."""

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.graph import InvalidGraphError as JInvalid
from repro_torch.core.graph import InvalidGraphError, validate_graph

MAX_DEG = 6


def _same_graph(a, b):
    assert a.parents == b.parents and a.names == b.names and a.model_name == b.model_name
    for f in ("flops", "param_bytes", "out_bytes"):
        assert np.array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name", sorted(tcore.MODEL_SPECS))
def test_table1_graphs_and_embeddings_match(name):
    t, j = tcore.build_model_graph(name), jcore.build_model_graph(name)
    _same_graph(t, j)
    assert t.content_hash() == j.content_hash()
    assert tcore.embed_graph(t, MAX_DEG).tobytes() == jcore.embed_graph(j, MAX_DEG).tobytes()
    assert np.array_equal(t.parent_matrix(MAX_DEG), j.parent_matrix(MAX_DEG))
    assert np.array_equal(t.child_matrix(8), j.child_matrix(8))
    assert (t.n, t.max_in_degree, t.depth) == tuple(tcore.MODEL_SPECS[name][:3])


@pytest.mark.parametrize("seed", range(6))
def test_sampler_graphs_match(seed):
    t = tcore.sample_batch(np.random.default_rng(seed), 4, n=(5, 40))
    j = jcore.sample_batch(np.random.default_rng(seed), 4, n=(5, 40))
    for a, b in zip(t, j):
        _same_graph(a, b)
        assert a.content_hash() == b.content_hash()
        assert np.array_equal(a.ancestor_matrix(), b.ancestor_matrix())
        assert tcore.embed_graph(a).tobytes() == jcore.embed_graph(b).tobytes()


@pytest.mark.parametrize("kw", [
    dict(n_stages=4),
    dict(n_stages=3, compute_rate=(1e12, 2e12, 4e12), link_bw=(1e8, 3e8, 2e8)),
    dict(n_stages=4, mem_capacity=(2e6, 3e6, 5e6, 8e6)),
    dict(n_stages=2, cache_bytes=(1e6, 4e7), mem_capacity=1e7),
])
def test_cost_model_and_profile_match(kw):
    ts, js = tcore.PipelineSystem(**kw), jcore.PipelineSystem(**kw)
    assert ts.profile_features().tobytes() == js.profile_features().tobytes()
    assert ts.is_uniform == js.is_uniform
    rng = np.random.default_rng(kw["n_stages"])
    for g_t, g_j in zip(tcore.sample_batch(np.random.default_rng(1), 5, n=(6, 30)),
                        jcore.sample_batch(np.random.default_rng(1), 5, n=(6, 30))):
        assign = np.sort(rng.integers(0, kw["n_stages"], g_t.n))
        a, b = tcore.evaluate_schedule(g_t, assign, ts), jcore.evaluate_schedule(g_j, assign, js)
        assert np.array_equal(a.stage_times, b.stage_times)
        assert a.objective == b.objective and a.capacity_ok == b.capacity_ok


def test_validation_matches():
    g = tcore.sample_dag(np.random.default_rng(0), n=10, deg=2)
    validate_graph(g)
    g.parents[3].append(7)                 # a cycle through mutation
    with pytest.raises(InvalidGraphError):
        validate_graph(g)
    jg = jcore.sample_dag(np.random.default_rng(0), n=10, deg=2)
    jg.parents[3].append(7)
    with pytest.raises(JInvalid):
        jcore.validate_graph(jg)
    h = tcore.sample_dag(np.random.default_rng(1), n=10, deg=2)
    assert tcore.validate_monotone(h, np.zeros(10, int), 2)
    assert not tcore.validate_monotone(h, np.r_[np.ones(1, int), np.zeros(9, int)], 2)
