"""The port's batched exact oracle (``repro_torch.eval.oracle``) against the
JAX package's (``repro.eval.oracle``) and its own host loop, on the CPU.

* ``ExactOracle(device="cpu").solve_many`` is bit-identical — assignment,
  order, float64 bottleneck and latency — to ``solve_many_host`` and to the
  reference's ``ExactOracle`` on 48 seeded random DAGs of 5-30 nodes
  (every third tie-heavy with uniform costs, most padded to a larger
  power-of-two bucket), at two stage counts, and on a heterogeneous,
  memory-capped system;
* ``label_pack`` equals the reference's on a labelled pack (assignment
  exactly, the float32 DP bottleneck within 1e-6 relative: float32 sums in
  another order), and a pack padded with ``pad_batch`` labels its real rows
  as the unpadded pack and its inert rows zero;
* ``with_exact`` keeps ``dense`` and ``label_stages``;
* without CUDA the oracle raises unless given ``device="cpu"``.

On the card (``cuda``, skipped here): the oracle there equals the host loop.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.eval as jeval
from repro_torch.core import PipelineSystem, sample_dag
from repro_torch.core.batching import pack_padded
from repro_torch.core.rl import pack_graphs
from repro_torch.eval import ExactOracle, layered_dag, run_grid, synthetic_dag

torch.set_num_threads(1)

N_GRAPHS = 24
STAGE_COUNTS = (2, 5)
TOL_BNECK = 1e-6     # the float32 DP objective: the same sums in another order


def jgraph(g):
    """The reference's CompGraph of a port graph (same arrays)."""
    return jcore.CompGraph(parents=[list(p) for p in g.parents], flops=g.flops.copy(),
                           param_bytes=g.param_bytes.copy(), out_bytes=g.out_bytes.copy(),
                           names=list(g.names), model_name=g.model_name)


def _uniform_costs(g):
    """Flat cost surface: most segmentations tie on the bottleneck, so only
    the lexicographic tie-break separates solutions."""
    n = g.n
    return dataclasses.replace(g, flops=np.full(n, 1.0e9), param_bytes=np.full(n, 1.0e6),
                               out_bytes=np.full(n, 1.0e5))


def _corpus(k: int) -> list:
    out = []
    for i in range(N_GRAPHS):
        rng = np.random.default_rng((k, i))
        n = int(rng.integers(5, 31))
        if i % 7 == 0:
            g = synthetic_dag("chain", rng, n)
        elif i % 5 == 0:
            g = layered_dag(rng, n)
        else:
            g = sample_dag(rng, n=n, deg=int(rng.integers(1, min(5, n - 1))))
        if i % 3 == 0:
            g = _uniform_costs(g)
        out.append(g)
    return out


@pytest.fixture(scope="module")
def oracle():
    return ExactOracle(device="cpu")


@pytest.mark.parametrize("k", STAGE_COUNTS)
def test_oracle_bit_identical_to_host_and_reference(oracle, k):
    graphs = _corpus(k)
    dev = oracle.solve_many(graphs, k)
    host = ExactOracle.solve_many_host(graphs, k)
    ref = jeval.ExactOracle().solve_many([jgraph(g) for g in graphs], k)
    assert sum(g.n < 1 << (g.n - 1).bit_length() for g in graphs) > N_GRAPHS // 2   # padded
    for i, (d, h, r) in enumerate(zip(dev, host, ref)):
        for other in (h, r):
            assert np.array_equal(d.assignment, other.assignment), (k, i)
            assert np.array_equal(d.order, other.order), (k, i)
            # float64 objectives re-derived from equal integer assignments
            assert d.bottleneck_s == other.bottleneck_s, (k, i)
            assert d.latency_s == other.latency_s, (k, i)
    assert {s[2] for s in oracle.compiled_shapes} >= {k}


def test_oracle_heterogeneous_and_capped_systems(oracle):
    k = 4
    graphs = _corpus(3)[:12]
    system = PipelineSystem(n_stages=k, compute_rate=(4e12, 2e12, 4e12, 8e12),
                            link_bw=(320e6, 160e6, 320e6, 640e6),
                            mem_capacity=(4e6, 6e6, 8e6, 1e7))
    jsys = jcore.PipelineSystem(**dataclasses.asdict(system))
    dev = oracle.solve_many(graphs, k, system)
    ref = jeval.ExactOracle().solve_many([jgraph(g) for g in graphs], k, jsys)
    for i, (d, r) in enumerate(zip(dev, ref)):
        assert np.array_equal(d.assignment, r.assignment), i
        assert (d.bottleneck_s, d.latency_s) == (r.bottleneck_s, r.latency_s), i


def test_label_pack_matches_reference_and_survives_batch_padding(oracle):
    rng = np.random.default_rng(3)
    graphs = [sample_dag(rng, n=int(rng.integers(5, 15)), deg=2) for _ in range(6)]
    graphs[2] = _uniform_costs(graphs[2])
    k = 4
    packed = pack_graphs(graphs, k, PipelineSystem(k), device="cpu")       # labelled
    assert packed.has_labels and packed.exact_assign is None
    labeled = oracle.label_pack(packed, k)
    ref = jeval.ExactOracle().label_pack(jcore.pack_padded([jgraph(g) for g in graphs]), k)
    got = labeled.exact_assign.numpy()
    assert got.shape == (6, packed.bucket_n) and labeled.exact_bottleneck.shape == (6,)
    assert np.array_equal(got, np.asarray(ref.exact_assign))
    np.testing.assert_allclose(labeled.exact_bottleneck.numpy(),
                               np.asarray(ref.exact_bottleneck), rtol=TOL_BNECK)
    for i, g in enumerate(graphs):
        assert np.all(got[i, g.n:] == 0), "exact labels are 0 past n_valid"
    assert labeled.label_stages == k and labeled.has_labels

    padded = oracle.label_pack(packed.pad_batch(8), k)
    assert padded.exact_assign.shape == (8, packed.bucket_n)
    assert torch.equal(padded.exact_assign[:6], labeled.exact_assign)
    assert torch.equal(padded.exact_bottleneck[:6], labeled.exact_bottleneck)
    assert not padded.exact_assign[6:].any() and not padded.exact_bottleneck[6:].any()


def test_with_exact_keeps_dense_and_label_stages():
    rng = np.random.default_rng(5)
    graphs = [sample_dag(rng, n=16, deg=2) for _ in range(3)]
    packed = pack_graphs(graphs, 3, PipelineSystem(3), device="cpu")
    assert packed.dense and packed.label_stages == 3
    ea = torch.ones((3, 16), dtype=torch.int32)
    eb = torch.ones(3)
    out = packed.with_exact(ea, eb)
    assert out.dense and out.label_stages == 3
    assert out.exact_assign is ea and out.exact_bottleneck is eb
    assert out.label_assign is packed.label_assign and packed.exact_assign is None
    assert pack_padded(graphs).with_exact(ea, eb).label_stages is None


def test_oracle_warmup_and_single_solve(oracle):
    g = sample_dag(np.random.default_rng(9), n=11, deg=3)
    assert oracle.warmup([g], 3) is None
    sol = oracle.solve(g, 3)
    a, _ = jcore.exact_dp(jgraph(g), 3)
    assert np.array_equal(sol.assignment, a)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_oracle_needs_cuda_unless_told_cpu():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExactOracle()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_grid([])


@pytest.mark.cuda
def test_oracle_on_cuda_matches_host():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the oracle's device run)")
    orc = ExactOracle()
    assert orc.device.type == "cuda"
    for k in STAGE_COUNTS:
        graphs = _corpus(k)
        orc.warmup(graphs, k)
        for d, h in zip(orc.solve_many(graphs, k), ExactOracle.solve_many_host(graphs, k)):
            assert np.array_equal(d.assignment, h.assignment)
            assert (d.bottleneck_s, d.latency_s) == (h.bottleneck_s, h.latency_s)
