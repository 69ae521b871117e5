"""The reference's RL tests (``tests/test_rl_training.py``,
``tests/test_train_engine.py``) rewritten against the port, on the CPU.

Each keeps its reference's claim: training packs are the serving
representation; a mixed-size padded rollout equals each graph's unpadded
one bit for bit (rewards, assignments, exact-match), greedy and sampled;
inert batch rows move no metric; the train step takes any (bucket_n, B)
shape of the curriculum stream; labels equal the host ``exact_dp`` and the
cache keys separate solver, budget and system; the sampler's stream is
deterministic and resumes; the trainer state round-trips through the
checkpoint manager; a short run improves the reward.  A data-parallel
trainer needs an initialised world of its size and names ``run_ranks``
without one (the data-parallel steps themselves are held to the reference
in ``tests/test_torch_parallel.py``).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import (DagSampler, PipelineSystem, embed_dim, embed_graph, exact_dp,
                              prefetch, prng, sample_batch, sample_dag, sample_order)
from repro_torch.core import segment
from repro_torch.core.batching import PaddedGraphBatch
from repro_torch.core.ptrnet import PointerNet
from repro_torch.core.rl import (RLTrainer, _label_cache_key, _policy_rewards, cosine_reward,
                                 label_graphs, make_eval_fn, make_rollout_fn, pack_graphs)

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def sys4():
    return PipelineSystem(n_stages=4)


@pytest.fixture(scope="module")
def small_batch(sys4):
    graphs = sample_batch(np.random.default_rng(0), 12)
    return pack_graphs(graphs, 4, sys4, device=CPU), graphs


@pytest.fixture(scope="module")
def mixed_graphs():
    rng = np.random.default_rng(0)
    return [sample_dag(rng, n=int(rng.integers(10, 51)), deg=int(rng.integers(2, 7)))
            for _ in range(10)]


def _key(seed):
    return prng.PRNGKey(seed)


# --------------------------------------------------------------------- #
# tests/test_rl_training.py
# --------------------------------------------------------------------- #
def test_pack_graphs_is_padded_serving_batch(small_batch):
    batch, graphs = small_batch
    assert isinstance(batch, PaddedGraphBatch) and batch.has_labels
    assert batch.bucket_n == 32          # 30-node graphs pad to 32
    assert batch.n_valid.tolist() == [g.n for g in graphs]
    assert (batch.label_assign[:, 30:] == 0).all()


def test_decode_emits_permutation(small_batch):
    batch, graphs = small_batch
    net = PointerNet.init(embed_dim(), 32, key=_key(0))
    order, logp, _ = sample_order(net, batch.feats[0], batch.parent_mat[0], _key(1),
                                  n_valid=batch.n_valid[0])
    n = graphs[0].n
    assert sorted(order[:n].tolist()) == list(range(n))
    assert torch.isfinite(logp).all()


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 10_000))
def test_masked_decode_is_topological(seed):
    g = sample_dag(np.random.default_rng(seed), n=16, deg=3)
    net = PointerNet.init(embed_dim(), 32, key=_key(seed))
    order, _, _ = sample_order(net, embed_graph(g), g.parent_matrix(6), _key(seed + 1))
    pos = np.empty(g.n, np.int64)
    pos[order.numpy()] = np.arange(g.n)
    for u, v in g.edges():
        assert pos[u] < pos[v], "masked decode violated a dependency"


def test_device_exact_dp_matches_host(small_batch, sys4):
    batch, graphs = small_batch
    g = graphs[0]
    assign_np, obj_np = exact_dp(g, 4, sys4)
    a, bott = segment.exact_dp(*(torch.as_tensor(np.asarray(x, np.float32)) for x in
                                 (g.flops, g.param_bytes, g.out_bytes)),
                               torch.from_numpy(g.parent_matrix(6)), 4, sys4)
    assert np.array_equal(a.numpy(), assign_np)
    assert float(bott) == pytest.approx(obj_np, rel=1e-5)


def test_perfect_imitation_reward_is_one(small_batch):
    batch, _ = small_batch
    r = cosine_reward(batch.label_assign[0], batch.label_assign[0])
    assert float(r) == pytest.approx(1.0, abs=1e-6)


def test_short_training_improves_reward(small_batch, sys4):
    batch, _ = small_batch
    trainer = RLTrainer(n_stages=4, system=sys4, hidden=32, lr=5e-3, seed=0, device=CPU)
    r0 = trainer.evaluate(batch)["reward_greedy"]
    key = _key(0)
    rewards = []
    for i in range(60):
        key, k = prng.split(key)
        m = trainer.train_step(batch, k)
        rewards.append(m["reward_sample"])
        if i % 10 == 9:
            trainer.maybe_update_baseline(batch)
    r1 = trainer.evaluate(batch)["reward_greedy"]
    assert r1 >= r0 - 0.02
    assert np.mean(rewards[-10:]) > np.mean(rewards[:10]) - 0.02


# --------------------------------------------------------------------- #
# tests/test_train_engine.py
# --------------------------------------------------------------------- #
def test_mixed_size_padded_matches_unpadded_bitwise(sys4, mixed_graphs):
    batch = pack_graphs(mixed_graphs, 4, sys4, device=CPU)
    net = RLTrainer(n_stages=4, system=sys4, hidden=32, seed=0, device=CPU).params
    roll = make_rollout_fn(4, sys4)
    r_pad, _, _, _, a_pad = roll(net, batch, _key(1))
    for i, g in enumerate(mixed_graphs):
        single = pack_graphs([g], 4, sys4, pad=False, device=CPU)
        assert single.bucket_n == g.n
        r1, _, _, _, a1 = roll(net, single, _key(1))
        assert float(r_pad[i]) == float(r1[0])
        assert torch.equal(a_pad[i, : g.n], a1[0])
        assert torch.equal(batch.label_assign[i, : g.n], single.label_assign[0])
        m_pad = bool((a_pad[i, : g.n] == batch.label_assign[i, : g.n]).all())
        assert m_pad == bool((a1[0] == single.label_assign[0]).all())


def test_sampled_rollout_padded_matches_unpadded(sys4, mixed_graphs):
    batch = pack_graphs(mixed_graphs[:4], 4, sys4, device=CPU)
    net = RLTrainer(n_stages=4, system=sys4, hidden=32, seed=1, device=CPU).params
    keys = prng.split(_key(7), 4)
    with torch.no_grad():
        r_pad, _, _, o_pad, _ = _policy_rewards(net, batch, keys, 4, sys4, True)
        for i, g in enumerate(mixed_graphs[:4]):
            single = pack_graphs([g], 4, sys4, pad=False, device=CPU)
            r1, _, _, o1, _ = _policy_rewards(net, single, keys[i][None], 4, sys4, True)
            assert torch.equal(o_pad[i, : g.n], o1[0])
            assert float(r_pad[i]) == float(r1[0])


def test_eval_ignores_inert_batch_padding_rows(sys4, mixed_graphs):
    batch = pack_graphs(mixed_graphs, 4, sys4, device=CPU)
    net = RLTrainer(n_stages=4, system=sys4, hidden=32, seed=0, device=CPU).params
    ev = make_eval_fn(4, sys4)
    m1, m2 = ev(net, batch), ev(net, batch.pad_batch(16))
    assert float(m1["reward_greedy"]) == float(m2["reward_greedy"])
    assert float(m1["exact_match"]) == float(m2["exact_match"])


def test_train_step_on_mixed_bucketed_stream(sys4):
    sam = DagSampler(seed=3, n=(10, 50))
    tr = RLTrainer(n_stages=4, system=sys4, hidden=32, lr=3e-3, seed=0, device=CPU)
    key = _key(0)
    shapes = set()
    n_packs = 0
    for pack in prefetch(sam.packed_stream(12, 4, system=sys4, batches_per_epoch=3, epochs=1,
                                           curriculum=True, device=CPU), depth=2):
        key, k = prng.split(key)
        m = tr.train_step(pack, k)
        shapes.add((pack.bucket_n, pack.batch))
        n_packs += 1
        assert np.isfinite(list(m.values())).all()
    assert len(shapes) > 1
    assert tr.step_count == n_packs


def test_mixed_size_labels_match_exact_dp(sys4, mixed_graphs):
    la, _ = label_graphs(mixed_graphs, 4, sys4, device=CPU)
    for g, a in zip(mixed_graphs, la):
        assert np.array_equal(a, exact_dp(g, 4, sys4)[0]), g.model_name


def test_label_cache_key_distinguishes_solver_and_system(sys4):
    g = sample_dag(np.random.default_rng(5), n=20, deg=3)
    base = _label_cache_key(g, 4, sys4, "dp", 6, 0.25)
    assert base == _label_cache_key(g, 4, sys4, "dp", 6, 99.0)
    bb1 = _label_cache_key(g, 4, sys4, "bb", 6, 0.25)
    bb2 = _label_cache_key(g, 4, sys4, "bb", 6, 0.50)
    assert bb1 != bb2 and bb1 != base
    assert base != _label_cache_key(g, 5, sys4.with_stages(5), "dp", 6, 0.25)
    slower = PipelineSystem(n_stages=4, link_bw=sys4.link_bw * 0.5)
    assert base != _label_cache_key(g, 4, slower, "dp", 6, 0.25)


def test_label_cache_bb_and_dp_do_not_collide(tmp_path, sys4):
    graphs = [sample_dag(np.random.default_rng(6), n=12, deg=2)]
    label_graphs(graphs, 4, sys4, cache_dir=tmp_path, device=CPU)
    n_dp = len(list(tmp_path.glob("*.npz")))
    label_graphs(graphs, 4, sys4, label_method="bb", bb_budget_s=0.05, cache_dir=tmp_path)
    assert len(list(tmp_path.glob("*.npz"))) == n_dp + 1


def _same(pa, pb):
    for f in ("feats", "parent_mat", "flops", "param_bytes", "out_bytes", "n_valid",
              "label_assign", "label_order"):
        assert torch.equal(getattr(pa, f), getattr(pb, f)), f


def test_dag_sampler_epoch_determinism():
    a, b = DagSampler(seed=11, n=(10, 50)), DagSampler(seed=11, n=(10, 50))
    packs_a = list(a.packed_stream(8, 4, batches_per_epoch=2, epochs=1, device=CPU))
    packs_b = list(b.packed_stream(8, 4, batches_per_epoch=2, epochs=1, device=CPU))
    assert len(packs_a) == len(packs_b)
    for pa, pb in zip(packs_a, packs_b):
        _same(pa, pb)
    state = a.state()
    next_a = a.next_batch(4)
    c = DagSampler(seed=0, n=(10, 50))
    c.restore(state)
    assert [g.content_hash() for g in next_a] == [g.content_hash() for g in c.next_batch(4)]


def test_packed_stream_respects_batch_divisor(sys4):
    sam = DagSampler(seed=4, n=(10, 50))
    packs = list(sam.packed_stream(10, 4, system=sys4, batches_per_epoch=2, epochs=1,
                                   batch_divisor=8, device=CPU))
    assert packs and all(p.batch % 8 == 0 for p in packs)
    fixed = DagSampler(seed=4, n=20)
    for p in fixed.packed_stream(10, 4, system=sys4, batches_per_epoch=1, epochs=1,
                                 batch_divisor=8, device=CPU):
        assert p.batch % 8 == 0


def test_curriculum_stream_resumes_mid_stream():
    a = DagSampler(seed=13, n=(10, 50))
    packs_a = list(a.packed_stream(6, 4, batches_per_epoch=4, epochs=1, curriculum=True,
                                   bucket=False, device=CPU))
    assert len(packs_a) == 4
    b = DagSampler(seed=13, n=(10, 50))
    b.restore({"seed": 13, "count": 2})
    packs_b = list(b.packed_stream(6, 4, batches_per_epoch=4, epochs=1, curriculum=True,
                                   bucket=False, device=CPU))
    assert len(packs_b) == 4
    for pa, pb in zip(packs_a[2:], packs_b[:2]):
        _same(pa, pb)


def test_trainer_state_roundtrips_through_manager(tmp_path, sys4):
    batch = DagSampler(seed=2, n=(10, 30)).next_packed_batch(8, 4, system=sys4, device=CPU)
    tr = RLTrainer(n_stages=4, system=sys4, hidden=32, lr=3e-3, seed=0, device=CPU)
    key = _key(0)
    for _ in range(3):
        key, k = prng.split(key)
        tr.train_step(batch, k)
    tr.maybe_update_baseline(batch)
    tr.save(tmp_path)
    tr2 = RLTrainer(n_stages=4, system=sys4, hidden=32, lr=3e-3, seed=42, device=CPU)
    assert tr2.restore(tmp_path) == tr.step_count
    from repro_torch.checkpoint.manager import flatten_leaves
    a, b = flatten_leaves(tr.state.tree()), flatten_leaves(tr2.state.tree())
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        assert np.array_equal(x, y), name
    m1, m2 = tr.train_step(batch, _key(9)), tr2.train_step(batch, _key(9))
    assert m1 == m2


def test_restore_on_empty_dir_returns_none(tmp_path, sys4):
    assert RLTrainer(n_stages=4, system=sys4, hidden=32, seed=0, device=CPU).restore(
        tmp_path) is None


def test_labeled_dataset_batch_is_padded(tmp_path, sys4):
    from repro_torch.data import LabeledDagDataset
    ds = LabeledDagDataset(count=8, n=20, n_stages=4, seed=0, label_method="dp", system=sys4,
                           cache_dir=tmp_path, device=CPU)
    batch = ds.batch(0, 4)
    assert isinstance(batch, PaddedGraphBatch)
    assert batch.bucket_n == 32 and batch.has_labels
    assert batch.n_valid.tolist() == [20] * 4
    tr = RLTrainer(n_stages=4, system=sys4, hidden=32, seed=0, device=CPU)
    assert np.isfinite(list(tr.train_step(batch, _key(0)).values())).all()


def test_prefetch_preserves_order_and_propagates_errors():
    assert list(prefetch(iter(range(5)), depth=2)) == [0, 1, 2, 3, 4]

    def boom():
        yield 1
        raise RuntimeError("label solver died")

    it = prefetch(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="label solver died"):
        next(it)


def test_data_parallel_trainer_needs_a_world(sys4):
    with pytest.raises(ValueError, match="world of 4 ranks.*run_ranks"):
        RLTrainer(n_stages=4, system=sys4, hidden=16, n_devices=4, device=CPU)
