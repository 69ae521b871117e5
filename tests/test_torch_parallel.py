"""The port's data-parallel training (``repro_torch.parallel.data``,
``RLTrainer(n_devices=n)``) and the ``train_respect`` twin, on the CPU with
spawned gloo ranks.

* The reference's data-parallel test (``tests/test_train_engine.py``: 8
  graphs of 10-25 nodes, hidden 16, lr 3e-3, 3 steps, keys from
  ``split``): 2 and 4 ranks against the single-process port and against
  the reference's single-device ``RLTrainer``.  Parameters within 1e-5 (the
  reference's bound for psum reordering), ``reward_sample`` within 1e-6,
  every rank's parameters equal (replicated); each rank's slice of the
  sampled and greedy-baseline orders and assignments equals the
  single-process step's rows (the rank takes its slice of the global key
  split, never a split of its own).
* A global batch that the world does not divide raises ``ValueError`` (from
  the ranks, with the reference's wording); a run past its timeout kills
  its ranks and raises; the placement refusals.
* The label cache is written atomically: threads labelling the same graphs
  into one cache all read whole labels.
* ``python -m repro_torch.train_respect`` at hidden 16 for 4 steps, stopped
  at 2 and resumed, equals the uninterrupted run in parameters and sampler
  state; its 2-rank run equals the single-process run within 1e-5.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import PipelineSystem as JaxPipelineSystem
from repro.core import rl as jrl
from repro.core import sample_dag as jax_sample_dag
from repro_torch.checkpoint import load_pytree_dict
from repro_torch.core import PipelineSystem, sample_dag
from repro_torch.core import rl as trl
from repro_torch.core.ptrnet import params_to_numpy
from repro_torch.parallel import data as pdata
from repro_torch import train_respect

torch.set_num_threads(1)

K = 4
STEPS = 3
TOL_PARAM = 1e-5
TOL_REWARD = 1e-6
TRAINER = dict(hidden=16, lr=3e-3, seed=0)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _max_diff(a: dict, b: dict) -> float:
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb)
    return max(float(np.abs(la[k].astype(np.float64) - lb[k]).max()) for k in la)


@pytest.fixture(scope="module")
def runs():
    """The reference's setup, run by the reference's single-device trainer
    and by the single-process port, with each step's rollouts recorded."""
    graphs = {}
    for name, sampler in (("jax", jax_sample_dag), ("torch", sample_dag)):
        rng = np.random.default_rng(0)
        graphs[name] = [sampler(rng, n=int(rng.integers(10, 25)), deg=3) for _ in range(8)]
    jsys, tsys = JaxPipelineSystem(n_stages=K), PipelineSystem(n_stages=K)
    jb = jrl.pack_graphs(graphs["jax"], K, jsys, label_method="dp")
    tb = trl.pack_graphs(graphs["torch"], K, tsys, label_method="dp", device="cpu")
    key, keys = jax.random.PRNGKey(0), []
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        keys.append(np.asarray(k))
    jtr = jrl.RLTrainer(n_stages=K, system=jsys, **TRAINER)
    ttr = trl.RLTrainer(n_stages=K, system=tsys, device="cpu", **TRAINER)
    ref, single = {"metrics": [], "rollouts": []}, {"metrics": [], "rollouts": []}
    for k in keys:
        split = jax.random.split(jax.numpy.asarray(k), jb.batch)
        s = jrl._policy_rewards(jtr.state.params, jb, split, K, jsys, True, True)
        b = jrl._policy_rewards(jtr.state.baseline_params, jb, split, K, jsys, True, False)
        ref["rollouts"].append({f"{p}_{f}": np.asarray(v[i]) for p, v in
                                (("sample", s), ("baseline", b))
                                for i, f in ((0, "rewards"), (3, "order"), (4, "assign"))})
        ref["metrics"].append(jtr.train_step(jb, k))
        ts = trl._split(k, tb.batch)
        with torch.no_grad():
            s = trl._policy_rewards(ttr.params, tb, ts, K, tsys, True)
            b = trl._policy_rewards(ttr.baseline_params, tb, ts, K, tsys, False,
                                    trl._resolve(ttr.baseline_params, tb, False))
        single["rollouts"].append({f"{p}_{f}": v[i].numpy() for p, v in
                                   (("sample", s), ("baseline", b))
                                   for i, f in ((0, "rewards"), (3, "order"), (4, "assign"))})
        single["metrics"].append(ttr.train_step(tb, k))
    ref["params"] = jax.tree.map(np.asarray, jtr.params)
    single["params"] = params_to_numpy(ttr.params)
    return {"tb": tb, "keys": keys, "tsys": tsys, "valid": tb.valid_mask().numpy(),
            "ref": ref, "single": single}


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_data_parallel_matches_single_process_and_reference(runs, n_ranks):
    out = trl.train_data_parallel([runs["tb"]] * STEPS, runs["keys"], n_ranks, backend="gloo",
                                  device="cpu", n_stages=K, record=True, timeout_s=300,
                                  system=runs["tsys"], **TRAINER)
    assert [o["rank"] for o in out] == list(range(n_ranks))
    valid = runs["valid"]
    for o in out:
        assert _max_diff(o["params"], out[0]["params"]) == 0.0      # replicated
        assert _max_diff(o["params"], runs["single"]["params"]) < TOL_PARAM
        assert _max_diff(o["params"], runs["ref"]["params"]) < TOL_PARAM
        for got, want_t, want_j in zip(o["metrics"], runs["single"]["metrics"],
                                       runs["ref"]["metrics"]):
            assert got["reward_sample"] == pytest.approx(want_t["reward_sample"],
                                                         abs=TOL_REWARD)
            assert got["reward_sample"] == pytest.approx(want_j["reward_sample"],
                                                         abs=TOL_REWARD)
            assert got["n_graphs"] == want_t["n_graphs"] == 8.0
    per = valid.shape[0] // n_ranks
    for step in range(STEPS):
        for f in ("sample_order", "sample_assign", "baseline_order", "baseline_assign",
                  "sample_rewards", "baseline_rewards"):
            got = np.concatenate([o["rollouts"][step][f] for o in out])
            assert got.shape[0] == per * n_ranks
            for want in (runs["single"]["rollouts"][step][f], runs["ref"]["rollouts"][step][f]):
                if f.endswith("order"):
                    got_m, want = np.where(valid, got, -1), np.where(valid, want, -1)
                else:
                    got_m = got
                assert np.array_equal(got_m, np.asarray(want)), (step, f)


def test_undivided_batch_and_timeout_fail_the_run(runs):
    # 8 graphs over 3 ranks: every rank raises, the caller gets the ValueError
    with pytest.raises(ValueError, match="global batch 8 not divisible by 3 devices") as ei:
        trl.train_data_parallel([runs["tb"]], runs["keys"][:1], 3, backend="gloo",
                                device="cpu", n_stages=K, timeout_s=300, system=runs["tsys"],
                                **TRAINER)
    assert any("rank" in note and "Traceback" in note for note in ei.value.__notes__)
    # a run past its timeout kills its ranks and raises
    with pytest.raises(pdata.RankFailure, match="did not finish within"):
        trl.train_data_parallel([runs["tb"]], runs["keys"][:1], 2, backend="gloo",
                                device="cpu", n_stages=K, timeout_s=0.5, system=runs["tsys"],
                                **TRAINER)


def test_rank_slices_and_placement(runs):
    tb, keys = runs["tb"], trl._split(runs["keys"][0], 8)
    parts = [pdata.rank_slice(tb, r, 4) for r in range(4)]
    assert all(p.batch == 2 and p.label_stages == tb.label_stages for p in parts)
    assert torch.equal(torch.cat([p.feats for p in parts]), tb.feats)
    assert torch.equal(torch.cat([p.label_assign for p in parts]), tb.label_assign)
    assert np.array_equal(np.concatenate([pdata.rank_slice(keys, r, 4) for r in range(4)]),
                          keys)
    with pytest.raises(ValueError, match="not divisible"):
        pdata.rank_slice(tb, 0, 3)
    assert pdata.rank_device(1, 4, "gloo", "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="nccl"):
        pdata.rank_device(0, 2, "nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        pdata.rank_device(0, 2, "mpi", "cpu")
    if not torch.cuda.is_available():   # a rank never carries on on the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pdata.rank_device(0, 2, "gloo", "cuda", share_device=True)
    assert pdata.current_world() is None


def test_label_cache_writes_are_atomic(tmp_path, runs):
    rng = np.random.default_rng(5)
    graphs = [sample_dag(rng, n=int(rng.integers(8, 20)), deg=3) for _ in range(6)]
    want, _ = trl.label_graphs(graphs, K, runs["tsys"], device="cpu")
    results, errors = [], []

    def work():
        try:
            results.append(trl.label_graphs(graphs, K, runs["tsys"], cache_dir=tmp_path,
                                            device="cpu")[0])
        except BaseException as e:   # noqa: BLE001 - collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(results) == 6
    for got in results + [trl.label_graphs(graphs, K, runs["tsys"], cache_dir=tmp_path,
                                           device="cpu")[0]]:
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".npz"] * 6


def _train_respect(tmp_path, name, steps, *extra):
    args = ["--hidden", "16", "--batch", "8", "--n-min", "5", "--n-max", "20",
            "--eval-every", "2", "--save-every", "2", "--device", "cpu",
            "--label-cache", str(tmp_path / "labels"), "--ckpt-dir", str(tmp_path / name),
            "--out", str(tmp_path / f"{name}_out"),
            "--metrics", str(tmp_path / f"{name}.jsonl"), "--steps", str(steps), *extra]
    assert train_respect.main(args) == 0
    state = json.loads((tmp_path / name / "sampler_state.json").read_text())
    return load_pytree_dict(tmp_path / f"{name}_out"), state


def test_train_respect_resume_equals_uninterrupted(tmp_path):
    whole, whole_state = _train_respect(tmp_path, "whole", 4)
    _, half_state = _train_respect(tmp_path, "resumed", 2)
    resumed, resumed_state = _train_respect(tmp_path, "resumed", 4)
    assert half_state != whole_state and resumed_state == whole_state
    assert _max_diff(resumed, whole) == 0.0
    steps = [json.loads(line)["step"]
             for line in (tmp_path / "resumed.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3, 4]


def test_train_respect_two_ranks_match_one(tmp_path):
    one, one_state = _train_respect(tmp_path, "one", 4)
    _train_respect(tmp_path, "two", 2, "--devices", "2", "--backend", "gloo")
    two, two_state = _train_respect(tmp_path, "two", 4, "--devices", "2", "--backend", "gloo")
    assert two_state == one_state
    assert _max_diff(two, one) < TOL_PARAM
