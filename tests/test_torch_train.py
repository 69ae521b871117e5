"""The port's RL training engine against the JAX package's (``repro.core.rl``).

The same seeded graphs (numpy) go through both packages on the CPU at a
small size (hidden 16, |V| 5-16).  Integer outputs — labels, packs, orders,
stage assignments — and the per-graph rewards (cosines of small-integer
vectors, exact in float32) must be equal.  Float tolerances, each for
float32 sums taken in another order:

* loss and metric means: 1e-5 relative (1e-6 absolute for the rewards'
  means, whose sums over graphs may round in another order);
* each gradient leaf: 1e-4 x max(1, max |g|);
* parameters after an update: 1e-6 absolute at lr 3e-4 (Adam's first step
  moves a parameter by lr * g / (|g| + eps), so a gradient error of
  delta moves it by at most lr / eps * delta: 3e4 x ~1e-11);
* checkpoints: bit for bit.

The golden file ``tests/golden/torch_train_steps.json``
(``scripts/make_train_golden.py``) holds the first three steps of
respect-v1's training configuration; the port reproduces it here on the
CPU and in ``chip_smoke.py`` on the card.
"""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro import optim as joptim
from repro.checkpoint.release import verify_release as jax_verify_release
from repro.checkpoint.release import write_release as jax_write_release
from repro.core import rl as jrl
from repro.core import segment as jsegment
from repro_torch import optim as toptim
from repro_torch.checkpoint import CheckpointManager, verify_release, write_release
from repro_torch.checkpoint.manager import flatten_leaves
from repro_torch.core import rl as trl
from repro_torch.core import segment as tsegment
from repro_torch.core.ptrnet import param_tree, params_from_numpy
from repro_torch.kernels.ptr import ops as ptr_ops
from repro_torch.kernels.ptr.decode import decode_batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "torch_train_steps.json"
H = 16
K = 4
LR = 3e-4
FIELDS = ("feats", "parent_mat", "flops", "param_bytes", "out_bytes", "n_valid",
          "label_assign", "label_order")
SYSTEMS = {
    "uniform": dict(n_stages=K),
    "hetero": dict(n_stages=K, compute_rate=(4e12, 2e12, 4e12, 8e12),
                   link_bw=(320e6, 160e6, 320e6, 640e6)),
    "memcap": dict(n_stages=K, mem_capacity=(4e6, 6e6, 8e6, 1e7)),
}


def _graphs(pkg, seed=0, count=6, lo=5, hi=16):
    rng = np.random.default_rng(seed)
    return [pkg.sample_dag(rng, n=int(rng.integers(lo, hi + 1)), deg=int(rng.integers(2, 5)))
            for _ in range(count)]


def _same_pack(jb, tb):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(jb, f)), getattr(tb, f).numpy()), f
    assert jb.dense == tb.dense


def _leaves(tree) -> dict:
    """Leaf name -> numpy array of a JAX pytree (the checkpoint names)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf) for path, leaf in flat}


def _params_close(jparams, net, atol=1e-6):
    tl = dict(flatten_leaves(param_tree(net)))
    jl = _leaves(jparams)
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=0, atol=atol, err_msg=k)


def _metrics_close(jm, tm):
    assert set(jm) == set(tm)
    for k in jm:
        tol = 1e-6 if k.startswith("reward") else 1e-5 * max(1.0, abs(float(jm[k])))
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=0, abs=tol), k


@pytest.fixture(scope="module")
def data():
    jg, tg = _graphs(jcore), _graphs(tcore)
    jsys, tsys = jcore.PipelineSystem(K), tcore.PipelineSystem(K)
    return {"jg": jg, "tg": tg, "jsys": jsys, "tsys": tsys,
            "jb": jrl.pack_graphs(jg, K, jsys), "tb": trl.pack_graphs(tg, K, tsys, device="cpu")}


def _init(lr=LR):
    jopt, topt = joptim.adamw(lr), toptim.adamw(lr)
    key = jax.random.PRNGKey(0)
    F = jcore.embed_dim()
    return (jopt, jrl.init_train_state(key, F, H, jopt),
            topt, trl.init_train_state(np.asarray(key), F, H, topt, device="cpu"))


# --------------------------------------------------------------------- #
# labels, cache keys, packs and the sampler's stream
# --------------------------------------------------------------------- #
def test_labels_match_reference_and_host_exact_dp(data):
    """Mixed sizes in one bucket: the device DP labeller equals the
    reference's labeller and the host ``exact_dp``; the batched
    ``exact_dp_batch`` equals the reference's, bottleneck included."""
    jla, jlo = jrl.label_graphs(data["jg"], K, data["jsys"])
    tla, tlo = trl.label_graphs(data["tg"], K, data["tsys"], device="cpu")
    for g, ja, jo, ta, to in zip(data["tg"], jla, jlo, tla, tlo):
        assert np.array_equal(ja, ta) and np.array_equal(jo, to)
        assert np.array_equal(ta, tcore.exact_dp(g, K, data["tsys"])[0])
    jb, tb = data["jb"], data["tb"]
    ja, jbott = jsegment.exact_dp_batch(jb.flops, jb.param_bytes, jb.out_bytes, jb.parent_mat,
                                        K, data["jsys"], jb.n_valid)
    ta, tbott = tsegment.exact_dp_batch(tb.flops, tb.param_bytes, tb.out_bytes, tb.parent_mat,
                                        K, data["tsys"], tb.n_valid)
    valid = tb.valid_mask()
    assert torch.equal(torch.where(valid, ta, 0),
                       torch.where(valid, torch.tensor(np.asarray(ja)).long(), 0))
    np.testing.assert_allclose(tbott.numpy(), np.asarray(jbott), rtol=1e-6)
    one_a, one_b = tsegment.exact_dp(tb.flops[0], tb.param_bytes[0], tb.out_bytes[0],
                                     tb.parent_mat[0], K, data["tsys"], tb.n_valid[0])
    assert torch.equal(one_a, ta[0]) and float(one_b) == float(tbott[0])


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_label_cache_key_equals_reference(name):
    jg, tg = _graphs(jcore, seed=5, count=2), _graphs(tcore, seed=5, count=2)
    jsys, tsys = jcore.PipelineSystem(**SYSTEMS[name]), tcore.PipelineSystem(**SYSTEMS[name])
    for a, b in zip(jg, tg):
        for method, budget in (("dp", 0.25), ("bb", 0.5)):
            assert (trl._label_cache_key(b, K, tsys, method, 6, budget)
                    == jrl._label_cache_key(a, K, jsys, method, 6, budget))


def test_label_cache_is_shared_with_reference(tmp_path, data):
    """Labels the reference cached are read by the port (no new file)."""
    jrl.label_graphs(data["jg"], K, data["jsys"], cache_dir=tmp_path)
    files = sorted(p.name for p in tmp_path.glob("*.npz"))
    assert len(files) == len(data["jg"])
    tla, _ = trl.label_graphs(data["tg"], K, data["tsys"], cache_dir=tmp_path, device="cpu")
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == files
    for a, b in zip(jrl.label_graphs(data["jg"], K, data["jsys"])[0], tla):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("pad", [True, False])
def test_pack_graphs_equals_reference(data, pad):
    _same_pack(jrl.pack_graphs(data["jg"], K, data["jsys"], pad=pad),
               trl.pack_graphs(data["tg"], K, data["tsys"], pad=pad, device="cpu"))


def test_pad_batch_pads_labels_with_inert_rows(data):
    jp, tp = data["jb"].pad_batch(8), data["tb"].pad_batch(8)
    _same_pack(jp, tp)
    assert int(tp.n_valid[-1]) == 0 and not tp.dense


@pytest.mark.parametrize("kw", [dict(curriculum=True, batches_per_epoch=3),
                                dict(batch_divisor=8, batches_per_epoch=2),
                                dict(bucket=False, pad_batch_dim=False, batches_per_epoch=2)],
                         ids=["curriculum", "divisor", "unbucketed"])
def test_packed_stream_equals_reference_and_resumes(kw):
    js, ts = jcore.DagSampler(seed=3, n=(5, 16)), tcore.DagSampler(seed=3, n=(5, 16))
    jp = list(js.packed_stream(6, K, epochs=1, **kw))
    tp = list(ts.packed_stream(6, K, epochs=1, device="cpu", **kw))
    assert len(jp) == len(tp) > 1
    for a, b in zip(jp, tp):
        _same_pack(a, b)
    # a sampler restored mid-stream continues the reference's stream
    tr = tcore.DagSampler(seed=0, n=(5, 16))
    tr.restore({"seed": 3, "count": 1})
    js2 = jcore.DagSampler(seed=3, n=(5, 16))
    js2.restore({"seed": 3, "count": 1})
    for a, b in zip(js2.packed_stream(6, K, epochs=1, **kw),
                    tr.packed_stream(6, K, epochs=1, device="cpu", **kw)):
        _same_pack(a, b)


def test_next_packed_batch_and_dataset_equal_reference(tmp_path):
    for pad, n in (("auto", 12), ("auto", (5, 16)), (True, 12)):
        _same_pack(jcore.DagSampler(seed=1, n=n).next_packed_batch(5, K, pad=pad),
                   tcore.DagSampler(seed=1, n=n).next_packed_batch(5, K, pad=pad, device="cpu"))
    from repro.data import LabeledDagDataset as JDataset
    from repro_torch.data import LabeledDagDataset as TDataset
    kw = dict(count=6, n=12, n_stages=K, seed=0, label_method="dp")
    jd = JDataset(cache_dir=tmp_path / "j", system=jcore.PipelineSystem(K), **kw)
    td = TDataset(cache_dir=tmp_path / "t", system=tcore.PipelineSystem(K), device="cpu", **kw)
    assert jd._cache_path().name == td._cache_path().name
    _same_pack(jd.batch(2, 4), td.batch(2, 4))
    # the port reads the reference's dataset cache
    td2 = TDataset(cache_dir=tmp_path / "j", system=tcore.PipelineSystem(K), **kw)
    _same_pack(jd.batch(3, 4), td2.batch(3, 4))


# --------------------------------------------------------------------- #
# one step, a trajectory, rollouts and eval
# --------------------------------------------------------------------- #
def test_train_step_matches_reference(data):
    jopt, jst, topt, tst = _init()
    jb, tb = data["jb"], data["tb"]
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, jb.batch)
    # sampled orders and per-graph rewards: equal
    jr, _, _, jo, ja = jrl._policy_rewards(jst.params, jb, keys, K, data["jsys"], True, True)
    tr, _, _, to, ta = trl.make_rollout_fn(K, data["tsys"], sample=True)(
        tst.params, tb, np.asarray(key))
    assert np.array_equal(np.where(np.asarray(jb.valid_mask()), np.asarray(jo), -1),
                          torch.where(tb.valid_mask(), to, -1).numpy())
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.asarray(jr).tobytes() == tr.numpy().tobytes()
    # loss and gradients
    (jl, jsums), jg = jax.value_and_grad(jrl._sum_loss_fn, has_aux=True)(
        jst.params, jst.baseline_params, jb, keys, K, data["jsys"], True, 0.0)
    tl, tsums, tg = trl.sum_loss_and_grads(tst.params, tst.baseline_params, tb,
                                           np.asarray(key), K, data["tsys"])
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _metrics_close(jsums, tsums)
    tgl = dict(flatten_leaves(tg))
    for name, g in _leaves(jg).items():
        np.testing.assert_allclose(tgl[name], g, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(g).max())), err_msg=name)
    # the update
    jp, _, jm = jrl.make_train_step(K, data["jsys"], jopt)(
        jst.params, jst.baseline_params, jst.opt_state, jb, key)
    _, tos, tm = trl.make_train_step(K, data["tsys"], topt)(
        tst.params, tst.baseline_params, tst.opt_state, tb, np.asarray(key))
    _metrics_close(jm, tm)
    _params_close(jp, tst.params)
    assert int(tos.step) == 1


def test_trajectory_across_stage_counts_and_a_heterogeneous_step(data):
    """Three steps of RLTrainer alternating k = 4, 3, 4, then one step
    under a heterogeneous system with an entropy bonus, where ``w_sys``
    gets a gradient (the small graphs' sampled and greedy rewards tie
    there, so the entropy term carries it)."""
    jt = jrl.RLTrainer(hidden=H, lr=LR, seed=0, stage_counts=(4, 3))
    tt = trl.RLTrainer(hidden=H, lr=LR, seed=0, stage_counts=(4, 3), device="cpu")
    packs = {k: (jrl.pack_graphs(data["jg"], k, data["jsys"]),
                 trl.pack_graphs(data["tg"], k, data["tsys"], device="cpu")) for k in (3, 4)}
    for i, k in enumerate((4, 3, 4)):
        key = jax.random.fold_in(jax.random.PRNGKey(1), i)
        jm = jt.train_step(packs[k][0], key, n_stages=k)
        tm = tt.train_step(packs[k][1], np.asarray(key), n_stages=k)
        _metrics_close(jm, tm)
        _params_close(jt.params, tt.params)
    assert tt.step_count == jt.step_count == 3
    hs = SYSTEMS["hetero"]
    jsys, tsys = jcore.PipelineSystem(**hs), tcore.PipelineSystem(**hs)
    jb, tb = jrl.pack_graphs(data["jg"], K, jsys), trl.pack_graphs(data["tg"], K, tsys,
                                                                  device="cpu")
    key = jax.random.PRNGKey(9)
    w_before = tt.params.w_sys.detach().clone()
    jp, _, jm = jrl.make_train_step(K, jsys, jt.optimizer, entropy_coef=0.01)(
        jt.params, jt.baseline_params, jt.opt_state, jb, key)
    _, _, tm = trl.make_train_step(K, tsys, tt.optimizer, entropy_coef=0.01)(
        tt.params, tt.baseline_params, tt.opt_state, tb, np.asarray(key))
    _metrics_close(jm, tm)
    _params_close(jp, tt.params)
    assert not torch.equal(tt.params.w_sys, w_before)


def test_pack_labelled_for_another_stage_count_is_refused(data):
    """A pack records the stage count of its labels, through ``to`` and
    ``pad_batch``; a step, an eval or a rollout at another count raises
    before it decodes."""
    tb = data["tb"]
    assert tb.label_stages == K and tb.pad_batch(8).to("cpu").label_stages == K
    tt = trl.RLTrainer(hidden=H, lr=LR, seed=0, stage_counts=(2, K), device="cpu")
    before = [p.detach().clone() for p in tt.params.parameters()]
    for call in (lambda: tt.train_step(tb, tcore.prng.PRNGKey(0)),
                 lambda: tt.evaluate(tb),
                 lambda: trl.make_rollout_fn(2, data["tsys"])(tt.params, tb,
                                                             tcore.prng.PRNGKey(0))):
        with pytest.raises(ValueError, match=f"labels are for {K} stages"):
            call()
    assert tt.step_count == 0
    assert all(torch.equal(a, b) for a, b in zip(before, tt.params.parameters()))
    tt.train_step(tb, tcore.prng.PRNGKey(0), n_stages=K)
    assert tt.step_count == 1


def test_inert_rows_carry_zero_weight(data):
    """Batch padding (``n_valid == 0`` rows) moves neither the metrics nor
    the gradients, in both packages."""
    _, jst, _, tst = _init()
    key = jax.random.PRNGKey(3)
    tb, tp = data["tb"], data["tb"].pad_batch(8)
    l1, s1, g1 = trl.sum_loss_and_grads(tst.params, tst.baseline_params, tb, np.asarray(key),
                                        K, data["tsys"])
    # the pad rows take keys split(key, 8)[6:]; the real rows' keys differ
    # from split(key, 6), so hold the padded step to the reference's padded
    # step, and its weights to the unpadded count
    l2, s2, g2 = trl.sum_loss_and_grads(tst.params, tst.baseline_params, tp, np.asarray(key),
                                        K, data["tsys"])
    jp = data["jb"].pad_batch(8)
    (jl, jsums), _ = jax.value_and_grad(jrl._sum_loss_fn, has_aux=True)(
        jst.params, jst.baseline_params, jp, jax.random.split(key, 8), K, data["jsys"], True,
        0.0)
    assert float(s2["n_graphs"]) == float(s1["n_graphs"]) == 6.0
    _metrics_close(jsums, s2)
    assert float(l2) == pytest.approx(float(jl), rel=1e-5)
    ev = trl.make_eval_fn(K, data["tsys"])
    m1, m2 = ev(tst.params, tb), ev(tst.params, tp)
    assert all(float(m1[k]) == float(m2[k]) for k in m1)


@pytest.mark.parametrize("impl", [None, "kernel"])
@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_rollout_matches_reference(data, impl, sample):
    _, jst, _, tst = _init()
    key = jax.random.PRNGKey(11)
    jr, jlp, jent, jo, ja = jrl.make_rollout_fn(K, data["jsys"], sample=sample)(
        jst.params, data["jb"], key)
    tr, tlp, tent, to, ta = trl.make_rollout_fn(K, data["tsys"], sample=sample,
                                                decode_impl=impl)(
        tst.params, data["tb"], np.asarray(key))
    valid = data["tb"].valid_mask()
    assert np.array_equal(np.where(valid.numpy(), np.asarray(jo), -1),
                          torch.where(valid, to, -1).numpy())
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.asarray(jr).tobytes() == tr.numpy().tobytes()
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tent.numpy(), np.asarray(jent), rtol=1e-5, atol=1e-5)


def test_eval_matches_reference_and_kernel_refuses_conditioned_system(data):
    _, jst, _, tst = _init()
    for name in ("uniform", "hetero"):
        jsys, tsys = jcore.PipelineSystem(**SYSTEMS[name]), tcore.PipelineSystem(**SYSTEMS[name])
        jb = jrl.pack_graphs(data["jg"], K, jsys)
        tb = trl.pack_graphs(data["tg"], K, tsys, device="cpu")
        jm = jrl.make_eval_fn(K, jsys)(jst.params, jb)
        tm = trl.make_eval_fn(K, tsys)(tst.params, tb)
        assert float(tm["exact_match"]) == float(jm["exact_match"])
        assert float(tm["reward_greedy"]) == pytest.approx(float(jm["reward_greedy"]), abs=1e-6)
    with pytest.raises(ValueError, match="heterogeneous"):
        trl.make_rollout_fn(K, tcore.PipelineSystem(**SYSTEMS["hetero"]), decode_impl="kernel")
    with pytest.raises(ValueError, match="run_ranks"):   # data parallel needs a world
        trl.RLTrainer(hidden=H, n_devices=2, device="cpu")


# --------------------------------------------------------------------- #
# the gradient guard
# --------------------------------------------------------------------- #
def test_kernel_wrappers_refuse_grad_and_plain_decode_differentiates(data):
    _, _, _, tst = _init()
    net, tb = tst.params, data["tb"]
    C, (h0, c0), emb = net.encode(tb.feats, tb.n_valid)
    with pytest.raises(RuntimeError, match="no gradient"):
        decode_batch(net, C, emb, h0, c0, tb.parent_mat, tb.n_valid)
    with pytest.raises(RuntimeError, match="no gradient"):
        ptr_ops.make_logits_fn(net, C)(h0, tb.valid_mask())
    with torch.no_grad():       # forward-only calls still run
        decode_batch(net, C, emb, h0, c0, tb.parent_mat, tb.n_valid)
    _, logp, _ = net.decode(C, emb, (h0, c0), tb.parent_mat, n_valid=tb.n_valid)
    logp.sum().backward()
    for head in (net.glimpse, net.pointer):
        assert head.w_q.grad is not None and float(head.w_q.grad.abs().sum()) > 0


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")


@pytest.mark.cuda
def test_trainer_gradients_reach_the_heads_on_cuda():
    """On the card the baseline runs B1 and the sampled pass stays off the
    kernels: the loss's gradient is non-zero on the glimpse and pointer
    heads, and B1 launched."""
    _need_cuda()
    tt = trl.RLTrainer(hidden=128, lr=LR, seed=0)
    pack = tcore.DagSampler(seed=0, n=(5, 30)).next_packed_batch(16, K)
    before = dict(ptr_ops.LAUNCHES)
    _, _, grads = trl.sum_loss_and_grads(tt.params, tt.baseline_params, pack,
                                         tcore.prng.PRNGKey(0), K, tt.system)
    assert ptr_ops.LAUNCHES["ptr_decode_cluster"] > before["ptr_decode_cluster"]
    for head in ("glimpse", "pointer"):
        for leaf in ("w_q", "w_ref", "v"):
            assert float(grads[head][leaf].abs().sum()) > 0, (head, leaf)


# --------------------------------------------------------------------- #
# checkpoints and releases across packages
# --------------------------------------------------------------------- #
def test_trainer_checkpoints_restore_across_packages(tmp_path, data):
    jt = jrl.RLTrainer(hidden=H, lr=LR, seed=0)
    jt.train_step(data["jb"], jax.random.PRNGKey(0))
    jt.consider_baseline(0.5)
    jt.save(tmp_path / "jax")
    tt = trl.RLTrainer(hidden=H, lr=LR, seed=7, device="cpu")
    assert tt.restore(tmp_path / "jax") == 1
    want = _leaves(jt.state)
    got = dict(flatten_leaves(tt.state.tree()))
    assert len(want) == 67 and want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].tobytes() == got[k].tobytes(), k
    # both continue alike, and the port's checkpoint restores in the reference
    key = jax.random.PRNGKey(4)
    _metrics_close(jt.train_step(data["jb"], key), tt.train_step(data["tb"], np.asarray(key)))
    tt.save(tmp_path / "port", blocking=False)
    tt._manager(tmp_path / "port").wait()
    jt2 = jrl.RLTrainer(hidden=H, lr=LR, seed=3)
    assert jt2.restore(tmp_path / "port") == 2
    got, want = _leaves(jt2.state), dict(flatten_leaves(tt.state.tree()))
    for k in want:
        assert want[k].tobytes() == got[k].tobytes(), k
    assert trl.RLTrainer(hidden=H, device="cpu").restore(tmp_path / "empty") is None


def test_checkpoint_manager_steps_latest_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(3, dtype=torch.float32), "b": {"c": torch.zeros(2, 2)}}
    for step in (1, 2, 3):
        tree["a"] += 1
        mgr.save(step, tree, blocking=step != 2)
        mgr.wait()
    (tmp_path / "step_00000009.tmp").mkdir()        # an interrupted save
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert (tmp_path / "LATEST").read_text() == "step_00000003"
    step, got = mgr.restore_latest(tree)
    assert step == 3 and torch.equal(got["a"], tree["a"]) and got["b"]["c"].shape == (2, 2)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(3, {"a": torch.zeros(4), "b": {"c": torch.zeros(2, 2)}})


def test_write_release_is_verified_by_both_packages(tmp_path):
    tt = trl.RLTrainer(hidden=H, seed=0, device="cpu")
    meta = {"version": "respect-v9", "config": {"hidden": H}, "train": {"steps": 0}}
    manifest = write_release(param_tree(tt.params), tmp_path / "respect-v9", meta)
    params, m = verify_release(tmp_path / "respect-v9")
    jparams, jm = jax_verify_release(tmp_path / "respect-v9")
    assert m == jm == manifest
    assert params_from_numpy(params).w_in.shape == (jcore.embed_dim(), H)
    jax_write_release(jax.tree.map(jnp.asarray, _leaves_tree(jparams)), tmp_path / "respect-v8",
                      dict(meta, version="respect-v8"))
    assert verify_release(tmp_path / "respect-v8")[1]["params_sha256"] == m["params_sha256"]


def _leaves_tree(tree):
    return {k: _leaves_tree(v) if isinstance(v, dict) else v for k, v in tree.items()}


# --------------------------------------------------------------------- #
# the golden file: respect-v1's training configuration, three steps
# --------------------------------------------------------------------- #
def _int_digest(a) -> str:
    return hashlib.sha256(np.asarray(a, dtype=np.int64).tobytes()).hexdigest()


def _f32_digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype="<f4").tobytes()).hexdigest()


def _golden_run(device):
    """The port through the golden file's three steps on ``device``; one
    comparable record a step."""
    gold = json.loads(GOLDEN.read_text())
    c = gold["meta"]["config"]
    system = tcore.PipelineSystem(c["n_stages"])
    tt = trl.RLTrainer(system=system, hidden=c["hidden"], lr=c["lr"], seed=c["seed"],
                       stage_counts=tuple(c["stage_counts"]), device=device)
    stream = tcore.DagSampler(seed=c["seed"], n=tuple(c["n"])).packed_stream(
        c["batch"], c["n_stages"], system=system, device=device)
    root = tcore.prng.PRNGKey(c["key_seed"])
    for i, want in enumerate(gold["steps"]):
        pack, key = next(stream), tcore.prng.fold_in(root, i)
        got = {"bucket_n": pack.bucket_n, "batch": pack.batch,
               "n_valid_sha256": _int_digest(pack.n_valid),
               "label_assign_sha256": _int_digest(pack.label_assign)}
        for prefix, net, sample in (("sample", tt.params, True),
                                    ("baseline", tt.baseline_params, False)):
            r, _, _, o, a = trl.make_rollout_fn(c["n_stages"], system, sample=sample)(
                net, pack, key)
            valid = pack.valid_mask().to(o.device)
            got[f"{prefix}_order_sha256"] = _int_digest(torch.where(valid, o, -1).cpu())
            got[f"{prefix}_assign_sha256"] = _int_digest(a.cpu())
            got[f"{prefix}_rewards_sha256"] = _f32_digest(r.cpu())
        got["metrics"] = tt.train_step(pack, key, n_stages=c["n_stages"])
        after = dict(flatten_leaves(param_tree(tt.params)))
        got["leaf_norms"] = {k: float(np.linalg.norm(v.astype(np.float64)))
                             for k, v in after.items()}
        got["entries"] = [float(after[e["leaf"]].reshape(-1)[e["index"]])
                          for e in want["entries"]]
        yield want, got


def _check_golden_step(want, got, param_tol):
    for k, v in want.items():
        if k.endswith("sha256") or k in ("bucket_n", "batch"):
            assert got[k] == v, k
    _metrics_close(want["metrics"], got["metrics"])
    for k, v in want["leaf_norms"].items():
        assert got["leaf_norms"][k] == pytest.approx(v, rel=1e-5), k
    for e, g in zip(want["entries"], got["entries"]):
        assert g == pytest.approx(e["value"], abs=param_tol), e


def test_port_reproduces_train_golden_on_cpu():
    for want, got in _golden_run("cpu"):
        _check_golden_step(want, got, 1e-6)


@pytest.mark.cuda
def test_port_reproduces_train_golden_on_cuda():
    """The same three steps on the card: B1 in the baseline; parameters
    within 1e-5 (float32 sums in another order, through Adam's lr / eps)."""
    _need_cuda()
    for want, got in _golden_run(None):
        _check_golden_step(want, got, 1e-5)
