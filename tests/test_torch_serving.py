"""The port's serving path end to end on the CPU.

* ``RespectScheduler.from_release(device="cpu").schedule_many`` on the ten
  Table-I graphs reproduces every ``order_sha256`` and ``assign_sha256``
  pinned in ``tests/golden/dnn_schedules.json``;
* on 32 mixed-size synthetic graphs it equals the reference's
  ``RespectScheduler.from_release().schedule_many`` integer for integer,
  for a uniform, a heterogeneous and a memory-capped system;
* at hidden 96, a width the reference's whole-decode kernel refuses (the
  port's takes it), a scheduler built from the reference's seeded
  ``init_params`` equals the reference's ``RespectScheduler`` with those
  parameters, uniform and heterogeneous;
* cache hits return copies; without CUDA, entry points raise unless given
  ``device="cpu"``;
* seeded weights are the reference's: ``RespectScheduler.init(seed)``,
  ``from_release`` without a release and ``fallback_schedule_many`` give
  the reference's orders and assignments, uniform and heterogeneous;
  ``greedy_order``/``sample_order`` (both decode choices, padded and
  unpadded) give its orders on the corpus of ``tests/test_decode_parity.py``
  (logp and entropy within 1e-4);
* ``tests/golden/torch_seeded_schedules.json``: its bucket-32 part is
  re-derived from JAX here, and the port reproduces the file on the CPU.

On the card (``cuda`` tests, skipped here): ``schedule_many`` of a
heterogeneous system at hidden 96 and 640 runs the scan with the
single-step kernel at every step and equals the CPU plain path (a uniform
one runs the whole-decode kernel at any width:
``tests/test_torch_decode_wide_cuda.py``); the whole-decode kernel's
sampled orders equal the golden file's, its logp and entropy within 1e-3
of the plain version.
"""

import hashlib
import importlib.util
import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import ptrnet as jptrnet
from repro_torch.core import batching, prng
from repro_torch.core import ptrnet as tptrnet
from repro_torch.core.ptrnet import params_from_numpy
from repro_torch.core.graph import validate_monotone

# one intra-op thread: the suite runs in several worker processes at once,
# and per-process thread pools would oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = json.loads((Path(__file__).parent / "golden" / "dnn_schedules.json").read_text())
SEEDED = json.loads((Path(__file__).parent / "golden" / "torch_seeded_schedules.json").read_text())
_spec = importlib.util.spec_from_file_location(
    "make_seeded_golden", Path(__file__).parents[1] / "scripts" / "make_seeded_golden.py")
make_golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_golden)
TOL_LOGP = 1e-4        # float32 sums in another order, over at most 32 decode steps
STAGES = 4
SYSTEMS = {
    "uniform": dict(n_stages=STAGES),
    "hetero": dict(n_stages=STAGES, compute_rate=(4e12, 2e12, 4e12, 8e12),
                   link_bw=(320e6, 160e6, 320e6, 640e6)),
    "memcap": dict(n_stages=STAGES, mem_capacity=(4e6, 6e6, 8e6, 1e7)),
}


def _digest(a) -> str:
    return hashlib.sha256(np.asarray(a, dtype=np.int64).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def sched():
    return tcore.RespectScheduler.from_release(device="cpu")


def test_table1_golden_digests(sched):
    assert sched.release["params_sha256"] == GOLDEN["meta"]["params_sha256"]
    names = list(GOLDEN["models"])
    graphs = [tcore.build_model_graph(nm) for nm in names]
    res = sched.schedule_many(graphs, GOLDEN["meta"]["n_stages"], use_cache=False)
    for nm, g, r in zip(names, graphs, res):
        want = GOLDEN["models"][nm]
        assert _digest(r["order"]) == want["order_sha256"], nm
        assert _digest(r["assignment"]) == want["assign_sha256"], nm
        ev = tcore.evaluate_schedule(g, r["assignment"], tcore.PipelineSystem(STAGES))
        assert ev.bottleneck_s == pytest.approx(want["bottleneck_s"], rel=1e-12)


@pytest.fixture(scope="module")
def jax_sched():
    return jcore.RespectScheduler.from_release()


@pytest.mark.parametrize("kind", ["uniform", "hetero", "memcap"])
def test_schedule_many_matches_jax(sched, jax_sched, kind):
    rng = np.random.default_rng({"uniform": 0, "hetero": 1, "memcap": 2}[kind])
    jgraphs = jcore.sample_batch(rng, 32, n=(9, 30))
    tgraphs = tcore.sample_batch(np.random.default_rng(
        {"uniform": 0, "hetero": 1, "memcap": 2}[kind]), 32, n=(9, 30))
    assert [g.content_hash() for g in tgraphs] == [g.content_hash() for g in jgraphs]
    want = jax_sched.schedule_many(jgraphs, STAGES, jcore.PipelineSystem(**SYSTEMS[kind]),
                                   use_cache=False)
    got = sched.schedule_many(tgraphs, STAGES, tcore.PipelineSystem(**SYSTEMS[kind]),
                              use_cache=False)
    for i, (g, a, b) in enumerate(zip(tgraphs, got, want)):
        assert np.array_equal(a["order"], b["order"]), f"graph {i}: order"
        assert np.array_equal(a["assignment"], b["assignment"]), f"graph {i}: assignment"
        assert validate_monotone(g, a["assignment"], STAGES)


@pytest.mark.parametrize("kind", ["uniform", "hetero"])
def test_hidden_96_matches_jax(kind):
    jsched = jcore.RespectScheduler.init(seed=0, hidden=96)
    net = params_from_numpy(jax.tree.map(np.asarray, jsched.params))
    tsched = tcore.RespectScheduler(net, device="cpu")
    seed = {"uniform": 3, "hetero": 4}[kind]
    jgraphs = jcore.sample_batch(np.random.default_rng(seed), 8, n=(9, 30))
    tgraphs = tcore.sample_batch(np.random.default_rng(seed), 8, n=(9, 30))
    want = jsched.schedule_many(jgraphs, STAGES, jcore.PipelineSystem(**SYSTEMS[kind]),
                                use_cache=False)
    got = tsched.schedule_many(tgraphs, STAGES, tcore.PipelineSystem(**SYSTEMS[kind]),
                               use_cache=False)
    assert tsched.hidden == 96
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a["order"], b["order"]), f"graph {i}: order"
        assert np.array_equal(a["assignment"], b["assignment"]), f"graph {i}: assignment"


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [96, 640])
def test_schedule_many_any_width_on_cuda(hidden):
    # buckets 32 to 1024: clusters of 1 to 8 blocks a graph
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels.ptr import ops
    graphs = tcore.sample_batch(np.random.default_rng(hidden), 6, n=(20, 700))
    system = tcore.PipelineSystem(**SYSTEMS["hetero"])
    card = tcore.RespectScheduler.init(seed=0, hidden=hidden)
    cpu = tcore.RespectScheduler.init(seed=0, hidden=hidden, device="cpu")
    before = ops.LAUNCHES["ptr_step"]
    got = card.schedule_many(graphs, STAGES, system, use_cache=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ptr_step"] - before == sum(batching.bucketize(graphs))
    want = cpu.schedule_many(graphs, STAGES, system, use_cache=False)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a["order"], b["order"]), f"graph {i}: order"
        assert np.array_equal(a["assignment"], b["assignment"]), f"graph {i}: assignment"


def test_cache_hits_return_copies(sched):
    sched.clear_cache()
    g = tcore.sample_dag(np.random.default_rng(9), n=12, deg=3)
    first = sched.schedule(g, STAGES)
    assert not first["cache_hit"]
    first["assignment"][:] = 99
    first["order"][:] = -1
    again = sched.schedule_many([g, g], STAGES)
    assert all(r["cache_hit"] for r in again)
    assert again[0]["assignment"] is not again[1]["assignment"]
    assert again[0]["assignment"].max() < STAGES and again[0]["order"].min() >= 0
    assert sched.cache_stats() == {"hits": 2, "misses": 1, "size": 1}
    # a duplicate inside one miss batch is served from the fresh entry
    sched.clear_cache()
    dup = sched.schedule_many([g, g], STAGES)
    assert [r["cache_hit"] for r in dup] == [False, True]
    assert dup[0]["assignment"] is not dup[1]["assignment"]
    assert np.array_equal(dup[0]["assignment"], dup[1]["assignment"])
    assert np.array_equal(sched.order(g), dup[0]["order"])


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.RespectScheduler.from_release()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.RespectScheduler.init(seed=0, hidden=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.RespectScheduler.from_release(device="cuda")


def test_decode_impl_routing_and_pad_batch():
    dec = batching.BucketedDecoder("cpu")
    assert dec.resolve_decode_impl(1024, 128) == "kernel"
    assert dec.resolve_decode_impl(1024, 96) == "kernel"      # any width whose state fits
    assert dec.resolve_decode_impl(1024, 3006) == "scan"
    assert dec.resolve_decode_impl(32, 128, conditioned=True) == "scan"
    forced = batching.BucketedDecoder("cpu", decode_impl="kernel")
    assert forced.resolve_decode_impl(1024, 128) == "kernel"
    assert forced.resolve_decode_impl(32, 96) == "kernel"
    with pytest.raises(ValueError, match="profile-conditioned"):
        forced.resolve_decode_impl(32, 128, conditioned=True)
    with pytest.raises(ValueError, match="bucket_n=8192"):
        forced.resolve_decode_impl(8192, 128)
    with pytest.raises(ValueError, match="hidden=4096"):
        forced.resolve_decode_impl(32, 4096)
    assert batching.BucketedDecoder("cpu", decode_impl="scan").resolve_decode_impl(
        32, 128, conditioned=True) == "scan"
    with pytest.raises(ValueError):
        batching.BucketedDecoder("cpu", decode_impl="pallas")
    graphs = tcore.sample_batch(np.random.default_rng(3), 3, n=(5, 12))
    batch = batching.pack_padded(graphs)
    assert batch.bucket_n == 16 and batch.n_valid.tolist() == [g.n for g in graphs]
    padded = batch.pad_batch(4)
    assert padded.batch == 4 and int(padded.n_valid[3]) == 0
    assert (padded.parent_mat[3] == -1).all() and (padded.feats[3] == 0).all()
    assert batch.pad_batch(3) is batch


def test_scan_and_kernel_impls_agree_on_cpu(sched):
    graphs = tcore.sample_batch(np.random.default_rng(7), 12, n=(6, 40))
    results = {}
    for impl in ("scan", "kernel"):
        dec = batching.BucketedDecoder("cpu", decode_impl=impl)
        results[impl] = dec.fused_schedules(sched.net, graphs, STAGES,
                                            tcore.PipelineSystem(STAGES))
    for (oa, aa), (ob, ab) in zip(results["scan"], results["kernel"]):
        assert np.array_equal(oa, ob) and np.array_equal(aa, ab)


def _same_results(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a["order"], b["order"]), f"graph {i}: order"
        assert np.array_equal(a["assignment"], b["assignment"]), f"graph {i}: assignment"


@pytest.mark.parametrize("kind", ["uniform", "hetero"])
def test_seeded_init_matches_jax(kind):
    seed = {"uniform": 5, "hetero": 6}[kind]
    jgraphs = jcore.sample_batch(np.random.default_rng(seed), 8, n=(9, 30))
    tgraphs = tcore.sample_batch(np.random.default_rng(seed), 8, n=(9, 30))
    want = jcore.RespectScheduler.init(seed=3, hidden=64).schedule_many(
        jgraphs, STAGES, jcore.PipelineSystem(**SYSTEMS[kind]), use_cache=False)
    got = tcore.RespectScheduler.init(seed=3, hidden=64, device="cpu").schedule_many(
        tgraphs, STAGES, tcore.PipelineSystem(**SYSTEMS[kind]), use_cache=False)
    _same_results(got, want)


def test_from_release_without_release_is_the_seeded_init(monkeypatch, tmp_path):
    monkeypatch.setenv("RESPECT_CHECKPOINT", str(tmp_path))      # no release there
    with pytest.warns(RuntimeWarning, match="seeded untrained agent"):
        tsched = tcore.RespectScheduler.from_release(fallback_seed=4, hidden=64, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jsched = jcore.RespectScheduler.from_release(fallback_seed=4, hidden=64)
    assert tsched.release is None and jsched.release is None
    want = tptrnet.init_params(prng.PRNGKey(4), tcore.embed_dim(6), 64)
    got = tptrnet.params_to_numpy(tsched.net)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    graphs = tcore.sample_batch(np.random.default_rng(8), 6, n=(9, 30))
    jgraphs = jcore.sample_batch(np.random.default_rng(8), 6, n=(9, 30))
    _same_results(tsched.schedule_many(graphs, STAGES, use_cache=False),
                  jsched.schedule_many(jgraphs, STAGES, use_cache=False))


@pytest.mark.parametrize("kind", ["uniform", "hetero"])
def test_fallback_schedule_many_matches_jax(sched, jax_sched, kind):
    rng_seed = {"uniform": 10, "hetero": 11}[kind]
    tgraphs = tcore.sample_batch(np.random.default_rng(rng_seed), 8, n=(9, 30))
    jgraphs = jcore.sample_batch(np.random.default_rng(rng_seed), 8, n=(9, 30))
    sched.clear_cache()
    sched.schedule_many(tgraphs[:2], STAGES)
    stats = sched.cache_stats()
    got = sched.fallback_schedule_many(tgraphs, STAGES, tcore.PipelineSystem(**SYSTEMS[kind]),
                                       fallback_seed=0)
    want = jax_sched.fallback_schedule_many(jgraphs, STAGES,
                                            jcore.PipelineSystem(**SYSTEMS[kind]),
                                            fallback_seed=0)
    _same_results(got, want)
    assert all(r["served_by"] == "fallback" and not r["cache_hit"] for r in got)
    assert sched.cache_stats() == stats
    # the first call's seed sticks, as in the reference
    again = sched.fallback_schedule_many(tgraphs, STAGES, tcore.PipelineSystem(**SYSTEMS[kind]),
                                         fallback_seed=7)
    _same_results(again, got)
    assert sched.cache_stats() == stats


def _parity_corpus():
    """tests/test_decode_parity.py's corpus: n 6-16, in-degree 1-4, half of
    the graphs with tie-heavy uniform costs."""
    rng = np.random.default_rng(2024)
    out = []
    for _ in range(10):
        n, deg, seed = int(rng.integers(6, 17)), int(rng.integers(1, 5)), int(rng.integers(10_000))
        g = tcore.sample_dag(np.random.default_rng(seed), n=n, deg=deg)
        if rng.random() < 0.5:
            g = tcore.CompGraph(parents=g.parents, flops=np.full(n, 1e9),
                                param_bytes=np.full(n, 1e6), out_bytes=np.full(n, 1e5),
                                names=g.names, model_name=g.model_name)
        out.append((g, seed))
    return out


def test_sample_and_greedy_order_match_jax_on_decode_parity_corpus():
    H, pad = 32, 32
    jparams = jptrnet.init_params(jax.random.PRNGKey(0), tcore.embed_dim(6), H)
    net = tptrnet.PointerNet.init(tcore.embed_dim(6), H, key=prng.PRNGKey(0))
    jsample = jax.jit(lambda f, p, k, nv: jptrnet.sample_order(jparams, f, p, k, n_valid=nv))
    jgreedy = jax.jit(lambda f, p, nv: jptrnet.greedy_order(jparams, f, p, n_valid=nv))
    corpus = _parity_corpus()
    feats = np.zeros((len(corpus), pad, tcore.embed_dim(6)), np.float32)
    pmat = np.full((len(corpus), pad, 6), -1, np.int32)
    keys = np.stack([prng.PRNGKey(seed) for _, seed in corpus])
    n_valid = np.array([g.n for g, _ in corpus], np.int32)
    want_s, want_g = [], []
    for b, (g, seed) in enumerate(corpus):
        feats[b, : g.n] = tcore.embed_graph(g, 6)
        pmat[b, : g.n] = g.parent_matrix(6)
        o, lp, e = jsample(feats[b], pmat[b], jax.random.PRNGKey(seed), g.n)
        want_s.append((np.asarray(o)[: g.n], np.asarray(lp), np.asarray(e)))
        want_g.append(np.asarray(jgreedy(feats[b], pmat[b], g.n)[0])[: g.n])
    for decode in ("kernel", "scan"):
        # the padded batch, one key a graph
        o, lp, e = batching.sample_order(net, feats, pmat, keys, n_valid=n_valid, decode=decode)
        og, _, _ = batching.greedy_order(net, feats, pmat, n_valid=n_valid, decode=decode)
        for b, (g, _) in enumerate(corpus):
            wo, wlp, we = want_s[b]
            assert np.array_equal(o[b, : g.n].numpy(), wo), (decode, b)
            assert np.abs(lp[b].numpy() - wlp).max() <= TOL_LOGP
            assert np.abs(e[b].numpy() - we).max() <= TOL_LOGP
            assert np.array_equal(og[b, : g.n].numpy(), want_g[b]), (decode, b)
        # one graph, unpadded and padded to its own bucket
        g, seed = corpus[0]
        f, pm = tcore.embed_graph(g, 6), g.parent_matrix(6)
        o1, _, _ = batching.sample_order(net, f, pm, prng.PRNGKey(seed), decode=decode)
        ob, _, _ = batching.sample_order(net, feats[0, :16], pmat[0, :16], prng.PRNGKey(seed),
                                        n_valid=g.n, decode=decode)
        assert np.array_equal(o1.numpy(), want_s[0][0])
        assert np.array_equal(ob[: g.n].numpy(), want_s[0][0])
    with pytest.raises(ValueError, match="profile-conditioned"):
        batching.greedy_order(net, f, pm, sys_feat=np.ones(tcore.SYS_FEAT_DIM, np.float32),
                             decode="kernel")


def test_seeded_golden_bucket_32_part_rederived_from_jax(jax_sched):
    mg = make_golden
    for h in mg.HIDDENS:
        assert mg.leaf_digests(h) == SEEDED["leaves"][str(h)], h
    synth = mg.synthetic()
    assert mg.seeded_digests(96, synth) == SEEDED["seeded"]["96"]["synthetic"]
    assert mg.sample_digests(jax_sched.params, synth) == SEEDED["sample_order"]["synthetic"]


def _digests(results) -> dict:
    return {"order_sha256": [_digest(r["order"]) for r in results],
            "assign_sha256": [_digest(r["assignment"]) for r in results]}


def test_port_reproduces_seeded_golden_on_cpu(sched):
    from repro_torch.checkpoint.manager import flatten_leaves
    synth = tcore.sample_batch(np.random.default_rng(0), 64, n=30)
    for h in make_golden.HIDDENS:
        tree = tptrnet.init_params(prng.PRNGKey(0), tcore.embed_dim(6), h)
        assert {n: hashlib.sha256(a.astype("<f4").tobytes()).hexdigest()
                for n, a in flatten_leaves(tree)} == SEEDED["leaves"][str(h)]
        got = tcore.RespectScheduler.init(seed=0, hidden=h, device="cpu").schedule_many(
            synth, STAGES, use_cache=False)
        assert _digests(got) == SEEDED["seeded"][str(h)]["synthetic"], h
    fresh = tcore.RespectScheduler.from_release(device="cpu")
    assert _digests(fresh.fallback_schedule_many(synth, STAGES)) == \
        SEEDED["fallback"]["synthetic"]
    batch = batching.pack_padded(synth)
    keys = prng.fold_in(prng.PRNGKey(1), np.arange(len(synth)))
    order, _, _ = batching.sample_order(sched.net, batch.feats, batch.parent_mat, keys,
                                       n_valid=batch.n_valid)
    assert [_digest(o[:30]) for o in order.numpy()] == SEEDED["sample_order"]["synthetic"]


@pytest.mark.cuda
def test_sampled_decode_on_cuda_matches_golden_and_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels.ptr import ops
    synth = tcore.sample_batch(np.random.default_rng(0), 64, n=30)
    batch = batching.pack_padded(synth)
    keys = prng.fold_in(prng.PRNGKey(1), np.arange(len(synth)))
    for sch, template in ((tcore.RespectScheduler.from_release(), "ptr_decode_cluster"),
                          (tcore.RespectScheduler.init(seed=0), "ptr_decode_block")):
        before = ops.LAUNCHES[template]
        o, lp, e = batching.sample_order(sch.net, batch.feats, batch.parent_mat, keys,
                                        n_valid=batch.n_valid, decode="kernel")
        torch.cuda.synchronize()
        assert ops.LAUNCHES[template] - before == 1
        cpu = tptrnet.params_from_numpy(tptrnet.params_to_numpy(sch.net))
        po, plp, pe = batching.sample_order(cpu, batch.feats, batch.parent_mat, keys,
                                           n_valid=batch.n_valid, decode="kernel")
        assert torch.equal(o.cpu(), po)
        assert float((lp.cpu() - plp).abs().max()) <= 1e-3      # chip_smoke's TOL_LOGP
        assert float((e.cpu() - pe).abs().max()) <= 1e-3
        if template == "ptr_decode_cluster":
            assert [_digest(x[:30]) for x in o.cpu().numpy()] == \
                SEEDED["sample_order"]["synthetic"]
