"""The port's serving path end to end on the CPU.

* ``RespectScheduler.from_release(device="cpu").schedule_many`` on the ten
  Table-I graphs reproduces every ``order_sha256`` and ``assign_sha256``
  pinned in ``tests/golden/dnn_schedules.json``;
* on 32 mixed-size synthetic graphs it equals the reference's
  ``RespectScheduler.from_release().schedule_many`` integer for integer,
  for a uniform, a heterogeneous and a memory-capped system;
* at hidden 96, a width the whole-decode kernel refuses, a scheduler built
  from the reference's seeded ``init_params`` equals the reference's
  ``RespectScheduler`` with those parameters, uniform and heterogeneous;
* cache hits return copies; without CUDA, entry points raise unless given
  ``device="cpu"``.

On the card (``cuda`` tests, skipped here): ``schedule_many`` at hidden 96
and 640 runs the scan with the single-step kernel at every step and equals
the CPU plain path.
"""

import hashlib
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.core import batching
from repro_torch.core.ptrnet import params_from_numpy
from repro_torch.core.graph import validate_monotone

# one intra-op thread: the suite runs in several worker processes at once,
# and per-process thread pools would oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = json.loads((Path(__file__).parent / "golden" / "dnn_schedules.json").read_text())
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
    assert dec.resolve_decode_impl(1024, 96) == "scan"
    assert dec.resolve_decode_impl(32, 128, conditioned=True) == "scan"
    forced = batching.BucketedDecoder("cpu", decode_impl="kernel")
    assert forced.resolve_decode_impl(1024, 128) == "kernel"
    with pytest.raises(ValueError, match="profile-conditioned"):
        forced.resolve_decode_impl(32, 128, conditioned=True)
    with pytest.raises(ValueError, match="bucket_n=8192"):
        forced.resolve_decode_impl(8192, 128)
    with pytest.raises(ValueError, match="hidden=96"):
        forced.resolve_decode_impl(32, 96)
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
