"""The port's traffic-serving front end (``repro_torch.serving``) against the
reference's: micro-batching, single-flight dedup, backpressure, graceful
drain, and the thread-safety of the port's scheduler underneath
(concurrent ``schedule_many`` + ``clear_cache``).

Each test of ``tests/test_serving.py`` has its counterpart here, run on the
port's ``RespectScheduler`` on the CPU at the same sizes (hidden 32, graphs
of 9-15 nodes, k = 4).  The hard guarantees under test:

* service output is BIT-identical to ``schedule_many`` on the same graphs,
  and to the JAX package's ``schedule_many`` with the same seeded weights
  (``RespectScheduler.init(seed=0, hidden=32)`` in both packages);
* >= 8 submitter threads with overlapping duplicate graphs lose no result,
  duplicate no result, and ``hits + misses + dedups + failed == requests``
  holds on a drained service;
* ``clear_cache`` racing a ``schedule_many`` fill never corrupts results;
* warmup returns the ``(bucket_n, bucket_b, ...)`` keys of the batches it
  ran, leaves the schedule cache empty, and builds no kernel on the CPU.

On the card (``cuda`` tests, skipped here): the service over the released
policy at hidden 128 from eight threads with a racing ``clear_cache`` gives
``schedule_many``'s results, and a clean run degrades nothing while the
pointer kernels' counters rise.
"""

import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.core import RespectScheduler, sample_dag, validate_monotone
from repro_torch.core.costmodel import PipelineSystem
from repro_torch.kernels import build
from repro_torch.kernels.ptr import ops as ptr_ops
from repro_torch.serving import (SchedulerService, ServiceClosedError,
                                 ServiceOverloadedError)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

HIDDEN = 32
N_STAGES = 4
HETERO = dict(n_stages=N_STAGES, compute_rate=(4e12, 2e12, 4e12, 8e12),
              link_bw=(320e6, 160e6, 320e6, 640e6))


@pytest.fixture(scope="module")
def sched():
    return RespectScheduler.init(seed=0, hidden=HIDDEN, device="cpu")


@pytest.fixture(scope="module")
def pool():
    rng = np.random.default_rng(7)
    return [sample_dag(rng, n=int(rng.integers(9, 15)), deg=3)
            for _ in range(5)]


@pytest.fixture(scope="module")
def reference(sched, pool):
    """content_hash -> assignment from an INDEPENDENT engine instance
    (fresh decoder, fresh caches) sharing only the weights."""
    fresh = RespectScheduler(sched.net, device="cpu")
    return {
        g.content_hash(): r.assignment
        for g, r in zip(pool, fresh.schedule_many(
            pool, N_STAGES, use_cache=False))
    }


class _SlowScheduler:
    """Delay wrapper: makes in-flight windows wide enough to test
    single-flight dedup and queue backpressure deterministically."""

    def __init__(self, inner, delay_s, gate: threading.Event | None = None):
        self._inner = inner
        self._delay_s = delay_s
        self._gate = gate

    def schedule_many(self, *args, **kw):
        if self._gate is not None:
            self._gate.wait(timeout=30)
        time.sleep(self._delay_s)
        return self._inner.schedule_many(*args, **kw)

    @property
    def _decoder(self):
        return self._inner._decoder


# --------------------------------------------------------------------- #
# exactness
# --------------------------------------------------------------------- #
def test_service_output_bit_identical_to_schedule_many(sched, pool):
    trace = [pool[i % len(pool)] for i in range(23)]
    with SchedulerService(sched, max_batch=8, max_wait_ms=2) as svc:
        futs = [svc.submit(g, N_STAGES) for g in trace]
        got = [f.result(timeout=120) for f in futs]
    reference = RespectScheduler(sched.net, device="cpu")   # fresh engine
    exp = reference.schedule_many(trace, N_STAGES, use_cache=False)
    for g, a, b in zip(trace, got, exp):
        assert np.array_equal(a.assignment, b.assignment)
        assert np.array_equal(a["order"], b["order"])
        assert validate_monotone(g, a.assignment, N_STAGES)
        assert isinstance(a.assignment, np.ndarray)
        assert isinstance(a["order"], np.ndarray)


@pytest.mark.parametrize("kind", ["uniform", "hetero"])
def test_service_output_matches_jax_schedule_many(kind):
    """The port's service against the JAX package's engine, both seeded
    with ``RespectScheduler.init(seed=0, hidden=32)``: equal orders and
    assignments, duplicates and all."""
    rng_seed = {"uniform": 31, "hetero": 32}[kind]
    tgraphs = tcore.sample_batch(np.random.default_rng(rng_seed), 12, n=(9, 15))
    jgraphs = jcore.sample_batch(np.random.default_rng(rng_seed), 12, n=(9, 15))
    trace = [i % len(tgraphs) for i in range(20)]
    system = HETERO if kind == "hetero" else dict(n_stages=N_STAGES)
    tsched = RespectScheduler.init(seed=0, hidden=HIDDEN, device="cpu")
    with SchedulerService(tsched, max_batch=8, max_wait_ms=2) as svc:
        futs = [svc.submit(tgraphs[i], N_STAGES, tcore.PipelineSystem(**system))
                for i in trace]
        got = [f.result(timeout=120) for f in futs]
        st = svc.stats()
    want = jcore.RespectScheduler.init(seed=0, hidden=HIDDEN).schedule_many(
        [jgraphs[i] for i in trace], N_STAGES, jcore.PipelineSystem(**system),
        use_cache=False)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a["served_by"] == "policy"
        assert np.array_equal(a["order"], b["order"]), f"request {k}: order"
        assert np.array_equal(a["assignment"], b["assignment"]), f"request {k}: assignment"
    assert st.cache_hits + st.cache_misses + st.dedup_hits == st.requests == len(trace)
    assert st.degraded == st.failed == 0


def test_waiter_results_are_private_copies(sched, pool):
    """Coalesced duplicates must not share arrays: mutating one caller's
    result cannot leak into another's."""
    gate = threading.Event()
    slow = _SlowScheduler(sched, 0.0, gate)
    g = pool[0]
    with SchedulerService(slow, max_batch=1, max_wait_ms=0) as svc:
        f1 = svc.submit(g, N_STAGES)
        f2 = svc.submit(g, N_STAGES)   # attaches while f1 is gated
        gate.set()
        r1, r2 = f1.result(timeout=60), f2.result(timeout=60)
    expected = r2.assignment.copy()
    r1.assignment[:] = -9
    r1["order"][:] = -9
    assert np.array_equal(r2.assignment, expected)
    assert (r2["order"] >= 0).all()


# --------------------------------------------------------------------- #
# concurrency hammer
# --------------------------------------------------------------------- #
def test_concurrent_submitters_no_lost_or_duplicated_results(
        sched, pool, reference):
    """>= 8 threads, overlapping duplicate graphs: every future resolves
    to the correct result, stats stay consistent, each distinct graph is
    solved at most once (single-flight + schedule cache)."""
    sched.clear_cache()
    n_threads, per_thread = 8, 12
    barrier = threading.Barrier(n_threads)
    results: list[list] = [[] for _ in range(n_threads)]
    errors: list[Exception] = []

    with SchedulerService(sched, max_batch=8, max_wait_ms=1,
                          max_queue=512) as svc:
        def hammer(tid):
            rng = np.random.default_rng(tid)
            barrier.wait(timeout=60)
            futs = []
            for _ in range(per_thread):
                g = pool[int(rng.integers(0, len(pool)))]
                futs.append((g, svc.submit(g, N_STAGES)))
            for g, f in futs:
                try:
                    results[tid].append((g, f.result(timeout=120)))
                except Exception as e:      # pragma: no cover
                    errors.append(e)

        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
        st = svc.stats()

    assert not errors
    flat = [rg for tr in results for rg in tr]
    assert len(flat) == n_threads * per_thread          # nothing lost
    for g, res in flat:
        assert np.array_equal(res.assignment, reference[g.content_hash()])
    # counter invariants on the drained service
    assert st.requests == n_threads * per_thread
    assert st.completed == st.requests and st.failed == 0
    assert st.cache_hits + st.cache_misses + st.dedup_hits == st.requests
    assert st.queue_depth == 0 and st.inflight_keys == 0
    # single-flight + schedule cache: each distinct (graph, stages) pair
    # is computed exactly once across all 96 requests
    assert st.cache_misses == len(pool)
    assert sched.cache_stats()["misses"] == len(pool)


def test_concurrent_schedule_many_direct_stats_consistent(
        sched, pool, reference):
    """The raw scheduler hammered from 8 threads (no service): results
    correct and hits + misses == total scheduled graphs."""
    sched.clear_cache()
    n_threads, reps = 8, 6
    barrier = threading.Barrier(n_threads)
    errors: list[Exception] = []

    def worker(tid):
        rng = np.random.default_rng(100 + tid)
        barrier.wait(timeout=60)
        try:
            for _ in range(reps):
                gs = [pool[int(rng.integers(0, len(pool)))]
                      for _ in range(3)]
                for g, r in zip(gs, sched.schedule_many(gs, N_STAGES)):
                    assert np.array_equal(
                        r.assignment, reference[g.content_hash()])
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    stats = sched.cache_stats()
    assert stats["hits"] + stats["misses"] == n_threads * reps * 3


def test_clear_cache_racing_fill_never_corrupts(sched, pool, reference):
    """clear_cache() storms while other threads schedule: no exception,
    every result stays correct (an in-progress fill re-inserts into the
    emptied cache; it must never KeyError or hand back a wrong entry)."""
    stop = threading.Event()
    errors: list[Exception] = []

    def clearer():
        while not stop.is_set():
            sched.clear_cache()
            time.sleep(1e-4)

    def scheduler_user(tid):
        rng = np.random.default_rng(200 + tid)
        try:
            for _ in range(8):
                gs = [pool[int(rng.integers(0, len(pool)))]
                      for _ in range(2)]
                for g, r in zip(gs, sched.schedule_many(gs, N_STAGES)):
                    assert np.array_equal(
                        r.assignment, reference[g.content_hash()])
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=scheduler_user, args=(t,))
               for t in range(4)]
    tc = threading.Thread(target=clearer)
    tc.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    stop.set()
    tc.join(timeout=30)
    assert not any(t.is_alive() for t in threads + [tc])
    assert not errors


# --------------------------------------------------------------------- #
# single-flight dedup
# --------------------------------------------------------------------- #
def test_single_flight_duplicates_attach_to_running_computation(sched, pool):
    gate = threading.Event()
    slow = _SlowScheduler(sched, 0.0, gate)
    sched.clear_cache()
    g = pool[1]
    n_dups = 9
    with SchedulerService(slow, max_batch=1, max_wait_ms=0) as svc:
        futs = [svc.submit(g, N_STAGES) for _ in range(n_dups)]
        st_mid = svc.stats()
        gate.set()
        res = [f.result(timeout=60) for f in futs]
        st = svc.stats()
    assert st_mid.dedup_hits >= 1          # attached while in flight
    assert st.requests == n_dups
    assert st.cache_hits + st.cache_misses + st.dedup_hits == n_dups
    assert sched.cache_stats()["misses"] == 1     # solved exactly once
    for r in res:
        assert np.array_equal(r.assignment, res[0].assignment)


def test_dedup_keys_distinguish_stages(sched, pool):
    """Same graph at different n_stages must NOT coalesce."""
    sched.clear_cache()
    g = pool[2]
    with SchedulerService(sched, max_batch=4, max_wait_ms=1) as svc:
        r4 = svc.submit(g, 4).result(timeout=60)
        r5 = svc.submit(g, 5).result(timeout=60)
        st = svc.stats()
    assert st.dedup_hits == 0
    assert r4["n_stages"] == 4 and r5["n_stages"] == 5
    assert sched.cache_stats()["misses"] == 2


# --------------------------------------------------------------------- #
# micro-batcher
# --------------------------------------------------------------------- #
def test_flush_on_max_batch_and_on_deadline(sched, pool):
    gate = threading.Event()
    slow = _SlowScheduler(sched, 0.0, gate)
    distinct = [sample_dag(np.random.default_rng(50 + i), n=12, deg=2)
                for i in range(4)]
    with SchedulerService(slow, max_batch=4, max_wait_ms=5000,
                          dedup=False) as svc:
        futs = [svc.submit(g, N_STAGES) for g in distinct]
        gate.set()
        for f in futs:
            f.result(timeout=60)
        st_full = svc.stats()
        # now a single trickle request: only the deadline can flush it
        gate.clear()
        svc.max_wait_s = 0.01
        f = svc.submit(distinct[0], N_STAGES)
        gate.set()
        f.result(timeout=60)
        st = svc.stats()
    assert st_full.flush_full >= 1
    assert st_full.max_batch_observed == 4
    assert st.flush_deadline >= 1


def test_mixed_stage_requests_in_one_flush_grouped_correctly(sched, pool):
    gate = threading.Event()
    slow = _SlowScheduler(sched, 0.0, gate)
    g = pool[3]
    with SchedulerService(slow, max_batch=8, max_wait_ms=50,
                          dedup=False) as svc:
        f4 = svc.submit(g, 4)
        f5 = svc.submit(g, 5)
        gate.set()
        r4, r5 = f4.result(timeout=60), f5.result(timeout=60)
    assert r4["n_stages"] == 4 and r5["n_stages"] == 5
    assert int(r4.assignment.max()) <= 3
    assert int(r5.assignment.max()) <= 4


# --------------------------------------------------------------------- #
# backpressure + lifecycle
# --------------------------------------------------------------------- #
def test_backpressure_queue_full_raises_overloaded(sched, pool):
    gate = threading.Event()
    slow = _SlowScheduler(sched, 0.0, gate)
    distinct = [sample_dag(np.random.default_rng(80 + i), n=10, deg=2)
                for i in range(6)]
    svc = SchedulerService(slow, max_batch=1, max_wait_ms=0,
                           max_queue=2, dedup=False)
    try:
        futs = []
        with pytest.raises(ServiceOverloadedError):
            for g in distinct:       # worker gated: queue must overflow
                futs.append(svc.submit(g, N_STAGES, timeout=0.01))
        gate.set()
        for f in futs:               # accepted requests still complete
            assert f.result(timeout=60)["cache_hit"] is False
        assert svc.stats().failed >= 1
    finally:
        gate.set()
        svc.close()


def test_hot_key_waiter_flood_hits_backpressure(sched, pool):
    """Duplicates coalescing onto one in-flight computation are bounded
    by max_waiters — a hot-key flood cannot grow memory off the bounded
    queue; it overflows like any other traffic."""
    gate = threading.Event()
    slow = _SlowScheduler(sched, 0.0, gate)
    g = pool[2]
    svc = SchedulerService(slow, max_batch=1, max_wait_ms=0, max_waiters=3)
    try:
        futs = [svc.submit(g, N_STAGES) for _ in range(4)]  # primary + 3
        with pytest.raises(ServiceOverloadedError):
            svc.submit(g, N_STAGES)                         # 4th waiter
        gate.set()
        for f in futs:
            assert f.result(timeout=60) is not None
        st = svc.stats()
        assert st.failed == 1 and st.dedup_hits == 3
        assert (st.cache_hits + st.cache_misses + st.dedup_hits + st.failed
                == st.requests)
    finally:
        gate.set()
        svc.close()


def test_close_drains_pending_and_rejects_new(sched, pool):
    gate = threading.Event()
    slow = _SlowScheduler(sched, 0.0, gate)
    svc = SchedulerService(slow, max_batch=2, max_wait_ms=1000, dedup=False)
    distinct = [sample_dag(np.random.default_rng(90 + i), n=10, deg=2)
                for i in range(5)]
    futs = [svc.submit(g, N_STAGES) for g in distinct]
    gate.set()
    assert svc.close(timeout=120) is True    # must drain all five, then join
    assert all(f.done() for f in futs)
    for g, f in zip(distinct, futs):
        assert validate_monotone(g, f.result(timeout=1).assignment, N_STAGES)
    with pytest.raises(ServiceClosedError):
        svc.submit(distinct[0], N_STAGES)
    svc.close()                       # idempotent
    st = svc.stats()
    assert st.completed == len(distinct) and st.queue_depth == 0


def test_worker_exception_propagates_and_service_survives(sched, pool):
    class _FailOnce:
        def __init__(self, inner):
            self._inner = inner
            self.tripped = False

        def schedule_many(self, *args, **kw):
            if not self.tripped:
                self.tripped = True
                raise ValueError("injected solver failure")
            return self._inner.schedule_many(*args, **kw)

        @property
        def _decoder(self):
            return self._inner._decoder

    failing = _FailOnce(sched)
    g = pool[4]
    # degrade=None pins the fail-fast contract: flush errors propagate to
    # the affected futures (the ladder path is covered in test_torch_faults.py)
    with SchedulerService(failing, max_batch=1, max_wait_ms=0,
                          degrade=None) as svc:
        f_bad = svc.submit(g, N_STAGES)
        with pytest.raises(ValueError, match="injected solver failure"):
            f_bad.result(timeout=60)
        f_ok = svc.submit(g, N_STAGES)      # service keeps serving
        assert validate_monotone(g, f_ok.result(timeout=60).assignment,
                                 N_STAGES)
        st = svc.stats()
    assert st.failed == 1 and st.completed == 1


def test_error_path_reclassifies_waiters_keeps_invariant(sched, pool):
    """Duplicates coalesced onto a computation that ERRORS terminate as
    failed, not as served dedups: hits+misses+dedups+failed == requests
    must hold even on the failure path."""
    gate = threading.Event()

    class _GatedFail:
        def __init__(self, inner):
            self._inner = inner

        def schedule_many(self, *args, **kw):
            gate.wait(timeout=30)
            raise ValueError("gated failure")

        @property
        def _decoder(self):
            return self._inner._decoder

    g = pool[0]
    with SchedulerService(_GatedFail(sched), max_batch=1,
                          max_wait_ms=0, degrade=None) as svc:
        futs = [svc.submit(g, N_STAGES) for _ in range(4)]
        gate.set()
        for f in futs:
            with pytest.raises(ValueError, match="gated failure"):
                f.result(timeout=60)
        st = svc.stats()
    assert st.requests == 4
    assert st.failed == 4 and st.completed == 0 and st.dedup_hits == 0
    assert (st.cache_hits + st.cache_misses + st.dedup_hits + st.failed
            == st.requests)


# --------------------------------------------------------------------- #
# warmup + metrics
# --------------------------------------------------------------------- #
def test_warmup_returns_bucket_keys_and_builds_nothing_on_cpu(pool, monkeypatch):
    """Eager PyTorch compiles nothing per shape: warmup returns the
    ``(bucket_n, bucket_b, n_stages, system, impl)`` keys of the batches it
    ran (in place of the reference's XLA program keys), leaves the schedule
    cache empty, and on the CPU neither builds nor loads a kernel."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel library was built or loaded on the CPU")

    for mod, name in ((build, "build_kernels"), (build, "load_function"),
                      (ptr_ops, "build_kernels"), (ptr_ops, "load_kernels")):
        monkeypatch.setattr(mod, name, refuse)
    launches = dict(build.LAUNCHES)
    s = RespectScheduler.init(seed=1, hidden=HIDDEN, device="cpu")
    svc = SchedulerService(s)
    try:
        # (n, batch) specs run synthetic stand-ins; a CompGraph spec runs
        # the exact bucket that graph's live traffic will hit
        shapes = svc.warmup([(12, 2), pool[0]], n_stages=N_STAGES)
        uniform = PipelineSystem(N_STAGES)
        assert shapes == [(16, 2, N_STAGES, uniform, "kernel"),
                          (16, 1, N_STAGES, uniform, "kernel")]
        # a conditioned system takes the scan
        hsys = PipelineSystem(**HETERO)
        assert svc.warmup([40], n_stages=N_STAGES, system=hsys) == [
            (64, 1, N_STAGES, hsys, "scan")]
        # warmup must not pollute the schedule cache
        assert s.cache_stats() == {"hits": 0, "misses": 0, "size": 0}
        svc.submit(pool[0], N_STAGES).result(timeout=60)
    finally:
        svc.close()
    assert build.LAUNCHES == launches


def test_stats_percentiles_sane_after_traffic(sched, pool):
    with SchedulerService(sched, max_batch=4, max_wait_ms=1) as svc:
        futs = [svc.submit(pool[i % len(pool)], N_STAGES)
                for i in range(12)]
        for f in futs:
            f.result(timeout=120)
        st = svc.stats()
    assert np.isfinite(st.p50_ms) and np.isfinite(st.p99_ms)
    assert st.p50_ms <= st.p99_ms + 1e-9
    assert st.mean_ms > 0
    assert 1 <= st.max_batch_observed <= 4
    assert st.batches >= 1
    d = st.as_dict()
    assert d["requests"] == 12


def test_submit_future_type_and_timing_fields(sched, pool):
    with SchedulerService(sched, max_batch=2, max_wait_ms=1) as svc:
        f = svc.submit(pool[0], N_STAGES,
                       system=PipelineSystem(n_stages=N_STAGES))
        assert isinstance(f, Future)
        res = f.result(timeout=60)
    assert res["model"] == pool[0].model_name
    assert res["n_stages"] == N_STAGES


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #
def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


@pytest.mark.cuda
def test_service_on_cuda_eight_threads_with_racing_clear_cache():
    """The released policy (hidden 128) on the card behind the service:
    eight submitter threads and a clear_cache storm give schedule_many's
    results, through B1 for the uniform requests and B2 for the
    heterogeneous ones."""
    _card_or_skip()
    card = RespectScheduler.from_release()
    graphs = tcore.sample_batch(np.random.default_rng(5), 24, n=(20, 200))
    hsys = PipelineSystem(**HETERO)
    want = {("u", i): r for i, r in enumerate(card.schedule_many(graphs, N_STAGES,
                                                                 use_cache=False))}
    want.update({("h", i): r for i, r in enumerate(card.schedule_many(
        graphs[:8], N_STAGES, hsys, use_cache=False))})
    stop = threading.Event()
    errors: list[Exception] = []
    got: dict = {}

    def clearer():
        while not stop.is_set():
            card.clear_cache()
            time.sleep(1e-3)

    with SchedulerService(card, max_batch=16, max_wait_ms=2) as svc:
        svc.warmup([graphs[0]], n_stages=N_STAGES)
        before = dict(build.LAUNCHES)

        def submitter(tid):
            try:
                futs = [((kind, i), svc.submit(graphs[i], N_STAGES,
                                               hsys if kind == "h" else None))
                        for kind, i in want if i % 8 == tid]
                for key, f in futs:
                    got.setdefault(key, []).append(f.result(timeout=300))
            except Exception as e:           # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(8)]
        tc = threading.Thread(target=clearer)
        tc.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        stop.set()
        tc.join(timeout=30)
        assert not any(t.is_alive() for t in threads + [tc])
        st = svc.stats()
    torch.cuda.synchronize()
    assert not errors
    assert set(got) == set(want)
    for key, rs in got.items():
        for r in rs:
            assert r["served_by"] == "policy"
            assert np.array_equal(r["order"], want[key]["order"]), key
            assert np.array_equal(r["assignment"], want[key]["assignment"]), key
    assert st.degraded == st.failed == st.retries == st.worker_restarts == 0
    assert st.cache_hits + st.cache_misses + st.dedup_hits == st.requests == len(want)
    assert build.LAUNCHES["ptr_decode_cluster"] > before["ptr_decode_cluster"]
    assert build.LAUNCHES["ptr_step"] > before["ptr_step"]


@pytest.mark.cuda
def test_concurrent_schedule_many_on_cuda_with_racing_clear_cache():
    """The scheduler's thread-safety on the card, no service in front: eight
    threads call schedule_many (kernels launched from each thread's default
    stream) while another storms clear_cache; every result is the
    single-threaded one."""
    _card_or_skip()
    card = RespectScheduler.from_release()
    graphs = tcore.sample_batch(np.random.default_rng(8), 12, n=(20, 120))
    want = {g.content_hash(): r for g, r in zip(graphs, card.schedule_many(
        graphs, N_STAGES, use_cache=False))}
    stop = threading.Event()
    errors: list[Exception] = []

    def clearer():
        while not stop.is_set():
            card.clear_cache()
            time.sleep(1e-3)

    def worker(tid):
        rng = np.random.default_rng(300 + tid)
        try:
            for _ in range(6):
                gs = [graphs[int(i)] for i in rng.integers(0, len(graphs), 3)]
                for g, r in zip(gs, card.schedule_many(gs, N_STAGES)):
                    w = want[g.content_hash()]
                    assert np.array_equal(r["order"], w["order"])
                    assert np.array_equal(r["assignment"], w["assignment"])
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    tc = threading.Thread(target=clearer)
    tc.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    stop.set()
    tc.join(timeout=30)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads + [tc])
    assert not errors, errors[:3]


@pytest.mark.cuda
def test_clean_service_run_on_cuda_degrades_nothing():
    """No faults and no deadline pressure on the card: every request is
    served by the policy rung, nothing is retried, restarted, degraded or
    failed, live traffic loads no kernel library after warmup, and the
    results equal schedule_many's."""
    _card_or_skip()
    card = RespectScheduler.from_release()
    graphs = tcore.sample_batch(np.random.default_rng(6), 32, n=30)
    with SchedulerService(card) as svc:
        svc.warmup([(30, 1), (30, 16)], n_stages=N_STAGES)
        libs = set(build._libs)
        before = build.LAUNCHES["ptr_decode_cluster"]
        futs = [svc.submit(g, N_STAGES) for g in graphs + graphs]
        res = [f.result(timeout=300) for f in futs]
        st = svc.stats()
    assert set(build._libs) == libs
    assert build.LAUNCHES["ptr_decode_cluster"] > before
    want = card.schedule_many(graphs + graphs, N_STAGES, use_cache=False)
    for a, b in zip(res, want):
        assert a["served_by"] == "policy"
        assert np.array_equal(a["order"], b["order"])
        assert np.array_equal(a["assignment"], b["assignment"])
    assert st.degraded == st.failed == st.retries == st.worker_restarts == 0
    assert (st.cache_hits + st.cache_misses + st.dedup_hits + st.degraded + st.failed
            == st.requests == 2 * len(graphs))


# a fresh process with an empty build directory: nothing built, nothing loaded
_COLD_WARMUP = """
import sys
from pathlib import Path

import numpy as np

from repro_torch.core import PipelineSystem, RespectScheduler, sample_dag
from repro_torch.kernels import build
from repro_torch.serving import SchedulerService

build.BUILD_DIR = Path(sys.argv[1])
card = RespectScheduler.from_release()
with SchedulerService(card) as svc:
    svc.warmup([(30, 1)], n_stages=4)              # uniform stand-ins: B1 only
    libs = set(build._libs)
    assert {("ptr_decode", ()), ("ptr_step", ())} <= libs, libs
    g = sample_dag(np.random.default_rng(3), n=30, deg=3)
    r = svc.submit(g, 4, PipelineSystem(**HETERO)).result(timeout=300)
    st = svc.stats()
    per_graph = svc._estimator.estimate("policy", 1)
assert set(build._libs) == libs, set(build._libs) - libs
assert r["served_by"] == "policy" and st.degraded == st.failed == 0, st.as_dict()
assert build.LAUNCHES["ptr_step"] > 0, build.LAUNCHES
# the request ran B2 on a loaded library; an nvcc build takes tens of seconds
assert per_graph < 0.5, per_graph
print("policy rung estimate", per_graph, "s a graph")
"""


@pytest.mark.cuda
def test_cold_warmup_on_cuda_loads_both_pointer_kernels(tmp_path):
    """From a cold start (fresh process, empty build directory), warmup on
    uniform shapes alone builds and loads B2's library too, so the first
    heterogeneous request loads nothing and the policy rung's cost estimate
    stays a scan's, not a build's."""
    _card_or_skip()
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    code = f"HETERO = {HETERO!r}\n" + _COLD_WARMUP
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "build")],
                         cwd=root, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout + out.stderr
