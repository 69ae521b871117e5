"""Fault tolerance of the port's service under deterministic injection:
supervisor restarts, the degradation ladder, deadline budgets, retries and
edge validation — each test of ``tests/test_faults.py`` against
``repro_torch.serving`` on the CPU, at the same sizes (hidden 32, graphs of
9-15 nodes, k = 4) — and the port held to the reference across packages:

* ``FaultPlan.random`` gives the reference's event list for the same
  arguments (several seeds and rung sets): a chaos run replays the same
  faults in both packages;
* each rung of the ladder, reached through the service by a scripted
  plan, gives the reference's rung exactly: the policy rung JAX's
  ``schedule_many``, the fallback rung JAX's ``fallback_schedule_many``,
  the heuristic floor JAX's ``heuristic_schedule_many``;
* the drained-service invariant ``hits + misses + dedups + degraded +
  failed == requests`` holds in every test that drains a service, the
  three seeded soaks included, and policy-rung results stay bit-identical
  to ``schedule_many``, faults or not.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serving as jserving
import repro_torch.core as tcore
from repro_torch.core import RespectScheduler, sample_dag, validate_monotone
from repro_torch.core.graph import InvalidGraphError, validate_graph
from repro_torch.kernels.build import KernelError
from repro_torch.serving import (DegradeConfig, FaultEvent, FaultPlan,
                                 FaultyScheduler, OverloadDetector,
                                 RungCostEstimator, SchedulerService)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

HIDDEN = 32
N_STAGES = 4


@pytest.fixture(scope="module")
def sched():
    return RespectScheduler.init(seed=0, hidden=HIDDEN, device="cpu")


@pytest.fixture(scope="module")
def pool():
    rng = np.random.default_rng(17)
    return [sample_dag(rng, n=int(rng.integers(9, 15)), deg=3)
            for _ in range(5)]


@pytest.fixture(scope="module")
def reference(sched, pool):
    """content_hash -> assignment from a fresh engine sharing only the
    weights — the bit-identity oracle for policy-rung results."""
    fresh = RespectScheduler(sched.net, device="cpu")
    return {g.content_hash(): r.assignment
            for g, r in zip(pool, fresh.schedule_many(
                pool, N_STAGES, use_cache=False))}


def _cfg(**kw):
    """Fast-converging ladder config for tests."""
    base = dict(retry_attempts=1, retry_backoff_s=0.001,
                retry_backoff_max_s=0.002, restart_backoff_s=0.01,
                restart_backoff_max_s=0.05)
    base.update(kw)
    return DegradeConfig(**base)


def _assert_drained_invariants(st):
    assert st.completed + st.failed == st.requests
    assert (st.cache_hits + st.cache_misses + st.dedup_hits + st.degraded
            + st.failed == st.requests)
    assert st.served_fallback + st.served_heuristic == st.degraded
    assert (st.degrade_deadline + st.degrade_overload + st.degrade_error
            + st.degrade_crash == st.degraded)


# --------------------------------------------------------------------- #
# the ladder
# --------------------------------------------------------------------- #
def test_persistent_policy_error_degrades_to_fallback(sched, pool):
    plan = FaultPlan([FaultEvent("error", rung="policy", persistent=True)])
    with SchedulerService(FaultyScheduler(sched, plan), max_batch=8,
                          max_wait_ms=2, degrade=_cfg()) as svc:
        futs = [svc.submit(g, N_STAGES) for g in pool]
        res = [f.result(timeout=120) for f in futs]
        st = svc.stats()
    for g, r in zip(pool, res):
        assert r["served_by"] == "fallback"
        assert validate_monotone(g, r["assignment"], N_STAGES)
    assert st.failed == 0 and st.degraded == len(pool)
    assert st.degrade_error == len(pool)
    assert st.retries >= 1             # the transient-retry ran first
    _assert_drained_invariants(st)


def test_transient_error_retries_on_same_rung(sched, pool, reference):
    plan = FaultPlan([FaultEvent("error", at=0, rung="policy")])  # one-shot
    with SchedulerService(FaultyScheduler(sched, plan), max_batch=8,
                          max_wait_ms=2, degrade=_cfg()) as svc:
        futs = [svc.submit(g, N_STAGES) for g in pool]
        res = [f.result(timeout=120) for f in futs]
        st = svc.stats()
    # the retry landed on a healthy rung: nothing degraded, results exact
    for g, r in zip(pool, res):
        assert r["served_by"] == "policy"
        assert np.array_equal(r["assignment"], reference[g.content_hash()])
    assert st.retries == 1 and st.degraded == 0 and st.failed == 0
    _assert_drained_invariants(st)


def test_exhausted_ladder_reaches_heuristic_floor(sched, pool):
    plan = FaultPlan([
        FaultEvent("error", rung="policy", persistent=True),
        FaultEvent("error", rung="fallback", persistent=True),
    ])
    with SchedulerService(FaultyScheduler(sched, plan), max_batch=8,
                          max_wait_ms=2, degrade=_cfg()) as svc:
        res = [svc.submit(g, N_STAGES).result(timeout=120) for g in pool]
        st = svc.stats()
    for g, r in zip(pool, res):
        assert r["served_by"] == "heuristic"
        assert validate_monotone(g, r["assignment"], N_STAGES)
    assert st.failed == 0 and st.served_heuristic == len(pool)
    _assert_drained_invariants(st)


class _KernelFault:
    """Delegates to a scheduler, but one rung raises :class:`KernelError`,
    as a kernel that cannot be built or launched does on the card."""

    def __init__(self, inner, rung):
        self._inner = inner
        self._rung = rung
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _call(self, rung, fn, *args, **kw):
        if rung == self._rung:
            self.calls += 1
            raise KernelError(f"{rung}: kernel launch failed (scripted)")
        return fn(*args, **kw)

    def schedule_many(self, *args, **kw):
        return self._call("policy", self._inner.schedule_many, *args, **kw)

    def fallback_schedule_many(self, *args, **kw):
        return self._call("fallback", self._inner.fallback_schedule_many,
                          *args, **kw)


@pytest.mark.parametrize("rung", ["policy", "fallback"])
def test_kernel_fault_fails_requests_instead_of_degrading(sched, pool, rung):
    """A kernel fault is not transient and the floor would move the work to
    the host: the affected requests fail with it, counted ``failed``, with
    no retry of that rung and no heuristic result."""
    faulty = _KernelFault(sched, rung)
    inner = faulty
    if rung == "fallback":              # reach the fallback rung first
        inner = FaultyScheduler(faulty, FaultPlan([
            FaultEvent("error", rung="policy", persistent=True)]))
    with SchedulerService(inner, max_batch=8, max_wait_ms=2,
                          degrade=_cfg()) as svc:
        futs = [svc.submit(g, N_STAGES) for g in pool]
        for f in futs:
            with pytest.raises(KernelError, match="scripted"):
                f.result(timeout=120)
        st = svc.stats()
    assert st.failed == len(pool) and st.completed == 0
    assert st.degraded == st.served_heuristic == st.served_fallback == 0
    assert faulty.calls == st.batches          # once a flush: never retried
    assert st.retries == (0 if rung == "policy" else st.batches)
    _assert_drained_invariants(st)


def test_corrupt_results_degrade_only_affected(sched, pool, reference):
    """Per-request isolation: when one result in a flush comes back
    malformed, only that request descends — its batchmates resolve on
    the rung that produced them."""
    class _CorruptFirst:
        def __init__(self, inner):
            self._inner = inner
            self.tripped = False

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def schedule_many(self, *args, **kw):
            out = self._inner.schedule_many(*args, **kw)
            if not self.tripped and len(out) > 1:
                self.tripped = True
                out[0]["assignment"] = np.asarray(out[0]["assignment"])[:-1]
            return out

    with SchedulerService(_CorruptFirst(sched), max_batch=8, max_wait_ms=50,
                          degrade=_cfg()) as svc:
        futs = [svc.submit(g, N_STAGES) for g in pool]
        res = [f.result(timeout=120) for f in futs]
        st = svc.stats()
    rungs = [r["served_by"] for r in res]
    assert rungs.count("policy") == len(pool) - 1
    assert sum(1 for r in rungs if r != "policy") == 1
    for g, r in zip(pool, res):
        assert len(r["assignment"]) == g.n
        if r["served_by"] == "policy":
            assert np.array_equal(r["assignment"],
                                  reference[g.content_hash()])
    assert st.degraded == 1 and st.failed == 0
    _assert_drained_invariants(st)


@pytest.mark.parametrize("rung", ["policy", "fallback", "heuristic"])
def test_each_rung_through_the_service_matches_jax(rung):
    """A plan that fails every rung above ``rung`` serves the traffic there;
    each result equals the reference package's rung on the same graphs with
    the same seeded weights (``init(seed=0, hidden=32)``), exactly."""
    tgraphs = tcore.sample_batch(np.random.default_rng(41), 8, n=(9, 15))
    jgraphs = jcore.sample_batch(np.random.default_rng(41), 8, n=(9, 15))
    above = {"policy": (), "fallback": ("policy",), "heuristic": ("policy", "fallback")}
    plan = FaultPlan([FaultEvent("error", rung=r, persistent=True) for r in above[rung]])
    tsched = RespectScheduler.init(seed=0, hidden=HIDDEN, device="cpu")
    with SchedulerService(FaultyScheduler(tsched, plan), max_batch=4,
                          max_wait_ms=2, degrade=_cfg()) as svc:
        got = [f.result(timeout=120)
               for f in [svc.submit(g, N_STAGES) for g in tgraphs]]
        st = svc.stats()
    jsched = jcore.RespectScheduler.init(seed=0, hidden=HIDDEN)
    if rung == "policy":
        want = [(r["order"], r["assignment"])
                for r in jsched.schedule_many(jgraphs, N_STAGES, use_cache=False)]
    elif rung == "fallback":
        want = [(r["order"], r["assignment"])
                for r in jsched.fallback_schedule_many(jgraphs, N_STAGES)]
    else:
        want = jcore.heuristic_schedule_many(jgraphs, N_STAGES)
    for i, (r, (order, assign)) in enumerate(zip(got, want)):
        assert r["served_by"] == rung
        assert np.array_equal(r["order"], order), f"graph {i}: order"
        assert np.array_equal(r["assignment"], assign), f"graph {i}: assignment"
    assert st.degraded == (0 if rung == "policy" else len(tgraphs))
    assert st.failed == 0
    _assert_drained_invariants(st)


# --------------------------------------------------------------------- #
# supervisor
# --------------------------------------------------------------------- #
def test_worker_crash_restarts_and_completes_inhand(sched, pool, reference):
    plan = FaultPlan([FaultEvent("crash", at=0, rung="policy")])
    with SchedulerService(FaultyScheduler(sched, plan), max_batch=8,
                          max_wait_ms=2, degrade=_cfg()) as svc:
        futs = [svc.submit(g, N_STAGES) for g in pool]
        res = [f.result(timeout=120) for f in futs]
        # the restarted worker serves fresh traffic on the policy rung
        g = pool[0]
        r2 = svc.submit(g, N_STAGES).result(timeout=120)
        st = svc.stats()
    assert all(r["served_by"] == "heuristic" for r in res)
    assert all(validate_monotone(g, r["assignment"], N_STAGES)
               for g, r in zip(pool, res))
    assert r2["served_by"] == "policy"
    assert np.array_equal(r2["assignment"], reference[g.content_hash()])
    assert st.worker_restarts == 1 and st.degrade_crash == len(pool)
    assert st.failed == 0
    _assert_drained_invariants(st)


def test_persistent_crash_plan_completes_every_request(sched, pool):
    """Under a persistent worker-crash plan the service completes 100% of
    accepted requests (degraded rungs allowed) and leaves zero futures
    pending."""
    plan = FaultPlan([FaultEvent("crash", rung="policy", persistent=True)])
    n = 12
    with SchedulerService(FaultyScheduler(sched, plan), max_batch=4,
                          max_wait_ms=1, degrade=_cfg()) as svc:
        futs = [svc.submit(pool[i % len(pool)], N_STAGES) for i in range(n)]
        res = [f.result(timeout=120) for f in futs]
        st = svc.stats()
    assert all(f.done() for f in futs)
    assert len(res) == n and st.completed == n and st.failed == 0
    assert st.worker_restarts >= 1
    assert all(r["served_by"] == "heuristic" for r in res)
    for i, r in enumerate(res):
        assert validate_monotone(pool[i % len(pool)], r["assignment"],
                                 N_STAGES)
    _assert_drained_invariants(st)


def test_crash_then_close_drains_cleanly(sched, pool):
    """close() must fully drain even when the crash plan keeps firing
    during the drain itself."""
    plan = FaultPlan([FaultEvent("crash", rung="policy", persistent=True)])
    svc = SchedulerService(FaultyScheduler(sched, plan), max_batch=4,
                           max_wait_ms=1, degrade=_cfg())
    futs = [svc.submit(pool[i % len(pool)], N_STAGES) for i in range(8)]
    assert svc.close(timeout=120)
    assert all(f.done() for f in futs)
    _assert_drained_invariants(svc.stats())


# --------------------------------------------------------------------- #
# deadlines + overload
# --------------------------------------------------------------------- #
def test_expired_deadline_goes_straight_to_floor(sched, pool):
    with SchedulerService(sched, max_batch=4, max_wait_ms=20,
                          degrade=_cfg()) as svc:
        # a microsecond budget is over before the flush opens
        res = svc.submit(pool[0], N_STAGES,
                         deadline_ms=0.001).result(timeout=120)
        st = svc.stats()
    assert res["served_by"] == "heuristic"
    assert res["deadline_met"] is False
    assert st.degrade_deadline == 1 and st.deadline_missed == 1
    _assert_drained_invariants(st)


def test_estimator_skips_rungs_predicted_to_blow_budget(sched, pool):
    """Seeding the cost estimator with absurd policy/fallback costs makes
    the deadline check skip both rungs deterministically — the request
    completes IN budget at the heuristic floor."""
    cfg = _cfg(initial_cost_s={"policy": 10.0, "fallback": 10.0},
               deadline_headroom=1.5)
    with SchedulerService(sched, max_batch=4, max_wait_ms=1,
                          degrade=cfg) as svc:
        res = svc.submit(pool[0], N_STAGES,
                         deadline_ms=500.0).result(timeout=120)
        st = svc.stats()
    assert res["served_by"] == "heuristic"
    assert res["deadline_met"] is True
    assert st.degrade_deadline == 1 and st.deadline_missed == 0
    _assert_drained_invariants(st)


def test_generous_deadline_stays_on_policy(sched, pool, reference):
    with SchedulerService(sched, max_batch=4, max_wait_ms=1,
                          degrade=_cfg()) as svc:
        res = svc.submit(pool[1], N_STAGES,
                         deadline_ms=60_000.0).result(timeout=120)
    assert res["served_by"] == "policy" and res["deadline_met"] is True
    assert np.array_equal(res["assignment"],
                          reference[pool[1].content_hash()])


def test_overload_detector_hysteresis():
    det = OverloadDetector(DegradeConfig(queue_high=4, queue_low=1),
                           max_queue=8)
    assert det.update(3) is False          # below high: off
    assert det.update(4) is True           # crosses high: latches on
    assert det.update(2) is True           # between low and high: stays on
    assert det.update(1) is False          # at low: releases
    assert det.transitions == 2
    # optional p99 signal ORs into the latch
    det2 = OverloadDetector(DegradeConfig(queue_high=100, queue_low=50,
                                          p99_high_ms=20.0, p99_low_ms=5.0),
                            max_queue=128)
    assert det2.update(0, p99_ms=25.0) is True
    assert det2.update(0, p99_ms=10.0) is True    # above p99_low: holds
    assert det2.update(0, p99_ms=2.0) is False


def test_rung_cost_estimator_ewma():
    est = RungCostEstimator(alpha=0.5)
    assert est.estimate("policy", 4) == 0.0       # no evidence: never skip
    est.observe("policy", seconds=1.0, n_graphs=4)   # 0.25/graph
    assert est.estimate("policy", 2) == pytest.approx(0.5)
    est.observe("policy", seconds=2.0, n_graphs=4)   # toward 0.5/graph
    assert est.estimate("policy", 1) == pytest.approx(0.375)
    assert est.snapshot() == {"policy": pytest.approx(0.375)}


def test_sustained_overload_sheds_to_floor_and_recovers(sched, pool):
    """Backlog above the high watermark sheds flushes to the heuristic
    floor; once drained below the low watermark the latch releases."""
    gate = threading.Event()

    class _Gated:
        def __init__(self, inner):
            self._inner = inner
            self.calls = 0

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def schedule_many(self, *args, **kw):
            self.calls += 1
            if self.calls == 1:
                gate.wait(timeout=30)
            return self._inner.schedule_many(*args, **kw)

    rng = np.random.default_rng(99)
    distinct = [sample_dag(rng, n=int(rng.integers(9, 15)), deg=3)
                for _ in range(7)]
    cfg = _cfg(queue_high=4, queue_low=1)
    with SchedulerService(_Gated(sched), max_batch=1, max_wait_ms=0,
                          max_queue=8, degrade=cfg) as svc:
        futs = [svc.submit(g, N_STAGES) for g in distinct]
        time.sleep(0.05)           # let the worker wedge on request 0
        gate.set()
        res = [f.result(timeout=120) for f in futs]
        st = svc.stats()
    rungs = [r["served_by"] for r in res]
    assert st.degrade_overload >= 1 and "heuristic" in rungs
    # recovery: the latch is off once the backlog drained under low
    assert st.overloaded is False
    assert st.failed == 0
    _assert_drained_invariants(st)


# --------------------------------------------------------------------- #
# edge validation
# --------------------------------------------------------------------- #
def test_validate_graph_rejects_malformed():
    rng = np.random.default_rng(0)
    g = sample_dag(rng, n=8, deg=3)
    validate_graph(g)                     # healthy graph passes
    bad_nan = sample_dag(rng, n=8, deg=3)
    bad_nan.flops[2] = np.nan
    with pytest.raises(InvalidGraphError, match="NaN/inf"):
        validate_graph(bad_nan)
    bad_neg = sample_dag(rng, n=8, deg=3)
    bad_neg.out_bytes[0] = -4.0
    with pytest.raises(InvalidGraphError, match="negative"):
        validate_graph(bad_neg)
    bad_cycle = sample_dag(rng, n=8, deg=3)
    bad_cycle.parents[1] = [3]            # edge from a LATER node: cycle
    with pytest.raises(InvalidGraphError, match="topological"):
        validate_graph(bad_cycle)


def test_submit_rejects_invalid_graph_at_edge(sched, pool):
    bad = sample_dag(np.random.default_rng(1), n=8, deg=3)
    bad.flops[0] = -1.0
    with SchedulerService(sched, max_batch=2, max_wait_ms=1) as svc:
        with pytest.raises(InvalidGraphError):
            svc.submit(bad, N_STAGES)
        with pytest.raises(ValueError, match="deadline_ms"):
            svc.submit(pool[0], N_STAGES, deadline_ms=-5.0)
        ok = svc.submit(pool[0], N_STAGES).result(timeout=120)
        st = svc.stats()
    assert validate_monotone(pool[0], ok["assignment"], N_STAGES)
    assert st.rejected_invalid == 1
    assert st.requests == 1               # the rejects never counted
    _assert_drained_invariants(st)


# --------------------------------------------------------------------- #
# seeded chaos soak
# --------------------------------------------------------------------- #
def test_faultplan_random_is_deterministic():
    a = FaultPlan.random(seed=42, n_calls=64, rungs=("policy", "fallback"))
    b = FaultPlan.random(seed=42, n_calls=64, rungs=("policy", "fallback"))
    assert a.events == b.events and len(a) > 0
    c = FaultPlan.random(seed=43, n_calls=64, rungs=("policy", "fallback"))
    assert a.events != c.events
    # adding a rung never reshuffles an existing rung's schedule
    d = FaultPlan.random(seed=42, n_calls=64, rungs=("policy",))
    assert [e for e in a.events if e.rung == "policy"] == list(d.events)


@pytest.mark.parametrize("seed,rungs", [
    (0, ("policy", "fallback")),
    (1, ("policy",)),
    (2, ("fallback", "policy")),
    (42, ("policy", "fallback", "any")),
])
def test_faultplan_random_matches_reference(seed, rungs):
    """The same arguments give the reference's events, in order: a chaos
    run replays the same faults in both packages."""
    kw = dict(seed=seed, n_calls=64, p_crash=0.08, p_error=0.15, p_slow=0.05,
              p_corrupt=0.08, slow_s=0.005, rungs=rungs)
    got = [dataclasses.astuple(e) for e in FaultPlan.random(**kw).events]
    want = [dataclasses.astuple(e) for e in jserving.FaultPlan.random(**kw).events]
    assert got == want and len(got) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_fault_soak(sched, pool, reference, seed):
    """Seeded FaultPlan sweep x duplicate-storm traffic.  Whatever fires:
    no pending futures, the drained-stats invariant holds, every result
    is a valid schedule, and policy-rung results stay bit-identical to
    the no-service reference."""
    plan = FaultPlan.random(seed=seed, n_calls=40, p_crash=0.08,
                            p_error=0.15, p_slow=0.05, p_corrupt=0.08,
                            slow_s=0.005, rungs=("policy", "fallback"))
    n = 30
    with SchedulerService(FaultyScheduler(sched, plan), max_batch=4,
                          max_wait_ms=1, degrade=_cfg()) as svc:
        futs = [svc.submit(pool[i % len(pool)], N_STAGES) for i in range(n)]
        res = [f.result(timeout=120) for f in futs]
        st = svc.stats()
    assert all(f.done() for f in futs)
    assert st.requests == n
    _assert_drained_invariants(st)
    for i, r in enumerate(res):
        g = pool[i % len(pool)]
        assert r["served_by"] in ("policy", "fallback", "heuristic")
        assert validate_monotone(g, r["assignment"], N_STAGES)
        if r["served_by"] == "policy":
            assert np.array_equal(r["assignment"],
                                  reference[g.content_hash()])
