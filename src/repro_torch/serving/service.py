"""Asynchronous scheduler service: queue, micro-batcher, single-flight,
supervised worker, deadline budgets and a degradation ladder — the
reference's ``repro.serving.service`` over the port's
:class:`~repro_torch.core.RespectScheduler`, whose miss path runs the
pointer kernels B1/B2 on the card.

``RespectScheduler.schedule_many`` is a *batch* engine — it is fast when
someone hands it a pre-formed list of graphs.  Real serving traffic is a
stream of single requests arriving at arbitrary times.  This module
bridges the two with the classic inference-serving front end:

* **bounded request queue with backpressure** — ``submit(graph,
  n_stages)`` returns a ``concurrent.futures.Future`` immediately; when
  the queue is full, ``submit`` blocks up to its ``timeout`` and then
  raises :class:`ServiceOverloadedError`, so overload surfaces at the
  edge instead of growing an unbounded backlog.  Malformed graphs are
  rejected at the edge too (:func:`repro_torch.core.graph.validate_graph` ->
  :class:`~repro_torch.core.graph.InvalidGraphError`) so attacker-shaped input
  can never crash the worker mid-flush;
* **adaptive micro-batcher** — a single worker thread coalesces queued
  requests and flushes when ``max_batch`` is reached or ``max_wait_ms``
  has elapsed since the batch opened, whichever is first;
* **supervised worker** — the worker loop runs under an in-thread
  supervisor: an exception that escapes flush handling (including
  injected ``BaseException`` crashes from the fault harness) fails ONLY
  the requests in hand — serving them at the heuristic floor when the
  ladder is enabled — then restarts the loop with bounded exponential
  backoff.  The no-future-left-pending invariant holds across restarts;
* **deadline budgets + degradation ladder** — ``submit(...,
  deadline_ms=)`` carries a budget spanning queue wait + batch wait +
  compute.  A flush predicted to blow its batch's tightest budget, a
  policy-path exception (after bounded retry), a corrupted result, or
  sustained overload drops the affected work one rung down
  ``policy -> fallback -> heuristic`` (:mod:`repro_torch.serving.degrade`);
  every result records its rung in ``ScheduleResult["served_by"]`` and
  whether it met its budget in ``["deadline_met"]``.  A kernel that
  cannot be built, loaded or launched, or a CUDA error the card reports,
  is not a transient fault: the affected requests fail with it (counted
  ``failed``) instead of being retried or served from the host floor;
* **single-flight dedup** — an identical in-flight request (same content
  hash, stages, system) attaches its future to the running computation
  instead of re-queueing (bounded by ``max_waiters``);
* **warmup** — :meth:`SchedulerService.warmup` builds and loads the
  pointer kernels on a CUDA scheduler, then runs stand-in batches of the
  bucket shapes production traffic is expected to hit, so the first live
  request neither waits for ``nvcc`` nor teaches the rung cost estimator
  a build's seconds;
* **metrics + graceful shutdown** — rolling p50/p99 latency, queue
  depth, hit/dedup/rung/SLO counters (:mod:`repro_torch.serving.metrics`);
  :meth:`SchedulerService.close` stops intake, drains every accepted
  request and joins the worker, so no future is ever left pending.

With no faults injected and no deadline pressure, output is bit-identical
to calling ``schedule_many`` on the same graphs — the service only
changes *when* work runs, never *what* runs (asserted by the concurrency
tests and the traffic benchmark).  Degraded rungs trade that exactness
for completion, and say so in ``served_by``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..core.batching import bucketize
from ..core.costmodel import PipelineSystem
from ..core.graph import CompGraph, InvalidGraphError, validate_graph
from ..core.heuristic import heuristic_schedule_many
from ..core.respect import RespectScheduler, ScheduleResult
from ..core.sampler import sample_dag
from ..kernels.build import KernelError
from .degrade import (
    LADDER,
    RUNG_FALLBACK,
    RUNG_HEURISTIC,
    RUNG_POLICY,
    DegradeConfig,
    OverloadDetector,
    RungCostEstimator,
)
from .metrics import LatencyWindow, ServiceStats

__all__ = [
    "SchedulerService",
    "ServiceClosedError",
    "ServiceOverloadedError",
    "InvalidGraphError",
]

_SENTINEL = object()
#: errors that the ladder passes to the affected futures instead of
#: degrading: every rung above the floor runs the same kernels on the same
#: card, and the floor would quietly move the work to the host
_KERNEL_FAULTS = (KernelError, getattr(torch, "AcceleratorError", KernelError))
#: default ladder config; pass ``degrade=None`` for fail-fast semantics
#: (flush exceptions propagate to the affected futures instead of
#: degrading — the pre-ladder contract, still used by strict tests)
_DEFAULT_DEGRADE = DegradeConfig()


class ServiceClosedError(RuntimeError):
    """submit() after close()."""


class ServiceOverloadedError(RuntimeError):
    """The bounded request queue stayed full past the submit timeout."""


class _Request:
    __slots__ = ("graph", "key", "n_stages", "system", "future",
                 "t_submit", "deadline", "waiters")

    def __init__(self, graph: CompGraph, key: tuple, n_stages: int,
                 system: PipelineSystem, deadline_ms: float | None):
        self.graph = graph
        self.key = key
        self.n_stages = n_stages
        self.system = system
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        # absolute budget expiry (perf_counter clock), None = no budget
        self.deadline = (None if deadline_ms is None
                         else self.t_submit + deadline_ms / 1e3)
        # duplicate submissions that coalesced onto this computation:
        # (future, t_submit, deadline) triples, appended under the lock.
        self.waiters: list[tuple[Future, float, float | None]] = []


def _copied_result(res: ScheduleResult) -> ScheduleResult:
    """Fresh copy so coalesced waiters never share mutable arrays."""
    out = ScheduleResult(res)
    out["assignment"] = res["assignment"].copy()
    out["order"] = res["order"].copy()
    return out


class SchedulerService:
    """Arrival-driven front end over a :class:`RespectScheduler`.

    Parameters
    ----------
    scheduler:      the batch engine to drive (owns params + caches).
    max_batch:      flush a micro-batch at this many requests.
    max_wait_ms:    flush an underfull micro-batch this long after it
                    opened (the tail-latency bound for trickle traffic).
    max_queue:      bounded queue depth; beyond it ``submit`` exerts
                    backpressure.
    dedup:          coalesce identical in-flight requests (single-flight).
    max_waiters:    bound on duplicates coalesced onto ONE in-flight
                    computation (default ``max_queue``).
    use_cache:      serve repeats from the scheduler's content-hash LRU.
    latency_window: number of recent latency samples kept for p50/p99.
    degrade:        :class:`~repro_torch.serving.degrade.DegradeConfig` for the
                    deadline/overload/failure ladder (the default), or
                    ``None`` for fail-fast semantics (flush errors
                    propagate to the affected futures; deadlines are
                    recorded but never trigger degradation).
    """

    def __init__(self, scheduler: RespectScheduler, max_batch: int = 16,
                 max_wait_ms: float = 2.0, max_queue: int = 256,
                 dedup: bool = True, use_cache: bool = True,
                 latency_window: int = 2048, max_waiters: int | None = None,
                 degrade: DegradeConfig | None = _DEFAULT_DEGRADE):
        if max_batch < 1:
            raise ValueError("max_batch >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms >= 0")
        self._scheduler = scheduler
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.dedup = dedup
        self.use_cache = use_cache
        self._max_waiters = max_queue if max_waiters is None else max_waiters
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._lock = threading.Lock()
        self._inflight: dict[tuple, _Request] = {}
        self._latency = LatencyWindow(latency_window)
        self._closed = False
        self._putting = 0          # submitters currently blocked in put()
        # ladder machinery (supervisor knobs come from the config even
        # when the ladder itself is off)
        self._degrade = degrade
        sup_cfg = degrade if degrade is not None else _DEFAULT_DEGRADE
        self._restart_backoff_init = sup_cfg.restart_backoff_s
        self._restart_backoff_max = sup_cfg.restart_backoff_max_s
        self._restart_backoff = self._restart_backoff_init
        self._overload = OverloadDetector(sup_cfg, max_queue)
        self._estimator = RungCostEstimator(
            initial=sup_cfg.initial_cost_s)
        # requests the worker currently holds (crash scope); worker-thread
        # only — the supervisor runs in the same thread after a crash
        self._inhand: list[_Request] = []
        # counters (all mutated under self._lock)
        self._requests = 0
        self._completed = 0
        self._failed = 0
        self._cache_hits = 0
        self._cache_misses = 0
        self._dedup_hits = 0
        self._batches = 0
        self._flush_full = 0
        self._flush_deadline = 0
        self._flush_drain = 0
        self._max_batch_observed = 0
        self._served_policy = 0
        self._served_fallback = 0
        self._served_heuristic = 0
        self._degraded = 0
        self._degrade_deadline = 0
        self._degrade_overload = 0
        self._degrade_error = 0
        self._degrade_crash = 0
        self._deadline_missed = 0
        self._retries = 0
        self._worker_restarts = 0
        self._rejected_invalid = 0
        self._worker = threading.Thread(
            target=self._worker_main, name="respect-serve", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ #
    # client API
    # ------------------------------------------------------------------ #
    def submit(self, graph: CompGraph, n_stages: int,
               system: PipelineSystem | None = None,
               timeout: float | None = None,
               deadline_ms: float | None = None) -> Future:
        """Enqueue one request; resolves to a :class:`ScheduleResult`.

        ``deadline_ms``: optional end-to-end latency budget (queue wait +
        batch wait + compute).  Work predicted to blow it is served on a
        cheaper rung (see :mod:`repro_torch.serving.degrade`); the result
        records ``deadline_met`` either way.  Blocks up to ``timeout``
        seconds when the queue is full (``timeout=0`` never blocks);
        raises :class:`ServiceOverloadedError` if no slot frees up,
        :class:`InvalidGraphError` on malformed input and
        :class:`ServiceClosedError` after :meth:`close`.
        """
        try:
            validate_graph(graph)
        except InvalidGraphError:
            with self._lock:
                self._rejected_invalid += 1
            raise
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive")
        # normalize exactly like the scheduler, so the dedup key and the
        # schedule-cache key agree and results stay bit-identical
        system = (system or PipelineSystem(n_stages)).with_stages(n_stages)
        key = (graph.content_hash(), n_stages, system)
        req = _Request(graph, key, n_stages, system, deadline_ms)
        with self._lock:
            if self._closed:
                raise ServiceClosedError("service is closed")
            self._requests += 1
            if self.dedup and key in self._inflight:
                holder = self._inflight[key]
                if len(holder.waiters) >= self._max_waiters:
                    # a hot-key flood must feel backpressure too, not
                    # grow an unbounded waiter list off the bounded queue
                    self._failed += 1
                    err = ServiceOverloadedError(
                        f"{len(holder.waiters)} duplicates already "
                        f"coalesced on this in-flight graph")
                    req.future.set_exception(err)
                    raise err
                holder.waiters.append((req.future, req.t_submit,
                                       req.deadline))
                self._dedup_hits += 1
                return req.future
            if self.dedup:
                self._inflight[key] = req
            self._putting += 1
        try:
            self._queue.put(req, block=timeout != 0, timeout=timeout)
        except queue.Full:
            with self._lock:
                self._putting -= 1
                if self.dedup and self._inflight.get(key) is req:
                    del self._inflight[key]
                waiters = req.waiters
                # waiters were provisionally classified dedup_hits; their
                # coalesce target never ran, so reclassify them as failed
                # to keep hits+misses+dedups+degraded+failed == requests.
                self._dedup_hits -= len(waiters)
                self._failed += 1 + len(waiters)
            err = ServiceOverloadedError(
                f"queue full ({self._queue.maxsize}) for {timeout}s")
            req.future.set_exception(err)
            for fut, _, _ in waiters:
                # duplicates that coalesced onto a rejected request are
                # rejected with it — they never held a queue slot.
                fut.set_exception(err)
            raise err from None
        with self._lock:
            self._putting -= 1
        return req.future

    def schedule(self, graph: CompGraph, n_stages: int,
                 system: PipelineSystem | None = None,
                 timeout: float | None = None,
                 deadline_ms: float | None = None) -> ScheduleResult:
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(graph, n_stages, system, timeout=timeout,
                           deadline_ms=deadline_ms).result()

    def warmup(self, shapes, n_stages: int = 4,
               system: PipelineSystem | None = None, deg: int = 3,
               seed: int = 0) -> list[tuple]:
        """Warm the miss path for expected bucket shapes.

        ``shapes`` is an iterable whose entries are an int node count
        ``n`` (batch of 1), an ``(n, batch)`` pair, or a ready
        :class:`CompGraph`.  On a CUDA scheduler the miss path's kernels
        are built and loaded first (:meth:`RespectScheduler.load_kernels`);
        then synthetic stand-in DAGs (``sample_dag`` with in-degree
        ``deg``) run through ``schedule_many`` without the schedule cache,
        which warms the CUDA context and the caching allocator at those
        shapes.  Eager PyTorch compiles nothing per shape, so where the
        reference returns its compiled programs' keys this returns the
        ``(bucket_n, bucket_b, n_stages, system, decode_impl)`` keys of
        the batches it ran, in order, without repeats; ``bucket_b`` is the
        batch as run (the port pads no batch dimension).
        """
        self._scheduler.load_kernels()
        system = (system or PipelineSystem(n_stages)).with_stages(n_stages)
        conditioned = bool(system.profile_features().any())
        decoder = self._scheduler._decoder
        rng = np.random.default_rng(seed)
        keys: list[tuple] = []
        for spec in shapes:
            if isinstance(spec, CompGraph):
                gs = [spec]
            else:
                n, b = spec if isinstance(spec, tuple) else (spec, 1)
                gs = [sample_dag(rng, n=max(int(n), 3), deg=deg)
                      for _ in range(int(b))]
            self._scheduler.schedule_many(
                gs, n_stages, system, use_cache=False)
            for bucket_n, idxs in bucketize(gs, decoder.min_bucket).items():
                impl = decoder.resolve_decode_impl(
                    bucket_n, self._scheduler.hidden, conditioned)
                key = (bucket_n, len(idxs), n_stages, system, impl)
                if key not in keys:
                    keys.append(key)
        return keys

    def stats(self) -> ServiceStats:
        p50, p99 = self._latency.percentiles_ms((50.0, 99.0))
        with self._lock:
            return ServiceStats(
                requests=self._requests,
                completed=self._completed,
                failed=self._failed,
                cache_hits=self._cache_hits,
                cache_misses=self._cache_misses,
                dedup_hits=self._dedup_hits,
                batches=self._batches,
                flush_full=self._flush_full,
                flush_deadline=self._flush_deadline,
                flush_drain=self._flush_drain,
                max_batch_observed=self._max_batch_observed,
                queue_depth=self._queue.qsize(),
                inflight_keys=len(self._inflight),
                served_policy=self._served_policy,
                served_fallback=self._served_fallback,
                served_heuristic=self._served_heuristic,
                degraded=self._degraded,
                degrade_deadline=self._degrade_deadline,
                degrade_overload=self._degrade_overload,
                degrade_error=self._degrade_error,
                degrade_crash=self._degrade_crash,
                deadline_missed=self._deadline_missed,
                retries=self._retries,
                worker_restarts=self._worker_restarts,
                rejected_invalid=self._rejected_invalid,
                overloaded=self._overload.overloaded,
                p50_ms=p50,
                p99_ms=p99,
                mean_ms=self._latency.mean_ms(),
            )

    def close(self, timeout: float | None = None) -> bool:
        """Stop intake, drain every accepted request, join the worker.

        Idempotent.  Returns True once the worker has fully drained and
        exited — from then on every future ever handed out is resolved
        (with a result or an exception), even if the worker crashed and
        restarted any number of times along the way.  With a ``timeout``
        it may return False: the drain is still running and pending
        futures will resolve later."""
        with self._lock:
            already = self._closed
            self._closed = True
        if not already:
            try:
                self._queue.put_nowait(_SENTINEL)   # wake the worker now
            except queue.Full:
                pass          # worker is busy; it polls the closed flag
        if self._worker.is_alive():
            self._worker.join(timeout)
        return not self._worker.is_alive()

    def __enter__(self) -> "SchedulerService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # supervisor
    # ------------------------------------------------------------------ #
    def _worker_main(self) -> None:
        """Supervise the worker loop: a crash (ANY escaping exception,
        ``BaseException`` included) resolves the in-hand requests — at
        the heuristic floor when the ladder is on, as failures otherwise
        — then restarts the loop after a bounded exponential backoff.
        The thread exits only when the service is closed and drained."""
        while True:
            try:
                self._worker_loop()
                return                      # clean drain exit
            except BaseException as exc:    # noqa: B036 — crash barrier
                self._on_worker_crash(exc)
                with self._lock:
                    self._worker_restarts += 1
                time.sleep(self._restart_backoff)
                self._restart_backoff = min(
                    self._restart_backoff * 2, self._restart_backoff_max)

    def _on_worker_crash(self, exc: BaseException) -> None:
        """Crash scope resolution: every in-hand request whose future is
        still pending is served at the heuristic floor (ladder on) or
        failed with the crash exception (ladder off) — a restart never
        strands a future."""
        pending = [r for r in self._inhand if not r.future.done()]
        self._inhand = []
        if not pending:
            return
        if self._degrade is None:
            e = (exc if isinstance(exc, Exception)
                 else RuntimeError(f"worker crashed: {exc!r}"))
            self._resolve_error(pending, e)
            return
        groups: dict[tuple, list[_Request]] = {}
        for r in pending:
            groups.setdefault((r.n_stages, r.system), []).append(r)
        for (n_stages, system), reqs in groups.items():
            try:
                self._serve_heuristic(reqs, n_stages, system, "crash")
            except Exception as e2:        # pragma: no cover — paranoia
                self._resolve_error(reqs, e2)

    # ------------------------------------------------------------------ #
    # worker
    # ------------------------------------------------------------------ #
    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                closed = self._closed
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                if closed and self._drain():
                    return
                continue
            if item is _SENTINEL:
                continue      # wake-up only; the closed flag drives drain
            batch, reason = self._collect(item)
            self._flush(batch, reason)

    def _drain(self) -> bool:
        """Post-close sweep: flush the backlog (plus any racing put that
        landed after close) until the queue is empty and no submitter is
        mid-put.  True = fully drained, worker may exit."""
        while True:
            leftovers: list[_Request] = []
            while True:
                try:
                    it = self._queue.get_nowait()
                except queue.Empty:
                    break
                if it is not _SENTINEL:
                    leftovers.append(it)
            for i in range(0, len(leftovers), self.max_batch):
                self._flush(leftovers[i:i + self.max_batch], "drain")
            with self._lock:
                busy = self._putting
            if not leftovers and busy == 0 and self._queue.empty():
                return True
            if not leftovers:
                time.sleep(1e-3)

    def _collect(self, first: _Request):
        """Fill a micro-batch: up to ``max_batch`` requests, waiting at
        most ``max_wait_s`` past the moment the batch opened.  A backlog
        already sitting in the queue is scooped with zero extra wait even
        after the deadline, so bursts fill batches instantly."""
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            try:
                item = self._queue.get(timeout=max(0.0, remaining))
            except queue.Empty:
                return batch, "deadline"
            if item is _SENTINEL:
                return batch, "drain"
            batch.append(item)
        return batch, "full"

    def _flush(self, batch: list[_Request], reason: str) -> None:
        if not batch:
            return
        with self._lock:
            self._batches += 1
            self._max_batch_observed = max(self._max_batch_observed,
                                           len(batch))
            if reason == "full":
                self._flush_full += 1
            elif reason == "deadline":
                self._flush_deadline += 1
            else:
                self._flush_drain += 1
        # sustained-overload check, once per flush: queue depth past the
        # batch we just scooped, plus (optionally) rolling p99
        overloaded = False
        if self._degrade is not None:
            p99 = None
            if self._degrade.p99_high_ms is not None:
                p99 = self._latency.percentiles_ms((99.0,))[0]
            overloaded = self._overload.update(self._queue.qsize(), p99)
        # one schedule_many per (stages, system) group; size bucketing
        # happens inside the engine.  _inhand is the crash scope: if
        # anything below escapes, the supervisor resolves what's left.
        self._inhand = list(batch)
        groups: dict[tuple, list[_Request]] = {}
        for r in batch:
            groups.setdefault((r.n_stages, r.system), []).append(r)
        for (n_stages, system), reqs in groups.items():
            self._serve_group(reqs, n_stages, system, overloaded)
        self._inhand = []
        # a fully clean flush re-arms the supervisor's backoff
        self._restart_backoff = self._restart_backoff_init

    # ------------------------------------------------------------------ #
    # the ladder
    # ------------------------------------------------------------------ #
    def _tightest_remaining(self, reqs: list[_Request]) -> float:
        """Smallest remaining deadline budget (seconds) across the group's
        primaries AND coalesced waiters; +inf when nobody set one."""
        now = time.perf_counter()
        tight = float("inf")
        for r in reqs:
            if r.deadline is not None:
                tight = min(tight, r.deadline - now)
            for _, _, dl in r.waiters:
                if dl is not None:
                    tight = min(tight, dl - now)
        return tight

    def _result_ok(self, req: _Request, res, n_stages: int) -> bool:
        """Cheap structural validation of one rung result — catches
        corrupted-shape outputs before they reach a caller."""
        try:
            a = np.asarray(res["assignment"])
            o = np.asarray(res["order"])
        except Exception:
            return False
        n = req.graph.n
        if a.shape != (n,) or o.shape != (n,):
            return False
        if a.dtype.kind not in "iu" or o.dtype.kind not in "iu":
            return False
        return bool((a >= 0).all() and (a < n_stages).all())

    def _serve_group(self, reqs: list[_Request], n_stages: int,
                     system: PipelineSystem, overloaded: bool) -> None:
        cfg = self._degrade
        if cfg is None:
            # fail-fast semantics: one policy attempt, errors propagate
            try:
                results = self._scheduler.schedule_many(
                    [r.graph for r in reqs], n_stages, system,
                    use_cache=self.use_cache)
            except Exception as exc:
                self._resolve_error(reqs, exc)
                return
            self._resolve(reqs, results)
            return

        first_reason: str | None = None
        start = 0
        if overloaded:
            # load shedding: only the host floor actually sheds compute
            start, first_reason = len(LADDER) - 1, "overload"
        elif self._tightest_remaining(reqs) <= 0.0:
            # budget already blown: complete ASAP at the cheap rung
            start, first_reason = len(LADDER) - 1, "deadline"

        pending = reqs
        for rung_i in range(start, len(LADDER)):
            if not pending:
                return
            rung = LADDER[rung_i]
            if rung == RUNG_HEURISTIC:
                self._serve_heuristic(pending, n_stages, system,
                                      first_reason or "error")
                return
            est = self._estimator.estimate(rung, len(pending))
            tight = self._tightest_remaining(pending)
            if est > 0.0 and tight < est * cfg.deadline_headroom:
                # this rung is predicted to blow the tightest budget
                if first_reason is None:
                    first_reason = "deadline"
                continue
            try:
                results = self._attempt_rung(pending, rung, n_stages,
                                             system, cfg, est)
            except _KERNEL_FAULTS as exc:
                self._resolve_error(pending, exc)
                return
            if results is None:            # errored out past the retries
                if first_reason is None:
                    first_reason = "error"
                continue
            good_r, good_res, bad = [], [], []
            for req, res in zip(pending, results):
                if self._result_ok(req, res, n_stages):
                    good_r.append(req)
                    good_res.append(res)
                else:
                    # per-request isolation: only the corrupted results
                    # descend; their batchmates resolve right here
                    bad.append(req)
            if good_r:
                self._resolve(good_r, good_res, reason=first_reason)
            if bad and first_reason is None:
                first_reason = "error"
            pending = bad

    def _attempt_rung(self, reqs: list[_Request], rung: str, n_stages: int,
                      system: PipelineSystem, cfg: DegradeConfig,
                      est: float):
        """Run one rung with bounded retry-with-backoff for transient
        failures (only while the tightest budget still covers the backoff
        plus the predicted retry).  Returns results or None; a kernel
        fault propagates at once."""
        graphs = [r.graph for r in reqs]
        attempt = 0
        backoff = cfg.retry_backoff_s
        while True:
            t0 = time.perf_counter()
            try:
                if rung == RUNG_POLICY:
                    results = self._scheduler.schedule_many(
                        graphs, n_stages, system, use_cache=self.use_cache)
                else:
                    results = self._scheduler.fallback_schedule_many(
                        graphs, n_stages, system)
            except _KERNEL_FAULTS:
                raise
            except Exception:
                tight = self._tightest_remaining(reqs)
                if (attempt < cfg.retry_attempts
                        and tight - backoff > est * cfg.deadline_headroom):
                    attempt += 1
                    with self._lock:
                        self._retries += 1
                    time.sleep(backoff)
                    backoff = min(backoff * 2, cfg.retry_backoff_max_s)
                    continue
                return None
            self._estimator.observe(
                rung, time.perf_counter() - t0, len(reqs))
            return results

    def _serve_heuristic(self, reqs: list[_Request], n_stages: int,
                         system: PipelineSystem, reason: str) -> None:
        """The ladder's floor: host ``list_schedule`` per request.  Pure
        numpy with per-request isolation — this rung always completes."""
        t0 = time.perf_counter()
        good_r, good_res = [], []
        for req in reqs:
            try:
                order, assign = heuristic_schedule_many(
                    [req.graph], n_stages, system)[0]
            except Exception as exc:       # pragma: no cover — paranoia
                self._resolve_error([req], exc)
                continue
            good_r.append(req)
            good_res.append(ScheduleResult(
                assignment=assign, order=order, n_stages=n_stages,
                model=req.graph.model_name, cache_hit=False,
                served_by=RUNG_HEURISTIC))
        if good_r:
            self._estimator.observe(
                RUNG_HEURISTIC, time.perf_counter() - t0, len(good_r))
            self._resolve(good_r, good_res, reason=reason)

    # ------------------------------------------------------------------ #
    # resolution
    # ------------------------------------------------------------------ #
    def _detach(self, req: _Request) -> list[tuple]:
        """Remove ``req`` from the in-flight map and freeze its waiters.
        After this, new identical submissions queue normally (and hit the
        schedule cache, which was filled before we got here)."""
        if self._inflight.get(req.key) is req:
            del self._inflight[req.key]
        return req.waiters

    @staticmethod
    def _set_result(fut: Future, res) -> None:
        """Resolve a future, tolerating caller-side ``cancel()`` — only
        the worker thread ever resolves, so ``done()`` is race-free."""
        if fut.done() or not fut.set_running_or_notify_cancel():
            return
        fut.set_result(res)

    @staticmethod
    def _set_exception(fut: Future, exc: Exception) -> None:
        if fut.done() or not fut.set_running_or_notify_cancel():
            return
        fut.set_exception(exc)

    def _resolve(self, reqs: list[_Request], results: list[ScheduleResult],
                 reason: str | None = None) -> None:
        t_done = time.perf_counter()
        for req, res in zip(reqs, results):
            rung = res.get("served_by", RUNG_POLICY)
            met = req.deadline is None or t_done <= req.deadline
            res["deadline_met"] = met
            with self._lock:
                waiters = self._detach(req)
                self._completed += 1 + len(waiters)
                if rung == RUNG_POLICY:
                    self._served_policy += 1
                    if res["cache_hit"]:
                        self._cache_hits += 1
                    else:
                        self._cache_misses += 1
                else:
                    # a degraded primary terminates in the `degraded`
                    # bucket (never hits/misses): the stats invariant is
                    # hits+misses+dedups+degraded+failed == requests
                    self._degraded += 1
                    if rung == RUNG_FALLBACK:
                        self._served_fallback += 1
                    else:
                        self._served_heuristic += 1
                    key = f"_degrade_{reason or 'error'}"
                    setattr(self, key, getattr(self, key) + 1)
                if not met:
                    self._deadline_missed += 1
            self._latency.add(t_done - req.t_submit)
            self._set_result(req.future, res)
            for fut, t_sub, dl in waiters:
                wres = _copied_result(res)
                wmet = dl is None or t_done <= dl
                wres["deadline_met"] = wmet
                if not wmet:
                    with self._lock:
                        self._deadline_missed += 1
                self._latency.add(t_done - t_sub)
                self._set_result(fut, wres)

    def _resolve_error(self, reqs: list[_Request], exc: Exception) -> None:
        for req in reqs:
            with self._lock:
                waiters = self._detach(req)
                # retract the provisional dedup classification (see the
                # overload path in submit): a waiter whose computation
                # errored terminates as failed, not as a served dedup.
                self._dedup_hits -= len(waiters)
                self._failed += 1 + len(waiters)
            self._set_exception(req.future, exc)
            for fut, _, _ in waiters:
                self._set_exception(fut, exc)
