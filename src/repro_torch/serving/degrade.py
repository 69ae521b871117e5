"""Deadline budgets and the SLO-aware degradation ladder; the rungs,
watermarks and cost estimator of the reference's ``repro.serving.degrade``.

The service never rejects work it has already accepted and never spends
more latency than a request's budget allows.  When the preferred path
cannot deliver — a policy exception, a flush that would blow the batch's
tightest deadline, or sustained overload — the work drops one rung down
a fixed ladder instead of failing:

    rung 0  ``policy``     trained-policy miss path (+ schedule cache): the
                           pointer kernels B1/B2 on the card
    rung 1  ``fallback``   seeded-weights decode through the SAME engine
                           (``RespectScheduler.fallback_schedule_many``)
                           — survives corrupted/poisoned trained params
    rung 2  ``heuristic``  host ``list_schedule`` (``core.heuristic``)
                           — pure numpy, per-request isolated, cannot be
                           reached by the fault-injection seam; this rung
                           ALWAYS succeeds, so every accepted request
                           completes.

Three mechanisms feed the ladder:

* **deadline budgets** — ``submit(..., deadline_ms=)`` spans queue wait +
  batch wait + compute.  At flush time the worker compares the batch's
  tightest remaining budget against an EWMA estimate of the rung's
  per-graph cost (:class:`RungCostEstimator`); a rung predicted to blow
  the budget is skipped.  An already-expired budget goes straight to the
  heuristic floor — completing late at the cheap rung beats completing
  later at the expensive one.
* **overload watermarks with hysteresis** — queue depth (and optionally
  rolling p99) above the high watermark sheds NEW flushes to the
  heuristic floor until the signal falls below the low watermark
  (:class:`OverloadDetector`), so the service degrades predictably under
  sustained overload instead of letting the queue-full backpressure
  reject at the edge.
* **bounded retry** — a transient flush exception is retried on the same
  rung with exponential backoff, at most ``retry_attempts`` times and
  only while the budget still covers the backoff plus the retry itself.
"""

from __future__ import annotations

import dataclasses
import threading

__all__ = [
    "RUNG_POLICY",
    "RUNG_FALLBACK",
    "RUNG_HEURISTIC",
    "LADDER",
    "DegradeConfig",
    "OverloadDetector",
    "RungCostEstimator",
]

RUNG_POLICY = "policy"
RUNG_FALLBACK = "fallback"
RUNG_HEURISTIC = "heuristic"
#: rung order, best first; index in this tuple == rung number
LADDER = (RUNG_POLICY, RUNG_FALLBACK, RUNG_HEURISTIC)


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    """Knobs for the ladder.  All times in seconds unless suffixed _ms.

    ``queue_high``/``queue_low``: queue-depth overload watermarks
    (fractions of ``max_queue`` when < 1.0, absolute depths otherwise);
    ``p99_high_ms``/``p99_low_ms``: optional rolling-p99 watermarks
    (``None`` disables the latency signal);
    ``deadline_headroom``: a rung is skipped when the tightest remaining
    budget < estimated rung cost * headroom;
    ``retry_attempts``: bounded same-rung retries for transient flush
    failures; ``retry_backoff_s`` doubles per attempt up to
    ``retry_backoff_max_s``;
    ``restart_backoff_s``/``restart_backoff_max_s``: supervisor backoff
    between worker restarts after a crash (doubles per consecutive
    crash, resets on the first clean flush);
    ``initial_cost_s``: optional rung -> per-graph seconds seed for the
    cost estimator (deterministic tests; production learns online).
    """

    queue_high: float = 0.75
    queue_low: float = 0.5
    p99_high_ms: float | None = None
    p99_low_ms: float | None = None
    deadline_headroom: float = 1.5
    retry_attempts: int = 1
    retry_backoff_s: float = 0.01
    retry_backoff_max_s: float = 0.25
    restart_backoff_s: float = 0.05
    restart_backoff_max_s: float = 1.0
    initial_cost_s: dict | None = None

    def resolve_watermarks(self, max_queue: int) -> tuple[int, int]:
        """(high, low) absolute queue depths for a given ``max_queue``."""
        high = (self.queue_high * max_queue if self.queue_high < 1.0
                else self.queue_high)
        low = (self.queue_low * max_queue if self.queue_low < 1.0
               else self.queue_low)
        high = max(int(high), 1)
        return high, min(max(int(low), 0), high - 1)


class OverloadDetector:
    """Hysteresis latch over queue depth and (optionally) rolling p99.

    ``update(depth, p99_ms)`` is called by the worker before each flush;
    the latch turns ON when either signal crosses its high watermark and
    OFF only when BOTH are back under their low watermarks — so recovery
    doesn't flap between rungs at the boundary.  Thread-safe (``stats()``
    reads from other threads).
    """

    def __init__(self, cfg: DegradeConfig, max_queue: int):
        self._cfg = cfg
        self._q_high, self._q_low = cfg.resolve_watermarks(max_queue)
        self._lock = threading.Lock()
        self._overloaded = False
        self.transitions = 0

    @property
    def overloaded(self) -> bool:
        with self._lock:
            return self._overloaded

    def update(self, depth: int, p99_ms: float | None = None) -> bool:
        cfg = self._cfg
        q_hot = depth >= self._q_high
        q_cold = depth <= self._q_low
        p_hot = (cfg.p99_high_ms is not None and p99_ms is not None
                 and p99_ms == p99_ms and p99_ms >= cfg.p99_high_ms)
        if cfg.p99_low_ms is None or p99_ms is None or p99_ms != p99_ms:
            p_cold = True
        else:
            p_cold = p99_ms <= cfg.p99_low_ms
        with self._lock:
            if not self._overloaded and (q_hot or p_hot):
                self._overloaded = True
                self.transitions += 1
            elif self._overloaded and q_cold and p_cold and not (q_hot or p_hot):
                self._overloaded = False
                self.transitions += 1
            return self._overloaded


class RungCostEstimator:
    """EWMA of per-graph flush cost per rung (seconds).

    The worker records ``observe(rung, seconds, n_graphs)`` after every
    successful rung execution; ``estimate(rung, n_graphs)`` predicts the
    next flush's cost for the deadline check.  Unknown rungs estimate 0.0
    — the ladder never skips a rung it has no evidence against.
    """

    def __init__(self, alpha: float = 0.3, initial: dict | None = None):
        self._alpha = alpha
        self._per_graph: dict[str, float] = dict(initial or {})
        self._lock = threading.Lock()

    def observe(self, rung: str, seconds: float, n_graphs: int) -> None:
        if n_graphs <= 0 or seconds < 0:
            return
        per = seconds / n_graphs
        with self._lock:
            old = self._per_graph.get(rung)
            self._per_graph[rung] = (per if old is None
                                     else old + self._alpha * (per - old))

    def estimate(self, rung: str, n_graphs: int) -> float:
        with self._lock:
            per = self._per_graph.get(rung, 0.0)
        return per * max(n_graphs, 1)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._per_graph)
