"""Rolling service metrics: latency percentiles and counter snapshots; the
same counters and percentiles as the reference's ``repro.serving.metrics``.

The service records one latency sample per finished request (submit ->
future resolution, micro-batching wait included) into a bounded ring so
p50/p99 track *recent* traffic, not the lifetime average — a burst that
blows the deadline shows up in p99 immediately and ages out once the
queue drains.  Counters are plain ints mutated under the service lock;
:class:`ServiceStats` is an immutable snapshot taken in one lock hold, so
``hits + misses + dedups == requests`` style invariants can be asserted
against a single consistent view even while submitters are running.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque

import numpy as np

__all__ = ["LatencyWindow", "ServiceStats"]


class LatencyWindow:
    """Bounded ring of recent latency samples (seconds), thread-safe."""

    def __init__(self, maxlen: int = 2048):
        self._samples: deque[float] = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def add(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def percentiles_ms(self, qs=(50.0, 99.0)) -> list[float]:
        """Latency percentiles in milliseconds (NaN while empty)."""
        with self._lock:
            snap = list(self._samples)
        if not snap:
            return [float("nan")] * len(qs)
        arr = np.asarray(snap) * 1e3
        return [float(np.percentile(arr, q)) for q in qs]

    def mean_ms(self) -> float:
        with self._lock:
            snap = list(self._samples)
        return float(np.mean(snap) * 1e3) if snap else float("nan")


@dataclasses.dataclass(frozen=True)
class ServiceStats:
    """One consistent snapshot of the service counters + latency window.

    Invariants (asserted by the concurrency and fault-injection tests):

    * ``requests == cache_hits + cache_misses + dedup_hits + degraded
      + failed`` once the queue is drained — every submitted request
      terminates in exactly one bucket.  ``cache_hits``/``cache_misses``
      count policy-rung primaries; ``degraded`` counts primaries served
      on a lower rung (``served_fallback + served_heuristic``); a
      duplicate whose coalesce target errors or is rejected is
      reclassified from ``dedup_hits`` to ``failed``;
    * ``completed + failed == requests`` after a drain — no future is
      ever left pending, including across worker crashes/restarts;
    * ``served_policy + degraded + dedup_hits + failed == requests``;
    * ``degrade_deadline + degrade_overload + degrade_error +
      degrade_crash == degraded`` (first cause that pushed each primary
      off the policy rung);
    * ``p50_ms <= p99_ms`` whenever any sample exists.

    ``served_*`` count which ladder rung produced each primary result
    (:mod:`repro_torch.serving.degrade`); ``deadline_missed`` counts resolved
    futures (primaries AND waiters) whose ``deadline_ms`` budget had
    expired by resolution time; ``retries`` counts same-rung retry
    attempts after transient flush failures; ``worker_restarts`` counts
    supervisor restarts of the crashed worker loop; ``rejected_invalid``
    counts submissions refused by graph validation (these raise before
    ``requests`` is incremented); ``overloaded`` is the live hysteresis
    latch state.
    """

    requests: int
    completed: int
    failed: int
    cache_hits: int
    cache_misses: int
    dedup_hits: int
    batches: int
    flush_full: int
    flush_deadline: int
    flush_drain: int
    max_batch_observed: int
    queue_depth: int
    inflight_keys: int
    served_policy: int
    served_fallback: int
    served_heuristic: int
    degraded: int
    degrade_deadline: int
    degrade_overload: int
    degrade_error: int
    degrade_crash: int
    deadline_missed: int
    retries: int
    worker_restarts: int
    rejected_invalid: int
    overloaded: bool
    p50_ms: float
    p99_ms: float
    mean_ms: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)
