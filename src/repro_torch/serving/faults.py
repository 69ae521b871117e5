"""Deterministic fault injection for the serving stack; the fault kinds,
seam and seeded plans of the reference's ``repro.serving.faults``
(:meth:`FaultPlan.random` gives the reference's events for the same
arguments: both draw from numpy's ``default_rng``).

Every recovery behavior the supervised service promises — worker restart,
per-request isolation, the degradation ladder, retry-with-backoff,
corrupted-result detection — is exercised by *injected* faults on a
scripted, seeded schedule instead of asserted in prose.  The injection
seam is the scheduler boundary: :class:`FaultyScheduler` wraps any object
exposing the scheduler protocol (``schedule_many`` /
``fallback_schedule_many``) and fires faults by CALL INDEX, so a test or
chaos bench run replays bit-identically from its seed.  Production code
carries no hooks — the wrapper *is* the seam.

Fault kinds:

* ``crash``   — raises :class:`InjectedWorkerCrash` (a ``BaseException``:
  it deliberately escapes the flush-level ``except Exception`` handlers
  to kill the worker-loop iteration, exactly like a real
  thread-destroying defect, exercising the supervisor restart path);
  it is raised before the wrapped call, so no kernel is cut off
  mid-launch;
* ``error``   — raises :class:`InjectedSchedulerError` (an ordinary
  ``Exception``): the flush-level failure the retry/degrade ladder
  handles; one-shot events model transient faults, ``persistent=True``
  models a wedged policy path;
* ``slow``    — sleeps ``duration_s`` before delegating: blows deadline
  budgets and inflates the rung cost estimator without any exception;
* ``corrupt`` — delegates, then truncates each result's ``assignment``
  to the wrong length: the service's result-shape validation must catch
  it and degrade the affected requests.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "FaultyScheduler",
    "InjectedFault",
    "InjectedSchedulerError",
    "InjectedWorkerCrash",
]

FAULT_KINDS = ("crash", "error", "slow", "corrupt")


class InjectedFault:
    """Marker mixin: lets tests distinguish injected faults from real bugs."""


class InjectedSchedulerError(InjectedFault, RuntimeError):
    """Flush-level scheduler exception (transient or persistent)."""


class InjectedWorkerCrash(InjectedFault, BaseException):
    """Worker-killing crash.  Subclasses ``BaseException`` ON PURPOSE so it
    sails past the ladder's ``except Exception`` rung handling and
    reaches the supervisor — simulating a defect that destroys the worker
    loop itself rather than one flush."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault.

    ``kind``: one of :data:`FAULT_KINDS`; ``at``: 0-based call index on
    ``rung`` at which the event fires; ``rung``: which entry point it
    arms (``"policy"``, ``"fallback"`` or ``"any"``); ``persistent``:
    fire on EVERY call with index >= ``at`` instead of once;
    ``duration_s``: sleep length for ``slow`` events.
    """

    kind: str
    at: int = 0
    rung: str = "policy"
    persistent: bool = False
    duration_s: float = 0.05

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def matches(self, rung: str, idx: int) -> bool:
        if self.rung != "any" and self.rung != rung:
            return False
        return idx >= self.at if self.persistent else idx == self.at


class FaultPlan:
    """An immutable scripted schedule of :class:`FaultEvent`\\ s.

    Build explicitly (``FaultPlan([FaultEvent("error", at=2)])``) for
    targeted tests, or via :meth:`random` for seeded chaos sweeps — the
    same seed always yields the same schedule, so a failing sweep is
    replayable from its printed seed alone.
    """

    def __init__(self, events: list[FaultEvent] | tuple = (), seed=None):
        self.events = tuple(events)
        self.seed = seed

    def events_for(self, rung: str, idx: int) -> list[FaultEvent]:
        return [e for e in self.events if e.matches(rung, idx)]

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return (f"FaultPlan(n_events={len(self.events)}, seed={self.seed})")

    @classmethod
    def random(cls, seed: int, n_calls: int, p_crash: float = 0.05,
               p_error: float = 0.1, p_slow: float = 0.05,
               p_corrupt: float = 0.05, slow_s: float = 0.02,
               rungs: tuple = ("policy",)) -> "FaultPlan":
        """Seeded Bernoulli script: for each (rung, call index) draw at
        most one fault kind.  Probabilities are per call; the draw stream
        is keyed on (seed, rung) so adding a rung never reshuffles
        another's schedule."""
        events = []
        kinds = (("crash", p_crash), ("error", p_error),
                 ("slow", p_slow), ("corrupt", p_corrupt))
        for rung in rungs:
            rng = np.random.default_rng(
                [int(seed), sum(ord(c) for c in rung)])
            for idx in range(n_calls):
                u = float(rng.random())
                acc = 0.0
                for kind, p in kinds:
                    acc += p
                    if u < acc:
                        events.append(FaultEvent(
                            kind, at=idx, rung=rung, duration_s=slow_s))
                        break
        return cls(events, seed=seed)


class FaultyScheduler:
    """The injection seam: a scheduler-protocol wrapper that fires a
    :class:`FaultPlan` keyed on per-rung call counters.

    Everything not intercepted (``_decoder``, ``params``, ``clear_cache``,
    ``cache_stats``, ...) delegates to the wrapped scheduler, so a
    ``FaultyScheduler`` drops into
    :class:`repro_torch.serving.SchedulerService` exactly where the real
    scheduler goes.  ``fired`` records every event that
    actually triggered as ``(rung, call_idx, kind)`` for assertions.
    """

    def __init__(self, inner, plan: FaultPlan):
        self._inner = inner
        self._plan = plan
        self._lock = threading.Lock()
        self._calls: dict[str, int] = {}
        self.fired: list[tuple[str, int, str]] = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # ------------------------------------------------------------------ #
    def _next_idx(self, rung: str) -> int:
        with self._lock:
            idx = self._calls.get(rung, 0)
            self._calls[rung] = idx + 1
            return idx

    def _apply(self, rung: str, fn, *args, **kw):
        idx = self._next_idx(rung)
        pre, corrupt = [], False
        for ev in self._plan.events_for(rung, idx):
            with self._lock:
                self.fired.append((rung, idx, ev.kind))
            if ev.kind == "corrupt":
                corrupt = True
            else:
                pre.append(ev)
        for ev in pre:
            if ev.kind == "slow":
                time.sleep(ev.duration_s)
            elif ev.kind == "error":
                raise InjectedSchedulerError(
                    f"injected scheduler error (rung={rung}, call={idx})")
            elif ev.kind == "crash":
                raise InjectedWorkerCrash(
                    f"injected worker crash (rung={rung}, call={idx})")
        results = fn(*args, **kw)
        if corrupt:
            for res in results:
                res["assignment"] = np.asarray(res["assignment"])[:-1]
        return results

    # ------------------------------------------------------------------ #
    def schedule_many(self, *args, **kw):
        return self._apply("policy", self._inner.schedule_many, *args, **kw)

    def fallback_schedule_many(self, *args, **kw):
        return self._apply(
            "fallback", self._inner.fallback_schedule_many, *args, **kw)
