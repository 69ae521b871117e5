"""Traffic-serving front end for the port's scheduling engine.

The reference's ``repro.serving`` over the port's ``RespectScheduler``:
turns the batch engine (``schedule_many``, whose miss path runs the pointer
kernels B1/B2 on the card) into an arrival-driven service — a bounded
request queue with backpressure, an adaptive micro-batcher (``max_batch`` /
``max_wait_ms``), single-flight dedup of identical in-flight graphs, warmup
of expected bucket shapes, and rolling latency/hit-rate metrics — plus the
fault-tolerance layer: a supervised worker, deadline budgets with a
degradation ladder (:mod:`repro_torch.serving.degrade`) and a deterministic
fault-injection seam (:mod:`repro_torch.serving.faults`).  See
:mod:`repro_torch.serving.service` for the architecture.
"""

from ..core.graph import InvalidGraphError  # noqa: F401
from .degrade import (  # noqa: F401
    LADDER,
    RUNG_FALLBACK,
    RUNG_HEURISTIC,
    RUNG_POLICY,
    DegradeConfig,
    OverloadDetector,
    RungCostEstimator,
)
from .faults import (  # noqa: F401
    FaultEvent,
    FaultPlan,
    FaultyScheduler,
    InjectedFault,
    InjectedSchedulerError,
    InjectedWorkerCrash,
)
from .metrics import LatencyWindow, ServiceStats  # noqa: F401
from .service import (  # noqa: F401
    SchedulerService,
    ServiceClosedError,
    ServiceOverloadedError,
)
