"""Real-model ingestion for the port: torch zoo model -> records -> CompGraph.

    trace   (:mod:`repro_torch.ingest.trace`)    a shapes-only forward pass on
                                                 the meta device, recorded one
                                                 compute call a record;
    coarsen (:mod:`repro_torch.ingest.coarsen`)  the reference's contraction
                                                 into <= |V|max super-nodes;
    schedule                                     the CompGraph goes through
                                                 ``RespectScheduler.schedule``
                                                 (``schedule_model``).

``ingest_model`` (:mod:`repro_torch.ingest.pipeline`) is the one-call
wrapper, with the reference's report.
"""

from .coarsen import coarsen_program  # noqa: F401
from .pipeline import IngestResult, ingest_model  # noqa: F401
from .records import HloProgram, InstrRecord  # noqa: F401
from .trace import TraceResult, trace_model  # noqa: F401

__all__ = [
    "trace_model", "TraceResult",
    "coarsen_program", "HloProgram", "InstrRecord",
    "ingest_model", "IngestResult",
]
