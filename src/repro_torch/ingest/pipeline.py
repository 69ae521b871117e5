"""One-call ingestion: architecture name -> scheduler-ready CompGraph.

``ingest_model("whisper-tiny", n_nodes=12)`` runs trace -> records ->
coarsen and returns the CompGraph plus the reference's report (the same
keys as ``repro.ingest.pipeline``).  Results are process-cached, as in the
reference: the trace separately (the oracle-tier and generalization-tier
ingests of one model share it), the whole ingest by its arguments.  The
cached CompGraph is shared, which is safe because nothing downstream
mutates graphs.

The report's ``timing`` keeps the reference's keys; the port has no lowering
or compilation, so ``lower_s`` is the time to build the model on the meta
device, ``compile_s`` is 0.0, ``parse_s`` the recorded forward pass and
``coarsen_s`` the coarsener.
"""

from __future__ import annotations

import dataclasses
import functools
import time

from ..core.graph import CompGraph, validate_graph
from .coarsen import coarsen_program
from .trace import trace_model

__all__ = ["IngestResult", "ingest_model"]


@dataclasses.dataclass
class IngestResult:
    graph: CompGraph
    report: dict


_trace_cached = functools.lru_cache(maxsize=16)(trace_model)


@functools.lru_cache(maxsize=64)
def _ingest_cached(arch: str, n_nodes: int, smoke: bool, kind: str, batch: int, seq_len: int,
                   max_deg: int) -> IngestResult:
    t = _trace_cached(arch, smoke=smoke, kind=kind, batch=batch, seq_len=seq_len)
    prog = t.program
    t0 = time.perf_counter()
    graph = coarsen_program(prog, n_nodes, max_deg=max_deg,
                            model_name=f"ingest:{arch}:{kind}:{n_nodes}")
    t_coarsen = time.perf_counter() - t0
    validate_graph(graph)
    totals = prog.totals()
    report = {
        "arch": arch,
        "kind": kind,
        "smoke": smoke,
        "batch": batch,
        "seq_len": t.seq_len,
        "n_raw_instructions": prog.n_raw_instructions,
        "n_records": len(prog.instructions),
        "n_nodes": graph.n,
        "n_edges": graph.num_edges,
        "max_in_degree": graph.max_in_degree,
        "depth": graph.depth,
        "warnings": dict(prog.warnings),
        "n_warnings": prog.n_warnings,
        "notes": dict(prog.notes),
        "flops_total": totals["flops"],
        "param_bytes_total": totals["param_bytes"],
        "out_bytes_total": totals["out_bytes"],
        "graph_hash": graph.content_hash(),
        "timing": {
            "lower_s": t.t_build_s,
            "compile_s": 0.0,
            "parse_s": t.t_trace_s,
            "coarsen_s": t_coarsen,
        },
    }
    return IngestResult(graph=graph, report=report)


def ingest_model(arch: str, n_nodes: int = 32, *, smoke: bool = True, kind: str = "prefill",
                 batch: int = 1, seq_len: int = 16, max_deg: int = 6) -> IngestResult:
    """Trace ``arch`` (its smoke or full config) on the meta device, record
    its operations, coarsen to at most ``n_nodes`` super-nodes and return
    the validated CompGraph with the ingest report."""
    return _ingest_cached(arch, int(n_nodes), bool(smoke), kind, int(batch), int(seq_len),
                          int(max_deg))
