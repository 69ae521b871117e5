"""Per-operation cost records: the port's copy of the reference's
``InstrRecord`` and ``HloProgram`` (``repro.utils.hlo``), the schema the
coarsener (:mod:`repro_torch.ingest.coarsen`) reads.

The reference fills them by parsing XLA's optimized HLO; the port fills
them from a shapes-only trace of the torch model
(:mod:`repro_torch.ingest.trace`).  The schema and its totals are the
reference's, field for field.
"""

from __future__ import annotations

import dataclasses

__all__ = ["InstrRecord", "HloProgram"]


@dataclasses.dataclass
class InstrRecord:
    """One compute operation (views folded into their producer, loops
    unrolled or aggregated)."""
    name: str
    opcode: str
    flops: float
    out_bytes: float
    param_bytes: float
    operands: tuple    # producer record names, each emitted earlier


@dataclasses.dataclass
class HloProgram:
    """The records of one traced program in topological order (operands
    always precede their consumers).  The name is the reference's; the
    port's programs come from a torch trace, not from HLO."""
    instructions: list
    entry: str | None
    n_raw_instructions: int
    warnings: dict = dataclasses.field(default_factory=dict)
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def n_warnings(self) -> int:
        return int(sum(self.warnings.values()))

    def totals(self) -> dict:
        return {
            "flops": float(sum(r.flops for r in self.instructions)),
            "out_bytes": float(sum(r.out_bytes for r in self.instructions)),
            "param_bytes": float(sum(r.param_bytes for r in self.instructions)),
        }
