"""The per-device cost record of one traced step: the twin of the
reference's ``HloCost`` (``repro.utils.hlo``), which XLA's HLO text fills
there and the port's own traced program fills here
(:mod:`repro_torch.launch.dryrun`).

Counting conventions (the reference's, on the local shards one device
holds):

* ``flops``: products only — matrix products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``; ``einsum`` and ``matmul`` reach these; the zoo runs no
  convolution op) and the attention and SSD kernels' products; elementwise
  work is not counted.
* ``bytes_accessed``: per local operation, the bytes of its tensor inputs
  read plus its outputs written, as the ingest recorder counts them; views
  and factories move nothing.
* ``collective_bytes``: the result bytes of each collective one device
  takes part in (an all-gather's gathered tensor, a reduce-scatter's
  shard), by kind under the reference's names; ring factors are applied by
  the roofline (:func:`repro_torch.launch.roofline.collective_seconds`).

The reference prices its CPU lowering's float32 stand-ins for bf16 at two
bytes (``bytes_bf16eq``).  The port's trace carries every tensor's true
dtype, so ``bytes_bf16eq`` equals ``bytes_accessed`` (and
``collective_bytes_bf16eq`` equals ``collective_bytes``); they are here so
that the record and :func:`~repro_torch.launch.roofline.roofline_from_cost`
keep the reference's shape.
"""

from __future__ import annotations

import dataclasses

__all__ = ["StepCost", "COLLECTIVE_KINDS", "LINKS"]

#: the reference's collective kind names
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")
#: a group inside one node (NVLink) or across nodes (InfiniBand)
LINKS = ("nvlink", "ib")


@dataclasses.dataclass
class StepCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    bytes_bf16eq: float = 0.0
    collective_bytes: float = 0.0
    collective_bytes_bf16eq: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    #: (kind, link) -> payload bytes, ``link`` "nvlink" for a group inside
    #: one node, "ib" for one that crosses nodes (the roofline's rates)
    collective_bytes_by_link: dict = dataclasses.field(default_factory=dict)

    def add_op(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes_accessed += nbytes
        self.bytes_bf16eq += nbytes

    def add_collective(self, kind: str, link: str, nbytes: float) -> None:
        if kind not in COLLECTIVE_KINDS or link not in LINKS:
            raise ValueError(f"unknown collective kind {kind!r} or link {link!r}")
        self.collective_bytes += nbytes
        self.collective_bytes_bf16eq += nbytes
        self.collective_counts[kind] = self.collective_counts.get(kind, 0) + 1
        self.collective_bytes_by_kind[kind] = self.collective_bytes_by_kind.get(kind, 0) + nbytes
        key = (kind, link)
        self.collective_bytes_by_link[key] = self.collective_bytes_by_link.get(key, 0) + nbytes

    def merged(self, other: "StepCost", mult: float = 1.0) -> "StepCost":
        """``self + mult * other`` (a loop body ``mult`` times)."""
        out = StepCost(
            flops=self.flops + mult * other.flops,
            bytes_accessed=self.bytes_accessed + mult * other.bytes_accessed,
            bytes_bf16eq=self.bytes_bf16eq + mult * other.bytes_bf16eq,
            collective_bytes=self.collective_bytes + mult * other.collective_bytes,
            collective_bytes_bf16eq=(self.collective_bytes_bf16eq
                                     + mult * other.collective_bytes_bf16eq),
            collective_counts=dict(self.collective_counts),
            collective_bytes_by_kind=dict(self.collective_bytes_by_kind),
            collective_bytes_by_link=dict(self.collective_bytes_by_link),
        )
        for name in ("collective_counts", "collective_bytes_by_kind", "collective_bytes_by_link"):
            acc = getattr(out, name)
            for k, v in getattr(other, name).items():
                acc[k] = acc.get(k, 0) + mult * v
        return out
