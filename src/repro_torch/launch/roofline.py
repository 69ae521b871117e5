"""Three-term roofline of one dry-run cell on NVIDIA H100 SXM5 cards (the
reference's ``repro.launch.roofline``, whose constants are a TPU v5e's).

Per (arch x shape x mesh) cell, from the per-device
:class:`~repro_torch.launch.cost.StepCost`:

    compute term    = flops_per_device / peak bf16 FLOP/s          [s]
    memory term     = bytes_per_device / HBM bandwidth             [s]
    collective term = sum over collectives of
                      ring factor x payload bytes / link bandwidth [s]

Ring factors (the reference's): all-reduce 2 (reduce-scatter then
all-gather on a bidirectional ring), all-gather, reduce-scatter,
all-to-all and collective-permute 1.

Links: ranks are laid out with eight consecutive ranks of the mesh's
innermost axis in one node, so a collective whose group has at most eight
ranks of that axis stays inside a node and runs over NVLink 4; any other
group crosses nodes and is charged at the slowest link it crosses, one NDR
InfiniBand port (400 Gb/s) a GPU.  On the production meshes the 16-wide
``model`` axis spans two nodes, so every collective is charged at the NDR
rate there.

The constants (:data:`HW`) are the H100 SXM5's published peaks (card:
NVIDIA H100 80GB HBM3, 700 W), not measurements; a term is a lower bound on
a perfectly overlapped step, and a dry-run record is a model.
"""

from __future__ import annotations

import dataclasses

from .cost import StepCost

__all__ = ["HW", "Roofline", "roofline_from_cost", "collective_seconds", "group_link",
           "MODEL_FLOPS_NOTE"]

PEAK_FLOPS = 989e12         # bf16 tensor cores, dense, per card
F32_FLOPS = 67e12           # float32 outside the tensor cores, per card
HBM_BW = 3.35e12            # HBM3, bytes/s per card
NVLINK_BW = 450e9           # NVLink 4, bytes/s a direction per card, inside a node
IB_BW = 50e9                # NDR InfiniBand 400 Gb/s, bytes/s per card, across nodes
NODE_SIZE = 8               # cards per node

HW = {"card": "NVIDIA H100 80GB HBM3 (SXM5, 700 W), published peaks",
      "peak_flops": PEAK_FLOPS, "f32_flops": F32_FLOPS, "hbm_bw": HBM_BW,
      "nvlink_bw": NVLINK_BW, "ib_bw": IB_BW, "node_size": NODE_SIZE}

# wire-traffic multiplier per payload byte, bidirectional-ring model
_RING_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather phases
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

MODEL_FLOPS_NOTE = (
    "MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (inference); the "
    "ratio MODEL_FLOPS / (traced FLOPs x chips) measures how much traced "
    "compute is useful — attention's quadratic work, work replicated across "
    "a mesh axis and MoE capacity padding push it away from 1."
)


def group_link(ranks) -> str:
    """"nvlink" when every rank of a collective's group sits in one node
    (ranks ``NODE_SIZE * i`` to ``NODE_SIZE * i + NODE_SIZE - 1``), else
    "ib": the slowest link the group crosses."""
    return "nvlink" if len({int(r) // NODE_SIZE for r in ranks}) == 1 else "ib"


LINK_BW = {"nvlink": NVLINK_BW, "ib": IB_BW}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float
    chips: int
    memory_s_raw: float = 0.0
    collective_s_raw: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound_s(self) -> float:
        """Perfect-overlap bound: the max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def model_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline-implied MFU: useful FLOPs / (chips x peak x bound time)."""
        t = self.step_time_lower_bound_s
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "memory_s_raw": self.memory_s_raw,
            "collective_s_raw": self.collective_s_raw,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops": self.model_flops,
            "model_flops_ratio": self.model_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "step_lower_bound_s": self.step_time_lower_bound_s,
            "chips": self.chips,
        }


def collective_seconds(cost: StepCost, link_bw: float | None = None,
                       bf16eq: bool = True) -> float:
    """Seconds of the collectives of ``cost``: each payload times its kind's
    ring factor over its link's bandwidth — ``link_bw`` for every group when
    given, else the link each group crosses (:func:`group_link`)."""
    total = cost.collective_bytes_bf16eq if bf16eq else cost.collective_bytes
    if cost.collective_bytes <= 0:
        return 0.0
    scale = total / cost.collective_bytes
    t = 0.0
    if link_bw is not None or not cost.collective_bytes_by_link:
        bw = IB_BW if link_bw is None else link_bw
        for kind, byts in cost.collective_bytes_by_kind.items():
            t += _RING_FACTOR.get(kind, 1.0) * byts * scale / bw
        return t
    for (kind, link), byts in cost.collective_bytes_by_link.items():
        t += _RING_FACTOR.get(kind, 1.0) * byts * scale / LINK_BW[link]
    return t


def roofline_from_cost(cost: StepCost, chips: int, model_flops: float) -> Roofline:
    """The three terms of one cell at the H100's published peaks.  The
    port's bytes are true-dtype bytes, so the raw terms equal the primary
    ones."""
    return Roofline(
        compute_s=cost.flops / PEAK_FLOPS,
        memory_s=cost.bytes_bf16eq / HBM_BW,
        collective_s=collective_seconds(cost, bf16eq=True),
        memory_s_raw=cost.bytes_accessed / HBM_BW,
        collective_s_raw=collective_seconds(cost, bf16eq=False),
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes_bf16eq,
        collective_bytes_per_device=cost.collective_bytes_bf16eq,
        model_flops=model_flops,
        chips=chips,
    )
