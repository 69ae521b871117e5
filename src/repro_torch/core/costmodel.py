"""Pipeline cost model of a chain of accelerators (Coral Edge TPUs by default).

Stage time for a stage ``s`` holding node set ``V_s``:

    T(s) = in_bytes(s) / link_bw                     # activation transfer in
         + flops(V_s) / (compute_rate * eff)         # compute
         + max(0, params(V_s) - cache) / link_bw     # off-chip param stream
         + fixed_overhead_s                          # if the stage is occupied

The pipeline's throughput is the bottleneck ``max_s T(s)``; its latency is
``sum_s T(s)``; schedulers minimize ``(bottleneck, latency)``
lexicographically.  Same semantics as the reference's
``repro.core.costmodel``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .graph import CompGraph

__all__ = [
    "PipelineSystem",
    "EDGETPU",
    "PodSystem",
    "evaluate_schedule",
    "ScheduleEval",
    "SYS_FEAT_DIM",
    "CAPACITY_PENALTY_S",
]

#: Width of the fixed-size system profile fed to the policy decoder.  A
#: uniform system encodes as the all-zero vector.
SYS_FEAT_DIM = 16

#: Additive stage-time penalty for a segment whose parameter bytes exceed the
#: stage's ``mem_capacity``: finite, so the DP still orders infeasible
#: completions, and representable in float32.
CAPACITY_PENALTY_S = 1.0e30

_STAGE_FIELDS = ("compute_rate", "compute_eff", "link_bw", "cache_bytes", "mem_capacity")


@dataclasses.dataclass(frozen=True)
class PipelineSystem:
    """Constants of a chained accelerator pipeline.

    ``compute_rate`` / ``compute_eff`` / ``link_bw`` / ``cache_bytes`` take a
    scalar (every stage identical) or a per-stage sequence of length
    ``n_stages`` (normalized to a tuple, so the system stays hashable).
    ``mem_capacity`` is an optional hard per-stage parameter-byte budget.
    """

    n_stages: int
    compute_rate: float | tuple = 4.0e12
    compute_eff: float | tuple = 0.25
    link_bw: float | tuple = 320.0e6
    cache_bytes: float | tuple = 8.0 * 2**20
    fixed_overhead_s: float = 1.0e-4
    mem_capacity: float | tuple | None = None

    def __post_init__(self) -> None:
        for name in _STAGE_FIELDS:
            v = getattr(self, name)
            if v is None or isinstance(v, (int, float)):
                continue
            t = tuple(float(x) for x in v)
            if len(t) != self.n_stages:
                raise ValueError(f"{name} has {len(t)} entries for n_stages={self.n_stages}")
            object.__setattr__(self, name, t)

    def with_stages(self, n_stages: int) -> "PipelineSystem":
        return dataclasses.replace(self, n_stages=n_stages)

    @property
    def has_stage_vectors(self) -> bool:
        return any(isinstance(getattr(self, name), tuple)
                   for name in ("compute_rate", "compute_eff", "link_bw", "cache_bytes"))

    @property
    def has_capacity(self) -> bool:
        return self.mem_capacity is not None

    @property
    def is_uniform(self) -> bool:
        return not self.has_stage_vectors and not self.has_capacity

    def stage_vector(self, name: str) -> np.ndarray:
        """The named constant broadcast to a ``(n_stages,)`` float64 array."""
        v = getattr(self, name)
        if isinstance(v, tuple):
            return np.asarray(v, dtype=np.float64)
        return np.full(self.n_stages, float(v), dtype=np.float64)

    def capacity_vector(self) -> np.ndarray | None:
        """``(n_stages,)`` float64 hard budget, or None if unconstrained."""
        if self.mem_capacity is None:
            return None
        return self.stage_vector("mem_capacity")

    def profile_features(self) -> np.ndarray:
        """Fixed-width float32 embedding of the hardware profile; all-zero iff
        :attr:`is_uniform`.  Per cost quantity: ``[min, max, std]`` of the
        per-stage log2 deviation from the geometric mean."""
        feats = np.zeros(SYS_FEAT_DIM, dtype=np.float32)
        if self.is_uniform:
            return feats
        rate_eff = self.stage_vector("compute_rate") * self.stage_vector("compute_eff")
        quantities = (rate_eff, self.stage_vector("link_bw"), self.stage_vector("cache_bytes"))
        i = 0
        for vec in quantities:
            logs = np.log2(vec)
            logs = logs - logs.mean()
            feats[i: i + 3] = (logs.min(), logs.max(), logs.std())
            i += 3
        cap = self.capacity_vector()
        if cap is not None:
            ref = self.stage_vector("cache_bytes")
            logs = np.log2(cap / ref) / 8.0
            feats[9] = 1.0
            feats[10:13] = (logs.min(), logs.max(), logs.std())
        return feats


EDGETPU = PipelineSystem(n_stages=4)


def PodSystem(n_stages: int) -> PipelineSystem:
    """The reference's pod-scale pipeline (``core/partitioner.py``'s system):
    a ring of TPU v5e stages, its ICI link and an HBM residency budget.
    Uniform, so a schedule on it decodes through B1."""
    return PipelineSystem(
        n_stages=n_stages,
        compute_rate=197e12,        # bf16 FLOP/s per chip
        compute_eff=0.5,
        link_bw=50e9,               # bytes/s per ICI link
        cache_bytes=16e9 * 0.7,     # HBM minus activation/headroom budget
        fixed_overhead_s=5.0e-6,
    )


@dataclasses.dataclass
class ScheduleEval:
    stage_times: np.ndarray
    bottleneck_s: float
    latency_s: float
    stage_params: np.ndarray
    stage_flops: np.ndarray
    stage_in_bytes: np.ndarray
    on_cache_bytes: np.ndarray
    off_cache_bytes: np.ndarray
    over_capacity_bytes: np.ndarray | None = None

    @property
    def objective(self) -> tuple[float, float]:
        return (self.bottleneck_s, self.latency_s)

    @property
    def capacity_ok(self) -> bool:
        return self.over_capacity_bytes is None or not np.any(self.over_capacity_bytes > 0.0)


def evaluate_schedule(graph: CompGraph, assign: np.ndarray,
                      system: PipelineSystem) -> ScheduleEval:
    """Evaluate a stage assignment under the pipeline cost model (float64)."""
    assign = np.asarray(assign, dtype=np.int64)
    k = system.n_stages
    if assign.shape != (graph.n,):
        raise ValueError("assignment length mismatch")

    stage_params = np.zeros(k)
    stage_flops = np.zeros(k)
    np.add.at(stage_params, assign, graph.param_bytes)
    np.add.at(stage_flops, assign, graph.flops)

    # a tensor u crosses boundary b (between stages b-1 and b) if it is
    # produced before b and consumed at or after b
    last_consumer_stage = assign.copy()
    for v, ps in enumerate(graph.parents):
        for u in ps:
            last_consumer_stage[u] = max(last_consumer_stage[u], assign[v])
    stage_in_bytes = np.zeros(k)
    for u in range(graph.n):
        lo, hi = assign[u] + 1, last_consumer_stage[u] + 1
        if hi > lo:
            stage_in_bytes[lo:hi] += graph.out_bytes[u]

    link_bw = system.stage_vector("link_bw")
    rate_eff = system.stage_vector("compute_rate") * system.stage_vector("compute_eff")
    cache = system.stage_vector("cache_bytes")
    off_cache = np.maximum(0.0, stage_params - cache)
    on_cache = stage_params - off_cache
    occupied = np.zeros(k)
    np.add.at(occupied, assign, 1.0)
    stage_times = (
        stage_in_bytes / link_bw
        + stage_flops / rate_eff
        + off_cache / link_bw
        + np.where(occupied > 0, system.fixed_overhead_s, 0.0)
    )
    cap = system.capacity_vector()
    over_capacity = None if cap is None else np.maximum(0.0, stage_params - cap)
    return ScheduleEval(
        stage_times=stage_times,
        bottleneck_s=float(stage_times.max(initial=0.0)),
        latency_s=float(stage_times.sum()),
        stage_params=stage_params,
        stage_flops=stage_flops,
        stage_in_bytes=stage_in_bytes,
        on_cache_bytes=on_cache,
        off_cache_bytes=off_cache,
        over_capacity_bytes=over_capacity,
    )
