"""Batched exact oracle: whole size buckets solved on the device at once.

The port of the reference's ``repro.eval.oracle``.  :class:`ExactOracle`
turns the exact solver into a batch engine on the same machinery the
scheduler's miss path runs on:

* graphs are grouped into power-of-two size buckets and packed into
  fixed-shape tensors (no embeddings: the oracle needs only the three cost
  attributes and the parent matrix);
* each bucket solves as ONE :func:`repro_torch.core.segment.exact_dp_batch`
  on the oracle's device (the identity-order DP the training labeller
  runs).  Eager PyTorch compiles nothing per shape, so the batch dimension
  is not padded to a power of two: a bucket runs exactly the graphs it
  holds, and :meth:`ExactOracle.label_pack` takes a pack padded with inert
  ``n_valid = 0`` rows (:meth:`PaddedGraphBatch.pad_batch`) as it is;
* the device returns the all-integer stage assignment, zeroed past
  ``n_valid``; the float objectives (bottleneck/latency) are re-derived on
  the host in float64 by :func:`repro_torch.core.costmodel.evaluate_schedule`
  from that assignment, so every field of an :class:`OracleSolution` is
  bit-identical to the host ``exact_dp`` + ``evaluate_schedule`` whenever
  the assignments agree.

The oracle runs on the card unless given ``device``; without CUDA it raises
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.batching import MIN_BUCKET, PaddedGraphBatch, bucketize
from ..core.costmodel import PipelineSystem, evaluate_schedule
from ..core.exact import exact_dp, order_from_assignment
from ..core.graph import CompGraph
from ..core.segment import exact_dp_batch
from ..device import resolve_device

__all__ = ["OracleSolution", "ExactOracle"]


@dataclasses.dataclass(frozen=True)
class OracleSolution:
    """Exact solution of one graph: the all-integer device outputs plus
    float64 host-derived objectives (see the module docstring)."""

    assignment: np.ndarray   # (n,) int64 per-node stage
    order: np.ndarray        # (n,) imitation sequence gamma (stage, index)
    bottleneck_s: float
    latency_s: float


class ExactOracle:
    """Solve many graphs exactly, one batched DP per size bucket."""

    def __init__(self, max_deg: int = 6, min_bucket: int = MIN_BUCKET, device=None):
        self.max_deg = max_deg
        self.min_bucket = min_bucket
        self.device = resolve_device(device)
        self._shapes: dict[tuple, None] = {}

    @property
    def compiled_shapes(self) -> list[tuple]:
        """The ``(bucket_n, bucket_b, n_stages)`` shapes solved so far, in
        first-run order (eager PyTorch compiles nothing; these are the
        reference's program keys without the system)."""
        return list(self._shapes)

    def _solve(self, fl, pb, ob, pm, nv, n_stages: int, system: PipelineSystem):
        """The batched DP on the oracle's device: the assignment (B, n)
        int32, zero past ``n_valid``, and the float32 DP bottleneck (B,)."""
        self._shapes.setdefault((fl.shape[1], fl.shape[0], n_stages))
        dev = self.device
        assign, bneck = exact_dp_batch(fl.to(dev), pb.to(dev), ob.to(dev), pm.to(dev),
                                       n_stages, system, nv.to(dev))
        valid = torch.arange(assign.shape[1], device=dev)[None, :] < nv.to(dev)[:, None]
        return torch.where(valid, assign, 0).to(torch.int32), bneck

    # ------------------------------------------------------------------ #
    def _pack_arrays(self, graphs: list[CompGraph], bucket_n: int):
        """Cost attributes and parent matrices of one bucket, padded to
        ``bucket_n`` nodes (no embeddings)."""
        B = len(graphs)
        fl = np.zeros((B, bucket_n), np.float32)
        pb = np.zeros((B, bucket_n), np.float32)
        ob = np.zeros((B, bucket_n), np.float32)
        pm = np.full((B, bucket_n, self.max_deg), -1, np.int32)
        nv = np.zeros(B, np.int32)
        for i, g in enumerate(graphs):
            fl[i, : g.n] = g.flops
            pb[i, : g.n] = g.param_bytes
            ob[i, : g.n] = g.out_bytes
            pm[i, : g.n] = g.parent_matrix(self.max_deg)
            nv[i] = g.n
        return tuple(torch.from_numpy(a) for a in (fl, pb, ob, pm, nv))

    def _solve_buckets(self, graphs: list[CompGraph], n_stages: int, system: PipelineSystem):
        """Yield (idxs, device assignment rows) per size bucket."""
        for bucket_n, idxs in bucketize(graphs, self.min_bucket).items():
            arrays = self._pack_arrays([graphs[i] for i in idxs], bucket_n)
            assign, _ = self._solve(*arrays, n_stages, system)
            yield idxs, assign

    def solve_many(self, graphs: list[CompGraph], n_stages: int,
                   system: PipelineSystem | None = None) -> list[OracleSolution]:
        """Exactly solve every graph; results positionally aligned.  Each size
        bucket runs as one batched DP on the device; the host only packs the
        cost attributes and re-derives the float64 objectives from the
        integer assignments (its ``.cpu()`` waits for the device)."""
        system = (system or PipelineSystem(n_stages)).with_stages(n_stages)
        out: list[OracleSolution | None] = [None] * len(graphs)
        for idxs, assign in self._solve_buckets(graphs, n_stages, system):
            assign = assign.cpu().numpy()
            for row, i in enumerate(idxs):
                g = graphs[i]
                a = assign[row, : g.n].astype(np.int64)
                ev = evaluate_schedule(g, a, system)
                out[i] = OracleSolution(assignment=a, order=order_from_assignment(a),
                                        bottleneck_s=ev.bottleneck_s, latency_s=ev.latency_s)
        return out

    def solve(self, graph: CompGraph, n_stages: int,
              system: PipelineSystem | None = None) -> OracleSolution:
        return self.solve_many([graph], n_stages, system)[0]

    def warmup(self, graphs: list[CompGraph], n_stages: int,
               system: PipelineSystem | None = None) -> None:
        """Run the per-bucket DPs these graphs need, without
        :meth:`solve_many`'s host-side objectives, and wait for the device:
        the untimed warm pass of the eval runner."""
        system = (system or PipelineSystem(n_stages)).with_stages(n_stages)
        for _ in self._solve_buckets(graphs, n_stages, system):
            pass
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    def label_pack(self, batch: PaddedGraphBatch, n_stages: int,
                   system: PipelineSystem | None = None) -> PaddedGraphBatch:
        """Stamp a padded pack with its own exact solution: ``exact_assign``
        (int32, zero past ``n_valid``, so zero on inert pad rows) and the
        float32 ``exact_bottleneck``, from one batched DP over the pack's own
        cost tensors on the oracle's device, returned on the pack's device."""
        system = (system or PipelineSystem(n_stages)).with_stages(n_stages)
        assign, bneck = self._solve(batch.flops, batch.param_bytes, batch.out_bytes,
                                    batch.parent_mat, batch.n_valid, n_stages, system)
        home = batch.flops.device
        return batch.with_exact(assign.to(home), bneck.to(home))

    # ------------------------------------------------------------------ #
    @staticmethod
    def solve_many_host(graphs: list[CompGraph], n_stages: int,
                        system: PipelineSystem | None = None) -> list[OracleSolution]:
        """The host reference loop (one :func:`exact_dp` per graph) with the
        same output derivation: the differential twin and the baseline the
        solve-time speedups measure against."""
        system = (system or PipelineSystem(n_stages)).with_stages(n_stages)
        out = []
        for g in graphs:
            a, _ = exact_dp(g, n_stages, system)
            ev = evaluate_schedule(g, a, system)
            out.append(OracleSolution(assignment=a.astype(np.int64),
                                      order=order_from_assignment(a),
                                      bottleneck_s=ev.bottleneck_s, latency_s=ev.latency_s))
        return out
