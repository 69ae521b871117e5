"""Batched scheduling engine: size buckets, padded packs, the miss path.

:meth:`BucketedDecoder.fused_schedules` turns a list of graphs into a few
fixed-shape batches and runs the cache-miss pipeline on each:

* **size bucketing** — a graph of ``n`` nodes is padded to the next
  power-of-two bucket (:func:`bucket_for`);
* **padded packing** — :func:`pack_padded` stacks embeddings, parent
  matrices and the three cost attributes with ``n_valid`` per graph; the
  pad-aware encode/decode and the ``n_valid``-aware DP make a padded graph
  schedule exactly as its unpadded self;
* **decode -> rho on the device, repair on the host** — the pointing decode
  (the whole-decode kernel or the scan with the single-step kernel) and the
  segmentation DP run batched on the device; the repair runs per graph on
  the host (:func:`repro_torch.core.segment.repair`).

Unlike the reference there is no cache of compiled programs and the batch
dimension is not padded: eager PyTorch compiles nothing per shape, so a
bucket runs exactly the graphs it holds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.ptr import ops as ptr_ops
from ..kernels.ptr.decode import decode_batch
from . import segment
from .costmodel import PipelineSystem
from .embedding import embed_graph
from .graph import CompGraph

__all__ = ["bucket_for", "bucketize", "PaddedGraphBatch", "pack_padded",
           "BucketedDecoder", "DECODE_IMPLS"]

MIN_BUCKET = 8

#: decode_impl choices: None picks per bucket (the whole-decode kernel when
#: its gate passes and the system is uniform, else the scan), "scan" runs
#: the per-step loop with the single-step kernel, "kernel" the whole-decode
#: kernel.  On CPU tensors both run the plain PyTorch versions.
DECODE_IMPLS = (None, "scan", "kernel")


def bucket_for(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Smallest power of two >= n (with a floor so tiny graphs share)."""
    if n < 1:
        raise ValueError("graph must have at least one node")
    return max(min_bucket, 1 << (n - 1).bit_length())


def bucketize(graphs: list[CompGraph], min_bucket: int = MIN_BUCKET) -> dict[int, list[int]]:
    """Group graph indices by their size bucket (insertion order kept)."""
    buckets: dict[int, list[int]] = {}
    for i, g in enumerate(graphs):
        buckets.setdefault(bucket_for(g.n, min_bucket), []).append(i)
    return buckets


@dataclasses.dataclass
class PaddedGraphBatch:
    """B graphs padded to a common node count, as tensors on one device."""

    feats: torch.Tensor        # (B, bucket_n, F) float32 embedding rows, zero padded
    parent_mat: torch.Tensor   # (B, bucket_n, D) int32, -1 padded
    flops: torch.Tensor        # (B, bucket_n) float32, zero padded
    param_bytes: torch.Tensor  # (B, bucket_n) float32, zero padded
    out_bytes: torch.Tensor    # (B, bucket_n) float32, zero padded
    n_valid: torch.Tensor      # (B,) int32 real node count per graph

    @property
    def batch(self) -> int:
        return self.feats.shape[0]

    @property
    def bucket_n(self) -> int:
        return self.feats.shape[1]

    def to(self, device) -> "PaddedGraphBatch":
        return PaddedGraphBatch(**{f.name: getattr(self, f.name).to(device)
                                   for f in dataclasses.fields(self)})

    def pad_batch(self, bucket_b: int) -> "PaddedGraphBatch":
        """Pad the batch dimension with inert ``n_valid = 0`` rows."""
        pad = bucket_b - self.batch
        if pad < 0:
            raise ValueError(f"batch {self.batch} exceeds bucket {bucket_b}")
        if pad == 0:
            return self

        def cat(a, fill):
            return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])

        return PaddedGraphBatch(
            feats=cat(self.feats, 0), parent_mat=cat(self.parent_mat, -1),
            flops=cat(self.flops, 0), param_bytes=cat(self.param_bytes, 0),
            out_bytes=cat(self.out_bytes, 0), n_valid=cat(self.n_valid, 0))


def pack_padded(graphs: list[CompGraph], bucket_n: int | None = None, max_deg: int = 6,
                min_bucket: int = MIN_BUCKET) -> PaddedGraphBatch:
    """Embed and pad a list of graphs to a common ``bucket_n`` (CPU tensors)."""
    if not graphs:
        raise ValueError("empty graph list")
    n_max = max(g.n for g in graphs)
    if bucket_n is None:
        bucket_n = bucket_for(n_max, min_bucket)
    if n_max > bucket_n:
        raise ValueError(f"graph with {n_max} nodes exceeds bucket {bucket_n}")
    B = len(graphs)
    feats = None
    pmat = np.full((B, bucket_n, max_deg), -1, dtype=np.int32)
    attrs = np.zeros((3, B, bucket_n), dtype=np.float32)
    n_valid = np.zeros(B, dtype=np.int32)
    for i, g in enumerate(graphs):
        f = embed_graph(g, max_deg)
        if feats is None:
            feats = np.zeros((B, bucket_n, f.shape[1]), dtype=np.float32)
        feats[i, : g.n] = f
        pmat[i, : g.n] = g.parent_matrix(max_deg)
        attrs[:, i, : g.n] = (g.flops, g.param_bytes, g.out_bytes)
        n_valid[i] = g.n
    t = torch.from_numpy
    return PaddedGraphBatch(feats=t(feats), parent_mat=t(pmat), flops=t(attrs[0]),
                            param_bytes=t(attrs[1]), out_bytes=t(attrs[2]),
                            n_valid=t(n_valid))


class BucketedDecoder:
    """Runs many graphs through per-bucket batched decodes on ``device``.

    ``decode_impl`` (see :data:`DECODE_IMPLS`) selects how the pointing loop
    runs.  A profile-conditioned system (heterogeneous or memory-capped)
    takes the scan: the whole-decode kernel has no system input.  A forced
    "kernel" that cannot take a bucket, or a conditioned system, raises.
    """

    def __init__(self, device: torch.device, max_deg: int = 6, min_bucket: int = MIN_BUCKET,
                 decode_impl: str | None = None):
        if decode_impl not in DECODE_IMPLS:
            raise ValueError(f"decode_impl {decode_impl!r} not one of {DECODE_IMPLS}")
        self.device = torch.device(device)
        self.max_deg = max_deg
        self.min_bucket = min_bucket
        self.decode_impl = decode_impl

    def resolve_decode_impl(self, bucket_n: int, hidden: int, conditioned: bool = False) -> str:
        """The decode impl one bucket runs: "kernel" or "scan"."""
        supported = not conditioned and ptr_ops.decode_kernel_supported(bucket_n, hidden,
                                                                        self.max_deg)
        if self.decode_impl is None:
            return "kernel" if supported else "scan"
        if self.decode_impl == "kernel" and not supported:
            why = ("a profile-conditioned (heterogeneous or memory-capped) system" if conditioned
                   else f"bucket_n={bucket_n}, hidden={hidden}, max_deg={self.max_deg}")
            raise ValueError(f"decode_impl='kernel': the whole-decode kernel cannot take {why}")
        return self.decode_impl

    def _decode(self, net, batch: PaddedGraphBatch, impl: str, sys_feat=None) -> torch.Tensor:
        C, (h0, c0), emb = net.encode(batch.feats, batch.n_valid)
        if impl == "kernel":
            order, _, _ = decode_batch(net, C, emb, h0, c0, batch.parent_mat, batch.n_valid)
        else:
            order, _, _ = net.decode(C, emb, (h0, c0), batch.parent_mat,
                                     n_valid=batch.n_valid,
                                     logits_fn=ptr_ops.make_logits_fn(net, C),
                                     sys_feat=sys_feat)
        return order

    def _packed_buckets(self, graphs: list[CompGraph]):
        for bucket_n, idxs in bucketize(graphs, self.min_bucket).items():
            batch = pack_padded([graphs[i] for i in idxs], bucket_n, self.max_deg)
            yield idxs, batch.to(self.device)

    @torch.inference_mode()
    def greedy_orders(self, net, graphs: list[CompGraph]) -> list[np.ndarray]:
        """Decode every graph; per-graph orders of length ``g.n``."""
        orders: list[np.ndarray | None] = [None] * len(graphs)
        for idxs, batch in self._packed_buckets(graphs):
            impl = self.resolve_decode_impl(batch.bucket_n, net.hidden)
            out = self._decode(net, batch, impl).cpu().numpy()
            for row, i in enumerate(idxs):
                orders[i] = out[row, : graphs[i].n].astype(np.int64)
        return orders

    @torch.inference_mode()
    def fused_schedules(self, net, graphs: list[CompGraph], n_stages: int,
                        system: PipelineSystem) -> list[tuple[np.ndarray, np.ndarray]]:
        """Decode, segment and repair every graph; per-graph ``(order,
        assignment)`` pairs aligned with ``graphs``."""
        system = system.with_stages(n_stages)
        profile = system.profile_features()
        conditioned = bool(profile.any())
        sys_feat = torch.from_numpy(profile).to(self.device) if conditioned else None
        caps = system.capacity_vector()
        results: list[tuple[np.ndarray, np.ndarray] | None] = [None] * len(graphs)
        for idxs, batch in self._packed_buckets(graphs):
            impl = self.resolve_decode_impl(batch.bucket_n, net.hidden, conditioned)
            orders = self._decode(net, batch, impl, sys_feat)
            assigns = segment.rho_dp(orders, batch.flops, batch.param_bytes, batch.out_bytes,
                                     batch.parent_mat, n_stages, system, batch.n_valid)
            orders = orders.cpu().numpy()
            assigns = assigns.cpu().numpy()
            for row, i in enumerate(idxs):
                g = graphs[i]
                results[i] = (orders[row, : g.n].astype(np.int64),
                              segment.repair(g, assigns[row, : g.n], n_stages,
                                             mem_capacity=caps))
        return results
