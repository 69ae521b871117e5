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

:func:`greedy_order` and :func:`sample_order` are the functional twins of
the reference's (``repro.core.ptrnet``): one graph or a padded batch through
the same decode choice, without the DP, the repair or the cache.

Unlike the reference there is no cache of compiled programs and the batch
dimension is not padded: eager PyTorch compiles nothing per shape, so a
bucket runs exactly the graphs it holds.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..kernels.ptr import ops as ptr_ops
from ..kernels.ptr.decode import decode_batch, step_uniforms
from . import segment
from .costmodel import PipelineSystem
from .embedding import embed_graph
from .graph import CompGraph

__all__ = ["bucket_for", "bucketize", "PaddedGraphBatch", "pack_padded",
           "BucketedDecoder", "DECODE_IMPLS", "DECODE_IMPL_ENV", "greedy_order",
           "sample_order"]

MIN_BUCKET = 8

#: decode_impl choices: None picks per bucket (the whole-decode kernel when
#: its gate passes and the system is uniform, else the scan), "scan" runs
#: the per-step loop with the single-step kernel, "kernel" the whole-decode
#: kernel.  On CPU tensors both run the plain PyTorch versions.
DECODE_IMPLS = (None, "scan", "kernel")

#: environment override, below an explicit ``decode_impl`` argument:
#: RESPECT_DECODE_IMPL=scan|kernel forces one impl for every BucketedDecoder
#: built without one (the reference's "kernel-interpret" has no port value
#: and raises like any other unknown value)
DECODE_IMPL_ENV = "RESPECT_DECODE_IMPL"


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
    """B graphs padded to a common node count, as tensors on one device.

    The optional ``label_assign``/``label_order`` fields carry the exact
    solver's supervision (zero past ``n_valid``): a labelled pack is a
    training pack (:func:`repro_torch.core.rl.pack_graphs`), the same
    representation serving runs on.  ``exact_assign``/``exact_bottleneck``
    carry a batched exact-DP solution of the pack
    (:func:`repro_torch.core.segment.exact_dp_batch`).  ``dense`` is True
    when every graph fills ``bucket_n``.  ``label_stages`` is the stage
    count the labels were solved for (None: not recorded); a train step,
    rollout or eval at another count refuses the pack.
    """

    feats: torch.Tensor        # (B, bucket_n, F) float32 embedding rows, zero padded
    parent_mat: torch.Tensor   # (B, bucket_n, D) int32, -1 padded
    flops: torch.Tensor        # (B, bucket_n) float32, zero padded
    param_bytes: torch.Tensor  # (B, bucket_n) float32, zero padded
    out_bytes: torch.Tensor    # (B, bucket_n) float32, zero padded
    n_valid: torch.Tensor      # (B,) int32 real node count per graph
    label_assign: torch.Tensor | None = None      # (B, bucket_n) int32, 0 padded
    label_order: torch.Tensor | None = None       # (B, bucket_n) int32, 0 padded
    exact_assign: torch.Tensor | None = None      # (B, bucket_n) int32, 0 padded
    exact_bottleneck: torch.Tensor | None = None  # (B,) float32 DP objective
    dense: bool = False        # every graph fills bucket_n exactly
    label_stages: int | None = None               # the labels' stage count

    @property
    def batch(self) -> int:
        return self.feats.shape[0]

    @property
    def bucket_n(self) -> int:
        return self.feats.shape[1]

    @property
    def has_labels(self) -> bool:
        return self.label_assign is not None

    def valid_mask(self) -> torch.Tensor:
        """(B, bucket_n) bool: True on real-node slots."""
        ar = torch.arange(self.bucket_n, device=self.n_valid.device)
        return ar[None, :] < self.n_valid[:, None]

    def _tensors(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name not in ("dense", "label_stages")}

    def to(self, device) -> "PaddedGraphBatch":
        return PaddedGraphBatch(**{k: None if v is None else v.to(device)
                                   for k, v in self._tensors().items()}, dense=self.dense,
                                label_stages=self.label_stages)

    def with_exact(self, exact_assign, exact_bottleneck) -> "PaddedGraphBatch":
        """A copy carrying the exact oracle's solution of this pack
        (:meth:`repro_torch.eval.oracle.ExactOracle.label_pack`)."""
        return dataclasses.replace(self, exact_assign=exact_assign,
                                   exact_bottleneck=exact_bottleneck)

    def pad_batch(self, bucket_b: int) -> "PaddedGraphBatch":
        """Pad the batch dimension with inert ``n_valid = 0`` rows (zero
        labels, -1 parents, zero everything else)."""
        pad = bucket_b - self.batch
        if pad < 0:
            raise ValueError(f"batch {self.batch} exceeds bucket {bucket_b}")
        if pad == 0:
            return self

        def cat(name, a):
            if a is None:
                return None
            fill = -1 if name == "parent_mat" else 0
            return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])

        return PaddedGraphBatch(**{k: cat(k, v) for k, v in self._tensors().items()},
                                dense=False, label_stages=self.label_stages)


def pack_padded(graphs: list[CompGraph], bucket_n: int | None = None, max_deg: int = 6,
                min_bucket: int = MIN_BUCKET,
                labels: tuple[list, list] | None = None,
                label_stages: int | None = None) -> PaddedGraphBatch:
    """Embed and pad a list of graphs to a common ``bucket_n`` (CPU tensors).

    ``labels`` is the ``(assigns, orders)`` pair of
    :func:`repro_torch.core.rl.label_graphs` (arrays of length ``g.n``),
    zero padded into ``label_assign``/``label_order``; ``label_stages`` the
    stage count they were solved for.  The pack always
    holds only what the decode and the DP read, as the reference's
    ``decode_only=True`` pack does: the port's repair runs on the host from
    the graphs."""
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
    lab = None if labels is None else np.zeros((2, B, bucket_n), dtype=np.int32)
    for i, g in enumerate(graphs):
        f = embed_graph(g, max_deg)
        if feats is None:
            feats = np.zeros((B, bucket_n, f.shape[1]), dtype=np.float32)
        feats[i, : g.n] = f
        pmat[i, : g.n] = g.parent_matrix(max_deg)
        attrs[:, i, : g.n] = (g.flops, g.param_bytes, g.out_bytes)
        n_valid[i] = g.n
        if lab is not None:
            lab[:, i, : g.n] = (labels[0][i], labels[1][i])
    t = torch.from_numpy
    return PaddedGraphBatch(feats=t(feats), parent_mat=t(pmat), flops=t(attrs[0]),
                            param_bytes=t(attrs[1]), out_bytes=t(attrs[2]),
                            n_valid=t(n_valid),
                            label_assign=None if lab is None else t(lab[0]),
                            label_order=None if lab is None else t(lab[1]),
                            dense=all(g.n == bucket_n for g in graphs),
                            label_stages=None if lab is None else label_stages)


def _profile_input(sys_feat, device) -> torch.Tensor | None:
    """A hardware profile as the decoder's start-token input: None for no
    profile or an all-zero one (a uniform system), which leaves ``dec0``
    as it is and which the whole-decode kernel can take."""
    if sys_feat is None:
        return None
    sys_feat = torch.as_tensor(sys_feat, dtype=torch.float32)
    return sys_feat.to(device) if bool(sys_feat.any()) else None


class BucketedDecoder:
    """Runs many graphs through per-bucket batched decodes on ``device``.

    ``decode_impl`` (see :data:`DECODE_IMPLS`) selects how the pointing loop
    runs.  A profile-conditioned system (heterogeneous or memory-capped)
    takes the scan: the whole-decode kernel has no system input.  A forced
    "kernel" that cannot take a bucket, or a conditioned system, raises.
    Without an explicit ``decode_impl`` the :data:`DECODE_IMPL_ENV`
    variable, when set and not empty, chooses it.
    """

    def __init__(self, device: torch.device, max_deg: int = 6, min_bucket: int = MIN_BUCKET,
                 decode_impl: str | None = None):
        if decode_impl is None:
            decode_impl = os.environ.get(DECODE_IMPL_ENV) or None
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

    @staticmethod
    def _decode(net, feats, parent_mat, n_valid, impl: str, sys_feat=None, uniforms=None):
        """Encode and decode one padded batch on ``impl``: order, logp and
        entropy, each (B, n); ``uniforms`` (B, n) for a sampled decode."""
        C, (h0, c0), emb = net.encode(feats, n_valid)
        if impl == "kernel":
            return decode_batch(net, C, emb, h0, c0, parent_mat, n_valid, uniforms)
        return net.decode(C, emb, (h0, c0), parent_mat, n_valid=n_valid, uniforms=uniforms,
                          logits_fn=ptr_ops.make_logits_fn(net, C), sys_feat=sys_feat)

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
            out = self._decode(net, batch.feats, batch.parent_mat, batch.n_valid,
                               impl)[0].cpu().numpy()
            for row, i in enumerate(idxs):
                orders[i] = out[row, : graphs[i].n].astype(np.int64)
        return orders

    @torch.inference_mode()
    def fused_schedules(self, net, graphs: list[CompGraph], n_stages: int,
                        system: PipelineSystem) -> list[tuple[np.ndarray, np.ndarray]]:
        """Decode, segment and repair every graph; per-graph ``(order,
        assignment)`` pairs aligned with ``graphs``."""
        system = system.with_stages(n_stages)
        sys_feat = _profile_input(system.profile_features(), self.device)
        caps = system.capacity_vector()
        results: list[tuple[np.ndarray, np.ndarray] | None] = [None] * len(graphs)
        for idxs, batch in self._packed_buckets(graphs):
            impl = self.resolve_decode_impl(batch.bucket_n, net.hidden, sys_feat is not None)
            orders = self._decode(net, batch.feats, batch.parent_mat, batch.n_valid, impl,
                                  sys_feat)[0]
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


@torch.inference_mode()
def _order(net, feats, parent_mat, keys, n_valid, sys_feat, decode):
    """One graph ``(n, F)`` or a padded batch ``(B, n, F)`` through
    :class:`BucketedDecoder`'s decode on the net's device."""
    dev = net.dec0.device
    feats = torch.as_tensor(feats, dtype=torch.float32)
    pm = torch.as_tensor(parent_mat)
    single = feats.dim() == 2
    if single:
        feats, pm = feats[None], pm[None]
    B, n, _ = feats.shape
    nv = torch.full((B,), n) if n_valid is None else torch.as_tensor(n_valid).reshape(B)
    sys_feat = _profile_input(sys_feat, dev)
    decoder = BucketedDecoder(dev, max_deg=pm.shape[-1], decode_impl=decode)
    impl = decoder.resolve_decode_impl(n, net.hidden, sys_feat is not None)
    uniforms = None if keys is None else step_uniforms(np.asarray(keys).reshape(B, 2), n).to(dev)
    out = decoder._decode(net, feats.to(dev), pm.to(device=dev, dtype=torch.int32),
                          nv.to(device=dev, dtype=torch.int32), impl, sys_feat, uniforms)
    return tuple(o[0] for o in out) if single else out


def greedy_order(net, feats, parent_mat, n_valid=None, sys_feat=None,
                 decode: str | None = None):
    """Greedy decode of one graph or of a padded batch, on the net's device.

    feats: (n, F) or (B, n, F) embedding rows; parent_mat: (n, D) or
    (B, n, D), -1 padded; n_valid: real node count(s), None for all;
    sys_feat: a hardware profile (a non-zero one conditions the start token
    and takes the scan); decode: one of :data:`DECODE_IMPLS`, chosen as in
    :class:`BucketedDecoder`; on CPU tensors each runs its plain PyTorch
    version.  Returns order (int64), logp and entropy, each (n,) or (B, n)."""
    return _order(net, feats, parent_mat, None, n_valid, sys_feat, decode)


def sample_order(net, feats, parent_mat, key, n_valid=None, sys_feat=None,
                 decode: str | None = None):
    """Sampled decode as :func:`greedy_order`, graph ``b`` drawing step
    ``i``'s uniform from ``fold_in(key[b], i)`` — the reference's stream, so
    orders equal its ``sample_order``'s, padded or not.  key: a (2,) uint32
    key for one graph, (B, 2) for a batch."""
    return _order(net, feats, parent_mat, key, n_valid, sys_feat, decode)
