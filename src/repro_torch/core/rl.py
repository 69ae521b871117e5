"""REINFORCE training for RESPECT (paper §III-B "RL Training").

The port of the reference's ``repro.core.rl``, step for step.

Reward (Eq. 3): the cosine of the stage vector ``rho(pi)`` of the policy's
order and the exact solver's ``rho(gamma)``.  Gradient (Eq. 6): REINFORCE
with a greedy rollout baseline of the best-so-far parameters (Kool et al.),
refreshed when the online policy's greedy reward improves
(:meth:`RLTrainer.maybe_update_baseline`).

One step (:func:`make_train_step`, the reference's ``_sum_loss_fn`` and
``_finish``):

* **sampled pass, with gradients** — encode, then the plain PyTorch decode
  of :class:`~repro_torch.core.ptrnet.PointerNet` with autograd, graph
  ``b`` drawing step ``i``'s uniform from ``fold_in(split(key, B)[b], i)``
  (the reference's stream, bit for bit); ``rho_dp`` on the device, stage
  vectors zeroed past ``n_valid``, the cosine reward;
* **greedy baseline pass, under ``torch.no_grad()``** — the baseline
  parameters through :class:`~repro_torch.core.batching.BucketedDecoder`'s
  choice: the whole-decode kernel B1 on the card where it takes the bucket
  and the system is uniform, else the scan with the single-step kernel B2.
  Its orders equal the reference's scan (integer outputs);
* **loss and update** — ``-sum(adv * logp * w) - entropy_coef * sum(ent *
  w)`` with ``adv = r_s - r_b`` (no gradient) and ``w = (n_valid > 0)``;
  ``backward()`` of the sum, gradients divided by ``max(sum(w), 1)``,
  clipped to global norm 1 and applied by the ported AdamW
  (:mod:`repro_torch.optim`), which updates every leaf, ``w_sys`` on a
  uniform step included.

No kernel sits on the gradient's path: the kernels' wrappers refuse
grad-requiring inputs in grad mode
(:func:`repro_torch.kernels.ptr.kernel.refuse_grad`).  Rollouts and evals
are forward only and run the kernels.

The stages of a step run inside ``torch.profiler.record_function`` ranges
named ``rl.<stage>`` (:data:`SPANS`), so a profiled step shows where its
time goes; outside a profiler they cost a few microseconds a step.

Data parallelism (the reference's ``shard_map`` over a ``data`` mesh): in a
world of ``n`` ranks (:mod:`repro_torch.parallel.data`; ``RLTrainer(n_devices=
n)``) every rank holds the replicated parameters and the same global pack,
splits the step's key over the global batch and takes its contiguous slice of
the graphs and of those keys, so each graph decodes as in one process.  One
all-reduce a step sums one flat float32 buffer (the loss sum, the five metric
sums, then every gradient leaf in ``param_tree``'s order, which fixes the
summation order); the normalization by the global valid-graph count, the
clip and AdamW then run on replicated values.  Evals stay replicated.

Where the reference is functional, the port updates the online network and
its optimizer state in place (no copy of the parameters a step);
:class:`TrainState` names the same five parts and checkpoints under the
reference's leaf names, so a trainer saved by either package restores in
the other.  Labels come from the exact DP on the device
(:func:`repro_torch.core.segment.exact_dp_batch`) with the reference's
on-disk cache and cache keys.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import optim
from ..device import resolve_device
from ..kernels.ptr.decode import step_uniforms
from . import prng, segment
from .batching import BucketedDecoder, PaddedGraphBatch, _profile_input, bucket_for, pack_padded
from .costmodel import PipelineSystem
from .exact import exact_bb, order_from_assignment
from .graph import CompGraph
from .ptrnet import PointerNet, param_tree

__all__ = [
    "label_graphs",
    "pack_graphs",
    "cosine_reward",
    "make_rollout_fn",
    "make_train_step",
    "make_eval_fn",
    "sum_loss_and_grads",
    "TrainState",
    "init_train_state",
    "RLTrainer",
    "train_data_parallel",
]

#: the profiler ranges (each ``rl.<name>``): the labeller of a pack, the
#: uniforms of the sampled pass, the encoder and plain decode of the
#: differentiable pass, a forward-only decode on B1 ("kernel") or the scan
#: with B2 ("scan"), encoder included, rho and the reward, backward, the
#: data-parallel step's all-reduce and the optimizer; ``train_step`` spans
#: the whole step
SPANS = ("label", "uniforms", "encode", "decode_plain", "decode_kernel", "decode_scan",
         "rho_reward", "backward", "all_reduce", "optimizer", "train_step")


def _span(name: str):
    return torch.profiler.record_function(f"rl.{name}")


# --------------------------------------------------------------------- #
# exact labels (the batched DP on the device, an on-disk cache)
# --------------------------------------------------------------------- #
def _label_cache_key(g: CompGraph, n_stages: int, system: PipelineSystem, method: str,
                     max_deg: int, bb_budget_s: float) -> str:
    """The reference's cache key, character for character, so both packages
    read and write one label cache."""
    h = hashlib.sha256()
    h.update(g.content_hash().encode())
    budget = bb_budget_s if method == "bb" else 0.0   # dp labels ignore the budget
    h.update(repr((n_stages, method, max_deg, budget, system.compute_rate,
                   system.compute_eff, system.link_bw, system.cache_bytes,
                   system.fixed_overhead_s)).encode())
    if system.mem_capacity is not None:
        h.update(repr(system.mem_capacity).encode())
    return h.hexdigest()[:40]


def label_graphs(graphs: list[CompGraph], n_stages: int, system: PipelineSystem,
                 max_deg: int = 6, label_method: str = "dp", bb_budget_s: float = 0.25,
                 cache_dir: str | Path | None = None, device=None):
    """Exact stage labels and imitation orders (lists of int64 arrays of
    length ``g.n``) for a list of graphs.

    ``"dp"`` solves the cache misses of one size bucket together (mixed
    sizes included) with :func:`~repro_torch.core.segment.exact_dp_batch`
    on ``device`` (the card unless the caller names one); ``"bb"`` runs the
    host branch and bound.  With ``cache_dir`` each label is kept as a
    ``.npz`` under the reference's key."""
    system = system.with_stages(n_stages)
    la: list[np.ndarray | None] = [None] * len(graphs)
    cache = Path(cache_dir) if cache_dir is not None else None
    keys: list[str | None] = [None] * len(graphs)
    misses: list[int] = []
    for i, g in enumerate(graphs):
        if cache is not None:
            keys[i] = _label_cache_key(g, n_stages, system, label_method, max_deg, bb_budget_s)
            p = cache / f"{keys[i]}.npz"
            if p.exists():
                with np.load(p) as d:
                    la[i] = d["assign"].astype(np.int64)
                continue
        misses.append(i)

    if misses:
        if label_method == "bb":
            for i in misses:
                assign, _ = exact_bb(graphs[i], n_stages, system, time_budget_s=bb_budget_s)
                la[i] = np.asarray(assign, dtype=np.int64)
        else:
            dev = resolve_device(device)
            by_bucket: dict[int, list[int]] = {}
            for i in misses:
                by_bucket.setdefault(bucket_for(graphs[i].n), []).append(i)
            for bucket_n, idxs in by_bucket.items():
                B = len(idxs)
                attrs = np.zeros((3, B, bucket_n), np.float32)
                pmat = np.full((B, bucket_n, max_deg), -1, np.int32)
                nv = np.zeros(B, np.int32)
                for row, i in enumerate(idxs):
                    g = graphs[i]
                    attrs[:, row, : g.n] = (g.flops, g.param_bytes, g.out_bytes)
                    pmat[row, : g.n] = g.parent_matrix(max_deg)
                    nv[row] = g.n
                t = lambda a: torch.from_numpy(a).to(dev)
                assigns, _ = segment.exact_dp_batch(t(attrs[0]), t(attrs[1]), t(attrs[2]),
                                                    t(pmat), n_stages, system, t(nv))
                assigns = assigns.cpu().numpy()
                for row, i in enumerate(idxs):
                    la[i] = assigns[row, : graphs[i].n].astype(np.int64)
        if cache is not None:
            cache.mkdir(parents=True, exist_ok=True)
            for i in misses:
                _write_label(cache / f"{keys[i]}.npz", la[i])

    return la, [order_from_assignment(a) for a in la]


def _write_label(path: Path, assign: np.ndarray) -> None:
    """Write one cached label atomically: ranks that label the same pack
    write the same file, and a reader never sees a partial one."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.stem}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, assign=assign)
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def pack_graphs(graphs: list[CompGraph], n_stages: int, system: PipelineSystem,
                max_deg: int = 6, label_method: str = "dp", bb_budget_s: float = 0.25,
                cache_dir: str | Path | None = None, bucket_n: int | None = None,
                pad: bool = True, device=None) -> PaddedGraphBatch:
    """Embed and label graphs (mixed sizes allowed) into one labelled
    :class:`PaddedGraphBatch` of CPU tensors, the representation serving
    runs on.  Nodes pad to ``bucket_n`` (default: the power-of-two bucket of
    the largest graph; ``pad=False``: exactly the largest graph's size).
    ``device`` is where the DP labeller runs; the pack records ``n_stages``
    as its ``label_stages``."""
    with _span("label"):
        la, lo = label_graphs(graphs, n_stages, system, max_deg=max_deg,
                              label_method=label_method, bb_budget_s=bb_budget_s,
                              cache_dir=cache_dir, device=device)
    if bucket_n is None and not pad:
        bucket_n = max(g.n for g in graphs)
    return pack_padded(graphs, bucket_n=bucket_n, max_deg=max_deg, labels=(la, lo),
                       label_stages=n_stages)


def cosine_reward(assign: torch.Tensor, label_assign: torch.Tensor,
                  eps: float = 1e-8) -> torch.Tensor:
    """Eq. 3 over the last dimension: ``a . b / max(|a| |b|, eps)``.  Stage
    vectors are small integers, so every sum is exact in float32 and a
    padded vector (zeros past ``n_valid``) scores as its unpadded self."""
    a = assign.float()
    b = label_assign.float()
    denom = torch.clamp_min(torch.sqrt((a * a).sum(-1)) * torch.sqrt((b * b).sum(-1)), eps)
    return (a * b).sum(-1) / denom


# --------------------------------------------------------------------- #
# rollouts, the train step and eval (all pad-aware)
# --------------------------------------------------------------------- #
def _check_mask(mask_infeasible: bool) -> None:
    if not mask_infeasible:
        raise ValueError("the port's decode always masks nodes with an unvisited parent "
                         "(mask_infeasible=True)")


def _on(batch: PaddedGraphBatch, dev) -> PaddedGraphBatch:
    return batch if batch.feats.device == dev else batch.to(dev)


def _check_labels(batch: PaddedGraphBatch, n_stages: int) -> None:
    """A reward against labels of another stage count trains and scores
    another objective: refuse it."""
    if batch.label_stages is not None and batch.label_stages != n_stages:
        raise ValueError(f"the pack's labels are for {batch.label_stages} stages, the step "
                         f"is for {n_stages}; pass n_stages={batch.label_stages}")


def _score(order, logp, ent, batch: PaddedGraphBatch, n_stages, system):
    """rho, masking and reward of decoded orders: per-graph (reward,
    logp sum, entropy mean over real steps, order, assignment)."""
    with _span("rho_reward"):
        assign = segment.rho_dp(order, batch.flops, batch.param_bytes, batch.out_bytes,
                                batch.parent_mat, n_stages, system, batch.n_valid)
        assign = torch.where(batch.valid_mask(), assign, 0)
        r = cosine_reward(assign, batch.label_assign)
        ent_mean = ent.sum(-1) / torch.clamp_min(batch.n_valid.float(), 1.0)
        return r, logp.sum(-1), ent_mean, order, assign


def _decode(net: PointerNet, batch: PaddedGraphBatch, impl: str, sys_feat, uniforms=None):
    """Encode and decode ``batch`` on ``impl``: "plain" (the differentiable
    PyTorch decode), "scan" (B2 each step on the card) or "kernel" (B1)."""
    if impl == "plain":
        with _span("encode"):
            C, state, emb = net.encode(batch.feats, batch.n_valid)
        with _span("decode_plain"):
            return net.decode(C, emb, state, batch.parent_mat, n_valid=batch.n_valid,
                              uniforms=uniforms, sys_feat=sys_feat)
    with _span(f"decode_{impl}"):
        return BucketedDecoder._decode(net, batch.feats, batch.parent_mat, batch.n_valid, impl,
                                       sys_feat, uniforms)


def _resolve(net: PointerNet, batch: PaddedGraphBatch, conditioned: bool) -> str:
    """The impl a forward-only pass takes: B1 where it takes the bucket and
    the system is uniform, else the scan (``BucketedDecoder``'s choice)."""
    decoder = BucketedDecoder(net.dec0.device, max_deg=batch.parent_mat.shape[-1])
    return decoder.resolve_decode_impl(batch.bucket_n, net.hidden, conditioned)


def _policy_rewards(net: PointerNet, batch: PaddedGraphBatch, keys, n_stages: int,
                    system: PipelineSystem, sample: bool, impl: str = "plain"):
    """Decode, rho and reward over a labelled pack on the net's device (the
    reference's ``_policy_rewards``): per-graph (rewards, logp sum,
    entropy mean, orders, assigns).  ``keys`` (B, 2) are the graphs' keys
    (graph ``b``'s step ``i`` draws ``uniform(fold_in(keys[b], i))``), read
    only when ``sample``; ``impl`` as :func:`_decode`."""
    _check_labels(batch, n_stages)
    dev = net.dec0.device
    batch = _on(batch, dev)
    sys_feat = _profile_input(system.profile_features(), dev)
    unif = None
    if sample:
        with _span("uniforms"):
            unif = step_uniforms(np.asarray(keys), batch.bucket_n).to(dev)
    return _score(*_decode(net, batch, impl, sys_feat, unif), batch, n_stages, system)


def _split(key, B: int) -> np.ndarray:
    return prng.split(np.asarray(key, dtype=np.uint32), B)


def make_rollout_fn(n_stages: int, system: PipelineSystem, mask_infeasible: bool = True,
                    sample: bool = False, decode_impl: str | None = None):
    """Per-graph rollout ``(net, batch, key) -> (rewards, logp, entropy,
    orders, assigns)``, each leading-dim B, forward only.

    ``decode_impl`` None or "scan" runs the scan (the single-step kernel on
    the card); "kernel" the whole-decode kernel, which raises for a
    profile-conditioned system as the reference does.  A sampled rollout
    draws the reference's per-step uniforms from ``split(key, B)``."""
    _check_mask(mask_infeasible)
    system = system.with_stages(n_stages)
    if decode_impl not in (None, "scan", "kernel"):
        raise ValueError(f"unknown decode_impl {decode_impl!r}")
    impl = decode_impl or "scan"
    if impl == "kernel" and system.profile_features().any():
        raise ValueError("whole-decode kernel rollouts cannot condition on a "
                         "heterogeneous system profile; use the scan decode_impl")

    @torch.no_grad()
    def rollout(net: PointerNet, batch: PaddedGraphBatch, key):
        return _policy_rewards(net, batch, _split(key, batch.batch), n_stages, system, sample,
                               impl)

    return rollout


def sum_loss_and_grads(net: PointerNet, baseline: PointerNet, batch: PaddedGraphBatch, key,
                       n_stages: int, system: PipelineSystem, entropy_coef: float = 0.0):
    """The summed REINFORCE loss of one batch, its metric sums and the
    gradient of the loss sum: ``(loss_sum, sums, grads)``, ``grads`` a
    tree of ``param_tree(net)``'s keys (zeros where no gradient reached a
    leaf).  The reference's ``value_and_grad(_sum_loss_fn)``.  ``key`` is
    one key, split over the batch's graphs, or the graphs' own keys (B, 2):
    a rank's slice of the split of the global batch."""
    system = system.with_stages(n_stages)
    batch = _on(batch, net.dec0.device)
    keys = np.asarray(key, dtype=np.uint32)
    if keys.ndim == 1:
        keys = _split(keys, batch.batch)
    elif keys.shape != (batch.batch, 2):
        raise ValueError(f"keys of shape {keys.shape} for a batch of {batch.batch}")
    for p in net.parameters():
        p.grad = None
    with torch.enable_grad():
        r_s, logp, ent, _, _ = _policy_rewards(net, batch, keys, n_stages, system, True)
    with torch.no_grad():
        impl = _resolve(baseline, batch, bool(system.profile_features().any()))
        r_b = _policy_rewards(baseline, batch, keys, n_stages, system, False, impl)[0]
    adv = (r_s - r_b).detach()
    w = (batch.n_valid > 0).float()
    with torch.enable_grad(), _span("backward"):
        loss_sum = -torch.sum(adv * logp * w) - entropy_coef * torch.sum(ent * w)
        loss_sum.backward()
    with torch.no_grad():
        sums = {"reward_sample": torch.sum(r_s * w), "reward_baseline": torch.sum(r_b * w),
                "advantage": torch.sum(adv * w), "entropy": torch.sum(ent * w),
                "n_graphs": torch.sum(w)}
        grads = optim.tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad, param_tree(net))
    for p in net.parameters():
        p.grad = None
    return loss_sum.detach(), sums, grads


_SUMS = ("reward_sample", "reward_baseline", "advantage", "entropy", "n_graphs")


def _all_reduce_sums(loss_sum, sums: dict, grads: dict, group):
    """Sum the loss, the metric sums and every gradient leaf over the ranks
    in ONE all-reduce of one flat float32 buffer, in that order (the
    gradient leaves in ``param_tree``'s order)."""
    import torch.distributed as dist
    leaves: list = []
    optim.tree_map(leaves.append, grads)      # param_tree's insertion order
    flat = torch.cat([torch.stack([loss_sum.float()] + [sums[k].float() for k in _SUMS])]
                     + [g.reshape(-1).float() for g in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = [], len(_SUMS) + 1
    for g in leaves:
        out.append(flat[at: at + g.numel()].view_as(g).to(g.dtype))
        at += g.numel()
    it = iter(out)
    grads = optim.tree_map(lambda _: next(it), grads)
    return flat[0], {k: flat[1 + i] for i, k in enumerate(_SUMS)}, grads


def make_train_step(n_stages: int, system: PipelineSystem, optimizer,
                    mask_infeasible: bool = True, entropy_coef: float = 0.0, group=None):
    """The REINFORCE step ``(net, baseline, opt_state, batch, key) -> (net,
    opt_state, metrics)``.  ``net`` (trainable) is updated in place and
    returned; ``metrics`` are the reference's keys as () tensors.  Any
    ``(bucket_n, B)`` shape runs: nothing is compiled per shape.  A pack
    labelled for another stage count raises ``ValueError``.

    ``group`` (a ``torch.distributed`` process group, or the default world
    when it is a :class:`~repro_torch.parallel.data.DataWorld`) runs the step
    data-parallel: every rank passes the same global ``batch`` and ``key``
    and computes its contiguous slice; a global batch that the world does not
    divide raises ``ValueError``."""
    _check_mask(mask_infeasible)
    system = system.with_stages(n_stages)
    if group is not None:
        import torch.distributed as dist
        from ..parallel.data import DataWorld
        pg = None if isinstance(group, DataWorld) else group
        rank, world = dist.get_rank(pg), dist.get_world_size(pg)

    def train_step(net: PointerNet, baseline: PointerNet, opt_state, batch, key):
        with _span("train_step"):
            if group is None:
                loss_sum, sums, grads = sum_loss_and_grads(net, baseline, batch, key, n_stages,
                                                           system, entropy_coef)
            else:
                from ..parallel.data import rank_slice
                keys = _split(key, batch.batch)
                mine = rank_slice(batch, rank, world)     # raises when world does not divide
                loss_sum, sums, grads = sum_loss_and_grads(
                    net, baseline, mine, rank_slice(keys, rank, world), n_stages, system,
                    entropy_coef)
                with _span("all_reduce"):
                    loss_sum, sums, grads = _all_reduce_sums(loss_sum, sums, grads, pg)
            with torch.no_grad(), _span("optimizer"):
                W = torch.clamp_min(sums["n_graphs"], 1.0)
                grads = optim.tree_map(lambda g: g / W, grads)
                grads, gnorm = optim.clip_by_global_norm(grads, 1.0)
                params = param_tree(net)
                new, opt_state = optimizer.update(grads, opt_state, params)
                optim.tree_map(lambda p, q: p.copy_(q), params, new)
                metrics = {k: v / W for k, v in sums.items() if k != "n_graphs"}
                metrics.update(loss=loss_sum / W, grad_norm=gnorm, n_graphs=sums["n_graphs"])
        return net, opt_state, metrics

    return train_step


def make_eval_fn(n_stages: int, system: PipelineSystem, mask_infeasible: bool = True):
    """Greedy eval ``(net, batch) -> {"reward_greedy", "exact_match"}``:
    valid-graph-weighted means of the reward and of the exact match of the
    real stage-vector prefix, decoded as the baseline pass decodes.  A pack
    labelled for another stage count raises ``ValueError``."""
    _check_mask(mask_infeasible)
    system = system.with_stages(n_stages)

    @torch.no_grad()
    def eval_fn(net: PointerNet, batch: PaddedGraphBatch):
        batch = _on(batch, net.dec0.device)
        impl = _resolve(net, batch, bool(system.profile_features().any()))
        r, _, _, _, assigns = _policy_rewards(net, batch, None, n_stages, system, False, impl)
        match = torch.where(batch.valid_mask(), assigns == batch.label_assign, True).all(-1)
        w = (batch.n_valid > 0).float()
        W = torch.clamp_min(w.sum(), 1.0)
        return {"reward_greedy": torch.sum(r * w) / W,
                "exact_match": torch.sum(match.float() * w) / W}

    return eval_fn


# --------------------------------------------------------------------- #
# trainer state and the trainer
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class TrainState:
    """What a run needs to resume: the online network (trainable), the
    rollout baseline (frozen), the optimizer state, the step and the best
    baseline reward seen.  :meth:`tree` gives it under the reference's
    checkpoint leaf names (``0/<param>``, ``1/<param>``, ``2/0`` the
    optimizer step, ``2/1/...`` mu, ``2/2/...`` nu, ``3``, ``4``)."""

    params: PointerNet
    baseline_params: PointerNet
    opt_state: optim.OptState
    step: torch.Tensor                  # () int32
    best_baseline_reward: torch.Tensor  # () float32

    def tree(self) -> dict:
        return {"0": param_tree(self.params), "1": param_tree(self.baseline_params),
                "2": self.opt_state.tree(), "3": self.step, "4": self.best_baseline_reward}

    def load_tree(self, tree: dict) -> None:
        """Take every leaf of ``tree`` (the shape of :meth:`tree`), the
        networks' parameters copied in place."""
        with torch.no_grad():
            for net, sub in ((self.params, tree["0"]), (self.baseline_params, tree["1"])):
                optim.tree_map(lambda p, q: p.copy_(q), param_tree(net), sub)
        self.opt_state = optim.OptState.from_tree(tree["2"])
        self.step = tree["3"]
        self.best_baseline_reward = tree["4"]


def _frozen_copy(net: PointerNet) -> PointerNet:
    return copy.deepcopy(net).requires_grad_(False)


def init_train_state(key, feat_dim: int, hidden: int, optimizer, device=None) -> TrainState:
    """The reference's ``init_train_state``: seeded parameters (``key`` a
    JAX-format key, :func:`repro_torch.core.prng.PRNGKey`), a baseline copy
    of them, a fresh optimizer state, step 0 and best reward -inf, on
    ``device`` (the card unless the caller names one)."""
    dev = resolve_device(device)
    net = PointerNet.init(feat_dim, hidden, key=key).to(dev).requires_grad_(True)
    return TrainState(params=net, baseline_params=_frozen_copy(net),
                      opt_state=optimizer.init(param_tree(net)),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      best_baseline_reward=torch.full((), -np.inf, dtype=torch.float32,
                                                      device=dev))


class RLTrainer:
    """The paper's training setup: Adam, a greedy rollout baseline, one
    parameter set trained against every count of ``stage_counts``
    (``train_step(batch, key, n_stages=k)``).  Runs on the card unless
    ``device`` names another; ``save``/``restore`` go through
    :class:`repro_torch.checkpoint.CheckpointManager` in the reference's
    format.

    ``n_devices=n > 1`` trains data-parallel over an initialised
    ``torch.distributed`` world of ``n`` ranks (start them with
    :func:`repro_torch.parallel.data.run_ranks`): every rank builds the same
    trainer and feeds it the same global packs and keys.  Evals stay
    replicated; the baseline decision follows rank 0's eval; ``save`` writes
    on rank 0 and ``restore`` reads on every rank, each followed by a
    barrier."""

    def __init__(self, n_stages: int = 4, system: PipelineSystem | None = None,
                 hidden: int = 256, lr: float = 1e-4, feat_dim: int | None = None,
                 mask_infeasible: bool = True, entropy_coef: float = 0.0, seed: int = 0,
                 n_devices: int | None = None, stage_counts: tuple[int, ...] | None = None,
                 device=None):
        from .embedding import embed_dim
        self.world = None
        if n_devices is not None and n_devices > 1:
            from ..parallel.data import current_world
            self.world = current_world()
            if self.world is None or self.world.size != n_devices:
                have = "none" if self.world is None else f"one of {self.world.size}"
                raise ValueError(
                    f"n_devices={n_devices} needs an initialised torch.distributed world of "
                    f"{n_devices} ranks (have {have}); start the ranks with "
                    "repro_torch.parallel.data.run_ranks")
        _check_mask(mask_infeasible)
        self.stage_counts = tuple(stage_counts) if stage_counts else (n_stages,)
        self.n_stages = self.stage_counts[0] if stage_counts else n_stages
        self._base_system = system or PipelineSystem(self.n_stages)
        self.system = self._base_system.with_stages(self.n_stages)
        self.optimizer = optim.adamw(lr=lr)
        self.hidden = hidden
        self.mask_infeasible = mask_infeasible
        self.entropy_coef = entropy_coef
        self.device = resolve_device(device)
        self.state = init_train_state(prng.PRNGKey(seed), feat_dim or embed_dim(), hidden,
                                      self.optimizer, self.device)
        self._train_steps: dict[int, object] = {}
        self._eval_fns: dict[int, object] = {}
        self._ckpt_managers: dict = {}

    def _step_fn(self, k: int):
        if k not in self._train_steps:
            self._train_steps[k] = make_train_step(
                k, self._base_system.with_stages(k), self.optimizer, self.mask_infeasible,
                self.entropy_coef, group=self.world)
        return self._train_steps[k]

    def _eval_fn_for(self, k: int):
        if k not in self._eval_fns:
            self._eval_fns[k] = make_eval_fn(k, self._base_system.with_stages(k),
                                             self.mask_infeasible)
        return self._eval_fns[k]

    @property
    def params(self) -> PointerNet:
        return self.state.params

    @property
    def baseline_params(self) -> PointerNet:
        return self.state.baseline_params

    @property
    def opt_state(self) -> optim.OptState:
        return self.state.opt_state

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    def train_step(self, batch: PaddedGraphBatch, key, n_stages: int | None = None) -> dict:
        """One REINFORCE step on a labelled pack; ``key`` a JAX-format key.
        Returns the reference's metrics as floats."""
        if not batch.has_labels:
            raise ValueError("training batch carries no labels; pack with "
                             "rl.pack_graphs / DagSampler.next_packed_batch")
        st = self.state
        _, st.opt_state, metrics = self._step_fn(n_stages or self.n_stages)(
            st.params, st.baseline_params, st.opt_state, batch, key)
        st.step = st.step + 1
        return {k: float(v) for k, v in metrics.items()}

    def evaluate(self, batch: PaddedGraphBatch, n_stages: int | None = None) -> dict:
        fn = self._eval_fn_for(n_stages or self.n_stages)
        return {k: float(v) for k, v in fn(self.state.params, batch).items()}

    def consider_baseline(self, reward: float) -> bool:
        """Adopt the online policy as the rollout baseline when ``reward``
        beats the best seen so far (data-parallel: rank 0's ``reward``, so
        every rank decides alike)."""
        if self.world is not None:
            import torch.distributed as dist
            r = torch.tensor([reward], dtype=torch.float32, device=self.device)
            dist.broadcast(r, src=0)
            reward = float(r[0])
        if reward > float(self.state.best_baseline_reward):
            self.state.baseline_params = _frozen_copy(self.state.params)
            self.state.best_baseline_reward = torch.tensor(
                reward, dtype=torch.float32, device=self.device)
            return True
        return False

    def maybe_update_baseline(self, eval_batch: PaddedGraphBatch,
                              n_stages: int | None = None) -> bool:
        """Rollout-baseline refresh from the greedy reward on ``eval_batch``."""
        return self.consider_baseline(self.evaluate(eval_batch, n_stages)["reward_greedy"])

    def _manager(self, ckpt_dir: str | Path):
        """One manager per directory for the trainer's lifetime, so saves
        to it serialize."""
        from ..checkpoint import CheckpointManager
        key = str(Path(ckpt_dir))
        if key not in self._ckpt_managers:
            self._ckpt_managers[key] = CheckpointManager(ckpt_dir)
        return self._ckpt_managers[key]

    def save(self, ckpt_dir: str | Path, blocking: bool = True) -> None:
        """Checkpoint the whole TrainState (atomic, retained, resumable);
        data-parallel: rank 0 writes, then every rank meets at a barrier."""
        if self.world is None or self.world.is_main:
            self._manager(ckpt_dir).save(self.step_count, self.state.tree(), blocking=blocking)
        if self.world is not None:
            self.world.barrier()

    def restore(self, ckpt_dir: str | Path) -> int | None:
        """Restore the newest complete checkpoint; its step, or None when
        the directory holds none (every rank reads, then a barrier)."""
        if self.world is not None and self.world.is_main:
            self._manager(ckpt_dir).wait()
        step, tree = self._manager(ckpt_dir).restore_latest(self.state.tree())
        if self.world is not None:
            self.world.barrier()
        if step is None:
            return None
        self.state.load_tree(tree)
        return step


# --------------------------------------------------------------------- #
# a data-parallel run of given steps (the rank body run_ranks spawns)
# --------------------------------------------------------------------- #
def _steps_rank(world, device, packs, keys, n_stages, trainer_kw, record):
    """One rank of :func:`train_data_parallel`."""
    from ..kernels.build import LAUNCHES
    from .ptrnet import params_to_numpy
    from ..parallel.data import rank_slice
    tr = RLTrainer(n_devices=world.size, device=device, **trainer_kw)
    out = {"rank": world.rank, "metrics": [], "rollouts": [], "params_by_step": [],
           "step_s": [], "launches": {}}
    for pack, key in zip(packs, keys):
        if record:
            mine = rank_slice(pack, world.rank, world.size)
            ks = rank_slice(_split(key, pack.batch), world.rank, world.size)
            with torch.no_grad():
                s = _policy_rewards(tr.params, mine, ks, n_stages, tr.system, True)
                impl = _resolve(tr.baseline_params, _on(mine, tr.device), False)
                b = _policy_rewards(tr.baseline_params, mine, ks, n_stages, tr.system, False,
                                    impl)
            out["rollouts"].append({f"{p}_{f}": v[i].cpu().numpy()
                                    for p, v in (("sample", s), ("baseline", b))
                                    for i, f in ((0, "rewards"), (3, "order"), (4, "assign"))})
        before = dict(LAUNCHES)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out["metrics"].append(tr.train_step(pack, key, n_stages=n_stages))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["step_s"].append(time.perf_counter() - t0)
        for k, v in LAUNCHES.items():
            out["launches"][k] = out["launches"].get(k, 0) + v - before[k]
        if record:
            out["params_by_step"].append(params_to_numpy(tr.params))
    out["params"] = params_to_numpy(tr.params)
    return out


def train_data_parallel(packs: list, keys: list, n_ranks: int, *, backend: str, device=None,
                        n_stages: int = 4, share_device: bool = False,
                        timeout_s: float = 600.0, record: bool = False,
                        **trainer_kw) -> list[dict]:
    """Train ``RLTrainer(n_devices=n_ranks, **trainer_kw)`` data-parallel on
    ``n_ranks`` spawned ranks (:func:`repro_torch.parallel.data.run_ranks`),
    one step a (global pack, key) pair, every rank fed the same packs.

    Returns one dict a rank: ``metrics`` (a step's), ``step_s`` (host
    seconds a step, synchronized), ``launches`` (kernel launches in the
    steps), ``params`` (the final parameters as numpy) and, with ``record``,
    ``rollouts`` (before each step the rank's slice of the sampled and
    greedy-baseline rewards, orders and assignments) and ``params_by_step``
    (the parameters after each step)."""
    from ..parallel.data import run_ranks
    keys = [np.asarray(k, dtype=np.uint32) for k in keys]
    packs = [p.to("cpu") for p in packs]
    return run_ranks(_steps_rank, n_ranks, backend=backend, device=device,
                     timeout_s=timeout_s, share_device=share_device,
                     args=(packs, keys, n_stages, trainer_kw, record))
