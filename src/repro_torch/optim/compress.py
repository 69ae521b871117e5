"""int8 gradient compression with error feedback for the data-parallel
all-reduce (the reference's ``repro.optim.compress``).

Each leaf is quantized against one scale that every rank shares (a ``MAX``
all-reduce of the float32 amax), so the int8 payload sums exactly as int32
across the ranks; ``mean = total * scale / n``.  Error feedback (Karimireddy
et al., 2019) returns each step's residual ``g32 - q * scale``, which the
caller adds back before the next step's compression.

As in the reference, which never reads its ``TrainConfig.grad_compression``,
no training step calls this module: ``make_train_fn`` refuses a
``grad_compression`` other than None.

gloo all-reduces CUDA tensors with ``SUM`` on int32 and ``MAX`` on float32,
so on a card the collectives run on the device tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .adamw import tree_map

__all__ = ["int8_compress", "int8_decompress", "int8_all_reduce", "compressed_all_reduce",
           "compressed_all_reduce_rows"]


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def _quantize(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def int8_compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 payload, float32 scale): symmetric per-tensor
    quantization."""
    x32 = x.float()
    scale = _scale(x32.abs().max())
    return _quantize(x32, scale), scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def int8_all_reduce(g32: torch.Tensor, group=None):
    """One float32 tensor's int8 all-reduce: ``(q, total, scale)``, this
    rank's payload, the int32 sum of every rank's and the shared scale."""
    amax = g32.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = _scale(amax)
    q = _quantize(g32, scale)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return q, total, scale


def compressed_all_reduce(tree, group=None, error_tree=None):
    """All-reduce a gradient tree (nested dicts of tensors) over ``group``
    in int8.  Returns ``(mean_tree, err_tree)``: the mean over the ranks in
    each leaf's dtype, and the float32 error feedback to pass as
    ``error_tree`` next time."""
    n = dist.get_world_size(group)

    def one(g, e):
        g32 = g.float() + (e.float() if e is not None else 0.0)
        q, total, scale = int8_all_reduce(g32, group)
        mean = total.float() * scale / n
        err = g32 - q.float() * scale
        return mean.to(g.dtype), err

    out = tree_map(one, tree, error_tree)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def compressed_all_reduce_rows(world, device, stacked: dict, error_stacked: dict | None = None):
    """Rank body for :func:`repro_torch.parallel.data.run_ranks`: rank
    ``r`` all-reduces row ``r`` of ``stacked`` (nested dicts of numpy arrays
    with a leading rank axis, as ``jax.vmap`` over a ``data`` axis feeds the
    reference's ``compressed_psum``), with row ``r`` of ``error_stacked`` as
    its error feedback.  Returns numpy trees ``{"mean", "err", "q", "total",
    "scale"}``: the function's outputs and, from :func:`int8_all_reduce` of
    the same inputs, this rank's int8 payload, the int32 totals and the
    shared scales."""
    def row(a):
        return torch.from_numpy(np.array(a[world.rank])).to(device)

    tree = tree_map(row, stacked)
    err = None if error_stacked is None else tree_map(row, error_stacked)
    mean, new_err = compressed_all_reduce(tree, None, err)
    g32 = tree_map(lambda g, e: g.float() + (e.float() if e is not None else 0.0), tree, err)
    parts = tree_map(lambda g: int8_all_reduce(g), g32)
    host = lambda t: t.detach().cpu().numpy()   # noqa: E731
    return {"mean": tree_map(host, mean), "err": tree_map(host, new_err),
            "q": tree_map(lambda p: host(p[0]), parts),
            "total": tree_map(lambda p: host(p[1]), parts),
            "scale": tree_map(lambda p: host(p[2]), parts)}
