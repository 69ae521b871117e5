"""One rule for running B3 and B4 on ``DTensor`` operands, shared by real
ranks (:mod:`repro_torch.kernels.flash.ops`, ``flash.vjp``,
``ssd.ops``) and the dry run's trace (:mod:`repro_torch.launch.dryrun`).

A kernel reads plain tensors, so each rank runs it on its local shards:

* **align** — the operands are redistributed so that every rank holds whole
  kernel problems.  Attention keeps the queries' batch and head shards
  (``Shard(0)``/``Shard(1)``) where they divide, and splits the keys and
  values the same way; the SSD scan keeps ``x``'s batch and head shards
  (dims 0 and 2), with ``dt`` and ``in_scale`` following the heads, ``A``
  the heads alone and ``B``/``C`` the batch alone.  Anything else is
  replicated.
* **the rank's heads** — where the key/value heads (the SSD's B/C groups)
  stay whole along an axis that splits the query heads (a GQA width the
  axis does not divide; zamba2's 2 groups on a 4-way axis), the rank takes
  the heads its own query heads read, found from its shard's offset
  (:func:`shard_offset`, the mesh coordinate): a slice where its query heads
  read whole groups, else one key/value head a query head.
* **wrap** — the kernel's local outputs become ``DTensor``s of the global
  shape at the aligned placements.

On the card the kernel then sees only local CUDA tensors; on the CPU the
plain version runs on the same local shards.
"""

from __future__ import annotations

import torch

__all__ = ["spread", "placed", "align_flash", "align_ssd", "ALIGN", "shard_offset",
           "read_index", "take_read", "put_read", "local_operands", "wrap", "on_shards"]


def spread(t, mesh_pl, dims_from, dims_to) -> tuple:
    """Placements for ``t``: the reference tensor's ``Shard(d)`` for ``d`` in
    ``dims_from`` mapped to ``dims_to`` where ``t`` divides, else
    ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    out = []
    for size, p in zip(mesh.shape, mesh_pl):
        d = getattr(p, "dim", None)
        if d in dims_from:
            to = dims_to[dims_from.index(d)]
            if to is not None and t.shape[to] % size == 0:
                out.append(Shard(to))
                continue
        out.append(Replicate())
    return tuple(out)


def placed(t, pl):
    return t if tuple(t.placements) == tuple(pl) else t.redistribute(t.device_mesh, pl)


def align_flash(inputs):
    """(q, k, v) placed for B3, and the placements of its (out, lse)."""
    q, k, v = inputs
    qp = spread(q, q.placements, (0, 1), (0, 1))
    q = placed(q, qp)
    k = placed(k, spread(k, qp, (0, 1), (0, 1)))
    v = placed(v, spread(v, qp, (0, 1), (0, 1)))
    return (q, k, v), (qp, spread(q, qp, (0, 1), (0, 1)))


def align_ssd(inputs):
    """(x, dt, A, B, C[, in_scale]) placed for B4, and the placements of its
    (y, h_final)."""
    x = inputs[0]
    xp = spread(x, x.placements, (0, 2), (0, 2))
    out = [placed(x, xp),
           placed(inputs[1], spread(inputs[1], xp, (0, 2), (0, 2))),
           placed(inputs[2], spread(inputs[2], xp, (0, 2), (None, 0))),
           placed(inputs[3], spread(inputs[3], xp, (0, 2), (0, None))),
           placed(inputs[4], spread(inputs[4], xp, (0, 2), (0, None)))]
    if len(inputs) > 5:
        out.append(placed(inputs[5], spread(inputs[5], xp, (0, 2), (0, 2))))
    return tuple(out), (xp, spread(out[0], xp, (0, 2), (0, 1)))


#: kernel name (as ``trace_hooks.kernel`` names it) -> its alignment
ALIGN = {"flash_fwd": align_flash, "ssd_scan": align_ssd}
#: kernel name -> (the operand and dim of the query heads, the operands read
#: by head group and their group dim)
_GROUPED = {"flash_fwd": ((0, 1), (1, 2), 1), "ssd_scan": ((0, 2), (3, 4), 2)}


def shard_offset(t, dim: int) -> int:
    """The global index of this rank's first entry of ``t`` along ``dim``
    (0 where ``dim`` is whole), from its mesh coordinate."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    return int(compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                     t.placements)[1][dim])


def read_index(n_heads: int, n_groups: int, head_off: int, n_local: int, group_off: int):
    """The local group indices that local heads ``head_off ..`` (``n_local``
    of ``n_heads``, each group serving ``n_heads / n_groups`` consecutive
    heads) read, where the rank's groups start at ``group_off``: a slice
    when the heads read whole, equal shares of their groups (the kernel's
    own mapping then holds locally), else a list of one group a head."""
    per = n_heads // n_groups
    first, last = head_off // per, (head_off + n_local - 1) // per
    count = last - first + 1
    if count == 1 or (head_off % per == 0 and n_local == count * per):
        return slice(first - group_off, first - group_off + count)
    return [(head_off + i) // per - group_off for i in range(n_local)]


def take_read(t, index, dim: int):
    """The entries ``index`` (a :func:`read_index`) of ``t`` along ``dim``."""
    if isinstance(index, slice):
        return t.narrow(dim, index.start, index.stop - index.start)
    return t.index_select(dim, torch.tensor(index, device=t.device))


def put_read(g, index, dim: int, shape):
    """The transpose of :func:`take_read`: ``g`` added into zeros of
    ``shape`` at ``index`` along ``dim``."""
    if isinstance(index, slice) and index.start == 0 and index.stop == shape[dim]:
        return g
    out = g.new_zeros(shape)
    if isinstance(index, slice):
        out.narrow(dim, index.start, index.stop - index.start).copy_(g)
        return out
    return out.index_add_(dim, torch.tensor(index, device=g.device), g)


def _read(kind: str, placed_ops) -> tuple:
    """(operand positions read by group, their group dim, the read index)
    of aligned operands."""
    (qi, qd), grouped, gd = _GROUPED[kind]
    q, g = placed_ops[qi], placed_ops[grouped[0]]
    index = read_index(q.shape[qd], g.shape[gd], shard_offset(q, qd),
                       q.to_local().shape[qd], shard_offset(g, gd))
    return grouped, gd, index


def local_operands(kind: str, placed_ops) -> list:
    """The aligned operands' local shards, the grouped ones cut to the
    groups this rank's heads read."""
    grouped, gd, index = _read(kind, placed_ops)
    return [take_read(t.to_local(), index, gd) if i in grouped else t.to_local()
            for i, t in enumerate(placed_ops)]


def wrap(local, mesh, placements):
    """A ``DTensor`` from an evenly split local tensor at ``placements``
    (its global shape: the local one times the split counts)."""
    from ..models.common import _from_local
    shape = list(local.shape)
    for size, p in zip(mesh.shape, placements):
        if hasattr(p, "dim"):
            shape[p.dim] *= size
    return _from_local(local, mesh, placements, shape)


def on_shards(kind: str, fn, *inputs):
    """``fn`` (the kernel's plain-tensor entry: B3/B4 on the card, the plain
    version on the CPU) on each rank's aligned local operands; its outputs
    (one tensor or a tuple) as ``DTensor``s.  A plain input is replicated
    onto the ``DTensor`` operands' mesh."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(t.device_mesh for t in inputs if hasattr(t, "device_mesh"))
    inputs = tuple(t if hasattr(t, "device_mesh") else
                   DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)
                   for t in inputs)
    ops, out_pl = ALIGN[kind](inputs)
    outs = fn(*local_operands(kind, ops))
    if isinstance(outs, tuple):
        return tuple(wrap(o, mesh, pl) for o, pl in zip(outs, out_pl))
    return wrap(outs, mesh, out_pl[0])
