"""Shared model building blocks: parameter draws, annotated parameters
(a value beside its logical sharding axes), input records, RMS and layer
norms, rotary, and the token-mean cross-entropy of the losses.

The reference's RMS norm has a custom VJP only to keep the residual
gradient in the activation dtype under XLA; autograd through the cast back
to ``x``'s dtype gives that here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import prng
from ..kernels.sharded import shard_offset

__all__ = ["DTYPES", "dtype_of", "Init", "KeyStream", "Annotated", "param", "split_annotated",
           "lift_layers", "TensorSpec", "constrain", "distribute_tree", "write_seq",
           "exclusive_cumsum",
           "embed_lookup", "column_sharded_product", "whole_product", "whole_heads",
           "flat_heads", "on_local_shards",
           "rms_norm", "layer_norm", "rotary_embedding", "apply_rotary", "softmax_cross_entropy"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


class KeyStream:
    """Threefry draws on the host, the same bits on every machine (and
    ``jax.random``'s, :mod:`repro_torch.core.prng`): the ``i``-th normal
    draw of an init is ``normal(fold_in(PRNGKey(seed), i), shape)``."""

    def __init__(self, seed: int):
        self.base = prng.PRNGKey(seed)
        self.count = 0

    def normal(self, shape) -> np.ndarray:
        key = prng.fold_in(self.base, self.count)
        self.count += 1
        return prng.normal(key, tuple(shape))


@dataclasses.dataclass(frozen=True)
class Init:
    """Where parameters are made: the device, the seeded generator (a
    ``torch.Generator`` on that device, or a host :class:`KeyStream`), and
    a leading shape (``(n,)`` for a stack of ``n`` layers).  On the
    ``meta`` device nothing is drawn or allocated."""
    device: torch.device
    generator: torch.Generator | KeyStream | None = None
    lead: tuple = ()

    def stacked(self, n: int) -> "Init":
        return dataclasses.replace(self, lead=(n,))

    def normal(self, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
        """``N(0, 1) * scale``, drawn in float32 and cast to ``dtype``."""
        shape = (*self.lead, *shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        if isinstance(self.generator, KeyStream):
            x = torch.from_numpy(self.generator.normal(shape)).to(self.device)
        else:
            x = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                            device=self.device)
        return x.mul_(scale).to(dtype)

    def full(self, shape, value: float, dtype: torch.dtype) -> torch.Tensor:
        return torch.full((*self.lead, *shape), value, dtype=dtype, device=self.device)


@dataclasses.dataclass
class Annotated:
    """A parameter leaf and its logical axes (one name or None a dim)."""
    value: Any
    axes: tuple


def param(init: Init, shape, axes, dtype: torch.dtype = torch.bfloat16,
          scale: float | None = None, kind: str = "normal") -> Annotated:
    """One annotated parameter: ``kind`` ``"zeros"``, ``"ones"`` or
    ``"normal"`` (``N(0, 1) * scale``, fan-in scaling when ``scale`` is
    None)."""
    if kind in ("zeros", "ones"):
        return Annotated(init.full(shape, float(kind == "ones"), dtype), tuple(axes))
    if scale is None:
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
        scale = fan_in ** -0.5
    return Annotated(init.normal(shape, scale, dtype), tuple(axes))


def split_annotated(tree):
    """A tree (nested dicts) of :class:`Annotated` leaves -> (value tree,
    logical-axes tree)."""
    if isinstance(tree, Annotated):
        return tree.value, tree.axes
    pairs = {k: split_annotated(v) for k, v in tree.items()}
    return {k: v for k, (v, _) in pairs.items()}, {k: a for k, (_, a) in pairs.items()}


def lift_layers(axes_tree):
    """An axes tree with a leading ``"layers"`` axis on every leaf: the
    tree of a stack of layers."""
    if isinstance(axes_tree, dict):
        return {k: lift_layers(v) for k, v in axes_tree.items()}
    return ("layers", *axes_tree)


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, nothing allocated (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def constrain(x, logical_axes):
    """The reference's activation constraint at its call sites: a
    ``DTensor`` (the dry run's sharded program) is redistributed to the
    placements ``logical_axes`` resolve to
    (:func:`repro_torch.parallel.sharding.constrain`); a plain tensor passes
    through untouched."""
    if not hasattr(x, "device_mesh"):
        return x
    from ..parallel.sharding import constrain as to_placements
    return to_placements(x, logical_axes)


def distribute_tree(make, axes_tree, like, rules=None):
    """``make(init)`` — a tree (nested dicts) of fresh zeros drawn from an
    :class:`Init` — on ``like``'s device; when ``like`` is a ``DTensor``,
    as ``DTensor``s on its mesh at the placements ``axes_tree`` resolves
    to, each device making only zeros of its local shape (the global shapes
    come from a fake-tensor pass that allocates nothing)."""
    if not hasattr(like, "device_mesh"):
        return make(Init(like.device))
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard

    from ..parallel.sharding import is_axes, placements_for
    mesh = like.device_mesh
    with FakeTensorMode():
        shapes = make(Init(torch.device("meta")))

    def place(t, axes):
        pl = placements_for(axes, t.shape, mesh, rules)
        local = list(t.shape)
        for size, p in zip(mesh.shape, pl):
            if isinstance(p, Shard):
                local[p.dim] //= size
        return _from_local(torch.zeros(local, dtype=t.dtype, device=like.device), mesh, pl,
                           t.shape)

    def walk(tree, axes):
        if is_axes(axes):
            return place(tree, axes)
        return {k: walk(v, axes[k]) for k, v in tree.items()}
    return walk(shapes, axes_tree)


def write_seq(dst, start: int, val, axis: int = 1) -> None:
    """``dst[:, start: start + n] = val`` along ``axis`` (``val`` n long
    there).  On a ``DTensor`` whose ``axis`` is sharded each rank writes the
    positions its shard owns, at their offset inside the shard (from its
    mesh coordinate); a write that straddles two shards is split between
    their ranks, and a rank that owns none of the positions writes
    nothing."""
    n = val.shape[axis]
    if not hasattr(dst, "device_mesh") or not any(
            getattr(p, "dim", None) == axis for p in dst.placements):
        dst[(slice(None),) * axis + (slice(start, start + n),)] = val
        return
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == axis else p
                 for p in dst.placements)
    if hasattr(val, "device_mesh"):
        val = val.redistribute(dst.device_mesh, want).to_local()
    local = dst.to_local()
    off = shard_offset(dst, axis)
    lo, hi = max(start, off), min(start + n, off + local.shape[axis])
    if lo < hi:
        local.narrow(axis, lo - off, hi - lo).copy_(val.narrow(axis, lo - start, hi - lo))


def exclusive_cumsum(x):
    """``x.cumsum(0) - x``: each row's sum of the rows before it.  On a
    ``DTensor`` split along dim 0 each rank takes its local cumsum and adds
    the totals of the shards before its own, all-gathered along the axes
    that split dim 0 (one row a shard, not the rows: the reference's
    prefix + correction); the shard's rank in that order comes from its
    offset (its mesh coordinate).  Other placements go through ``DTensor``'s
    own cumsum."""
    pl = tuple(getattr(x, "placements", ()))
    split = [i for i, p in enumerate(pl) if getattr(p, "dim", None) == 0]
    if not split or any(p.is_partial() for p in pl):
        return x.cumsum(0) - x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    ways = math.prod(mesh.shape[i] for i in split)
    if x.shape[0] % ways:
        return x.cumsum(0) - x
    local = x.to_local()
    totals = _from_local(local.sum(0, keepdim=True), mesh, pl, (ways, *x.shape[1:]))
    whole = tuple(Replicate() if i in split else p for i, p in enumerate(pl))
    totals = totals.redistribute(mesh, whole).to_local()
    before = totals[: shard_offset(x, 0) // local.shape[0]].sum(0)
    return _from_local(local.cumsum(0) - local + before, mesh, pl, x.shape)


def embed_lookup(table, tokens):
    """``table[tokens]``.  On a ``DTensor`` table whose rows (the
    vocabulary) may be split across the mesh, each rank looks its tokens up
    in its own rows, from its shard's offset, and the other ranks' rows give
    zeros: the sum across the vocabulary's axes is the lookup, exactly (the
    reference's vocabulary-parallel embedding).  Its gradient is added into
    each rank's rows."""
    if not hasattr(table, "device_mesh"):
        return table[tokens]
    return _Embedding.apply(table, tokens)


class _Embedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh = table.device_mesh
        tp = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in getattr(tokens, "placements", (Replicate(),) * mesh.ndim))
        wp = tuple(q if isinstance(q, Shard) and q.dim == 0 and not isinstance(p, Shard) else
                   Replicate() for p, q in zip(tp, table.placements))
        tl = tokens.redistribute(mesh, tp).to_local() if hasattr(tokens, "device_mesh") \
            else tokens
        wd = table.redistribute(mesh, wp)
        wl = wd.to_local()
        idx = tl.long() - shard_offset(wd, 0)
        inside = (idx >= 0) & (idx < wl.shape[0])
        idx = idx.clamp(0, wl.shape[0] - 1)
        out = wl[idx] * inside[..., None].to(wl.dtype)
        ctx.save_for_backward(idx, inside)
        ctx.meta = (mesh, tp, wp, wl.shape, table.shape)
        po = tuple(Partial() if isinstance(q, Shard) else p for p, q in zip(tp, wp))
        return _from_local(out, mesh, po, (*tokens.shape, table.shape[1]))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Shard
        idx, inside = ctx.saved_tensors
        mesh, tp, wp, local_shape, shape = ctx.meta
        gl = g.redistribute(mesh, tp).to_local() * inside[..., None].to(g.dtype)
        dw = gl.new_zeros(local_shape).index_add_(0, idx.reshape(-1),
                                                  gl.reshape(-1, local_shape[1]))
        pdw = tuple(Partial() if isinstance(p, Shard) else q for p, q in zip(tp, wp))
        return _from_local(dw, mesh, pdw, shape), None


def column_sharded_product(x, w):
    """``x @ w`` of ``DTensor``s with ``w``'s columns split over every mesh
    axis that splits neither operand (and divides them): the product is
    computed once across the mesh, each device its columns."""
    from torch.distributed.tensor import Replicate, Shard
    pl = []
    for size, px, pw in zip(w.device_mesh.shape, x.placements, w.placements):
        free = isinstance(px, Replicate) and isinstance(pw, Replicate)
        pl.append(Shard(1) if free and w.shape[1] % size == 0 else pw)
    if tuple(pl) != tuple(w.placements):
        w = w.redistribute(w.device_mesh, tuple(pl))
    return x @ w


def whole_heads(y, heads: int):
    """A ``DTensor`` whose last dim packs ``heads`` heads, gathered along
    every mesh axis that splits that dim other than at head boundaries (so
    that it unflattens into (heads, head_dim)); its gradient is split back."""
    from torch.distributed.tensor import Replicate, Shard
    last = y.ndim - 1
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == last and heads % size else p
               for size, p in zip(y.device_mesh.shape, y.placements))
    return y if pl == tuple(y.placements) else y.redistribute(y.device_mesh, pl)


def flat_heads(x):
    """``x`` (..., heads, head_dim) with its last two dims packed into one.
    On a ``DTensor`` the gradient is gathered along every mesh axis that
    splits the packed dim other than at head boundaries (a product with a
    weight whose rows split it, where the ``model`` axis does not divide
    the heads), so that it unflattens: the transpose of
    :func:`whole_heads`."""
    if not hasattr(x, "device_mesh"):
        return x.reshape(*x.shape[:-2], -1)
    return _FlatHeads.apply(x)


class _FlatHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return whole_heads(g, ctx.shape[-2]).reshape(ctx.shape)


def whole_product(x, w):
    """``x @ w`` of ``DTensor``s with ``w``'s columns split only where ``w``
    is stored split: ``x`` keeps only its batch shards, ``w`` is gathered
    along its rows, and each device multiplies its local rows by its local
    columns (all of them, along an axis that stores ``w`` whole).  In the
    backward the weight's gradient is computed the same way, and the
    input's gradient with the columns split across those axes (a partial
    sum, reduced with the other sublayers' where the residual needs it)."""
    return _WholeProduct.apply(x, w)


class _WholeProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        from torch.distributed.tensor import Replicate, Shard
        mesh = x.device_mesh
        px = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in x.placements)
        pw = tuple(q if isinstance(q, Shard) and q.dim == 1 and not isinstance(p, Shard) else
                   Replicate() for p, q in zip(px, w.placements))
        po = tuple(Shard(x.ndim - 1) if isinstance(q, Shard) else p for p, q in zip(px, pw))
        xl = x.redistribute(mesh, px).to_local()
        wl = w.redistribute(mesh, pw).to_local()
        ctx.save_for_backward(xl, wl)
        ctx.meta = (mesh, px, pw, po, x.shape, w.shape)
        return _from_local(xl @ wl, mesh, po, (*x.shape[:-1], w.shape[1]))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate, Shard
        xl, wl = ctx.saved_tensors
        mesh, px, pw, po, xshape, wshape = ctx.meta
        gl = g.redistribute(mesh, po).to_local()
        rows = xl.reshape(-1, xl.shape[-1])
        dw = rows.transpose(0, 1) @ gl.reshape(-1, gl.shape[-1])
        pdw = tuple(Partial() if isinstance(p, Shard) else q for p, q in zip(px, pw))
        # the input's gradient: columns split across the axes storing w whole
        # (each rank its own block, numbered by its coordinates on them)
        block, n = 0, wl.shape[1]
        for dim, (size, p, q) in enumerate(zip(mesh.shape, px, pw)):
            if not isinstance(p, Shard) and not isinstance(q, Shard):
                n //= size
                block = block * size + mesh.get_local_rank(dim)
        cols = slice(block * n, (block + 1) * n)
        dx = gl[..., cols] @ wl[:, cols].transpose(0, 1)
        pdx = tuple(p if isinstance(p, Shard) or isinstance(q, Shard) else Partial()
                    for p, q in zip(px, pw))
        pdx = tuple(Partial() if isinstance(q, Shard) else p for p, q in zip(pdx, pw))
        return (_from_local(dx, mesh, pdx, xshape),
                _from_local(dw.to(wl.dtype), mesh, pdw, wshape))


def on_local_shards(fn, *xs, lead: int = 2):
    """``fn(*xs)`` where every operand shares its ``lead`` leading dims (a
    batched product): on ``DTensor``s each device applies ``fn`` to its
    local shards, split along those dims as the last operand is (and whole
    along the others); plain tensors go straight to ``fn``."""
    ref = xs[-1]
    if not hasattr(ref, "device_mesh"):
        return fn(*xs)
    from torch.distributed.tensor import Replicate, Shard
    mesh = ref.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim < lead else Replicate()
               for p in ref.placements)
    out = fn(*(x.redistribute(mesh, pl).to_local() for x in xs))
    shape = list(out.shape)
    for size, p in zip(mesh.shape, pl):
        if isinstance(p, Shard):
            shape[p.dim] *= size
    return _from_local(out, mesh, pl, shape)


def _from_local(t, mesh, placements, shape):
    """A ``DTensor`` of global ``shape`` from a local tensor, made
    contiguous (its global strides are then the contiguous ones)."""
    from torch.distributed.tensor import DTensor
    stride = [1]
    for n in reversed(tuple(shape)[1:]):
        stride.insert(0, stride[0] * n)
    return DTensor.from_local(t.contiguous(), mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with float32 statistics, cast back to ``x``'s dtype."""
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with float32 statistics (biased variance), cast back to
    ``x``'s dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float = 1e4):
    """positions (...,) -> (cos, sin) each (..., head_dim/2), float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (S, D/2) aligned to x's S axis.  The
    half-split (not interleaved) rotation, in float32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    target = (1,) * (x1.ndim - 3) + (cos.shape[0], 1, cos.shape[-1])
    cos, sin = cos.reshape(target), sin.reshape(target)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _sharded_nll(logits, labels):
    """The token losses of ``DTensor`` logits whose vocabulary may be split
    across the mesh (vocabulary-parallel): the log-sum-exp from each
    shard's max and sum (reduced across the shards), the label's logit
    picked by the rank whose vocabulary rows hold it (a partial sum over
    the shards; the labels shifted by the rank's first row)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, last = logits.device_mesh, logits.ndim - 1
    m = logits.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    local = logits.to_local()
    keep = tuple(p if isinstance(p, Shard) and p.dim < last else Replicate()
                 for p in logits.placements)
    lab = labels.redistribute(mesh, keep).to_local() if hasattr(labels, "device_mesh") \
        else labels
    n = local.shape[-1]                    # this rank's vocabulary rows off .. off + n - 1
    lab = lab.long() - shard_offset(logits, last)
    inside = (lab >= 0) & (lab < n)
    picked = local.gather(-1, lab.clamp(0, n - 1)[..., None])[..., 0] * inside
    pl = tuple(Partial() if isinstance(p, Shard) and p.dim == last else k
               for p, k in zip(logits.placements, keep))
    picked = _from_local(picked, mesh, pl, lse.shape)
    return lse.redistribute(mesh, keep) - picked.redistribute(mesh, keep)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross-entropy in float32: logits (..., V), integer labels
    (...); with ``mask`` the mean over the masked-in tokens (at least one
    in the denominator)."""
    logits = logits.float()
    if hasattr(logits, "device_mesh"):
        nll = _sharded_nll(logits, labels)
    else:
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
