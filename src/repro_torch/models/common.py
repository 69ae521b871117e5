"""Shared model building blocks: parameter draws, annotated parameters
(a value beside its logical sharding axes), input records, RMS and layer
norms, rotary, and the token-mean cross-entropy of the losses.

The reference's RMS norm has a custom VJP only to keep the residual
gradient in the activation dtype under XLA; autograd through the cast back
to ``x``'s dtype gives that here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import prng

__all__ = ["DTYPES", "dtype_of", "Init", "KeyStream", "Annotated", "param", "split_annotated",
           "lift_layers", "TensorSpec", "rms_norm", "layer_norm", "rotary_embedding",
           "apply_rotary", "softmax_cross_entropy"]

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


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross-entropy in float32: logits (..., V), integer labels
    (...); with ``mask`` the mean over the masked-in tokens (at least one
    in the denominator)."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
