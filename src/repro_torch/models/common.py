"""Shared model building blocks: parameter draws, RMS norm, rotary.

Forward only (serving); ``layer_norm`` and the loss wait for training.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DTYPES", "dtype_of", "Init", "rms_norm", "rotary_embedding", "apply_rotary"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


@dataclasses.dataclass(frozen=True)
class Init:
    """Where parameters are made: the device, the seeded generator, and a
    leading shape (``(n,)`` for a stack of ``n`` layers).  On the ``meta``
    device nothing is drawn or allocated."""
    device: torch.device
    generator: torch.Generator | None = None
    lead: tuple = ()

    def stacked(self, n: int) -> "Init":
        return dataclasses.replace(self, lead=(n,))

    def normal(self, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
        """``N(0, 1) * scale``, drawn in float32 and cast to ``dtype``."""
        shape = (*self.lead, *shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return x.mul_(scale).to(dtype)

    def full(self, shape, value: float, dtype: torch.dtype) -> torch.Tensor:
        return torch.full((*self.lead, *shape), value, dtype=dtype, device=self.device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with float32 statistics, cast back to ``x``'s dtype."""
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * weight.float()).to(x.dtype)


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
