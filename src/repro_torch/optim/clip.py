"""Global-norm gradient clipping on trees of tensors (the reference's
``repro.optim.clip``)."""

from __future__ import annotations

import torch

from .adamw import _leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32; leaves summed
    in sorted key order, as ``jax.tree.leaves`` orders a dict."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in _leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by ``min(1, max_norm / (norm + 1e-12))``, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda l: (l.float() * scale).to(l.dtype), tree), norm
