"""Optimizers, clipping and schedules on trees of tensors (the reference's
``repro.optim``, without the int8 gradient compression of data-parallel
training)."""

from .adamw import OptState, Optimizer, adamw, sgd, tree_map
from .clip import clip_by_global_norm, global_norm
from .schedule import constant_schedule, cosine_schedule, warmup_cosine

__all__ = ["OptState", "Optimizer", "adamw", "sgd", "tree_map", "clip_by_global_norm",
           "global_norm", "constant_schedule", "cosine_schedule", "warmup_cosine"]
