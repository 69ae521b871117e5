"""Optimizers, clipping, schedules and the int8 compressed all-reduce on
trees of tensors (the reference's ``repro.optim``)."""

from .adamw import OptState, Optimizer, adamw, sgd, tree_map
from .clip import clip_by_global_norm, global_norm
from .compress import compressed_all_reduce, int8_compress, int8_decompress
from .schedule import constant_schedule, cosine_schedule, warmup_cosine

__all__ = ["OptState", "Optimizer", "adamw", "sgd", "tree_map", "clip_by_global_norm",
           "global_norm", "constant_schedule", "cosine_schedule", "warmup_cosine",
           "compressed_all_reduce", "int8_compress", "int8_decompress"]
