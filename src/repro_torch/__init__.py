"""RESPECT scheduler in PyTorch, with the pointer-decode kernels in CUDA.

A port of the JAX package ``repro`` (which stays the reference): the
serving miss path behind ``RespectScheduler.from_release().schedule_many``
— embed, LSTM pointer-network decode, contiguous-segmentation DP, repair —
runs on an NVIDIA GPU, with the whole-decode and single-step pointer
kernels hand-written for Hopper (``repro_torch.kernels.ptr``).

Nothing here imports ``jax`` or ``repro``.

The reference computes in float32 throughout, so TF32 is switched off for
matrix products and cuDNN when this package is imported: a float32
``torch.matmul`` on the card then runs in full float32, as on the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
