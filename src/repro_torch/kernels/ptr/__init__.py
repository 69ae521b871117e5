"""Pointer-decode kernels: the single-step glimpse + pointer kernel
(``csrc/ptr_step.cu``) and the persistent whole-decode kernel
(``csrc/ptr_decode.cu``), each with its plain PyTorch version."""

from ..build import LAUNCHES, build_kernels
