"""Causal GQA flash-attention forward: the CUDA kernel
(``csrc/flash_fwd.cu``) and its plain PyTorch version."""
