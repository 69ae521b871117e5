"""Mamba-2 SSD chunked scan: the CUDA kernel (``csrc/ssd_scan.cu``) and its
plain PyTorch versions."""
