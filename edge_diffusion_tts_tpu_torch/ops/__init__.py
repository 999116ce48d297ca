"""Kernels of the port and their plain PyTorch versions.

window_attention  banded attention (CUDA kernel, plain version)
fused_denoise     the few-step DDIM loop (CUDA kernel sequence, plain version)
"""
