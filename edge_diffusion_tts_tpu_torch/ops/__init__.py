"""Kernels of the port and their plain PyTorch versions.

window_attention  banded attention (CUDA kernel, plain version)
fused_denoise     the few-step DDIM loop and the full-schedule DDPM loop
                  (CUDA kernel sequences with in-kernel Philox noise, plain
                  versions)
fused_frontend    the HuBERT conv feature extractor (CUDA kernel sequence,
                  plain version) and fast_encode
"""
