"""Kernels of the port and their plain PyTorch versions.

window_attention  banded attention (CUDA kernel, plain version)
fused_denoise     the few-step DDIM loop and the full-schedule DDPM loop
                  (CUDA kernel sequences with in-kernel Philox noise, plain
                  versions)
fused_frontend    the HuBERT conv feature extractor, and WavLM's in its
                  LayerNorm mode (CUDA kernel sequence, plain version), and
                  fast_encode
relpos_attention  WavLM's gated relative-position attention (CUDA kernel,
                  plain version)
pos_conv          the encoders' positional conv embedding and its residual
                  add at float32 (CUDA kernel, plain version)
mel               STFT, iSTFT, HTK mel filterbank, MelFrontend (torch.fft)
resample          polyphase windowed-sinc resampling (one strided conv)
vocoder           Griffin-Lim
"""

import importlib

# The JAX package's ops names, resolved at first use: the kernel modules
# import the layers, which import ops.window_attention.
_NAMES = {
    "FusedEdgeInference": "fused_denoise",
    "fused_ddpm_sample": "fused_denoise",
    "fused_generate_mel": "fused_denoise",
    "conv_frontend": "fused_frontend",
    "fast_encode": "fused_frontend",
    "MelFrontend": "mel",
    "hann_window": "mel",
    "inverse_mel_scale": "mel",
    "istft": "mel",
    "mel_filterbank": "mel",
    "stft_complex": "mel",
    "stft_power": "mel",
    "resample": "resample",
    "griffin_lim": "vocoder",
    "banded_attention": "window_attention",
}


def __getattr__(name):
    if name == "fused_conv_frontend":  # the JAX package's name of conv_frontend
        name = "conv_frontend"
    if name in _NAMES:
        return getattr(importlib.import_module(f".{_NAMES[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted([*_NAMES, "fused_conv_frontend"])
