"""Polyphase windowed-sinc resampling in PyTorch (counterpart of
``edge_diffusion_tts_tpu/ops/resample.py``).

``torchaudio.functional.resample`` with ``sinc_interp_hann``: the kernel bank
[new_g, K] is built once per ratio in float64 numpy (``_sinc_kernel``, the
JAX package's own copy, which ``data/`` reuses), and resampling is one
strided ``F.conv1d`` with ``orig_g`` as its stride.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=32)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99) -> Tuple[np.ndarray, int]:
    """Kernel bank [new_g, width*2 + orig_g] (float32) and the left pad width."""
    g = math.gcd(orig_freq, new_freq)
    orig_g, new_g = orig_freq // g, new_freq // g
    base_freq = min(orig_g, new_g) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig_g / base_freq))
    idx = np.arange(-width, width + orig_g, dtype=np.float64)[None, :] / orig_g
    t = np.arange(0, -new_g, -1, dtype=np.float64)[:, None] / new_g + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t *= np.pi
    kernel = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel *= window * base_freq / orig_g
    return kernel.astype(np.float32), width


def resample(wav: torch.Tensor, orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
             rolloff: float = 0.99) -> torch.Tensor:
    """Resample [B, T] (or [T]) waveforms from ``orig_freq`` to ``new_freq``;
    the output has ``ceil(new_g * T / orig_g)`` samples."""
    if orig_freq == new_freq:
        return wav
    squeeze = wav.dim() == 1
    if squeeze:
        wav = wav[None, :]
    B, T = wav.shape
    g = math.gcd(orig_freq, new_freq)
    orig_g, new_g = orig_freq // g, new_freq // g
    kernel, width = _sinc_kernel(orig_g, new_g, lowpass_filter_width, rolloff)
    padded = F.pad(wav.float(), (width, width + orig_g))
    weight = torch.from_numpy(kernel).to(wav.device)[:, None, :]  # [new_g, 1, K]
    out = F.conv1d(padded[:, None, :], weight, stride=orig_g)  # [B, new_g, blocks]
    out = out.transpose(1, 2).reshape(B, -1)[:, :int(math.ceil(new_g * T / orig_g))]
    return out[0] if squeeze else out
