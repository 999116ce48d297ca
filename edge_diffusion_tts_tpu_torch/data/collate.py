"""Batch collation: resample -> crop/pad -> clamp -> stack (counterpart of
``edge_diffusion_tts_tpu/data/collate.py``, the same numpy code).

The host does the cheap waveform work (polyphase resample, random crop,
pad, clamp, stack); the mel spectrogram is computed on the device inside
the training step (``ops.mel.MelFrontend``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from ..config import CFG
from ..ops.resample import _sinc_kernel  # the port's own copy of the kernel bank


def resample_np(wav: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Host-side polyphase resample with ``ops.resample``'s windowed-sinc
    kernel bank (torchaudio ``sinc_interp_hann``)."""
    if orig_freq == new_freq:
        return wav
    g = math.gcd(orig_freq, new_freq)
    orig_g, new_g = orig_freq // g, new_freq // g
    kernel, width = _sinc_kernel(orig_g, new_g)
    T = wav.shape[-1]
    padded = np.pad(wav, (width, width + orig_g))
    n_blocks = (padded.shape[-1] - kernel.shape[1]) // orig_g + 1
    # out[p, j] = sum_k padded[j*orig_g + k] * kernel[p, k]
    idx = np.arange(n_blocks)[:, None] * orig_g + np.arange(kernel.shape[1])[None, :]
    frames = padded[idx]  # [blocks, K]
    out = frames @ kernel.T  # [blocks, new_g]
    out = out.reshape(-1)
    target_len = int(math.ceil(new_g * T / orig_g))
    return out[:target_len].astype(np.float32)


def crop_or_pad(
    wav: np.ndarray, target_len: int, rng: np.random.Generator
) -> np.ndarray:
    """Random-crop long waveforms, zero-pad short ones."""
    n = wav.shape[-1]
    if n > target_len:
        start = int(rng.integers(0, n - target_len + 1))
        return wav[start : start + target_len]
    if n < target_len:
        return np.pad(wav, (0, target_len - n))
    return wav


class Collate:
    """List of (wav, sr) -> {"wav": [B, segment_len] float32 in [-1, 1]}.

    The mel spectrogram is not produced here: the training step computes it
    on the device.  ``deterministic=True`` crops from offset 0 (validation).
    """

    def __init__(self, cfg: CFG, deterministic: bool = False, seed: int = 0):
        self.cfg = cfg
        self.deterministic = deterministic
        self.rng = np.random.default_rng(seed)

    def __call__(self, batch: Sequence[Tuple[np.ndarray, int]]) -> dict:
        cfg = self.cfg
        out = np.zeros((len(batch), cfg.segment_len), dtype=np.float32)
        for i, (wav, sr) in enumerate(batch):
            if sr != cfg.sample_rate:
                wav = resample_np(wav, sr, cfg.sample_rate)
            if self.deterministic:
                wav = wav[: cfg.segment_len]
                wav = np.pad(wav, (0, cfg.segment_len - wav.shape[0]))
            else:
                wav = crop_or_pad(wav, cfg.segment_len, self.rng)
            out[i] = np.clip(wav, -1.0, 1.0)
        return {"wav": out}
