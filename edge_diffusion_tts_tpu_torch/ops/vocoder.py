"""Griffin-Lim phase reconstruction in PyTorch (counterpart of
``edge_diffusion_tts_tpu/ops/vocoder.py``).

Momentum-accelerated Griffin-Lim in torchaudio's formulation, a fixed
``n_iter`` loop of iSTFT -> STFT -> phase projection (``ops/mel.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .mel import istft, stft_complex


def griffin_lim(spec_power: torch.Tensor, generator: Optional[torch.Generator] = None,
                n_fft: int = 1024, hop_length: int = 160, win_length: int = 1024,
                n_iter: int = 32, momentum: float = 0.99, length: Optional[int] = None,
                power: float = 2.0, rand_init: bool = True,
                angle: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Power (or magnitude) spectrogram [B, frames, n_freqs] -> waveform [B, T].

    The start phase is ``angle`` [B, frames, n_freqs] where given, else
    uniform in [0, 2 pi) from ``generator`` (one on the spectrogram's device,
    seeded 0, when None) with ``rand_init``, else zero.  The previous rebuilt
    spectrum is subtracted with momentum / (1 + momentum) before each phase
    normalization.
    """
    mag = spec_power.clamp(min=0.0) ** (1.0 / power)
    if angle is None and rand_init:
        if generator is None:
            generator = torch.Generator(device=mag.device).manual_seed(0)
        angle = torch.rand(mag.shape, generator=generator, device=mag.device) * (2 * math.pi)
    if angle is not None:
        re, im = torch.cos(angle) * mag, torch.sin(angle) * mag
    else:
        re, im = mag.clone(), torch.zeros_like(mag)
    tre, tim = torch.zeros_like(mag), torch.zeros_like(mag)
    mom = momentum / (1.0 + momentum)
    for _ in range(n_iter):
        cre, cim = re - mom * tre, im - mom * tim
        norm = torch.sqrt(cre ** 2 + cim ** 2) + 1e-16
        wav = istft(mag * cre / norm, mag * cim / norm, n_fft, hop_length, win_length)
        tre, tim = re, im
        re, im = stft_complex(wav, n_fft, hop_length, win_length)
    norm = torch.sqrt(re ** 2 + im ** 2) + 1e-16
    wav = istft(mag * re / norm, mag * im / norm, n_fft, hop_length, win_length)
    return wav if length is None else wav[:, :length]
