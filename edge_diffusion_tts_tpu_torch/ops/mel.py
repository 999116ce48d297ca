"""Mel-spectrogram frontend and STFT in PyTorch (counterpart of
``edge_diffusion_tts_tpu/ops/mel.py``).

torchaudio-parity numerics (n_fft 1024, hop 160, periodic Hann window,
reflect padding at the centre, power 2, HTK mel scale, norm=None): framing
by ``unfold``, the DFT by ``torch.fft.rfft``/``irfft`` (cuFFT on the card),
and the overlap-add as the JAX package's K shifted adds.  ``istft`` keeps
the JAX package's edge handling (divide by ``clip(win_sq, 1e-11)``, trim
``n_fft // 2`` at each end) where ``torch.istft`` would raise on a window
sum that fails NOLA.  The filterbank is built in float64 numpy, as the JAX
package builds it, and kept in float32.  None of this is a kernel of its
own: JAX computes it outside any Pallas kernel too.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(periodic=True)``), float32."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win_length))


def _padded_window(n_fft: int, win_length: int, device=None) -> torch.Tensor:
    """The Hann window centred inside ``n_fft`` (torch's convention)."""
    window = hann_window(win_length, device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of ``numpy.pad(x, pad, mode="reflect")`` into x of length n
    (the reflection repeats for pads longer than the signal)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def frame_signal(wav: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """[B, T] -> frames [B, num_frames, n_fft], reflect-padded at the centre."""
    if center:
        wav = wav[:, _reflect_index(wav.shape[1], n_fft // 2, wav.device)]
    return wav.unfold(1, n_fft, hop_length)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """frames [B, T, W] -> signal [B, (T-1)*hop + W]: each frame split into
    K = ceil(W / hop) hop-length chunks, chunk k of frame t added at output
    chunk t + k, as K shifted adds (the JAX package's order)."""
    B, T, W = frames.shape
    K = -(-W // hop_length)
    fr = F.pad(frames, (0, K * hop_length - W)).reshape(B, T, K, hop_length)
    out = frames.new_zeros((B, T + K - 1, hop_length))
    for k in range(K):
        out[:, k:k + T] += fr[:, :, k]
    return out.reshape(B, -1)[:, :(T - 1) * hop_length + W]


def _windowed_rfft(wav, n_fft, hop_length, win_length, center):
    frames = frame_signal(wav, n_fft, hop_length, center)
    frames = frames * _padded_window(n_fft, win_length, wav.device)
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def stft_power(wav: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
               win_length: int = 1024, power: float = 2.0, center: bool = True) -> torch.Tensor:
    """Power spectrogram [B, num_frames, n_fft//2 + 1]."""
    spec = _windowed_rfft(wav, n_fft, hop_length, win_length, center)
    mag_sq = spec.real ** 2 + spec.imag ** 2
    if power == 2.0:
        return mag_sq
    return torch.sqrt(mag_sq) ** power


def stft_complex(wav: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
                 win_length: int = 1024, center: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(real, imag) STFT parts, each [B, num_frames, n_freqs]."""
    spec = _windowed_rfft(wav, n_fft, hop_length, win_length, center)
    return spec.real, spec.imag


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
          win_length: int = 1024, length: Optional[int] = None) -> torch.Tensor:
    """One-sided spectrum [B, num_frames, n_freqs] -> waveform: inverse DFT,
    windowed overlap-add, divided by the overlap-added squared window
    (clipped at 1e-11), ``n_fft // 2`` trimmed at each end."""
    T = re.shape[1]
    frames = torch.fft.irfft(torch.complex(re, im), n=n_fft, dim=-1)
    window = _padded_window(n_fft, win_length, re.device)
    sig = overlap_add(frames * window, hop_length)
    win_sq = overlap_add((window ** 2).expand(1, T, n_fft), hop_length)[0]
    sig = sig / win_sq.clamp(min=1e-11)
    pad = n_fft // 2
    sig = sig[:, pad:-pad]
    return sig if length is None else sig[:, :length]


def _hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int,
                   norm: Optional[str] = None) -> np.ndarray:
    """Triangular HTK-scale mel filterbank [n_freqs, n_mels], float32
    (``torchaudio.functional.melscale_fbanks(mel_scale="htk")``), built in
    float64."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(np.asarray(f_min)), _hz_to_mel_htk(np.asarray(f_max)),
                        n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb *= (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


class MelFrontend(nn.Module):
    """wav [B, T] -> log-mel [B, frames, n_mels]: power-2 spectrogram -> HTK
    mel (norm=None) -> log(clamp(mel, 1e-5)).

    Holds the filterbank ``fbank`` [n_freqs, n_mels] and its pseudo-inverse
    ``fbank_pinv`` [n_mels, n_freqs] (for ``inverse_mel_scale``), computed
    once here in float64 and kept in float32, as buffers that follow
    ``.to(device)``.
    """

    def __init__(self, sample_rate: int = 16000, n_fft: int = 1024, hop_length: int = 160,
                 win_length: int = 1024, n_mels: int = 80, f_min: float = 0.0,
                 f_max: float = 8000.0, log_clamp: float = 1e-5):
        super().__init__()
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mels = n_mels
        self.log_clamp = log_clamp
        fb = mel_filterbank(n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate)
        self.register_buffer("fbank", torch.from_numpy(fb), persistent=False)
        pinv = np.linalg.pinv(fb.astype(np.float64)).astype(np.float32)
        self.register_buffer("fbank_pinv", torch.from_numpy(pinv), persistent=False)

    def mel_power(self, wav: torch.Tensor) -> torch.Tensor:
        """Linear-power mel [B, frames, n_mels]."""
        return stft_power(wav, self.n_fft, self.hop_length, self.win_length) @ self.fbank

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return torch.log(self.mel_power(wav).clamp(min=self.log_clamp))


def inverse_mel_scale(mel_power: torch.Tensor, fbank_pinv: torch.Tensor,
                      eps: float = 0.0) -> torch.Tensor:
    """Mel power [B, T, n_mels] -> linear power spectrogram [B, T, n_freqs]
    by the filterbank's pseudo-inverse (``MelFrontend.fbank_pinv``; the JAX
    package takes it of ``fbank`` here), clamped at ``eps``."""
    return (mel_power @ fbank_pinv).clamp(min=eps)
