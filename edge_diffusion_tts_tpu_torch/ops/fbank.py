"""w2v-BERT 2.0's filterbank frontend on the device, float32: the features
transformers' ``SeamlessM4TFeatureExtractor`` gives, as tensor ops.

Per utterance (``fbank``)::

  wav x 2^15 -> 25 ms frames every 10 ms, no edge padding
    (1 + (N - 400) // 160 frames, by ``unfold``) ->
  per frame: DC removed, pre-emphasis 0.97 (x[0] (1 - 0.97) first),
    the Povey window ->
  512-point power spectrum (``torch.fft.rfft``) ->
  80 Kaldi-scale mel triangles from 20 to 8000 Hz (a matrix product, TF32
    off) -> log(max(x, 2^-23)) ->
  per mel bin, over the utterance's frames: subtract the mean, divide by
    sqrt(unbiased variance + 1e-7) ->
  an odd last frame dropped, pairs of frames stacked to [S, 160] (50 Hz)

``wav_len`` (true sample counts) makes a zero-padded batch exact: each row
is normalized over its own frames, as the feature extractor normalizes each
utterance, and its stacked frames past its own are zeros.  Without it the
whole padded row is one utterance.  The JAX package has no such frontend.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
FRAME, HOP, NFFT = 400, 160, 512  # 25 ms frames every 10 ms, a 512-point FFT
PREEMPHASIS = 0.97
MEL_FLOOR = 1.192092955078125e-07  # float32's epsilon, 2^-23
NORM_EPS = 1e-7
WAV_SCALE = 2.0 ** 15  # Kaldi's 16-bit sample scale


def frame_count(samples):
    """Frames of ``samples`` (an int or an integer tensor): 1 + (N - 400) //
    160, at least 0."""
    if isinstance(samples, torch.Tensor):
        return torch.clamp_min(1 + torch.div(samples - FRAME, HOP, rounding_mode="floor"), 0)
    return max(0, 1 + (int(samples) - FRAME) // HOP)


def stacked_count(samples, stride: int = 2):
    """Stacked frames (the encoder's positions) of ``samples``: frames //
    ``stride`` (49 at 1 s)."""
    n = frame_count(samples)
    if isinstance(n, torch.Tensor):
        return torch.div(n, stride, rounding_mode="floor")
    return n // stride


def kaldi_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=None)
def _tables(num_mel_bins: int, low_hz: float, high_hz: float):
    """(Povey window [400], mel matrix [257, num_mel_bins]) in float64 numpy:
    triangles in the Kaldi mel scale over the bins' mel positions."""
    window = np.hanning(FRAME) ** 0.85
    centers = np.linspace(kaldi_mel(low_hz), kaldi_mel(high_hz), num_mel_bins + 2)
    bins = kaldi_mel(SAMPLE_RATE / NFFT * np.arange(NFFT // 2 + 1))
    slopes = centers[None, :] - bins[:, None]
    width = np.diff(centers)
    down, up = -slopes[:, :-2] / width[:-1], slopes[:, 2:] / width[1:]
    return window, np.maximum(0.0, np.minimum(down, up))


def tables(device, num_mel_bins: int = 80, low_hz: float = 20.0, high_hz: float = 8000.0):
    """The Povey window [400] and the mel matrix [257, bins], float32 on ``device``."""
    window, mel = _tables(num_mel_bins, float(low_hz), float(high_hz))
    return (torch.as_tensor(window, dtype=torch.float32, device=device),
            torch.as_tensor(mel, dtype=torch.float32, device=device))


def log_mel(wav: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """wav [B, N] (float, [-1, 1]) -> log mel energies [B, frames, bins], float32."""
    if wav.shape[1] < FRAME:
        raise ValueError(f"{wav.shape[1]} samples: the filterbank needs at least {FRAME}")
    if wav.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    window, mel = tables(wav.device, num_mel_bins)
    frames = (wav.float() * WAV_SCALE).unfold(1, FRAME, HOP)  # [B, F, 400]
    frames = frames - frames.mean(-1, keepdim=True)
    frames = torch.cat([frames[..., :1] * (1.0 - PREEMPHASIS),
                        frames[..., 1:] - PREEMPHASIS * frames[..., :-1]], -1)
    spec = torch.fft.rfft(frames * window, n=NFFT)
    power = spec.real.square() + spec.imag.square()
    return torch.log(torch.clamp_min(power @ mel, MEL_FLOOR))


def fbank(wav: torch.Tensor, wav_len=None, num_mel_bins: int = 80, stride: int = 2
          ) -> torch.Tensor:
    """wav [B, N] -> the encoder's input features [B, S, stride x bins]
    (float32; S = frames // stride), normalized per utterance and per mel
    bin; ``wav_len`` as the module says."""
    x = log_mel(wav, num_mel_bins)
    B, F, M = x.shape
    if wav_len is None:
        n = torch.full((B,), F, device=x.device)
    else:
        n = frame_count(torch.as_tensor(wav_len, device=x.device).reshape(-1)).clamp(max=F)
    keep = (torch.arange(F, device=x.device)[None, :] < n[:, None])[..., None]  # [B, F, 1]
    cnt = n.clamp(min=1).to(x.dtype)[:, None, None]
    mean = torch.where(keep, x, 0.0).sum(1, keepdim=True) / cnt
    dev = torch.where(keep, x - mean, 0.0)
    var = dev.square().sum(1, keepdim=True) / (cnt - 1).clamp(min=1)
    x = torch.where(keep, dev / torch.sqrt(var + NORM_EPS), 0.0)
    S = F // stride
    x = x[:, :S * stride].reshape(B, S, stride * M)
    if wav_len is not None:  # a stacked frame that reaches past the row's own frames
        x = torch.where((torch.arange(S, device=x.device)[None, :]
                         < torch.div(n, stride, rounding_mode="floor")[:, None])[..., None],
                        x, 0.0)
    return x

