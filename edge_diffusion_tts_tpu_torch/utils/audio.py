"""Mel normalization (counterpart of ``edge_diffusion_tts_tpu/utils/audio.py``).

Training and the long-form pipeline work in normalized-mel space; statistics
are per utterance over the time axis, with the unbiased (ddof=1) standard
deviation clipped at ``eps``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def normalize_mel(mel: torch.Tensor, eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, T, n_mels] -> (normalized, mean, std); stats over the time axis."""
    mean = mel.mean(1, keepdim=True)
    std = mel.std(1, keepdim=True, correction=1).clamp(min=eps)
    return (mel - mean) / std, mean, std


def denormalize_mel(mel_n: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return mel_n * std + mean
