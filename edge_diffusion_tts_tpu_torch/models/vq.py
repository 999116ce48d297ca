"""Vector quantizer, inference half (counterpart of
``edge_diffusion_tts_tpu/models/vq.py``): L2-nearest codebook lookup, the
straight-through output, ``encode`` and ``decode``.

The codebook is a buffer.  The EMA codebook update and the dead-code reset
belong to training and are not ported yet (ROADMAP, training slice): a
``train=True`` call raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .fsq import count_code_usage, usage_metrics


class VectorQuantizer(nn.Module):
    """Classic VQ-VAE quantizer at inference: nearest code + straight-through."""

    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self.dim = dim
        self.codebook_size = codebook_size
        self.register_buffer("codebook", torch.randn(codebook_size, dim))

    def _nearest(self, flat: torch.Tensor) -> torch.Tensor:
        cb = self.codebook
        dist = (flat.square().sum(1, keepdim=True) - 2.0 * flat @ cb.T
                + cb.square().sum(1)[None, :])
        return dist.argmin(1)

    def forward(
        self, z: torch.Tensor, train: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        if train:
            raise NotImplementedError(
                "the VQ EMA codebook update is training and not ported yet")
        B, T, D = z.shape
        idx = self._nearest(z.reshape(-1, D).float().detach())
        z_q = self.codebook[idx].reshape(B, T, D)
        z_q = z + (z_q - z).detach()
        perplexity, used = usage_metrics(count_code_usage(idx, self.codebook_size))
        loss = torch.zeros((), dtype=torch.float32, device=z.device)
        return z_q, idx.reshape(B, T), loss, perplexity, used

    def encode(self, z: torch.Tensor) -> torch.Tensor:
        B, T, D = z.shape
        return self._nearest(z.reshape(-1, D)).reshape(B, T)

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        return self.codebook[idx]
