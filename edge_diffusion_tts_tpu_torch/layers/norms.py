"""Normalization layers: RMSNorm and adaptive (timestep-conditioned) RMSNorm.

Counterpart of ``edge_diffusion_tts_tpu/layers/norms.py``: eps 1e-6 with
float32 statistics; AdaLN computes ``rms(x) * w * (1 + scale) + shift`` with
its [cond -> 2*dim] projection split scale first, then shift.
"""

from __future__ import annotations

import torch
from torch import nn


def rms_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps)`` over the last axis, statistics in f32."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return normed.to(x.dtype)


class RMSNorm(nn.Module):
    """Root-mean-square norm; statistics in float32, output cast back."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_normalize(x, self.eps) * self.weight.to(x.dtype)


class AdaLayerNorm(nn.Module):
    """Adaptive RMSNorm: ``norm(x) * (1 + scale) + shift``.

    scale/shift come from a zero-initialized projection of the conditioning
    vector, so at init the layer is an identity RMSNorm.
    """

    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.proj = nn.Linear(cond_dim, dim * 2)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.norm(x)
        scale, shift = self.proj(cond).chunk(2, dim=-1)
        return h * (1.0 + scale[:, None, :]) + shift[:, None, :]
