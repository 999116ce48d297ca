"""Normalization layers: RMSNorm and adaptive (timestep-conditioned) RMSNorm.

Counterpart of ``edge_diffusion_tts_tpu/layers/norms.py``: eps 1e-6 with
float32 statistics; AdaLN computes ``rms(x) * w * (1 + scale) + shift`` with
its [cond -> 2*dim] projection split scale first, then shift.  RMSNorm works
at its input's dtype (its output is rounded to it, as in JAX); AdaLN's
projection computes at ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .dtypes import Linear, call_at


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

    def __init__(self, dim: int, cond_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.proj = Linear(cond_dim, dim * 2, compute_dtype=dtype)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def modulation(self, cond: torch.Tensor, dtype: Optional[torch.dtype] = None):
        """``(scale, shift)`` of ``cond``, the projection at ``dtype`` if
        given (its compute dtype otherwise)."""
        return call_at(self.proj, cond, dtype).chunk(2, dim=-1)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.norm(x)
        scale, shift = self.modulation(cond)
        return h * (1.0 + scale[:, None, :]) + shift[:, None, :]
