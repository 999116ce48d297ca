"""SwiGLU feed-forward (counterpart of ``edge_diffusion_tts_tpu/layers/ffn.py``).

The fc1 output splits value first, then gate.  Parameter names follow the
reference state dict: ``net.0`` is fc1 and ``net.3`` is fc2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def swiglu(x: torch.Tensor) -> torch.Tensor:
    """Split the last axis in half: value * silu(gate)."""
    value, gate = x.chunk(2, dim=-1)
    return value * F.silu(gate)


class SwiGLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x)


class FeedForward(nn.Module):
    """Linear(dim -> 2*mult*dim) -> SwiGLU -> Dropout -> Linear -> Dropout."""

    def __init__(self, dim: int, mult: int = 2, dropout: float = 0.1):
        super().__init__()
        hidden = dim * mult
        self.net = nn.Sequential(
            nn.Linear(dim, hidden * 2),
            SwiGLU(),
            nn.Dropout(dropout),
            nn.Linear(hidden, dim),
            nn.Dropout(dropout),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)
