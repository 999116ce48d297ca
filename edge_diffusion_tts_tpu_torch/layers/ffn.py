"""SwiGLU feed-forward (counterpart of ``edge_diffusion_tts_tpu/layers/ffn.py``)
and the port's dropout.

The fc1 output splits value first, then gate.  Parameter names follow the
reference state dict: ``net.0`` is fc1 and ``net.3`` is fc2.

Dropout draws its mask from an explicit ``torch.Generator``, as the JAX
package draws it from a key: a training-mode call with a non-zero rate and
no generator raises rather than read torch's global random stream.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``Dropout``: keep each element with probability ``1 - rate`` and
    scale the kept ones by ``1 / (1 - rate)``; the identity outside training
    or at rate 0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("training-mode dropout draws its mask from an explicit "
                         "torch.Generator: pass generator=")
    keep = torch.bernoulli(torch.full_like(x, 1.0 - rate), generator=generator).bool()
    return torch.where(keep, x / (1.0 - rate), 0.0)


def swiglu(x: torch.Tensor) -> torch.Tensor:
    """Split the last axis in half: value * silu(gate)."""
    value, gate = x.chunk(2, dim=-1)
    return value * F.silu(gate)


class SwiGLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x)


class Dropout(nn.Module):
    """``dropout`` as a module: the mask comes from the ``generator`` argument."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.rate, self.training, generator)


class FeedForward(nn.Module):
    """Linear(dim -> 2*mult*dim) -> SwiGLU -> Dropout -> Linear -> Dropout."""

    def __init__(self, dim: int, mult: int = 2, dropout: float = 0.1):
        super().__init__()
        hidden = dim * mult
        self.net = nn.Sequential(
            nn.Linear(dim, hidden * 2),
            SwiGLU(),
            Dropout(dropout),
            nn.Linear(hidden, dim),
            Dropout(dropout),
        )

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        fc1, act, drop1, fc2, drop2 = self.net
        return drop2(fc2(drop1(act(fc1(x)), generator)), generator)
