"""Layers that compute at a dtype of their own, as flax modules do with ``dtype``.

Each stores its parameters at whatever dtype they were made or cast to (a
model's ``param_dtype``) and computes at ``compute_dtype``: the input and the
parameters are cast to it where they are used, and the output has it.  This
is flax's semantics, not ``torch.autocast``'s: a bf16 model's residual
stream is bf16, and the norms, whose statistics flax takes in float32,
return bf16.  With float32 parameters, input and ``compute_dtype`` every
cast is the identity, so each layer computes exactly what its torch base
class computes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def cast(x: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """``x`` at ``dtype`` (``x`` itself when it has it already, or is None)."""
    return x if x is None or x.dtype == dtype else x.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` at ``compute_dtype`` (flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(self.weight, dt), cast(self.bias, dt))


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose rows come out at ``compute_dtype`` (flax ``Embed``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_embeddings, embedding_dim)
        self.compute_dtype = compute_dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, cast(self.weight, self.compute_dtype))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` at ``compute_dtype`` (flax ``Conv(dtype=...)``).

    On the CPU a bf16 convolution runs in float32 over the bf16-rounded
    operands and rounds its output once, what a bf16 convolution on the
    card's tensor cores computes: torch 2.13's CPU bf16 convolution gives
    wrong results for grouped convolutions of few channels per group (HuBERT
    tiny's positional conv, 4 channels per group, lands far from float32)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, f32 = self.compute_dtype, torch.float32
        x, w, b = cast(x, dt), cast(self.weight, dt), cast(self.bias, dt)
        if dt != f32 and x.device.type == "cpu":
            return cast(self._conv_forward(cast(x, f32), cast(w, f32), cast(b, f32)), dt)
        return self._conv_forward(x, w, b)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax's dtype rule: statistics, scale and shift in
    float32, the result rounded once to ``compute_dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5, compute_dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        y = F.layer_norm(cast(x, f32), self.normalized_shape, cast(self.weight, f32),
                         cast(self.bias, f32), self.eps)
        return cast(y, self.compute_dtype)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` with flax's dtype rule, as ``LayerNorm`` here."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        y = F.group_norm(cast(x, f32), self.num_groups, cast(self.weight, f32),
                         cast(self.bias, f32), self.eps)
        return cast(y, self.compute_dtype)


def cast_parameters(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store every floating parameter of ``module`` at ``dtype`` (the JAX
    package's ``param_dtype`` cast of the whole tree after init); buffers
    (positional tables, VQ statistics) keep theirs.  Returns ``module``."""
    for p in module.parameters():
        if p.is_floating_point() and p.dtype != dtype:
            p.data = p.data.to(dtype)
    return module
