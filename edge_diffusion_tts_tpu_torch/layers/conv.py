"""1-D conv blocks, depthwise-separable and standard (counterpart of
``edge_diffusion_tts_tpu/layers/conv.py``).

The public layout stays channels-last [B, T, C] as in the JAX package;
convolutions run channels-first inside.  Padding is "SAME" (left gets the
smaller half), GroupNorm has eps 1e-6 and GELU is the exact erf form, as in
flax.  On a CUDA tensor the forward turns TF32 off for cuDNN convolutions so
they stay full float32.  ``dtype`` is the blocks' compute dtype (the
GroupNorm's statistics stay float32, as flax's do).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .dtypes import Conv1d, GroupNorm


def _same_pad(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """Pad [B, C, T] as flax's padding="SAME" does."""
    n = x.shape[-1]
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel_size - n, 0)
    return F.pad(x, (total // 2, total - total // 2))


class DepthwiseSeparableConv(nn.Module):
    """Depthwise conv (no bias) + pointwise 1x1 + GroupNorm(<=8) + GELU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.depthwise = Conv1d(
            in_ch, in_ch, kernel_size, stride=stride, groups=in_ch, bias=False,
            compute_dtype=dtype,
        )
        self.pointwise = Conv1d(in_ch, out_ch, 1, compute_dtype=dtype)
        self.norm = GroupNorm(min(8, out_ch), out_ch, eps=1e-6, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            torch.backends.cudnn.allow_tf32 = False
        h = x.transpose(1, 2)
        h = self.depthwise(_same_pad(h, self.kernel_size, self.stride))
        h = self.norm(self.pointwise(h))
        return F.gelu(h).transpose(1, 2)



class ConvBlock(nn.Module):
    """Conv1d (SAME padding, ``stride``) + GroupNorm(<=8) + GELU.

    A library component: the decoder does not use it.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.conv = Conv1d(in_ch, out_ch, kernel_size, stride=stride, compute_dtype=dtype)
        self.norm = GroupNorm(min(8, out_ch), out_ch, eps=1e-6, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            torch.backends.cudnn.allow_tf32 = False
        h = self.conv(_same_pad(x.transpose(1, 2), self.kernel_size, self.stride))
        return F.gelu(self.norm(h)).transpose(1, 2)
