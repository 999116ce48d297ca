"""Diffusion transformer block (counterpart of ``edge_diffusion_tts_tpu/layers/transformer.py``).

Pre-norm residual block with three sub-layers:

1. AdaLN(timestep cond) + windowed self-attention
2. RMSNorm + MLA cross-attention on the semantic context (full attention;
   the block passes no ``cond`` to it)
3. AdaLN(timestep cond) + SwiGLU feed-forward

``dtype`` is the block's compute dtype (flax's ``dtype``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention import EfficientAttention, MultiHeadLatentAttention
from .ffn import FeedForward
from .norms import AdaLayerNorm, RMSNorm


class DiffusionTransformerBlock(nn.Module):
    def __init__(
        self,
        dim: int,
        cond_dim: Optional[int] = None,
        heads: int = 4,
        ffn_mult: int = 2,
        dropout: float = 0.1,
        use_adaln: bool = True,
        window_size: Optional[int] = None,
        use_kernel: bool = False,
        kernel_min_seq: int = 0,
        cross_q_chunk: int = 0,
        band_q_chunk: int = 0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        cond_dim = cond_dim or dim
        self.use_adaln = use_adaln
        norm = ((lambda: AdaLayerNorm(dim, cond_dim, dtype)) if use_adaln
                else (lambda: RMSNorm(dim)))
        self.norm1 = norm()
        self.attn = EfficientAttention(
            dim, heads, dropout, window_size=window_size, use_kernel=use_kernel,
            kernel_min_seq=kernel_min_seq, band_q_chunk=band_q_chunk, dtype=dtype,
        )
        self.norm2 = RMSNorm(dim)
        self.cross_attn = MultiHeadLatentAttention(
            dim, heads, kv_lora_rank=dim // 2, dropout=dropout, window_size=None,
            q_chunk=cross_q_chunk, dtype=dtype,
        )
        self.norm3 = norm()
        self.ffn = FeedForward(dim, ffn_mult, dropout, dtype)

    def _norm(self, norm: nn.Module, x: torch.Tensor, cond) -> torch.Tensor:
        return norm(x, cond) if self.use_adaln else norm(x)

    def forward(
        self,
        x: torch.Tensor,
        context: torch.Tensor,
        cond: Optional[torch.Tensor] = None,
        mel_mask: Optional[torch.Tensor] = None,
        ctx_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``mel_mask`` ([B, T] bool) / ``ctx_mask`` ([B, S] bool) exclude padded
        key positions from self-/cross-attention respectively; ``generator``
        draws every training-mode dropout mask of the block."""
        x = x + self.attn(self._norm(self.norm1, x, cond), key_mask=mel_mask,
                          generator=generator)
        x = x + self.cross_attn(self.norm2(x), context=context, key_mask=ctx_mask,
                                generator=generator)
        return x + self.ffn(self._norm(self.norm3, x, cond), generator)
