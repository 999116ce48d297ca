"""Attention layers: windowed self-attention, cross-attention and MLA.

Counterpart of ``edge_diffusion_tts_tpu/layers/attention.py``.  Masked logits
take ``finfo(float32).min`` and the softmax runs in float32.  The windowed
self-attention of ``EfficientAttention`` routes to the banded-attention
kernel (ops/window_attention.py) on the same conditions as the JAX package
routes to its Pallas kernel.  ``dtype`` is the layers' compute dtype (flax's
``dtype``): the projections run at it and the logits and softmax stay
float32; the banded kernel takes float32 only (a bf16 layer raises there on
the card, ROADMAP Queue B, B3.4).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import window_attention
from .embeddings import apply_rope
from .dtypes import Linear
from .ffn import dropout
from .norms import RMSNorm

_NEG = torch.finfo(torch.float32).min


def local_attention_mask(seq_len: int, window_size: int, device=None) -> torch.Tensor:
    """Boolean band mask [T, T]: attend iff |i - j| <= window_size."""
    idx = torch.arange(seq_len, device=device)
    return (idx[None, :] - idx[:, None]).abs() <= window_size


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Scaled dot-product attention on [B, H, T, D] with a softmax in float32
    (float64 for float64 inputs).  In training, dropout on the probabilities
    draws its mask from ``generator``."""
    scale = q.shape[-1] ** -0.5
    ft = torch.promote_types(q.dtype, torch.float32)  # float64 stays float64
    logits = torch.matmul(q.to(ft), k.to(ft).transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, _NEG)
    probs = dropout(torch.softmax(logits, dim=-1), dropout_rate, training, generator)
    return torch.matmul(probs.to(v.dtype), v)


def q_chunked_sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_chunk: int,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SDPA over query chunks: same math, a bounded [B, H, q_chunk, S] tile."""
    mask = None if key_mask is None else key_mask[:, None, None, :]
    outs = [sdpa(qi, k, v, mask) for qi in q.split(q_chunk, dim=2)]
    return torch.cat(outs, dim=2)


def q_chunked_banded_sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    q_chunk: int,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Windowed self-attention via query chunks over k/v band slices.

    Query rows ``[i*C, (i+1)*C)`` can only reach keys ``[i*C - w,
    (i+1)*C + w)``, so each chunk attends over that zero-padded slice of
    ``C + 2w`` keys alone: the same math as dense masked SDPA.  A row whose
    every key is masked averages its slice, padding included, as the JAX
    package's form does.
    """
    B, H, T, D = q.shape
    C = q_chunk
    n = -(-T // C)
    pad = n * C - T
    kwin = C + 2 * window
    kp = F.pad(k, (0, 0, window, window + pad))
    vp = F.pad(v, (0, 0, window, window + pad))
    kmp = None if key_mask is None else F.pad(key_mask, (window, window + pad))
    # Within-chunk band: row a attends slice column j iff 0 <= j - a <= 2w.
    a = torch.arange(C, device=q.device)[:, None]
    j = torch.arange(kwin, device=q.device)[None, :]
    band = (j >= a) & (j - a <= 2 * window)
    outs = []
    for i in range(n):
        s = i * C
        g = s - window + torch.arange(kwin, device=q.device)  # global key index
        mask = (band & ((g >= 0) & (g < T))[None, :])[None, None]
        if kmp is not None:
            mask = mask & kmp[:, None, None, s:s + kwin]
        rows = min(C, T - s)
        outs.append(sdpa(q[:, :, s:s + rows], kp[:, :, s:s + kwin], vp[:, :, s:s + kwin],
                         mask[:, :, :rows]))
    return torch.cat(outs, dim=2)


class EfficientAttention(nn.Module):
    """Multi-head self-attention with fused QKV and optional band mask.

    ``qkv`` is one no-bias projection to 3*dim laid out (3, heads, head_dim),
    so head h of q is columns [h*dh, (h+1)*dh); ``proj`` has a bias.

    Routing, as in the JAX package: with ``use_kernel`` and a window, an
    unmasked eval-mode call at ``T >= kernel_min_seq`` goes to the banded
    kernel; a masked one at that length goes to the chunked-band path;
    ``band_q_chunk`` selects the chunked-band path at ``T >= 2*band_q_chunk``;
    everything else is dense masked SDPA.
    """

    def __init__(
        self,
        dim: int,
        heads: int = 4,
        dropout: float = 0.1,
        window_size: Optional[int] = None,
        use_kernel: bool = False,
        kernel_min_seq: int = 0,
        band_q_chunk: int = 0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dim, self.heads, self.dropout = dim, heads, dropout
        self.window_size = window_size
        self.use_kernel = use_kernel
        self.kernel_min_seq = kernel_min_seq
        self.band_q_chunk = band_q_chunk
        self.qkv = Linear(dim, dim * 3, bias=False, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)

    def forward(
        self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``key_mask`` ([B, T] bool, True = real position) excludes padded keys;
        ``generator`` draws the training-mode dropout mask."""
        B, T, C = x.shape
        dh = self.dim // self.heads
        qkv = self.qkv(x).reshape(B, T, 3, self.heads, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]

        windowed_eval = self.window_size is not None and not self.training
        kernel_len = self.use_kernel and windowed_eval and T >= self.kernel_min_seq
        band_chunk = self.band_q_chunk
        if key_mask is not None and kernel_len:
            # The kernel carries no key mask: masked calls at kernel-worthy
            # lengths take the chunked-band path instead of the dense one.
            band_chunk = min(band_chunk or 512, T // 2)

        if kernel_len and key_mask is None:
            # Views of the qkv output in, o in [B, T, H, dh] memory out: the
            # reshape below is then a view, and no copy kernel runs.
            out = window_attention.banded_attention(
                q, k, v, self.window_size, out_layout="bthd"
            )
        elif band_chunk > 0 and windowed_eval and T >= 2 * band_chunk:
            out = q_chunked_banded_sdpa(
                q, k, v, self.window_size, band_chunk, key_mask=key_mask
            )
        else:
            mask = None
            if self.window_size is not None:
                mask = local_attention_mask(T, self.window_size, x.device)[None, None]
            if key_mask is not None:
                km = key_mask[:, None, None, :]
                mask = km if mask is None else (mask & km)
            out = sdpa(q, k, v, mask, self.dropout, self.training, generator)

        return self.proj(out.transpose(1, 2).reshape(B, T, C))


class CrossAttention(nn.Module):
    """Standard cross-attention (q from x, fused kv from context).

    A library component: the decoder uses MLA for its cross-attention.
    """

    def __init__(self, dim: int, context_dim: Optional[int] = None, heads: int = 4,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.dropout = dim, heads, dropout
        context_dim = context_dim or dim
        self.q = Linear(dim, dim, bias=False, compute_dtype=dtype)
        self.kv = Linear(context_dim, dim * 2, bias=False, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, C = x.shape
        S = context.shape[1]
        dh = self.dim // self.heads
        q = self.q(x).reshape(B, T, self.heads, dh).transpose(1, 2)
        kv = self.kv(context).reshape(B, S, 2, self.heads, dh).permute(2, 0, 3, 1, 4)
        out = sdpa(q, kv[0], kv[1], None, self.dropout, self.training, generator)
        return self.proj(out.transpose(1, 2).reshape(B, T, C))


class MultiHeadLatentAttention(nn.Module):
    """MLA: K and V come from a low-rank latent, kv_down -> RMSNorm -> kv_up.

    K is the first ``dim`` columns of kv_up, V the last.  No biases.  RoPE
    and the band mask apply only in self-attention mode (no context); the
    decoder uses it as cross-attention over the semantic context.
    """

    def __init__(
        self,
        dim: int,
        heads: int = 8,
        kv_lora_rank: Optional[int] = None,
        dropout: float = 0.1,
        window_size: Optional[int] = None,
        q_chunk: int = 0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dim, self.heads, self.dropout = dim, heads, dropout
        self.window_size = window_size
        self.q_chunk = q_chunk
        rank = kv_lora_rank or dim // 2
        self.q_proj = Linear(dim, dim, bias=False, compute_dtype=dtype)
        self.kv_down_proj = Linear(dim, rank, bias=False, compute_dtype=dtype)
        self.kv_norm = RMSNorm(rank)
        self.kv_up_proj = Linear(rank, dim * 2, bias=False, compute_dtype=dtype)
        self.out_proj = Linear(dim, dim, bias=False, compute_dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        cond: Optional[torch.Tensor] = None,
        key_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``key_mask`` ([B, S] bool over the kv sequence) excludes padded keys;
        ``generator`` draws the training-mode dropout mask."""
        B, T, C = x.shape
        dh = self.dim // self.heads
        kv_input = context if context is not None else x
        S = kv_input.shape[1]

        q_in = x if cond is None else x + cond[:, None, :]
        q = self.q_proj(q_in).reshape(B, T, self.heads, dh).transpose(1, 2)
        kv = self.kv_up_proj(self.kv_norm(self.kv_down_proj(kv_input)))
        kv = kv.reshape(B, S, 2, self.heads, dh).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]

        if context is None:
            q, k = apply_rope(q, k)

        mask = None
        if self.window_size is not None and context is None:
            mask = local_attention_mask(T, self.window_size, x.device)[None, None]
        if key_mask is not None:
            km = key_mask[:, None, None, :]
            mask = km if mask is None else (mask & km)

        use_dropout = self.dropout > 0 and self.training
        if (
            self.q_chunk > 0
            and context is not None
            and not use_dropout
            and self.window_size is None
            and T >= 2 * self.q_chunk
        ):
            out = q_chunked_sdpa(q, k, v, self.q_chunk, key_mask=key_mask)
        else:
            out = sdpa(q, k, v, mask, self.dropout, self.training, generator)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, C))
