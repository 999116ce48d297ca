"""Embeddings: diffusion-timestep (fixed and learned), positional (fixed
sinusoidal table and learned) and RoPE.

Counterpart of ``edge_diffusion_tts_tpu/layers/embeddings.py``.  The time
embedding is concat(sin, cos) with denominator ``half - 1``; the positional
table is *interleaved* (even columns sin, odd columns cos).  The time
embedding is made in float32 and then cast to the module's ``dtype``, as
JAX's decoder casts it; the fixed positional tables are cast to the input's
dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .dtypes import Embedding, Linear, cast


def sinusoidal_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] timesteps -> [B, dim]: concat(sin, cos) halves."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * (-math.log(10000.0) / (half - 1))
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class SinusoidalTimeEmb(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return cast(sinusoidal_time_embedding(t, self.dim), self.dtype)


class LearnedTimeEmb(nn.Module):
    """Sinusoidal embedding refined by a 2-layer MLP: fc1 -> exact GELU -> fc2,
    hidden width ``hidden_dim`` (4 x ``dim`` by default).

    fc1 and fc2 are ``net.0`` and ``net.3`` (index 2 is empty), the names
    under which ``weights.state_dict_from_jax`` carries flax's ``fc1``/``fc2``.
    """

    def __init__(self, dim: int, hidden_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        hidden = hidden_dim or dim * 4
        self.net = nn.Sequential(Linear(dim, hidden, compute_dtype=dtype), nn.GELU(),
                                 nn.Identity(), Linear(hidden, dim, compute_dtype=dtype))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.net(cast(sinusoidal_time_embedding(t, self.dim), self.dtype))


def sinusoidal_position_table(max_len: int, dim: int) -> torch.Tensor:
    """Interleaved sin/cos positional table [max_len, dim] (float32, CPU)."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32) * (-math.log(10000.0) / dim)
    )
    angles = position * div_term[None, :]
    pe = torch.zeros(max_len, dim)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe


class SinusoidalPositionalEmb(nn.Module):
    """Adds a fixed interleaved sin/cos table to the input sequence.

    ``offset`` shifts the table window so a sequence shard sees its global
    positions.  The table is a non-persistent buffer: it is not a weight.
    """

    def __init__(self, dim: int, max_len: int = 5000):
        super().__init__()
        self.max_len = max_len
        self.register_buffer(
            "table", sinusoidal_position_table(max_len, dim), persistent=False
        )

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        T = x.shape[1]
        if offset < 0 or offset + T > self.max_len:
            raise ValueError(
                f"positions [{offset}, {offset + T}) exceed the table's "
                f"{self.max_len} rows"
            )
        return x + self.table[offset:offset + T][None].to(x.dtype)


class LearnedPositionalEmb(nn.Module):
    """A learned table ``emb`` [max_len, dim] added over positions 0..T-1.

    A library component: the decoder uses the sinusoidal table.  The rows
    come out at ``dtype`` and are added to ``x`` as JAX adds them (a bf16
    table and a float32 ``x`` give float32).
    """

    def __init__(self, max_len: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_len = max_len
        self.emb = Embedding(max_len, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        if T > self.max_len:
            raise ValueError(f"{T} positions exceed the table's {self.max_len} rows")
        return x + cast(self.emb.weight[:T], self.emb.compute_dtype)[None]


def rope_tables(max_len: int, dim: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [max_len, dim] with duplicated frequency halves."""
    inv_freq = 1.0 / (
        10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    )
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, max_len: int = 5000
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k ([B, H, T, D]) by position."""
    T = q.shape[2]
    cos, sin = rope_tables(max_len, q.shape[-1], device=q.device)
    cos = cos[None, None, :T, :].to(q.dtype)
    sin = sin[None, None, :T, :].to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
