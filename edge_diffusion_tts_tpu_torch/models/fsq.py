"""Finite Scalar Quantization (counterpart of ``edge_diffusion_tts_tpu/models/fsq.py``).

FSQ bounds each latent dimension with tanh, rounds it to a fixed number of
levels, and maps codes <-> flat indices through a mixed-radix basis.  No
codebook, no EMA, no commitment loss.  ``torch.round`` rounds half to even,
as ``jnp.round`` does: token identity depends on it.  The level arithmetic
runs in float32 whatever the projections' dtype (a bf16 ``tanh`` output is
promoted by the float32 level table, as in JAX), so a bf16 encoder's
quantized features come out float32 and its ``proj_up`` casts them back.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..layers.dtypes import Linear


class FSQ(nn.Module):
    """Quantize each of ``len(levels)`` dims to its own number of levels."""

    def __init__(self, levels: Sequence[int]):
        super().__init__()
        self.levels = tuple(int(l) for l in levels)
        self.register_buffer("_levels", torch.tensor(self.levels, dtype=torch.float32),
                             persistent=False)
        self.register_buffer(
            "_basis", torch.from_numpy(np.cumprod([1] + list(self.levels)[:-1])).long(),
            persistent=False)

    @property
    def dim(self) -> int:
        return len(self.levels)

    @property
    def codebook_size(self) -> int:
        return int(np.prod(self.levels))

    def _half(self) -> torch.Tensor:
        return (self._levels - 1.0) / 2.0

    def bound(self, z: torch.Tensor) -> torch.Tensor:
        """Each latent dim into (-1, 1): ``tanh``, at ``z``'s dtype."""
        return torch.tanh(z)

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """Round bounded z in [-1, 1] to per-dim levels, back to [-1, 1]."""
        half = self._half()
        z_q = torch.round((z + 1.0) * half)
        z_q = torch.minimum(torch.clamp(z_q, min=0.0), self._levels - 1.0)
        return z_q / half - 1.0

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(quantized with straight-through gradient, flat indices)."""
        z_b = self.bound(z)
        z_q = self.quantize(z_b)
        return z_b + (z_q - z_b).detach(), self.codes_to_indices(z_q)

    def codes_to_indices(self, z_q: torch.Tensor) -> torch.Tensor:
        codes = torch.round((z_q + 1.0) * self._half()).long()
        return (codes * self._basis).sum(-1)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """Inverse of ``codes_to_indices``: dim 0 is the least significant digit."""
        rem = indices.long()
        codes = []
        for l in self.levels:
            codes.append(rem % l)
            rem = rem // l
        return torch.stack(codes, -1).float() / self._half() - 1.0


def count_code_usage(indices: torch.Tensor, num_codes: int) -> torch.Tensor:
    """Float32 histogram of code usage over every index (in [0, num_codes)),
    as a scatter-add: ``bincount`` on the card reads the largest index back
    to the host."""
    flat = indices.reshape(-1)
    counts = torch.zeros(num_codes, dtype=torch.int64, device=flat.device)
    return counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int64)).float()


def usage_metrics(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perplexity, number of used codes) from a usage histogram."""
    probs = counts / counts.sum().clamp(min=1.0)
    perplexity = torch.exp(-(probs * torch.log(probs.clamp(min=1e-12))).sum())
    return perplexity, (counts > 0).sum()


class FSQEncoder(nn.Module):
    """proj_down(input_dim -> len(levels)) -> FSQ -> proj_up, VQ-compatible.

    ``forward`` returns the 5-tuple (z_q, indices, loss(=0), perplexity, used).
    """

    def __init__(self, input_dim: int, levels: Sequence[int] = (8, 6, 5, 5, 5),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fsq = FSQ(levels)
        self.proj_down = Linear(input_dim, self.fsq.dim, compute_dtype=dtype)
        self.proj_up = Linear(self.fsq.dim, input_dim, compute_dtype=dtype)

    @property
    def codebook_size(self) -> int:
        return self.fsq.codebook_size

    def forward(self, z: torch.Tensor):
        z_q_low, indices = self.fsq(self.proj_down(z))
        z_q = self.proj_up(z_q_low)
        perplexity, used = usage_metrics(count_code_usage(indices, self.codebook_size))
        loss = torch.zeros((), dtype=torch.float32, device=z.device)
        return z_q, indices, loss, perplexity, used

    def encode(self, z: torch.Tensor) -> torch.Tensor:
        return self.fsq(self.proj_down(z))[1]

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        return self.proj_up(self.fsq.indices_to_codes(indices))
