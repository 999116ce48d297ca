"""Vector quantizer with EMA codebook updates and dead-code resets
(counterpart of ``edge_diffusion_tts_tpu/models/vq.py``).

The JAX package threads its statistics functionally through the ``vq_state``
collection; here they are buffers (``codebook``, ``ema_cluster_size``,
``ema_w``, ``update_count``) that a training-mode forward updates in place,
under no gradient.  Dead-code resets permute the batch rows with an explicit
``torch.Generator`` where JAX draws from its ``"vq"`` key; a test hands in
JAX's own permutation through ``perm``.

Data-parallel training sets ``group`` (a ``parallel.mesh.Axis``, the
counterpart of the JAX module's ``axis_name``) for the duration of a step:
the counts ``n`` and sums ``dw`` are summed over the group before the EMA
blend, so the update equals the big-batch one on every rank; the reset's
candidate pool is every rank's rows in rank order and its permutation is
rank 0's draw, so the codebook stays bit-equal across ranks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .fsq import count_code_usage, usage_metrics


class VectorQuantizer(nn.Module):
    """Classic VQ-VAE quantizer: L2-nearest lookup + straight-through.

    Losses: codebook MSE + ``commit`` * commitment MSE.  With ``decay`` > 0 the
    codebook is maintained by EMA; every ``reset_unused_every`` updates, codes
    with EMA cluster size < 1 are replaced by random batch vectors.
    """

    def __init__(self, dim: int, codebook_size: int, commit: float = 0.25,
                 decay: float = 0.99, epsilon: float = 1e-5, reset_unused_every: int = 100):
        super().__init__()
        self.dim = dim
        self.codebook_size = codebook_size
        self.commit = commit
        self.decay = decay
        self.epsilon = epsilon
        self.reset_unused_every = reset_unused_every
        init = torch.randn(codebook_size, dim)
        self.register_buffer("codebook", init)
        self.register_buffer("ema_cluster_size", torch.ones(codebook_size))
        self.register_buffer("ema_w", init.clone())
        self.register_buffer("update_count", torch.zeros((), dtype=torch.int32))
        self.group = None  # a parallel.mesh.Axis under data-parallel training

    def _nearest(self, flat: torch.Tensor) -> torch.Tensor:
        cb = self.codebook
        dist = (flat.square().sum(1, keepdim=True) - 2.0 * flat @ cb.T
                + cb.square().sum(1)[None, :])
        return dist.argmin(1)

    def forward(
        self, z: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None, perm: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(z_q straight-through, indices [B, T], vq_loss, perplexity, used).

        ``train=True`` returns the codebook + commitment loss and, with
        ``decay`` > 0, updates the EMA buffers (``_ema_update``; ``generator``
        or ``perm`` for a dead-code reset)."""
        B, T, D = z.shape
        flat = z.reshape(-1, D).float()
        idx = self._nearest(flat.detach())
        z_q = self.codebook[idx].reshape(B, T, D)
        if train:
            # Under EMA the codebook's gradient is irrelevant: keep the loss
            # value for parity, route the gradient through commitment only.
            codebook_loss = (z.detach() - z_q).square().mean()
            commit_loss = (z_q.detach() - z).square().mean()
            vq_loss = codebook_loss + self.commit * commit_loss
            if self.decay > 0:
                self._ema_update(flat.detach(), idx, generator, perm)
        else:
            vq_loss = torch.zeros((), dtype=torch.float32, device=z.device)
        z_q = z + (z_q - z).detach()
        perplexity, used = usage_metrics(count_code_usage(idx, self.codebook_size))
        return z_q, idx.reshape(B, T), vq_loss, perplexity, used

    @torch.no_grad()
    def _ema_update(self, flat: torch.Tensor, idx: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    perm: Optional[torch.Tensor] = None) -> None:
        """EMA cluster/weight update + periodic dead-code reset, selected with
        ``torch.where`` as the JAX package does (no host read of the count).

        The reset draws a permutation of the batch rows every update, from
        ``generator`` unless ``perm`` [rows] is given; each dead code takes
        the row at its rank among the dead codes.  With ``group`` the
        statistics are the group's sums, the pool is every rank's rows in
        rank order (``perm`` then indexes that pool) and the drawn
        permutation is the group's first rank's."""
        one_hot = torch.nn.functional.one_hot(idx, self.codebook_size).float()
        n = one_hot.sum(0)
        dw = one_hot.T @ flat
        group = self.group
        if group is not None:
            # Global-batch statistics: n and dw are sums over rows, so the
            # big-batch reduction is a SUM of the raw statistics, one bucket.
            bucket = group.all_reduce(torch.cat([n[:, None], dw], 1))
            n, dw = bucket[:, 0], bucket[:, 1:]
        ema_n = self.ema_cluster_size * self.decay + n * (1.0 - self.decay)
        ema_w = self.ema_w * self.decay + dw * (1.0 - self.decay)
        codebook = ema_w / ema_n.clamp(min=self.epsilon)[:, None]
        count = self.update_count + 1

        if self.reset_unused_every > 0:
            if group is not None:
                flat = group.all_gather(flat, 0)
            rows = flat.shape[0]
            do_reset = (count % self.reset_unused_every) == 0
            dead = ema_n < 1.0
            if perm is None:
                if generator is None:
                    raise ValueError("the VQ dead-code reset draws its permutation from an "
                                     "explicit torch.Generator: pass generator= (or perm=)")
                perm = torch.randperm(rows, generator=generator, device=flat.device)
                if group is not None:
                    group.broadcast(perm)
            perm = perm.to(flat.device).long()
            dead_rank = torch.cumsum(dead.int(), 0) - 1
            replacement = flat[perm[dead_rank.clamp(0, rows - 1)]]
            replace = (dead & (dead_rank < rows) & do_reset)[:, None]
            codebook = torch.where(replace, replacement, codebook)
            ema_w = torch.where(replace, replacement, ema_w)
            ema_n = torch.where(replace[:, 0], 1.0, ema_n)

        self.ema_cluster_size.copy_(ema_n)
        self.ema_w.copy_(ema_w)
        self.codebook.copy_(codebook)
        self.update_count.copy_(count)

    def encode(self, z: torch.Tensor) -> torch.Tensor:
        B, T, D = z.shape
        return self._nearest(z.reshape(-1, D)).reshape(B, T)

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        return self.codebook[idx]
