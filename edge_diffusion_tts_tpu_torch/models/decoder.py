"""EdgeDiffusionDecoder: the conditional diffusion denoiser, in PyTorch.

Counterpart of ``edge_diffusion_tts_tpu/models/decoder.py``.  Inputs: noisy
mel x_t [B, T, n_mels], timestep t [B], and semantic conditioning as token
indices or continuous features; an optional few-step stage index adds a
learned embedding (clamped to the 16-row table) to the time conditioning.
Parameter names are the reference decoder's state-dict keys
(``time_emb.1``/``.3``, ``layers.{i}.norm1.proj``, ``final_norm`` ...).

``dtype`` is the compute dtype, as the JAX module's: float32 by default;
with bfloat16 every layer computes in bf16 (the residual stream too) but
for the float32 spots JAX keeps (attention logits and softmax, the norms'
statistics, the time embedding before its cast), and the output is float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import CFG
from ..layers import (
    DiffusionTransformerBlock,
    SinusoidalPositionalEmb,
    SinusoidalTimeEmb,
)
from ..layers.dtypes import Embedding, LayerNorm, Linear, cast

MAX_STEP_EMB = 16  # few-step stage embedding table size


def backbone_block(cfg: CFG, use_kernel: Optional[bool] = None,
                   dtype: torch.dtype = torch.float32) -> DiffusionTransformerBlock:
    """The decoder's transformer block with the kernel routing resolved, at
    compute ``dtype``.

    ``use_kernel=None`` follows the config (``use_flash_attn`` above
    ``pallas_min_seq_len``); True/False force the route at every length.
    """
    if use_kernel is None:
        uk, kms = cfg.use_flash_attn, cfg.pallas_min_seq_len
    else:
        uk, kms = use_kernel, 0
    return DiffusionTransformerBlock(
        dim=cfg.hidden,
        cond_dim=cfg.hidden,
        heads=cfg.heads,
        ffn_mult=cfg.ffn_mult,
        dropout=cfg.dropout,
        use_adaln=cfg.use_adaln,
        window_size=cfg.attn_window_size,
        use_kernel=uk,
        kernel_min_seq=kms,
        cross_q_chunk=cfg.cross_q_chunk,
        band_q_chunk=cfg.band_q_chunk,
        dtype=dtype,
    )


class EdgeDiffusionDecoder(nn.Module):
    """Edge-optimized diffusion decoder: prelude -> backbone -> postlude."""

    def __init__(self, cfg: CFG, use_kernel: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        H = cfg.hidden
        self.time_emb = nn.Sequential(
            SinusoidalTimeEmb(H, dtype), Linear(H, H, compute_dtype=dtype), nn.GELU(),
            Linear(H, H, compute_dtype=dtype),
        )
        self.step_emb = Embedding(MAX_STEP_EMB, H, compute_dtype=dtype)
        self.sem_proj = Linear(cfg.semantic_dim, H, compute_dtype=dtype)
        self.token_emb = Embedding(cfg.effective_codebook_size(), H, compute_dtype=dtype)
        self.context_pos_emb = SinusoidalPositionalEmb(H, max_len=cfg.max_ctx_positions)
        self.in_proj = Linear(cfg.n_mels, H, compute_dtype=dtype)
        if cfg.use_depthwise:
            from ..layers.conv import DepthwiseSeparableConv

            self.pre_conv = DepthwiseSeparableConv(H, H, dtype=dtype)
        self.pos_emb = SinusoidalPositionalEmb(H, max_len=cfg.max_mel_positions)
        self.layers = nn.ModuleList(
            [backbone_block(cfg, use_kernel, dtype) for _ in range(cfg.layers)]
        )
        # flax LayerNorm: eps 1e-6, not torch's default 1e-5.
        self.final_norm = LayerNorm(H, eps=1e-6, compute_dtype=dtype)
        self.out_proj = Linear(H, cfg.n_mels, compute_dtype=dtype)
        nn.init.zeros_(self.out_proj.weight)
        nn.init.zeros_(self.out_proj.bias)

    def time_cond(self, t: torch.Tensor, step_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Timestep [B] (and stage index [B]) -> conditioning vector [B, H]."""
        t_cond = self.time_emb(t)
        if step_idx is not None:
            t_cond = t_cond + self.step_emb(step_idx.clamp(0, MAX_STEP_EMB - 1))
        return t_cond

    def context(
        self,
        sem_idx: Optional[torch.Tensor] = None,
        sem_features: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Semantic context [B, S, H]: features projection or token embedding,
        plus the context positional table."""
        if sem_features is not None:
            ctx = self.sem_proj(sem_features)
        elif sem_idx is not None:
            ctx = self.token_emb(sem_idx)
        else:
            raise ValueError("either sem_idx or sem_features must be provided")
        return self.context_pos_emb(ctx)

    def prelude(
        self,
        x_t: torch.Tensor,
        t: torch.Tensor,
        sem_idx: Optional[torch.Tensor] = None,
        step_idx: Optional[torch.Tensor] = None,
        sem_features: Optional[torch.Tensor] = None,
        pos_offset: int = 0,
    ):
        """Embeddings + conditioning: ``(h0, context, t_cond)``."""
        t_cond = self.time_cond(t, step_idx)
        context = self.context(sem_idx, sem_features)
        h = self.in_proj(cast(x_t.float(), self.dtype))
        if self.cfg.use_depthwise:
            h = h + self.pre_conv(h)
        h = self.pos_emb(h, offset=pos_offset)
        return h, context, t_cond

    def backbone(
        self,
        h: torch.Tensor,
        context: torch.Tensor,
        t_cond: torch.Tensor,
        mel_mask: Optional[torch.Tensor] = None,
        ctx_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        for block in self.layers:
            h = block(h, context, cond=t_cond, mel_mask=mel_mask, ctx_mask=ctx_mask,
                      generator=generator)
        return h

    def postlude(self, h: torch.Tensor) -> torch.Tensor:
        """LayerNorm + zero-init output head."""
        return self.out_proj(self.final_norm(h)).float()

    def align_contexts(self, sem_idx: torch.Tensor, sem_features: torch.Tensor):
        """Both conditioning embeddings of one utterance, ``(token_emb(sem_idx),
        sem_proj(sem_features))``, without positions: the phase-1 token-
        alignment loss pulls the first toward the second (training/steps.py)."""
        return self.token_emb(sem_idx), self.sem_proj(sem_features)

    def forward(
        self,
        x_t: torch.Tensor,
        t: torch.Tensor,
        sem_idx: Optional[torch.Tensor] = None,
        step_idx: Optional[torch.Tensor] = None,
        sem_features: Optional[torch.Tensor] = None,
        pos_offset: int = 0,
        sem_mask: Optional[torch.Tensor] = None,
        mel_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``sem_mask`` ([B, S] bool) / ``mel_mask`` ([B, T] bool) mark real
        (non-padded) positions; padded keys are excluded from attention.  In
        training mode ``generator`` draws every dropout mask, as the JAX
        package's ``rngs={"dropout": key}`` does."""
        h, context, t_cond = self.prelude(
            x_t, t, sem_idx=sem_idx, step_idx=step_idx,
            sem_features=sem_features, pos_offset=pos_offset,
        )
        h = self.backbone(h, context, t_cond, mel_mask=mel_mask, ctx_mask=sem_mask,
                          generator=generator)
        return self.postlude(h)
