"""Semantic encoder: frozen HuBERT layer-9 features -> projection -> FSQ/VQ
(counterpart of ``edge_diffusion_tts_tpu/models/encoder.py``, inference).

HuBERT's output is detached, as the JAX package stops its gradient.  The
projection-dropout variant (``use_dropout``) is training and not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CFG
from .fsq import FSQEncoder
from .hubert import HubertConfig, HubertEncoder, conv_frame_lengths, valid_mask
from .vq import VectorQuantizer


class SemanticEncoder(nn.Module):
    """wav [B, T] -> quantized semantic features + token indices.

    ``forward`` returns the VQ-compatible 5-tuple (z_q, idx, vq_loss,
    perplexity, used).
    """

    def __init__(self, cfg: CFG, hubert_cfg: HubertConfig = HubertConfig()):
        super().__init__()
        self.cfg = cfg
        self.hubert_cfg = hubert_cfg
        D = cfg.semantic_dim
        self.hubert = HubertEncoder(hubert_cfg)
        self.proj_fc1 = nn.Linear(hubert_cfg.hidden_size, D)
        self.proj_ln = nn.LayerNorm(D, eps=1e-6)  # flax LayerNorm's default eps
        self.proj_fc2 = nn.Linear(D, D)
        if cfg.use_fsq:
            self.vq = FSQEncoder(D, tuple(cfg.fsq_levels))
        else:
            self.vq = VectorQuantizer(D, cfg.codebook_size)

    @property
    def codebook_size(self) -> int:
        return self.cfg.effective_codebook_size()

    def extract_hubert(self, wav: torch.Tensor, conv_feats=None, wav_len=None) -> torch.Tensor:
        """Frozen HuBERT hidden layer ``cfg.hubert_layer`` (9), clamped to the
        encoder's depth.  ``conv_feats`` replaces the conv frontend's output
        (``ops/fused_frontend.fast_encode``); ``wav_len`` makes zero-padded
        inputs exact (see ``HubertEncoder.forward``)."""
        layer = min(self.cfg.hubert_layer, self.hubert_cfg.num_layers)
        return self.hubert.extract_layer(wav, layer, conv_feats=conv_feats,
                                         wav_len=wav_len).detach()

    def _project(self, h: torch.Tensor) -> torch.Tensor:
        return self.proj_fc2(self.proj_ln(F.gelu(self.proj_fc1(h))))

    def _quantize(self, z: torch.Tensor, train: bool):
        return self.vq(z) if self.cfg.use_fsq else self.vq(z, train=train)

    def forward(self, wav: torch.Tensor, train: bool = False, wav_len=None, conv_feats=None):
        """``wav_len`` (true sample count) makes zero-padded inputs exact, and
        zeroes the quantized features and indices at padded frames (the
        projection of a zeroed hidden state is not zero).  ``conv_feats``
        replaces the conv frontend's output (``ops/fused_frontend.
        conv_frontend``, computed with the same ``wav_len``)."""
        h = self.extract_hubert(wav, conv_feats=conv_feats, wav_len=wav_len)
        out = self._quantize(self._project(h), train)
        if wav_len is None:
            return out
        n_valid = conv_frame_lengths(self.hubert_cfg, torch.as_tensor(wav_len))[-1]
        mask = valid_mask(h.shape[1], n_valid, h.device)
        z_q, idx, vq_loss, ppl, used = out
        return (torch.where(mask[:, :, None], z_q, 0.0), torch.where(mask, idx, 0),
                vq_loss, ppl, used)

    def from_features(self, feats: torch.Tensor, train: bool = False):
        """Precomputed HuBERT features [B, S, hidden] -> the same 5-tuple."""
        return self._quantize(self._project(feats), train)

    def encode(self, wav: torch.Tensor, conv_feats=None) -> torch.Tensor:
        """wav -> discrete token indices [B, S]."""
        return self.vq.encode(self._project(self.extract_hubert(wav, conv_feats=conv_feats)))

    def decode_tokens(self, idx: torch.Tensor) -> torch.Tensor:
        """token indices -> continuous semantic features."""
        return self.vq.decode(idx)


def is_hubert_param(name: str) -> bool:
    """True for a parameter name of the frozen HuBERT (``hubert.`` sub-module)."""
    return "hubert" in name.split(".")
