"""Semantic encoder: frozen HuBERT layer-9 features -> projection -> FSQ/VQ
(counterpart of ``edge_diffusion_tts_tpu/models/encoder.py``).

HuBERT runs under ``torch.no_grad()``, as the JAX package stops its
gradient; the trainer keeps its parameters out of the optimizer.  A
training-mode call (``train=True``) draws its dropout masks (the
``use_dropout`` projection variant) and the VQ's dead-code permutation from
the ``generator`` it is given.  ``dtype`` is the compute dtype of HuBERT,
the projection and the FSQ's projections (the VQ computes in float32, as
JAX's has no dtype).  Its HuBERT owns the conv frontend's route (the
conv-frontend kernel where it takes the stack at ``dtype``, the modules
elsewhere: models/hubert.py), so every caller just calls the encoder.

The speech encoder is the one its configuration names: a ``HubertConfig``
builds ``HubertEncoder`` (HuBERT, WavLM), a ``W2vBertConfig`` builds
``W2vBertEncoder`` (models/w2v_bert.py) to ``cfg.hubert_layer`` only, and
the valid frame counts come from the architecture (``num_frames``).  The
MaskGCT recipe's per-channel statistics before quantizing w2v-BERT's layer
17 are a fixed affine map of the features, which ``proj_fc1`` absorbs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CFG
from ..layers.dtypes import LayerNorm, Linear
from ..layers.ffn import dropout
from .fsq import FSQEncoder
from .hubert import HubertConfig, HubertEncoder, valid_mask
from .vq import VectorQuantizer
from .w2v_bert import W2vBertConfig, W2vBertEncoder


def speech_encoder(hubert_cfg, dtype: torch.dtype = torch.float32,
                   num_layers: Optional[int] = None) -> nn.Module:
    """The frozen speech encoder ``hubert_cfg`` describes: ``W2vBertEncoder``
    for a ``W2vBertConfig`` (built to ``num_layers``, default all), else
    ``HubertEncoder`` (every layer)."""
    if isinstance(hubert_cfg, W2vBertConfig):
        return W2vBertEncoder(hubert_cfg, dtype, num_layers)
    return HubertEncoder(hubert_cfg, dtype)


class SemanticEncoder(nn.Module):
    """wav [B, T] -> quantized semantic features + token indices.

    ``forward`` returns the VQ-compatible 5-tuple (z_q, idx, vq_loss,
    perplexity, used).  ``use_dropout`` adds dropout (rate ``cfg.dropout``)
    before the projection's second layer, the FastSemanticEncoder variant.
    """

    def __init__(self, cfg: CFG, hubert_cfg: HubertConfig = HubertConfig(),
                 use_dropout: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.hubert_cfg = hubert_cfg
        self.use_dropout = use_dropout
        self.dtype = dtype
        D = cfg.semantic_dim
        self.hubert = speech_encoder(hubert_cfg, dtype,
                                     min(cfg.hubert_layer, hubert_cfg.num_layers))
        self.proj_fc1 = Linear(hubert_cfg.hidden_size, D, compute_dtype=dtype)
        # flax LayerNorm's default eps
        self.proj_ln = LayerNorm(D, eps=1e-6, compute_dtype=dtype)
        self.proj_fc2 = Linear(D, D, compute_dtype=dtype)
        if cfg.use_fsq:
            self.vq = FSQEncoder(D, tuple(cfg.fsq_levels), dtype)
        else:
            self.vq = VectorQuantizer(D, cfg.codebook_size, commit=cfg.vq_commit)

    @property
    def codebook_size(self) -> int:
        return self.cfg.effective_codebook_size()

    def extract_hubert(self, wav: torch.Tensor, conv_feats=None, wav_len=None) -> torch.Tensor:
        """Frozen HuBERT hidden layer ``cfg.hubert_layer`` (9), clamped to the
        encoder's depth.  ``conv_feats`` replaces the conv frontend's output
        (a test's injection point); ``wav_len`` makes zero-padded inputs exact
        (see ``HubertEncoder.forward``)."""
        layer = min(self.cfg.hubert_layer, self.hubert_cfg.num_layers)
        with torch.no_grad():
            return self.hubert.extract_layer(wav, layer, conv_feats=conv_feats,
                                             wav_len=wav_len)

    def _project(self, h: torch.Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = self.proj_ln(F.gelu(self.proj_fc1(h)))
        if self.use_dropout:
            z = dropout(z, self.cfg.dropout, train, generator)
        return self.proj_fc2(z)

    def _quantize(self, z: torch.Tensor, train: bool,
                  generator: Optional[torch.Generator] = None):
        if self.cfg.use_fsq:
            return self.vq(z)
        return self.vq(z, train=train, generator=generator)

    def forward(self, wav: torch.Tensor, train: bool = False, wav_len=None, conv_feats=None,
                generator: Optional[torch.Generator] = None):
        """``wav_len`` (true sample count) makes zero-padded inputs exact, and
        zeroes the quantized features and indices at padded frames (the
        projection of a zeroed hidden state is not zero).  ``conv_feats``
        replaces the conv frontend's output (a test's injection point,
        computed with the same ``wav_len``).  ``train`` is the JAX package's
        ``train=True, deterministic=False``."""
        h = self.extract_hubert(wav, conv_feats=conv_feats, wav_len=wav_len)
        out = self._quantize(self._project(h, train, generator), train, generator)
        if wav_len is None:
            return out
        n_valid = self.hubert_cfg.num_frames(torch.as_tensor(wav_len))
        mask = valid_mask(h.shape[1], n_valid, h.device)
        z_q, idx, vq_loss, ppl, used = out
        return (torch.where(mask[:, :, None], z_q, 0.0), torch.where(mask, idx, 0),
                vq_loss, ppl, used)

    def from_features(self, feats: torch.Tensor, train: bool = False,
                      generator: Optional[torch.Generator] = None):
        """Precomputed HuBERT features [B, S, hidden] -> the same 5-tuple."""
        return self._quantize(self._project(feats, train, generator), train, generator)

    def encode(self, wav: torch.Tensor, conv_feats=None) -> torch.Tensor:
        """wav -> discrete token indices [B, S]."""
        return self.vq.encode(self._project(self.extract_hubert(wav, conv_feats=conv_feats)))

    def decode_tokens(self, idx: torch.Tensor) -> torch.Tensor:
        """token indices -> continuous semantic features."""
        return self.vq.decode(idx)


def is_hubert_param(name: str) -> bool:
    """True for a parameter name of the frozen HuBERT (``hubert.`` sub-module)."""
    return "hubert" in name.split(".")
