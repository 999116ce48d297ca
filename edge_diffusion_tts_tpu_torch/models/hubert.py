"""HuBERT-base speech encoder (counterpart of ``edge_diffusion_tts_tpu/models/hubert.py``).

The architecture of facebook/hubert-base-ls960 (feat_extract_norm="group",
post-LN encoder)::

  wav [B, T] ->
    7x strided Conv1d feature extractor (GroupNorm on the first layer) ->
    LayerNorm + Linear(512->768) feature projection ->
    grouped positional conv (k=128, groups=16) added in ->
    LayerNorm -> 12 post-LN transformer layers (12 heads, FFN 3072, GELU)

``hidden_states[i]`` follows the HF indexing: 0 is the encoder input (after
the positional conv and LayerNorm), i the output of layer i.

Parameter names follow the state dict of transformers' ``HubertModel``
(``feature_extractor.conv_layers.{i}.conv.weight``, ``encoder.layers.{i}.
attention.q_proj.weight`` ...), with the positional conv's weight norm
materialized into a plain ``weight``; ``weights.hubert_state_dict_from_hf``
turns an HF state dict into this module's.  Attention and the dense layers
are plain tensor ops.  The conv feature extractor has a CUDA kernel
(``ops/fused_frontend.py``) that ``conv_feats`` takes the output of.

``dtype`` is the compute dtype, as the JAX module's: with bfloat16 the wav
is cast to bf16 before conv0 and every layer computes in bf16, but for the
spots JAX keeps in float32: the masked GroupNorm's statistics, the attention
logits and softmax, and the LayerNorms' statistics.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers.dtypes import Conv1d, LayerNorm, Linear, cast

MASK_LOGIT = -1e30  # padded keys' logit: exp underflows to exactly 0 in float32


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    """Architecture hyperparameters (defaults = hubert-base-ls960)."""

    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @property
    def total_stride(self) -> int:
        """Samples per output latent (320 for hubert-base: 20 ms at 16 kHz)."""
        return int(np.prod(self.conv_stride))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "HubertConfig":
        d = json.loads(s)
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

    @classmethod
    def tiny(cls) -> "HubertConfig":
        """Small config for tests (total stride 20, not the real 320)."""
        return cls(
            conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        )

    @classmethod
    def tiny320(cls) -> "HubertConfig":
        """Small config with the real 320-sample total stride."""
        return cls(
            conv_dim=(16, 16, 16, 16, 16), conv_kernel=(10, 4, 4, 2, 2),
            conv_stride=(5, 4, 4, 2, 2),
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        )


def conv_frame_lengths(cfg: HubertConfig, length) -> list:
    """Valid frame count after each conv layer for a true sample ``length``
    (int or integer tensor); the last entry is what the transformer sees."""
    out = []
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        length = (length - k) // s + 1
        out.append(length)
    return out


def valid_mask(n: int, lengths, device) -> torch.Tensor:
    """[B, n] bool: position < that row's length."""
    lengths = torch.as_tensor(lengths, device=device).reshape(-1, 1)
    return torch.arange(n, device=device)[None, :] < lengths


class MaskedGroupNorm(nn.Module):
    """Per-channel norm over time (GroupNorm with one group per channel) whose
    statistics, given ``length``, cover only each row's true frames, so a
    zero-padded batch is normalized as its unpadded rows.  Input [B, C, T];
    computed in float32, the output at ``dtype``."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, length=None) -> torch.Tensor:
        x = x.float()
        if length is None:
            mean = x.mean(2, keepdim=True)
            var = (x - mean).square().mean(2, keepdim=True)
        else:
            m = valid_mask(x.shape[2], length, x.device)[:, None, :].float()
            cnt = m.sum(2, keepdim=True).clamp(min=1.0)
            mean = (x * m).sum(2, keepdim=True) / cnt
            var = ((x - mean).square() * m).sum(2, keepdim=True) / cnt
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return cast(y * self.weight[None, :, None] + self.bias[None, :, None], self.dtype)


class ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, s: int, norm: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv1d(c_in, c_out, k, stride=s, bias=False, compute_dtype=dtype)
        if norm:
            self.layer_norm = MaskedGroupNorm(c_out, dtype=dtype)


class FeatureExtractor(nn.Module):
    """Strided conv stack: wav [B, T] -> features [B, frames, conv_dim[-1]].

    ``wav_len`` (true sample count, int or [B]) makes the GroupNorm ignore
    zero-padded tail samples; every conv is VALID, so frames inside the true
    length then equal an exact-length forward's."""

    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.cfg, self.dtype = cfg, dtype
        self.conv_layers = nn.ModuleList(
            ConvLayer(dims[i], dims[i + 1], k, s, norm=i == 0, dtype=dtype)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride))
        )

    def forward(self, wav: torch.Tensor, wav_len=None) -> torch.Tensor:
        x = cast(wav[:, None, :].float(), self.dtype)
        for i, layer in enumerate(self.conv_layers):
            x = layer.conv(x)
            if i == 0:
                length = None if wav_len is None else conv_frame_lengths(
                    self.cfg, torch.as_tensor(wav_len, device=x.device))[0]
                x = layer.layer_norm(x, length)
            x = F.gelu(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps,
                                    compute_dtype=dtype)
        self.projection = Linear(cfg.conv_dim[-1], cfg.hidden_size, compute_dtype=dtype)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(feats))


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding; an even kernel trims its last frame."""

    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                           groups=cfg.num_conv_pos_embedding_groups, compute_dtype=dtype)
        self.trim = k % 2 == 0

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        y = self.conv(h.transpose(1, 2))
        if self.trim:
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention; the logits and softmax in float32 whatever
    the compute dtype (JAX's ``preferred_element_type=float32``)."""

    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        H = cfg.hidden_size
        self.head_dim = H // cfg.num_heads
        self.q_proj = Linear(H, H, compute_dtype=dtype)
        self.k_proj = Linear(H, H, compute_dtype=dtype)
        self.v_proj = Linear(H, H, compute_dtype=dtype)
        self.out_proj = Linear(H, H, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        # The head count follows q_proj's rows, so a tensor-parallel rank
        # holding a slice of them runs its own heads (parallel/tensor_parallel.py).
        B, T, _ = x.shape
        dh = self.head_dim

        def split(t):
            return t.reshape(B, T, -1, dh).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        f32 = torch.float32
        logits = (cast(q, f32) @ cast(k, f32).transpose(-1, -2)) * dh ** -0.5
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :], MASK_LOGIT)
        attn = cast(torch.softmax(logits, dim=-1), v.dtype) @ v
        return self.out_proj(attn.transpose(1, 2).reshape(B, T, -1))


class FeedForward(nn.Module):
    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size,
                                         compute_dtype=dtype)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Post-LN transformer layer: MHA -> +res -> LN -> FFN -> +res -> LN."""

    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.attention = Attention(cfg, dtype)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=eps, compute_dtype=dtype)
        self.feed_forward = FeedForward(cfg, dtype)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=eps, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        x = self.layer_norm(x + self.attention(x, key_mask))
        return self.final_layer_norm(x + self.feed_forward(x))


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg, dtype)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, compute_dtype=dtype)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype) for _ in range(cfg.num_layers))


class HubertEncoder(nn.Module):
    """Full HuBERT; ``forward`` returns the hidden states (HF indices)."""

    def __init__(self, cfg: HubertConfig = HubertConfig(), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.feature_extractor = FeatureExtractor(cfg, dtype)
        self.feature_projection = FeatureProjection(cfg, dtype)
        self.encoder = TransformerEncoder(cfg, dtype)

    def forward(
        self,
        wav: torch.Tensor,
        conv_feats: Optional[torch.Tensor] = None,
        wav_len=None,
        num_layers: Optional[int] = None,
    ) -> List[torch.Tensor]:
        """``conv_feats`` [B, frames, conv_dim[-1]] replaces the conv feature
        extractor's output (the frontend kernel's route).  ``wav_len`` (true
        sample count, int or [B]) makes a zero-padded forward exact up to
        summation order: masked GroupNorm statistics, padded positions
        zeroed before the positional conv, padded keys masked out of every
        softmax, and padded frames zeroed in every returned hidden state.
        ``num_layers`` stops after that many layers (default: all)."""
        feats = conv_feats if conv_feats is not None else self.feature_extractor(
            wav, wav_len=wav_len)
        frame_mask = None
        if wav_len is not None:
            n_valid = conv_frame_lengths(self.cfg, torch.as_tensor(wav_len))[-1]
            frame_mask = valid_mask(feats.shape[1], n_valid, feats.device)

        def finalize(x):
            return x if frame_mask is None else torch.where(frame_mask[:, :, None], x, 0.0)

        h = self.feature_projection(feats)
        if frame_mask is not None:
            h = finalize(h)
        enc = self.encoder
        h = enc.layer_norm(h + enc.pos_conv_embed(h))
        hidden_states = [finalize(h)]
        n = self.cfg.num_layers if num_layers is None else num_layers
        for layer in enc.layers[:n]:
            h = layer(h, key_mask=frame_mask)
            hidden_states.append(finalize(h))
        return hidden_states

    def extract_layer(self, wav: torch.Tensor, layer: int,
                      conv_feats: Optional[torch.Tensor] = None, wav_len=None):
        """Hidden state at HF index ``layer`` (9 = the standard semantic layer);
        the layers above it are not run."""
        return self(wav, conv_feats=conv_feats, wav_len=wav_len, num_layers=layer)[layer]
