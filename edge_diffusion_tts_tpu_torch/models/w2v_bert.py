"""w2v-BERT 2.0 as the frozen speech encoder: a Conformer stack on a
filterbank frontend (the JAX package has no such encoder).

facebook/w2v-bert-2.0 (Seamless, arXiv:2312.05187; transformers'
``Wav2Vec2BertModel`` with ``position_embeddings_type="relative_key"``)::

  wav [B, N] ->
    the filterbank (ops/fbank.py: 80 log-mel bins a 10 ms frame, normalized
      per utterance, pairs stacked to [B, S, 160] at 50 Hz) ->
    LayerNorm(160) + Linear(160 -> 1024) ->
    24 Conformer layers (16 heads of 64, FFN 4096, swish, eps 1e-5):
      x = x + 0.5 FFN1(LN(x))
      x = x + MHSA(LN(x))        q, k, v, out Linears with bias
      x = x + ConvModule(x)      LN -> pointwise 1024 -> 2048 (no bias) -> GLU
                                 -> depthwise k=31, left-padded 30 (causal,
                                 no bias) -> LN -> swish -> pointwise 1024
      x = x + 0.5 FFN2(LN(x))
      x = LN(x)
    and no positional conv and no LayerNorm after the last layer.

The attention's position term is a table read by the query:
``z[b, h, i, j] = (q_i . k_j + q_i . E[clamp(j - i, -64, 8) + 64]) / 8``,
``E`` the layer's ``distance_embedding`` [73, 64], shared by the heads.  q,
k and v come from one GEMM (``RelKeyAttention.packed_input``); on the card
at bfloat16 with no key mask the attention is one kernel a layer
(``ops/relpos_attention.py::relkey_attention16``), which never forms the
[B, heads, S, S] scores nor the [S, S, 64] table, and elsewhere
``relkey_attention``'s tensor ops.

``hidden_states[i]`` follows the HF indexing: 0 is the feature projection's
output, i the output of layer i (after its own final LayerNorm).  Parameter
names are those of transformers' ``Wav2Vec2BertModel`` state dict
(``feature_projection.layer_norm.weight``, ``encoder.layers.{i}.ffn1.
intermediate_dense.weight``, ``...self_attn.distance_embedding.weight``,
``...conv_module.depthwise_conv.weight`` ...): an HF state dict loads as it
is, less ``masked_spec_embed`` and the layers the encoder was not built
with (``weights.w2v_bert_state_dict_from_hf``).

``dtype`` is the compute dtype: with bfloat16 every layer from the feature
projection on computes in bf16, but for the filterbank, the LayerNorms'
statistics and the attention's logits and softmax, which stay float32.
``wav_len`` makes a zero-padded batch exact: each row's filterbank is
normalized over its own frames, padded keys are masked, the conv module's
input is zeroed at padded frames (as transformers does), and padded frames
are zeroed in every returned hidden state.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.dtypes import Conv1d, LayerNorm, Linear, cast
from ..ops.fbank import HOP, fbank, stacked_count
from ..utils.speed import span
from .hubert import MASK_LOGIT, valid_mask

ARCHITECTURE = "w2v-bert"  # the ``architecture`` key of a saved configuration


@dataclasses.dataclass(frozen=True)
class W2vBertConfig:
    """Architecture hyperparameters (defaults = facebook/w2v-bert-2.0:
    transformers' ``Wav2Vec2BertConfig`` and ``SeamlessM4TFeatureExtractor``
    defaults)."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_depthwise_kernel_size: int = 31
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    feature_projection_input_dim: int = 160
    layer_norm_eps: float = 1e-5
    num_mel_bins: int = 80
    stride: int = 2  # frames stacked into one position

    def __post_init__(self):
        if self.feature_projection_input_dim != self.stride * self.num_mel_bins:
            raise ValueError(f"feature_projection_input_dim {self.feature_projection_input_dim}"
                             f" != stride {self.stride} x {self.num_mel_bins} mel bins")
        if self.conv_depthwise_kernel_size % 2 == 0:
            raise ValueError("conv_depthwise_kernel_size must be odd, as transformers' is")

    @property
    def total_stride(self) -> int:
        """Samples a position advances (320: 20 ms at 16 kHz)."""
        return HOP * self.stride

    def num_frames(self, samples):
        """Positions the encoder gives for ``samples`` (int or integer
        tensor): (1 + (N - 400) // 160) // stride, 49 at 1 s."""
        return stacked_count(samples, self.stride)

    def to_json(self) -> str:
        return json.dumps(dict(architecture=ARCHITECTURE, **dataclasses.asdict(self)), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "W2vBertConfig":
        d = json.loads(s)
        if d.pop("architecture", None) != ARCHITECTURE:
            raise ValueError(f"not a {ARCHITECTURE} configuration")
        return cls(**d)

    @classmethod
    def tiny(cls) -> "W2vBertConfig":
        """Small config for tests: width 64, 2 layers of 4 heads, FFN 128, the
        published kernel, clamp window and filterbank."""
        return cls(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)


class PointwiseConv(nn.Module):
    """A kernel-1 Conv1d without bias (its ``weight`` [out, in, 1], as
    transformers stores it) applied along the last axis of [B, S, in] at
    ``compute_dtype``: a Linear."""

    def __init__(self, c_in: int, c_out: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in, 1))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(self.weight[..., 0], dt))


class FeedForward(nn.Module):
    def __init__(self, cfg: W2vBertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size,
                                         compute_dtype=dtype)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.silu(self.intermediate_dense(x)))


class ConvModule(nn.Module):
    """LN -> pointwise to 2C -> GLU -> causal depthwise conv -> LN -> swish ->
    pointwise; ``frame_mask`` [B, S] zeroes the padded frames of its normed
    input."""

    def __init__(self, cfg: W2vBertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        C, k, eps = cfg.hidden_size, cfg.conv_depthwise_kernel_size, cfg.layer_norm_eps
        self.layer_norm = LayerNorm(C, eps=eps, compute_dtype=dtype)
        self.pointwise_conv1 = PointwiseConv(C, 2 * C, dtype)
        self.depthwise_conv = Conv1d(C, C, k, groups=C, bias=False, compute_dtype=dtype)
        self.depthwise_layer_norm = LayerNorm(C, eps=eps, compute_dtype=dtype)
        self.pointwise_conv2 = PointwiseConv(C, C, dtype)

    def forward(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor] = None):
        if x.is_cuda:  # a float32 depthwise conv in full float32, as layers/conv.py's
            torch.backends.cudnn.allow_tf32 = False
        h = self.layer_norm(x)
        if frame_mask is not None:
            h = torch.where(frame_mask[:, :, None], h, 0.0)
        h = F.glu(self.pointwise_conv1(h), dim=-1)
        k = self.depthwise_conv.kernel_size[0]
        h = self.depthwise_conv(F.pad(h.transpose(1, 2), (k - 1, 0))).transpose(1, 2)
        return self.pointwise_conv2(F.silu(self.depthwise_layer_norm(h)))


class RelKeyAttention(nn.Module):
    """Multi-head self-attention with the relative-key position term (the
    module's note); the logits and softmax in float32 whatever the compute
    dtype."""

    def __init__(self, cfg: W2vBertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        H = cfg.hidden_size
        self.head_dim = H // cfg.num_heads
        self.left = cfg.left_max_position_embeddings
        self.linear_q = Linear(H, H, compute_dtype=dtype)
        self.linear_k = Linear(H, H, compute_dtype=dtype)
        self.linear_v = Linear(H, H, compute_dtype=dtype)
        self.linear_out = Linear(H, H, compute_dtype=dtype)
        self.distance_embedding = nn.Embedding(
            cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1,
            self.head_dim)

    def packed_input(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, 3 H] at the compute dtype: q, k and v from one GEMM."""
        dt = self.linear_q.compute_dtype
        w = torch.cat([self.linear_q.weight, self.linear_k.weight, self.linear_v.weight])
        b = torch.cat([self.linear_q.bias, self.linear_k.bias, self.linear_v.bias])
        return F.linear(cast(x, dt), cast(w, dt), cast(b, dt))

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        y = self.packed_input(x)
        E = cast(self.distance_embedding.weight, self.linear_q.compute_dtype)
        if relkey_kernel_serves(x, key_mask, self.head_dim, E.shape[0]):
            from ..ops.relpos_attention import relkey_attention16

            return self.linear_out(relkey_attention16(y, E, self.left))
        return self.linear_out(relkey_attention(y, E, self.left, key_mask))


def relkey_attention(y: torch.Tensor, E: torch.Tensor, left: int,
                     key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The relative-key attention's plain route on a layer's packed
    projections ``y`` [B, S, 3 H] (``packed_input``) and distance table ``E``
    [left + right + 1, head_dim] at ``y``'s dtype: ``q . k`` and ``q . E``
    summed in float32, their sum scaled, the softmax in float32, P rounded
    to ``y``'s dtype before it weights v; the heads' outputs [B, S, H]
    before ``linear_out``."""
    B, S, width = y.shape
    H, dh = width // 3, E.shape[1]
    heads = H // dh
    q, k, v = (y[..., n * H:(n + 1) * H].reshape(B, S, heads, dh).transpose(1, 2)
               for n in range(3))
    f32 = torch.float32
    qf = cast(q, f32)
    pos = torch.arange(S, device=y.device)
    d = torch.clamp(pos[None, :] - pos[:, None], -left, E.shape[0] - 1 - left) + left
    qe = qf @ cast(E, f32).t()  # [B, heads, S, rows of E]
    logits = qf @ cast(k, f32).transpose(-1, -2) + torch.gather(qe, -1, d.expand(B, heads, S, S))
    logits = logits * dh ** -0.5
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], MASK_LOGIT)
    attn = cast(torch.softmax(logits, dim=-1), v.dtype) @ v
    return attn.transpose(1, 2).reshape(B, S, H)


def relkey_kernel_serves(x: torch.Tensor, key_mask, head_dim: int, rows: int) -> bool:
    """Whether the relative-key attention takes the bf16 kernel: bf16 CUDA
    input with no key mask (a masked call takes the plain route), head dim
    64, a distance table of at most 80 rows and no gradient to carry."""
    from ..ops.relpos_attention import RELKEY_MAX_ROWS

    return (x.is_cuda and x.dtype == torch.bfloat16 and key_mask is None and head_dim == 64
            and rows <= RELKEY_MAX_ROWS and not (torch.is_grad_enabled() and x.requires_grad))


class ConformerLayer(nn.Module):
    """Macaron FFN half-step, attention, conv module, FFN half-step, LN."""

    def __init__(self, cfg: W2vBertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ffn1_layer_norm = LayerNorm(H, eps=eps, compute_dtype=dtype)
        self.ffn1 = FeedForward(cfg, dtype)
        self.self_attn_layer_norm = LayerNorm(H, eps=eps, compute_dtype=dtype)
        self.self_attn = RelKeyAttention(cfg, dtype)
        self.conv_module = ConvModule(cfg, dtype)
        self.ffn2_layer_norm = LayerNorm(H, eps=eps, compute_dtype=dtype)
        self.ffn2 = FeedForward(cfg, dtype)
        self.final_layer_norm = LayerNorm(H, eps=eps, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask`` [B, S] (True at a row's own frames) masks padded keys and
        zeroes the conv module's padded input."""
        x = x + 0.5 * self.ffn1(self.ffn1_layer_norm(x))
        x = x + self.self_attn(self.self_attn_layer_norm(x), mask)
        x = x + self.conv_module(x, mask)
        x = x + 0.5 * self.ffn2(self.ffn2_layer_norm(x))
        return self.final_layer_norm(x)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: W2vBertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        D = cfg.feature_projection_input_dim
        self.layer_norm = LayerNorm(D, eps=cfg.layer_norm_eps, compute_dtype=dtype)
        self.projection = Linear(D, cfg.hidden_size, compute_dtype=dtype)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(feats))


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: W2vBertConfig, dtype: torch.dtype, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(ConformerLayer(cfg, dtype) for _ in range(num_layers))


class W2vBertEncoder(nn.Module):
    """w2v-BERT 2.0 to ``num_layers`` layers (default: all of ``cfg``'s);
    ``forward`` returns the hidden states (HF indices), ``extract_layer``
    one of them: ``HubertEncoder``'s interface (models/hubert.py)."""

    def __init__(self, cfg: W2vBertConfig = W2vBertConfig(), dtype: torch.dtype = torch.float32,
                 num_layers: Optional[int] = None):
        super().__init__()
        n = cfg.num_layers if num_layers is None else num_layers
        if not 0 <= n <= cfg.num_layers:
            raise ValueError(f"{n} layers of w2v-BERT's {cfg.num_layers}")
        self.cfg, self.dtype = cfg, dtype
        self.feature_projection = FeatureProjection(cfg, dtype)
        self.encoder = ConformerEncoder(cfg, dtype, n)

    def pack_frontend(self, *_) -> None:
        """Nothing to pack: the filterbank has no weights (``HubertEncoder``'s
        interface)."""

    def features(self, wav: torch.Tensor, wav_len=None) -> torch.Tensor:
        """wav [B, N] -> the filterbank's stacked features [B, S, 160], float32."""
        with span("prep:fbank"):
            return fbank(wav, wav_len, self.cfg.num_mel_bins, self.cfg.stride)

    def forward(self, wav: torch.Tensor, conv_feats: Optional[torch.Tensor] = None,
                wav_len=None, num_layers: Optional[int] = None) -> List[torch.Tensor]:
        """``conv_feats`` [B, S, 160] replaces the filterbank's output (a
        test's injection point); ``wav_len`` as the module says;
        ``num_layers`` stops after that many layers (default: all built)."""
        feats = conv_feats if conv_feats is not None else self.features(wav, wav_len)
        mask = None
        if wav_len is not None:
            n_valid = self.cfg.num_frames(torch.as_tensor(wav_len, device=feats.device))
            mask = valid_mask(feats.shape[1], n_valid, feats.device)

        def finalize(x):
            return x if mask is None else torch.where(mask[:, :, None], x, 0.0)

        h = finalize(self.feature_projection(feats))
        hidden_states = [h]
        layers = self.encoder.layers
        n = len(layers) if num_layers is None else num_layers
        if n > len(layers):
            raise ValueError(f"{n} layers asked of an encoder built with {len(layers)}")
        with span("prep:encoder_layers"):
            for layer in layers[:n]:
                h = layer(h, mask)
                hidden_states.append(finalize(h))
        return hidden_states

    def extract_layer(self, wav: torch.Tensor, layer: int,
                      conv_feats: Optional[torch.Tensor] = None, wav_len=None):
        """Hidden state at HF index ``layer`` (17: MaskGCT's and IndexTTS2's
        semantic layer); the layers above it are not run."""
        return self(wav, conv_feats=conv_feats, wav_len=wav_len, num_layers=layer)[layer]
