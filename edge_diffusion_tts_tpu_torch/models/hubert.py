"""The frozen speech encoder: HuBERT-base, and WavLM-Large (counterpart of
``edge_diffusion_tts_tpu/models/hubert.py``, which has HuBERT-base alone).

The architecture of facebook/hubert-base-ls960 (feat_extract_norm="group",
post-LN encoder)::

  wav [B, T] ->
    7x strided Conv1d feature extractor (GroupNorm on the first layer) ->
    LayerNorm + Linear(512->768) feature projection ->
    grouped positional conv (k=128, groups=16) added in ->
    LayerNorm -> 12 post-LN transformer layers (12 heads, FFN 3072, GELU)

and that of microsoft/wavlm-large (``HubertConfig.wavlm_large()``: Chen et
al. 2022, arXiv:2110.13900; transformers' ``WavLMModel`` with
``do_stable_layer_norm`` and ``feat_extract_norm="layer"``)::

  wav [B, T] ->
    7x strided Conv1d, no bias, each followed by a LayerNorm over channels ->
    LayerNorm + Linear(512->1024) -> positional conv (k=128, groups=16) added
    in, no LayerNorm -> 24 pre-LN layers (16 heads of 64, FFN 4096) with
    the gated relative-position attention -> a final LayerNorm

The relative-position attention adds ``gate[b, h, i] * r[h, j - i]`` to the
scaled logits: ``r`` is layer 0's ``rel_attn_embed`` [320 buckets, heads]
read through a log-bucket map of the offset (``relative_buckets``), built
once a call as a per-head vector over the 2S - 1 offsets and shared by every
layer; each layer's gate comes from that head's slice of its normed input:
``gru_rel_pos_linear`` (head_dim -> 8), the sums of its two groups of 4,
sigmoids a and b, ``a * (b * gru_rel_pos_const[h] - 1) + 2``.  q, k, v and
the gate projections come from one GEMM (``Attention.packed_input``); on the
card at bfloat16 the attention is then one kernel a layer
(``ops/relpos_attention.py``), which never forms the [B, heads, S, S] bias,
and elsewhere ``gated_attention``'s tensor ops.

``hidden_states[i]`` follows the HF indexing: 0 is the encoder input (after
the positional conv, and for post-LN its LayerNorm), i the output of layer
i; with stable (pre-LN) layers the last layer's output also passes the
final LayerNorm, and no other does.

Parameter names follow the state dict of transformers' ``HubertModel``
(``feature_extractor.conv_layers.{i}.conv.weight``, ``encoder.layers.{i}.
attention.q_proj.weight`` ...), with the positional conv's weight norm
materialized into a plain ``weight``; ``weights.hubert_state_dict_from_hf``
turns an HF state dict into this module's.  Attention and the dense layers
are plain tensor ops.

The encoder owns its conv frontend's route, and no caller decides it:
where the conv-frontend kernel (``ops/fused_frontend.py``) takes the stack
at the encoder's dtype (``kernel_serves``: hubert-base's stack, and a
LayerNorm stack such as WavLM's at bfloat16 only), ``HubertEncoder`` keeps
the stack's weights packed for that kernel and runs its frontend on it
(on a CPU, its plain version); any other stack runs ``FeatureExtractor``.
It owns the positional conv's route the same way: at float32, with 48 or
64 channels a group (``ops/pos_conv.py``'s ``kernel_serves``), the conv,
its GELU and the residual add are one launch of the positional-conv kernel
(on a CPU, its plain version); anywhere else ``PositionalConvEmbedding``.

``dtype`` is the compute dtype, as the JAX module's: with bfloat16 the wav
is cast to bf16 before conv0 and every layer computes in bf16, but for the
spots JAX keeps in float32: the masked GroupNorm's statistics, the attention
logits and softmax, and the LayerNorms' statistics.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers.dtypes import Conv1d, LayerNorm, Linear, cast
from ..utils.speed import span

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
    # The architecture's own switches (hubert-base's values by default):
    # the conv stack's norm, "group" (conv0 alone) or "layer" (every conv);
    # pre-LN layers (transformers' do_stable_layer_norm); and the gated
    # relative-position attention's buckets and distance, 0 for none.
    feat_extract_norm: str = "group"
    do_stable_layer_norm: bool = False
    num_buckets: int = 0
    max_bucket_distance: int = 0

    def __post_init__(self):
        if self.feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm {self.feat_extract_norm!r}: 'group' or 'layer'")

    @property
    def total_stride(self) -> int:
        """Samples per output latent (320 for hubert-base: 20 ms at 16 kHz)."""
        return int(np.prod(self.conv_stride))

    def num_frames(self, samples):
        """Frames the encoder gives for ``samples`` (int or integer tensor):
        the conv stack's last valid length."""
        return conv_frame_lengths(self, samples)[-1]

    def to_json(self) -> str:
        """The fields as JSON; the architecture's switches only where they
        differ from hubert-base's, so that a hubert-base file is the one the
        JAX package reads."""
        d, base = dataclasses.asdict(self), dataclasses.asdict(HubertConfig())
        for k in SWITCHES:
            if d[k] == base[k]:
                del d[k]
        return json.dumps(d, indent=2)

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

    @classmethod
    def wavlm_large(cls) -> "HubertConfig":
        """microsoft/wavlm-large at its published widths (transformers'
        ``WavLMConfig`` defaults for the buckets)."""
        return cls(
            hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
            feat_extract_norm="layer", do_stable_layer_norm=True,
            num_buckets=320, max_bucket_distance=800,
        )


SWITCHES = ("feat_extract_norm", "do_stable_layer_norm", "num_buckets", "max_bucket_distance")

def _w2v_bert_2():
    from .w2v_bert import W2vBertConfig

    return W2vBertConfig()


# The encoders a configuration's ``hubert_id`` names.
HUBERT_IDS = {
    "facebook/hubert-base-ls960": HubertConfig,
    "microsoft/wavlm-large": HubertConfig.wavlm_large,
    "facebook/w2v-bert-2.0": _w2v_bert_2,
}


def hubert_config_for(hubert_id: str):
    """The architecture of the encoder ``hubert_id`` names (``CFG.hubert_id``):
    a ``HubertConfig``, or for w2v-BERT 2.0 a ``W2vBertConfig``
    (models/w2v_bert.py); an id the port does not know raises."""
    if hubert_id not in HUBERT_IDS:
        raise ValueError(f"hubert_id {hubert_id!r}: the port knows {sorted(HUBERT_IDS)}")
    return HUBERT_IDS[hubert_id]()


def encoder_config_from_json(s: str):
    """The encoder architecture a checkpoint's ``hubert.json`` holds: a
    ``W2vBertConfig`` where the file names that architecture, else a
    ``HubertConfig``."""
    from .w2v_bert import ARCHITECTURE, W2vBertConfig

    if json.loads(s).get("architecture") == ARCHITECTURE:
        return W2vBertConfig.from_json(s)
    return HubertConfig.from_json(s)


def relative_buckets(offsets: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """WavLM's bucket of each key - query offset (transformers'
    ``WavLMAttention._relative_positions_bucket``): half the buckets for
    keys after the query, exact up to a quarter of the buckets, then
    logarithmic up to ``max_distance``."""
    half = num_buckets // 2
    exact = half // 2
    n = offsets.abs()
    large = torch.log(n.float() / exact) / math.log(max_distance / exact) * (half - exact)
    large = torch.clamp_max((exact + large).to(torch.long), half - 1)
    return (offsets > 0).to(torch.long) * half + torch.where(n < exact, n, large)


def relative_bias(rel: torch.Tensor, S: int) -> torch.Tensor:
    """The per-head offset vector ``rel`` [heads, 2S - 1] (offset j - i at
    index j - i + S - 1) as the [heads, S, S] bias of S positions."""
    pos = torch.arange(S, device=rel.device)
    return rel[:, pos[None, :] - pos[:, None] + S - 1]


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
    """A conv of the stack and its norm: ``"group"`` (conv0's masked
    GroupNorm), ``"layer"`` (a LayerNorm over channels, eps 1e-5) or None."""

    def __init__(self, c_in: int, c_out: int, k: int, s: int, norm: Optional[str],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = norm
        self.conv = Conv1d(c_in, c_out, k, stride=s, bias=False, compute_dtype=dtype)
        if norm == "group":
            self.layer_norm = MaskedGroupNorm(c_out, dtype=dtype)
        elif norm == "layer":
            self.layer_norm = LayerNorm(c_out, eps=1e-5, compute_dtype=dtype)


class FeatureExtractor(nn.Module):
    """Strided conv stack: wav [B, T] -> features [B, frames, conv_dim[-1]].

    ``wav_len`` (true sample count, int or [B]) makes the GroupNorm ignore
    zero-padded tail samples; every conv is VALID and a LayerNorm over
    channels sees one frame, so frames inside the true length then equal an
    exact-length forward's."""

    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.cfg, self.dtype = cfg, dtype
        layer_norm = cfg.feat_extract_norm == "layer"
        self.conv_layers = nn.ModuleList(
            ConvLayer(dims[i], dims[i + 1], k, s,
                      norm="layer" if layer_norm else ("group" if i == 0 else None),
                      dtype=dtype)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride))
        )

    def forward(self, wav: torch.Tensor, wav_len=None) -> torch.Tensor:
        x = cast(wav[:, None, :].float(), self.dtype)
        for i, layer in enumerate(self.conv_layers):
            x = layer.conv(x)
            if layer.norm == "group":
                length = None if wav_len is None else conv_frame_lengths(
                    self.cfg, torch.as_tensor(wav_len, device=x.device))[i]
                x = layer.layer_norm(x, length)
            elif layer.norm == "layer":
                x = layer.layer_norm(x.transpose(1, 2)).transpose(1, 2)
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
    the compute dtype (JAX's ``preferred_element_type=float32``).

    With ``cfg.num_buckets`` it is WavLM's gated relative-position
    attention: ``forward`` then takes the call's offset vector ``rel``
    [heads, 2S - 1] (float32) and adds each head's gated bias to the scaled
    logits.  ``has_rel_embed`` (layer 0) holds the bucket table the vector
    is read from."""

    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32,
                 has_rel_embed: bool = False):
        super().__init__()
        H = cfg.hidden_size
        self.head_dim = H // cfg.num_heads
        self.q_proj = Linear(H, H, compute_dtype=dtype)
        self.k_proj = Linear(H, H, compute_dtype=dtype)
        self.v_proj = Linear(H, H, compute_dtype=dtype)
        self.out_proj = Linear(H, H, compute_dtype=dtype)
        if cfg.num_buckets:
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, cfg.num_heads, 1, 1))
            self.gru_rel_pos_linear = Linear(self.head_dim, 8, compute_dtype=dtype)
            if has_rel_embed:
                self.rel_attn_embed = nn.Embedding(cfg.num_buckets, cfg.num_heads)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                rel: Optional[torch.Tensor] = None):
        # The head count follows q_proj's rows, so a tensor-parallel rank
        # holding a slice of them runs its own heads (parallel/tensor_parallel.py).
        B, T, _ = x.shape
        dh = self.head_dim
        if rel is not None:
            y = self.packed_input(x)
            if relpos_kernel_serves(x, key_mask, dh):
                from ..ops.relpos_attention import relpos_attention16

                return self.out_proj(relpos_attention16(y, rel, self.gru_rel_pos_const))
            return self.out_proj(gated_attention(y, rel, self.gru_rel_pos_const, key_mask))

        def split(t):
            return t.reshape(B, T, -1, dh).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        f32 = torch.float32
        logits = (cast(q, f32) @ cast(k, f32).transpose(-1, -2)) * dh ** -0.5
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :], MASK_LOGIT)
        attn = cast(torch.softmax(logits, dim=-1), v.dtype) @ v
        return self.out_proj(attn.transpose(1, 2).reshape(B, T, -1))

    def packed_input(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, 3 H + 8 heads] at the compute dtype: q, k, v and each
        head's 8 gate projections from one GEMM, the gate's [8, head_dim]
        weight set block-diagonally over the heads."""
        dt = self.q_proj.compute_dtype
        heads = self.q_proj.weight.shape[0] // self.head_dim
        g = self.gru_rel_pos_linear
        w = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight,
                       torch.block_diag(*[g.weight] * heads)])
        b = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias,
                       g.bias.repeat(heads)])
        return F.linear(cast(x, dt), cast(w, dt), cast(b, dt))


def gated_attention(y: torch.Tensor, rel: torch.Tensor, const: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gated relative-position attention's plain route on a layer's
    packed projections ``y`` [B, T, 3 H + 8 heads] (``packed_input``; heads
    = ``rel``'s rows): the logits, the gated bias and the softmax in
    float32, P rounded to ``y``'s dtype before it weights v; the heads'
    outputs [B, T, H] before ``out_proj``."""
    heads = rel.shape[0]
    B, T, width = y.shape
    H = (width - 8 * heads) // 3
    dh = H // heads
    q, k, v = (y[..., n * H:(n + 1) * H].reshape(B, T, heads, dh).transpose(1, 2)
               for n in range(3))
    f32 = torch.float32
    logits = (cast(q, f32) @ cast(k, f32).transpose(-1, -2)) * dh ** -0.5
    gate = relpos_gate(y[..., 3 * H:].reshape(B, T, heads, 8), const)  # [B, T, heads]
    logits = logits + gate.transpose(1, 2)[..., None] * relative_bias(rel.float(), T)
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], MASK_LOGIT)
    attn = cast(torch.softmax(logits, dim=-1), v.dtype) @ v
    return attn.transpose(1, 2).reshape(B, T, H)


def relpos_gate(gp: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """WavLM's gate [B, T, heads] (float32) from the gate projections ``gp``
    [B, T, heads, 8]: sigmoids a and b of the sums of its two groups of 4,
    then ``a * (b * const[h] - 1) + 2``."""
    a, b = torch.sigmoid(gp.float().unflatten(-1, (2, 4)).sum(-1)).unbind(-1)
    return a * (b * const.float().reshape(-1) - 1.0) + 2.0


def relpos_kernel_serves(x: torch.Tensor, key_mask, head_dim: int) -> bool:
    """Whether the gated attention takes the bf16 kernel: bf16 CUDA input
    with no key mask (a masked call takes the plain route), head dim 64 and
    no gradient to carry."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and key_mask is None and head_dim == 64
            and not (torch.is_grad_enabled() and x.requires_grad))


class FeedForward(nn.Module):
    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size,
                                         compute_dtype=dtype)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Post-LN transformer layer: MHA -> +res -> LN -> FFN -> +res -> LN;
    with ``stable`` (pre-LN, WavLM-Large's): x + MHA(LN(x)), then x +
    FFN(final LN(x))."""

    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32,
                 has_rel_embed: bool = False):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.stable = cfg.do_stable_layer_norm
        self.attention = Attention(cfg, dtype, has_rel_embed)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=eps, compute_dtype=dtype)
        self.feed_forward = FeedForward(cfg, dtype)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=eps, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                rel: Optional[torch.Tensor] = None):
        if self.stable:
            x = x + self.attention(self.layer_norm(x), key_mask, rel)
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, key_mask, rel))
        return self.final_layer_norm(x + self.feed_forward(x))


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_bucket_distance = cfg.max_bucket_distance
        self.pos_conv_embed = PositionalConvEmbedding(cfg, dtype)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, compute_dtype=dtype)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype, has_rel_embed=i == 0)
                                    for i in range(cfg.num_layers))

    def rel_values(self, S: int, device) -> torch.Tensor:
        """The call's offset vector [heads, 2S - 1] (float32): layer 0's
        bucket table at each offset -(S - 1) .. S - 1."""
        table = self.layers[0].attention.rel_attn_embed.weight
        offsets = torch.arange(-(S - 1), S, device=device)
        buckets = relative_buckets(offsets, table.shape[0], self.max_bucket_distance)
        return table.float()[buckets].t().contiguous()


class HubertEncoder(nn.Module):
    """Full HuBERT; ``forward`` returns the hidden states (HF indices).

    ``frontend_kernel`` is whether the conv-frontend kernel takes ``cfg``'s
    conv stack at ``dtype``.  Where it does, the stack's weights packed for
    it (``pack_frontend_weights``) are non-persistent buffers
    ``frontend_w0`` ... ``frontend_beta``: out of the state dict, moved by
    ``.to()``, seen by ``functional_call``, and packed again, in place, by
    every ``load_state_dict`` (``pack_frontend`` does it after any other
    change to the stack's weights).  ``pos_conv_kernel`` is whether the
    positional-conv kernel takes the positional conv at ``dtype``; where it
    does, the conv's packed weight (``pack_pos_conv_weights``) is such a
    buffer too, ``pos_conv_w``, packed by the same hook."""

    def __init__(self, cfg: HubertConfig = HubertConfig(), dtype: torch.dtype = torch.float32):
        super().__init__()
        from ..ops import fused_frontend as ff
        from ..ops import pos_conv as pc

        self.cfg, self.dtype = cfg, dtype
        self.feature_extractor = FeatureExtractor(cfg, dtype)
        self.feature_projection = FeatureProjection(cfg, dtype)
        self.encoder = TransformerEncoder(cfg, dtype)
        self.frontend_kernel = ff.kernel_serves(cfg, dtype)
        self.pos_conv_kernel = pc.kernel_serves(cfg, dtype)
        if self.frontend_kernel:
            for name, w in ff.pack_frontend_weights(self.feature_extractor, dtype).items():
                self.register_buffer(f"frontend_{name}", w, persistent=False)
        if self.pos_conv_kernel:
            self.register_buffer("pos_conv_w", pc.pack_pos_conv_weights(
                self.encoder.pos_conv_embed.conv.weight), persistent=False)
        if self.frontend_kernel or self.pos_conv_kernel:
            self.register_load_state_dict_post_hook(HubertEncoder.pack_frontend)

    @torch.no_grad()
    def pack_frontend(self, *_) -> None:
        """Pack the conv stack's weights and the positional conv's, as they
        are now, into the kernels' buffers, in place (a holder of the
        buffers sees the new values); also ``load_state_dict``'s post-hook."""
        if self.frontend_kernel:
            from ..ops import fused_frontend as ff

            for name, w in ff.pack_frontend_weights(self.feature_extractor, self.dtype).items():
                getattr(self, f"frontend_{name}").copy_(w)
        if self.pos_conv_kernel:
            from ..ops.pos_conv import pack_pos_conv_weights

            self.pos_conv_w.copy_(pack_pos_conv_weights(self.encoder.pos_conv_embed.conv.weight))

    def conv_features(self, wav: torch.Tensor, wav_len=None) -> torch.Tensor:
        """wav [B, T] -> conv features [B, frames, conv_dim[-1]]: the
        frontend kernel's ``conv_frontend`` at the encoder's dtype where
        ``frontend_kernel``, the modules anywhere else."""
        if not self.frontend_kernel:
            return self.feature_extractor(wav, wav_len=wav_len)
        from ..ops.fused_frontend import conv_frontend

        return conv_frontend(wav.float().contiguous(), self.packed_frontend(), wav_len=wav_len,
                             compute_dtype=self.dtype)

    def packed_frontend(self) -> Dict[str, torch.Tensor]:
        """The frontend buffers by ``pack_frontend_weights``' names (where
        ``frontend_kernel``)."""
        from ..ops.fused_frontend import FRONTEND_NAMES

        return {name: getattr(self, f"frontend_{name}") for name in FRONTEND_NAMES}

    def forward(
        self,
        wav: torch.Tensor,
        conv_feats: Optional[torch.Tensor] = None,
        wav_len=None,
        num_layers: Optional[int] = None,
    ) -> List[torch.Tensor]:
        """``conv_feats`` [B, frames, conv_dim[-1]] replaces
        ``conv_features``' output (a test's injection point).  ``wav_len`` (true
        sample count, int or [B]) makes a zero-padded forward exact up to
        summation order: masked GroupNorm statistics, padded positions
        zeroed before the positional conv, padded keys masked out of every
        softmax, and padded frames zeroed in every returned hidden state.
        ``num_layers`` stops after that many layers (default: all)."""
        feats = conv_feats if conv_feats is not None else self.conv_features(wav, wav_len)
        frame_mask = None
        if wav_len is not None:
            n_valid = conv_frame_lengths(self.cfg, torch.as_tensor(wav_len))[-1]
            frame_mask = valid_mask(feats.shape[1], n_valid, feats.device)

        def finalize(x):
            return x if frame_mask is None else torch.where(frame_mask[:, :, None], x, 0.0)

        h = self.feature_projection(feats)
        if frame_mask is not None:
            h = finalize(h)
        enc, cfg = self.encoder, self.cfg
        if self.pos_conv_kernel:
            from ..ops.pos_conv import positional_conv

            h = positional_conv(h, self.pos_conv_w, enc.pos_conv_embed.conv.bias)
        else:
            h = h + enc.pos_conv_embed(h)
        if not cfg.do_stable_layer_norm:
            h = enc.layer_norm(h)
        hidden_states = [finalize(h)]
        rel = None
        if cfg.num_buckets:
            with span("prep:relpos_bias"):
                rel = enc.rel_values(h.shape[1], h.device)
        n = cfg.num_layers if num_layers is None else num_layers
        with span("prep:encoder_layers"):
            for layer in enc.layers[:n]:
                h = layer(h, key_mask=frame_mask, rel=rel)
                hidden_states.append(finalize(h))
        if cfg.do_stable_layer_norm and n == cfg.num_layers:
            hidden_states[-1] = finalize(enc.layer_norm(h))
        return hidden_states

    def extract_layer(self, wav: torch.Tensor, layer: int,
                      conv_feats: Optional[torch.Tensor] = None, wav_len=None):
        """Hidden state at HF index ``layer`` (9 = the standard semantic layer);
        the layers above it are not run."""
        return self(wav, conv_feats=conv_feats, wav_len=wav_len, num_layers=layer)[layer]
