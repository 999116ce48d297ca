"""WavLM-Large to a layer, the projection and FSQ, in plain PyTorch.

microsoft/wavlm-large (Chen et al. 2022, arXiv:2110.13900; transformers'
``WavLMModel`` with ``feat_extract_norm="layer"`` and
``do_stable_layer_norm``): seven VALID convolutions without bias (512
channels; kernels 10,3,3,3,3,2,2; strides 5,2,2,2,2,2,2), each followed by a
LayerNorm over its channels (eps 1e-5) and a GELU; LayerNorm + Linear(512 ->
1024); a grouped positional convolution (k 128, 16 groups, padding 64, the
last frame trimmed) whose GELU is added, with no LayerNorm after it; then
pre-LN layers (16 heads of 64, FFN 4096, GELU, eps 1e-5): x = x +
MHA(LN(x)), x = x + FFN(LN(x)); a final LayerNorm after the last layer only.
Hidden state i is the stream after i layers.

The attention adds a gated relative-position bias to the scaled logits:
bias[h, i, j] = gate[b, h, i] * E[bucket(j - i), h], E layer 0's
``rel_attn_embed`` (320 buckets), bucket() transformers' log-bucket map
(half the buckets for keys after the query, exact below 80, logarithmic to
800), the gate from that head's 64-wide slice x_h of the layer's normed
input: p = x_h W^T + c (W [8, 64]), a = sigmoid(p_0 + .. + p_3), b =
sigmoid(p_4 + .. + p_7), gate = a (b const_h - 1) + 2.

The semantic encoder then projects the hidden state and FSQ quantizes it,
as ``hubert.py`` here says; its ``project``, ``FSQ`` and ``flip_margin``
are used as they are.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .hubert import FSQ, frames, project  # noqa: F401  (frames: the cell's token counts)
from .precision import Ops


def layers_run(cfg: dict, h: dict) -> int:
    """The layers an extraction at ``cfg["hubert_layer"]`` runs."""
    return min(cfg["hubert_layer"], h["num_layers"])


def wavlm_shapes(h: dict, upto: int) -> Dict[str, tuple]:
    """Name -> shape of the parameters (``hubert.`` prefix) that an
    extraction after ``upto`` layers reads: the final LayerNorm only where
    ``upto`` is the last layer."""
    C, D, Fi = h["conv_dim"], h["hidden_size"], h["intermediate_size"]
    heads = h["num_heads"]
    s, c_in = {}, 1
    for i, (c, k) in enumerate(zip(C, h["conv_kernel"])):
        p = f"hubert.feature_extractor.conv_layers.{i}."
        s[p + "conv.weight"] = (c, c_in, k)
        s[p + "layer_norm.weight"] = (c,)
        s[p + "layer_norm.bias"] = (c,)
        c_in = c
    s["hubert.feature_projection.layer_norm.weight"] = (C[-1],)
    s["hubert.feature_projection.layer_norm.bias"] = (C[-1],)
    s["hubert.feature_projection.projection.weight"] = (D, C[-1])
    s["hubert.feature_projection.projection.bias"] = (D,)
    k, g = h["num_conv_pos_embeddings"], h["num_conv_pos_embedding_groups"]
    s["hubert.encoder.pos_conv_embed.conv.weight"] = (D, D // g, k)
    s["hubert.encoder.pos_conv_embed.conv.bias"] = (D,)
    for l in range(upto):
        p = f"hubert.encoder.layers.{l}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[p + f"attention.{n}.weight"] = (D, D)
            s[p + f"attention.{n}.bias"] = (D,)
        s[p + "attention.gru_rel_pos_const"] = (1, heads, 1, 1)
        s[p + "attention.gru_rel_pos_linear.weight"] = (8, D // heads)
        s[p + "attention.gru_rel_pos_linear.bias"] = (8,)
        if l == 0:
            s[p + "attention.rel_attn_embed.weight"] = (h["num_buckets"], heads)
        for n in ("layer_norm", "final_layer_norm"):
            s[p + f"{n}.weight"] = (D,)
            s[p + f"{n}.bias"] = (D,)
        s[p + "feed_forward.intermediate_dense.weight"] = (Fi, D)
        s[p + "feed_forward.intermediate_dense.bias"] = (Fi,)
        s[p + "feed_forward.output_dense.weight"] = (D, Fi)
        s[p + "feed_forward.output_dense.bias"] = (D,)
    if upto == h["num_layers"]:
        s["hubert.encoder.layer_norm.weight"] = (D,)
        s["hubert.encoder.layer_norm.bias"] = (D,)
    return s


def encoder_shapes(cfg: dict, h: dict) -> Dict[str, tuple]:
    """Name -> shape of every parameter the cell's encode reads (WavLM to
    ``hubert_layer``, projection, FSQ)."""
    D, Dh, n = cfg["semantic_dim"], h["hidden_size"], len(cfg["fsq_levels"])
    s = wavlm_shapes(h, layers_run(cfg, h))
    s.update({"proj_fc1.weight": (D, Dh), "proj_fc1.bias": (D,), "proj_ln.weight": (D,),
              "proj_ln.bias": (D,), "proj_fc2.weight": (D, D), "proj_fc2.bias": (D,),
              "vq.proj_down.weight": (n, D), "vq.proj_down.bias": (n,),
              "vq.proj_up.weight": (D, n), "vq.proj_up.bias": (D,)})
    return s


def bucket(offsets: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """transformers' ``WavLMAttention._relative_positions_bucket`` of key - query."""
    half = num_buckets // 2
    exact = half // 2
    n = offsets.abs()
    large = torch.log(n.float() / exact) / math.log(max_distance / exact) * (half - exact)
    large = torch.min((exact + large).to(torch.long), torch.full_like(n, half - 1))
    return (offsets > 0).to(torch.long) * half + torch.where(n < exact, n, large)


def relative_bias(P, h: dict, S: int, device) -> torch.Tensor:
    """[heads, S, S]: E[bucket(j - i), h]."""
    pos = torch.arange(S, device=device)
    b = bucket(pos[None, :] - pos[:, None], h["num_buckets"], h["max_bucket_distance"])
    return P["hubert.encoder.layers.0.attention.rel_attn_embed.weight"][b].permute(2, 0, 1)


def conv_features(P, h: dict, wav: torch.Tensor, ops: Ops) -> torch.Tensor:
    """wav [B, N] -> conv features [B, frames, C]."""
    x = wav[:, None, :].float()
    for i, s in enumerate(h["conv_stride"]):
        p = f"hubert.feature_extractor.conv_layers.{i}."
        x = ops.conv1d(x, P[p + "conv.weight"], None, stride=s)
        x = F.layer_norm(x.transpose(1, 2), (x.shape[1],), P[p + "layer_norm.weight"],
                         P[p + "layer_norm.bias"], 1e-5).transpose(1, 2)
        x = F.gelu(x)
    return x.transpose(1, 2)


def attention(P, h: dict, p: str, x: torch.Tensor, bias: torch.Tensor, ops: Ops) -> torch.Tensor:
    """The gated relative-position attention of layer prefix ``p`` on the
    normed input x [B, T, D], the layers' shared ``bias`` [heads, T, T]."""
    B, T, D = x.shape
    heads = h["num_heads"]
    dh = D // heads

    def split(z):
        return z.reshape(B, T, heads, dh).transpose(1, 2)

    q, k, v = (split(ops.linear(x, P[p + f"attention.{n}.weight"], P[p + f"attention.{n}.bias"]))
               for n in ("q_proj", "k_proj", "v_proj"))
    gp = ops.linear(split(x), P[p + "attention.gru_rel_pos_linear.weight"],
                    P[p + "attention.gru_rel_pos_linear.bias"])  # [B, heads, T, 8]
    g = torch.sigmoid(gp.reshape(B, heads, T, 2, 4).sum(-1))
    const = P[p + "attention.gru_rel_pos_const"].reshape(1, heads, 1)
    gate = g[..., 0] * (g[..., 1] * const - 1.0) + 2.0  # [B, heads, T]
    logits = ops.matmul(q, k.transpose(-1, -2)) * dh ** -0.5 + gate[..., None] * bias[None]
    a = ops.matmul(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(B, T, D)
    return ops.linear(a, P[p + "attention.out_proj.weight"], P[p + "attention.out_proj.bias"])


def layer(P, h: dict, wav: torch.Tensor, ops: Ops, upto: int, attn_out: list = None
          ) -> torch.Tensor:
    """Hidden state ``upto`` (the stream after ``upto`` layers; after the
    last, its final LayerNorm) of wav [B, N].  ``attn_out``, where given,
    receives each layer's attention output (after ``out_proj``, before the
    residual add)."""
    eps, D = 1e-5, h["hidden_size"]
    feats = conv_features(P, h, wav, ops)
    x = F.layer_norm(feats, (feats.shape[-1],), P["hubert.feature_projection.layer_norm.weight"],
                     P["hubert.feature_projection.layer_norm.bias"], eps)
    x = ops.linear(x, P["hubert.feature_projection.projection.weight"],
                   P["hubert.feature_projection.projection.bias"])
    k = h["num_conv_pos_embeddings"]
    pos = ops.conv1d(x.transpose(1, 2), P["hubert.encoder.pos_conv_embed.conv.weight"],
                     P["hubert.encoder.pos_conv_embed.conv.bias"], padding=k // 2,
                     groups=h["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    bias = relative_bias(P, h, x.shape[1], x.device) if upto else None
    for l in range(upto):
        p = f"hubert.encoder.layers.{l}."
        n = F.layer_norm(x, (D,), P[p + "layer_norm.weight"], P[p + "layer_norm.bias"], eps)
        a = attention(P, h, p, n, bias, ops)
        if attn_out is not None:
            attn_out.append(a)
        x = x + a
        n = F.layer_norm(x, (D,), P[p + "final_layer_norm.weight"], P[p + "final_layer_norm.bias"],
                         eps)
        f = F.gelu(ops.linear(n, P[p + "feed_forward.intermediate_dense.weight"],
                              P[p + "feed_forward.intermediate_dense.bias"]))
        x = x + ops.linear(f, P[p + "feed_forward.output_dense.weight"],
                           P[p + "feed_forward.output_dense.bias"])
    if upto == h["num_layers"]:
        x = F.layer_norm(x, (D,), P["hubert.encoder.layer_norm.weight"],
                         P["hubert.encoder.layer_norm.bias"], eps)
    return x


def encode(P, cfg: dict, h: dict, wav: torch.Tensor, ops: Ops, rows: int = 4):
    """wav [B, N] -> (tokens [B, S], scaled FSQ values [B, S, dims]), in blocks
    of ``rows`` wavs so that the activations fit."""
    fsq = FSQ(cfg["fsq_levels"], wav.device)
    toks, vals = [], []
    for i in range(0, wav.shape[0], rows):
        hid = layer(P, h, wav[i:i + rows], ops, layers_run(cfg, h))
        u = fsq.bounded(P, project(P, hid, ops), ops)
        toks.append(fsq.tokens(fsq.codes(u)))
        vals.append(fsq.scaled(u))
    return torch.cat(toks), torch.cat(vals)
