"""w2v-BERT 2.0 to a layer, its filterbank, the projection and FSQ, in plain
PyTorch.

facebook/w2v-bert-2.0 (Seamless, arXiv:2312.05187; transformers'
``Wav2Vec2BertModel`` with ``position_embeddings_type="relative_key"``, fed
by ``SeamlessM4TFeatureExtractor``).

The filterbank, per utterance: the wav times 2^15; 400-sample frames every
160 samples with no edge padding (1 + (N - 400) // 160 of them); per frame
the mean removed, pre-emphasis 0.97 (the first sample times 0.03), the
Povey window (the symmetric Hann window to the power 0.85); the power of
its 512-point DFT (257 bins); 80 triangles, equally spaced on the Kaldi mel
scale 1127 ln(1 + f / 700) from 20 to 8000 Hz, each bin weighted by where
its own mel value falls; log(max(x, 2^-23)); per mel bin over the
utterance's frames, the mean subtracted and the result divided by
sqrt(unbiased variance + 1e-7); an odd last frame dropped and pairs of
frames stacked to 160 values, 50 a second.

The encoder: LayerNorm(160) + Linear(160 -> 1024); then Conformer layers
(16 heads of 64, FFN 4096, swish, LayerNorm eps 1e-5):
x = x + FFN1(LN(x)) / 2; x = x + MHSA(LN(x)); x = x + Conv(x);
x = x + FFN2(LN(x)) / 2; x = LN(x).  The attention's scores are
(q_i . k_j + q_i . E[clamp(j - i, -64, 8) + 64]) / 8, E the layer's
``distance_embedding`` [73, 64]; Conv is LN, a pointwise conv to 2048
channels without bias, GLU over the channels, a depthwise conv of 31 taps
without bias on the input left-padded by 30 (causal), LN, swish, a
pointwise conv without bias.  Hidden state i is the output of layer i.

The semantic encoder then projects the hidden state and FSQ quantizes it,
as ``hubert.py`` here says; its ``project``, ``FSQ`` and ``flip_margin``
are used as they are.

Departures, none of them in the values: the DFT is a product with a [400,
257] cosine and sine table (exact arithmetic gives the FFT's values; the
controls round its operands with every other product's), and the position
term gathers E into [S, S, 64] per call, as transformers does.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .hubert import FSQ, project
from .precision import Ops

FRAME, HOP, NFFT, SR = 400, 160, 512, 16000


def layers_run(cfg: dict, h: dict) -> int:
    """The layers an extraction at ``cfg["hubert_layer"]`` runs."""
    return min(cfg["hubert_layer"], h["num_layers"])


def positions(samples: int) -> int:
    """The encoder's positions for ``samples``: frames // 2 (49 at 1 s)."""
    return max(0, 1 + (samples - FRAME) // HOP) // 2


def w2v_bert_shapes(h: dict, upto: int) -> Dict[str, tuple]:
    """Name -> shape of the parameters (``hubert.`` prefix) that an
    extraction after ``upto`` layers reads."""
    D, Fi, Din = h["hidden_size"], h["intermediate_size"], h["feature_projection_input_dim"]
    rows = h["left_max_position_embeddings"] + h["right_max_position_embeddings"] + 1
    dh = D // h["num_heads"]
    s = {"hubert.feature_projection.layer_norm.weight": (Din,),
         "hubert.feature_projection.layer_norm.bias": (Din,),
         "hubert.feature_projection.projection.weight": (D, Din),
         "hubert.feature_projection.projection.bias": (D,)}
    for l in range(upto):
        p = f"hubert.encoder.layers.{l}."
        for n in ("ffn1_layer_norm", "self_attn_layer_norm", "conv_module.layer_norm",
                  "conv_module.depthwise_layer_norm", "ffn2_layer_norm", "final_layer_norm"):
            s[p + f"{n}.weight"] = (D,)
            s[p + f"{n}.bias"] = (D,)
        for n in ("ffn1", "ffn2"):
            s[p + f"{n}.intermediate_dense.weight"] = (Fi, D)
            s[p + f"{n}.intermediate_dense.bias"] = (Fi,)
            s[p + f"{n}.output_dense.weight"] = (D, Fi)
            s[p + f"{n}.output_dense.bias"] = (D,)
        for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
            s[p + f"self_attn.{n}.weight"] = (D, D)
            s[p + f"self_attn.{n}.bias"] = (D,)
        s[p + "self_attn.distance_embedding.weight"] = (rows, dh)
        s[p + "conv_module.pointwise_conv1.weight"] = (2 * D, D, 1)
        s[p + "conv_module.depthwise_conv.weight"] = (D, 1, h["conv_depthwise_kernel_size"])
        s[p + "conv_module.pointwise_conv2.weight"] = (D, D, 1)
    return s


def encoder_shapes(cfg: dict, h: dict) -> Dict[str, tuple]:
    """Name -> shape of every parameter the cell's encode reads (w2v-BERT to
    ``hubert_layer``, projection, FSQ)."""
    D, Dh, n = cfg["semantic_dim"], h["hidden_size"], len(cfg["fsq_levels"])
    s = w2v_bert_shapes(h, layers_run(cfg, h))
    s.update({"proj_fc1.weight": (D, Dh), "proj_fc1.bias": (D,), "proj_ln.weight": (D,),
              "proj_ln.bias": (D,), "proj_fc2.weight": (D, D), "proj_fc2.bias": (D,),
              "vq.proj_down.weight": (n, D), "vq.proj_down.bias": (n,),
              "vq.proj_up.weight": (D, n), "vq.proj_up.bias": (D,)})
    return s


def _tables(bins: int, device):
    """The Povey window [400], the DFT's cosine and sine tables [400, 257]
    and the mel weights [257, bins], float32 (made in float64)."""
    f64 = torch.float64
    n = torch.arange(FRAME, dtype=f64)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * n / (FRAME - 1))) ** 0.85
    k = torch.arange(NFFT // 2 + 1, dtype=f64)
    angle = 2 * math.pi * torch.outer(n, k) / NFFT
    cos, sin = torch.cos(angle), torch.sin(angle)

    def mel(f):
        return 1127.0 * torch.log(1.0 + f / 700.0)

    edges = torch.linspace(float(mel(torch.tensor(20.0, dtype=f64))),
                           float(mel(torch.tensor(8000.0, dtype=f64))), bins + 2, dtype=f64)
    at = mel(k * SR / NFFT)[:, None]  # each bin's mel value
    lo, mid, hi = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
    weights = torch.clamp(torch.minimum((at - lo) / (mid - lo), (hi - at) / (hi - mid)), min=0.0)
    return tuple(t.float().to(device) for t in (window, cos, sin, weights))


def features(wav: torch.Tensor, h: dict, ops: Ops) -> torch.Tensor:
    """wav [B, N] -> the encoder's input features [B, S, 160], each row one
    utterance."""
    bins, stride = h["num_mel_bins"], h["stride"]
    window, cos, sin, weights = _tables(bins, wav.device)
    x = wav.float() * 32768.0
    nf = 1 + (x.shape[1] - FRAME) // HOP
    idx = HOP * torch.arange(nf, device=x.device)[:, None] + torch.arange(FRAME, device=x.device)
    fr = x[:, idx]  # [B, F, 400]
    fr = fr - fr.mean(-1, keepdim=True)
    fr = torch.cat([0.03 * fr[..., :1], fr[..., 1:] - 0.97 * fr[..., :-1]], -1) * window
    power = ops.matmul(fr, cos) ** 2 + ops.matmul(fr, sin) ** 2
    logmel = torch.log(torch.clamp(ops.matmul(power, weights), min=2.0 ** -23))
    mean = logmel.mean(1, keepdim=True)
    var = ((logmel - mean) ** 2).sum(1, keepdim=True) / (nf - 1)
    normed = (logmel - mean) / torch.sqrt(var + 1e-7)
    S = nf // stride
    return normed[:, :S * stride].reshape(wav.shape[0], S, stride * bins)


def attention(P, h: dict, p: str, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    """The relative-key attention of layer prefix ``p`` on its normed input
    x [B, S, D], after ``linear_out``."""
    B, S, D = x.shape
    heads, L, R = h["num_heads"], h["left_max_position_embeddings"], \
        h["right_max_position_embeddings"]
    dh = D // heads

    def split(z):
        return z.reshape(B, S, heads, dh).transpose(1, 2)

    q, k, v = (split(ops.linear(x, P[p + f"self_attn.{n}.weight"], P[p + f"self_attn.{n}.bias"]))
               for n in ("linear_q", "linear_k", "linear_v"))
    pos = torch.arange(S, device=x.device)
    table = P[p + "self_attn.distance_embedding.weight"][
        torch.clamp(pos[None, :] - pos[:, None], -L, R) + L]  # [S, S, dh]
    rel = torch.einsum("bhid,ijd->bhij", ops.r(q), ops.r(table))
    scores = (ops.matmul(q, k.transpose(-1, -2)) + rel) / math.sqrt(dh)
    a = ops.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(B, S, D)
    return ops.linear(a, P[p + "self_attn.linear_out.weight"], P[p + "self_attn.linear_out.bias"])


def conv_module(P, h: dict, p: str, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    D, eps, k = h["hidden_size"], h["layer_norm_eps"], h["conv_depthwise_kernel_size"]
    c = p + "conv_module."
    n = F.layer_norm(x, (D,), P[c + "layer_norm.weight"], P[c + "layer_norm.bias"], eps)
    a = ops.linear(n, P[c + "pointwise_conv1.weight"][..., 0])
    a = a[..., :D] * torch.sigmoid(a[..., D:])  # GLU over the channels
    a = ops.conv1d(F.pad(a.transpose(1, 2), (k - 1, 0)), P[c + "depthwise_conv.weight"],
                   groups=D).transpose(1, 2)
    a = F.layer_norm(a, (D,), P[c + "depthwise_layer_norm.weight"],
                     P[c + "depthwise_layer_norm.bias"], eps)
    return ops.linear(F.silu(a), P[c + "pointwise_conv2.weight"][..., 0])


def ffn(P, p: str, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    f = F.silu(ops.linear(x, P[p + "intermediate_dense.weight"], P[p + "intermediate_dense.bias"]))
    return ops.linear(f, P[p + "output_dense.weight"], P[p + "output_dense.bias"])


def layer(P, h: dict, wav: torch.Tensor, ops: Ops, upto: int, attn_out: list = None,
          feats: torch.Tensor = None) -> torch.Tensor:
    """Hidden state ``upto`` (the output of layer ``upto``) of wav [B, N].
    ``attn_out``, where given, receives each layer's attention output (after
    ``linear_out``, before the residual add); ``feats`` replaces the
    filterbank's output."""
    eps, D = h["layer_norm_eps"], h["hidden_size"]
    x = features(wav, h, ops) if feats is None else feats
    x = F.layer_norm(x, (x.shape[-1],), P["hubert.feature_projection.layer_norm.weight"],
                     P["hubert.feature_projection.layer_norm.bias"], eps)
    x = ops.linear(x, P["hubert.feature_projection.projection.weight"],
                   P["hubert.feature_projection.projection.bias"])

    def ln(z, name):
        return F.layer_norm(z, (D,), P[name + ".weight"], P[name + ".bias"], eps)

    for l in range(upto):
        p = f"hubert.encoder.layers.{l}."
        x = x + 0.5 * ffn(P, p + "ffn1.", ln(x, p + "ffn1_layer_norm"), ops)
        a = attention(P, h, p, ln(x, p + "self_attn_layer_norm"), ops)
        if attn_out is not None:
            attn_out.append(a)
        x = x + a
        x = x + conv_module(P, h, p, x, ops)
        x = x + 0.5 * ffn(P, p + "ffn2.", ln(x, p + "ffn2_layer_norm"), ops)
        x = ln(x, p + "final_layer_norm")
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
