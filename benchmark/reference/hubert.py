"""HuBERT-base to layer 9, the projection and FSQ, in plain PyTorch.

facebook/hubert-base-ls960 (feat_extract_norm "group", post-LN encoder):
seven VALID convolutions without bias (512 channels; kernels 10,3,3,3,3,2,2;
strides 5,2,2,2,2,2,2), GELU after each and a per-channel GroupNorm (eps
1e-5, over time) on the first before its GELU; LayerNorm + Linear(512 ->
768); a grouped positional convolution (k 128, 16 groups, padding 64, the
last frame trimmed) whose GELU is added before a LayerNorm; then post-LN
layers (12 heads, FFN 3072, GELU, eps 1e-5): x = LN(x + MHA(x)), x = LN(x +
FFN(x)).  The positional convolution's weight norm is taken as materialized.

The semantic encoder of Krabbens/edge-diffusion-tts then projects layer 9:
z = fc2(LN(gelu(fc1(h)), eps 1e-6)), and FSQ quantizes it: u = tanh(proj_down
z), code_d = round_half_even((u_d + 1) (L_d - 1) / 2) clipped to [0, L_d - 1],
token = sum_d code_d prod_{e < d} L_e, features = proj_up(code / half - 1).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .precision import Ops

def hubert_shapes(h: dict) -> Dict[str, tuple]:
    """Name -> shape of the HuBERT parameters (``hubert.`` prefix) at config ``h``."""
    C, D, Fi = h["conv_dim"], h["hidden_size"], h["intermediate_size"]
    s = {}
    c_in = 1
    for i, (c, k) in enumerate(zip(C, h["conv_kernel"])):
        s[f"hubert.feature_extractor.conv_layers.{i}.conv.weight"] = (c, c_in, k)
        c_in = c
    s["hubert.feature_extractor.conv_layers.0.layer_norm.weight"] = (C[0],)
    s["hubert.feature_extractor.conv_layers.0.layer_norm.bias"] = (C[0],)
    s["hubert.feature_projection.layer_norm.weight"] = (C[-1],)
    s["hubert.feature_projection.layer_norm.bias"] = (C[-1],)
    s["hubert.feature_projection.projection.weight"] = (D, C[-1])
    s["hubert.feature_projection.projection.bias"] = (D,)
    k, g = h["num_conv_pos_embeddings"], h["num_conv_pos_embedding_groups"]
    s["hubert.encoder.pos_conv_embed.conv.weight"] = (D, D // g, k)
    s["hubert.encoder.pos_conv_embed.conv.bias"] = (D,)
    s["hubert.encoder.layer_norm.weight"] = (D,)
    s["hubert.encoder.layer_norm.bias"] = (D,)
    for l in range(h["num_layers"]):
        p = f"hubert.encoder.layers.{l}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[p + f"attention.{n}.weight"] = (D, D)
            s[p + f"attention.{n}.bias"] = (D,)
        for n in ("layer_norm", "final_layer_norm"):
            s[p + f"{n}.weight"] = (D,)
            s[p + f"{n}.bias"] = (D,)
        s[p + "feed_forward.intermediate_dense.weight"] = (Fi, D)
        s[p + "feed_forward.intermediate_dense.bias"] = (Fi,)
        s[p + "feed_forward.output_dense.weight"] = (D, Fi)
        s[p + "feed_forward.output_dense.bias"] = (D,)
    return s


def encoder_shapes(cfg: dict, h: dict) -> Dict[str, tuple]:
    """Name -> shape of every semantic-encoder parameter (HuBERT, projection, FSQ)."""
    D, Dh, n = cfg["semantic_dim"], h["hidden_size"], len(cfg["fsq_levels"])
    s = hubert_shapes(h)
    s.update({"proj_fc1.weight": (D, Dh), "proj_fc1.bias": (D,), "proj_ln.weight": (D,),
              "proj_ln.bias": (D,), "proj_fc2.weight": (D, D), "proj_fc2.bias": (D,),
              "vq.proj_down.weight": (n, D), "vq.proj_down.bias": (n,),
              "vq.proj_up.weight": (D, n), "vq.proj_up.bias": (D,)})
    return s


def frames(h: dict, samples: int) -> list:
    """Frames after each convolution of a ``samples``-long wav."""
    out = []
    for k, s in zip(h["conv_kernel"], h["conv_stride"]):
        samples = (samples - k) // s + 1
        out.append(samples)
    return out


def conv_features(P, h: dict, wav: torch.Tensor, ops: Ops) -> torch.Tensor:
    """wav [B, N] -> conv features [B, frames, C]."""
    x = wav[:, None, :].float()
    for i, s in enumerate(h["conv_stride"]):
        x = ops.conv1d(x, P[f"hubert.feature_extractor.conv_layers.{i}.conv.weight"], stride=s)
        if i == 0:
            mean = x.mean(2, keepdim=True)
            var = (x - mean).square().mean(2, keepdim=True)
            x = (x - mean) * torch.rsqrt(var + 1e-5)
            x = x * P["hubert.feature_extractor.conv_layers.0.layer_norm.weight"][None, :, None] \
                + P["hubert.feature_extractor.conv_layers.0.layer_norm.bias"][None, :, None]
        x = F.gelu(x)
    return x.transpose(1, 2)


def layer(P, h: dict, wav: torch.Tensor, ops: Ops, upto: int) -> torch.Tensor:
    """Hidden state ``upto`` (HF numbering: 0 after the positional conv) of wav [B, N]."""
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
    x = F.layer_norm(x + F.gelu(pos).transpose(1, 2), (D,), P["hubert.encoder.layer_norm.weight"],
                     P["hubert.encoder.layer_norm.bias"], eps)
    B, T, _ = x.shape
    heads = h["num_heads"]
    dh = D // heads

    def split(z):
        return z.reshape(B, T, heads, dh).transpose(1, 2)

    for l in range(upto):
        p = f"hubert.encoder.layers.{l}."
        q, kk, v = (split(ops.linear(x, P[p + f"attention.{n}.weight"], P[p + f"attention.{n}.bias"]))
                    for n in ("q_proj", "k_proj", "v_proj"))
        a = torch.softmax(ops.matmul(q, kk.transpose(-1, -2)) * dh ** -0.5, dim=-1)
        a = ops.matmul(a, v).transpose(1, 2).reshape(B, T, D)
        a = ops.linear(a, P[p + "attention.out_proj.weight"], P[p + "attention.out_proj.bias"])
        x = F.layer_norm(x + a, (D,), P[p + "layer_norm.weight"], P[p + "layer_norm.bias"], eps)
        f = F.gelu(ops.linear(x, P[p + "feed_forward.intermediate_dense.weight"],
                              P[p + "feed_forward.intermediate_dense.bias"]))
        f = ops.linear(f, P[p + "feed_forward.output_dense.weight"],
                       P[p + "feed_forward.output_dense.bias"])
        x = F.layer_norm(x + f, (D,), P[p + "final_layer_norm.weight"],
                         P[p + "final_layer_norm.bias"], eps)
    return x


def project(P, hid: torch.Tensor, ops: Ops) -> torch.Tensor:
    z = F.gelu(ops.linear(hid, P["proj_fc1.weight"], P["proj_fc1.bias"]))
    z = F.layer_norm(z, (z.shape[-1],), P["proj_ln.weight"], P["proj_ln.bias"], 1e-6)
    return ops.linear(z, P["proj_fc2.weight"], P["proj_fc2.bias"])


class FSQ:
    """Finite scalar quantization at ``levels``."""

    def __init__(self, levels, device):
        self.levels = torch.tensor(list(levels), dtype=torch.float32, device=device)
        self.half = (self.levels - 1.0) / 2.0
        basis = [1]
        for l in list(levels)[:-1]:
            basis.append(basis[-1] * int(l))
        self.basis = torch.tensor(basis, dtype=torch.int64, device=device)

    def bounded(self, P, z, ops: Ops) -> torch.Tensor:
        return torch.tanh(ops.linear(z, P["vq.proj_down.weight"], P["vq.proj_down.bias"]))

    def scaled(self, u: torch.Tensor) -> torch.Tensor:
        """(u + 1) * half: the value whose rounding gives the code."""
        return (u + 1.0) * self.half

    def codes(self, u: torch.Tensor) -> torch.Tensor:
        return self.round(self.scaled(u))

    def round(self, scaled: torch.Tensor) -> torch.Tensor:
        return torch.minimum(torch.round(scaled).clamp(min=0.0), self.levels - 1.0)

    def tokens(self, codes: torch.Tensor) -> torch.Tensor:
        return (codes.long() * self.basis).sum(-1)

    def digits(self, tokens: torch.Tensor) -> torch.Tensor:
        """Codes [..., dims] of flat tokens (dim 0 the least significant)."""
        out, rem = [], tokens.long()
        for l in self.levels.tolist():
            out.append(rem % int(l))
            rem = rem // int(l)
        return torch.stack(out, -1).float()

    def features(self, P, codes: torch.Tensor, ops: Ops) -> torch.Tensor:
        return ops.linear(codes / self.half - 1.0, P["vq.proj_up.weight"], P["vq.proj_up.bias"])


def encode(P, cfg: dict, h: dict, wav: torch.Tensor, ops: Ops, rows: int = 4):
    """wav [B, N] -> (tokens [B, S], scaled FSQ values [B, S, dims]), in blocks
    of ``rows`` wavs so that the convolutions' activations fit."""
    fsq = FSQ(cfg["fsq_levels"], wav.device)
    toks, vals = [], []
    for i in range(0, wav.shape[0], rows):
        hid = layer(P, h, wav[i:i + rows], ops, min(cfg["hubert_layer"], h["num_layers"]))
        u = fsq.bounded(P, project(P, hid, ops), ops)
        toks.append(fsq.tokens(fsq.codes(u)))
        vals.append(fsq.scaled(u))
    return torch.cat(toks), torch.cat(vals)


def flip_margin(fsq: FSQ, scaled: torch.Tensor, tokens: torch.Tensor) -> float:
    """How far from a rounding edge the reference's value lies, at the worst
    token digit where ``tokens`` disagrees with the reference's own code, in
    level units (0 where every digit agrees; 0.5 at most for a digit one
    level off, more for a digit further off)."""
    ref_codes = fsq.round(scaled)
    got = fsq.digits(tokens)
    differ = got != ref_codes
    if not bool(differ.any()):
        return 0.0
    # Distance of the reference's value from the edge between its own code
    # and the code given: |scaled - (code_given + code_ref) / 2|.
    edge = (got + ref_codes) / 2.0
    dist = (scaled - edge).abs()
    return float(dist[differ].max())
