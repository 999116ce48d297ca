"""The edge diffusion decoder in plain PyTorch, from its equations.

The denoiser of Krabbens/edge-diffusion-tts (configs/flagship.json): noisy mel
x [B, T, n_mels], timestep t, stage index i and a semantic context [B, S, H]
(token embeddings, or projected features in training) ->

  c    = fc2(gelu(fc1(sincos(t)))) + step_emb[min(i, 15)]
  ctx  = context + P[:S]                       (P: interleaved sin/cos table)
  h    = in_proj(x); h += gelu(gn8(pw(dw3(h)))) (depthwise pre-net); h += P[:T]
  per layer:
    h += proj(attn_band64(qkv(rms(h) * w1 * (1 + s1) + b1)))   (s1, b1 = ada1(c))
    h += out(attn(q(rms(h) * w2), kv_up(rms(kv_down(ctx)) * wkv)))
    h += fc2(value * silu(gate)), [value, gate] = fc1(rms(h) * w3 * (1 + s3) + b3)
  out  = out_proj(layernorm(h))

RMS and layer norms take eps 1e-6, the GroupNorm of the pre-net 8 groups and
eps 1e-6, GELU the erf form; the softmax is in float32.  Parameters are a
dict named as the upstream state dict (``parameter_shapes``), all float32.
Dropout, where asked, draws its masks from the generator it is given, one
``torch.bernoulli`` per dropout site in the forward's order: self-attention
probabilities, cross-attention probabilities, the feed-forward's two.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .precision import Ops

MAX_STEP_EMB = 16


def parameter_shapes(cfg: dict) -> Dict[str, tuple]:
    """Name -> shape of every decoder parameter at configuration ``cfg``."""
    H, M, D = cfg["hidden"], cfg["n_mels"], cfg["semantic_dim"]
    F_ = H * cfg["ffn_mult"]
    codes = int(math.prod(cfg["fsq_levels"])) if cfg["use_fsq"] else cfg["codebook_size"]
    s = {
        "time_emb.1.weight": (H, H), "time_emb.1.bias": (H,),
        "time_emb.3.weight": (H, H), "time_emb.3.bias": (H,),
        "step_emb.weight": (MAX_STEP_EMB, H),
        "sem_proj.weight": (H, D), "sem_proj.bias": (H,),
        "token_emb.weight": (codes, H),
        "in_proj.weight": (H, M), "in_proj.bias": (H,),
    }
    if cfg["use_depthwise"]:
        s.update({"pre_conv.depthwise.weight": (H, 1, 3), "pre_conv.pointwise.weight": (H, H, 1),
                  "pre_conv.pointwise.bias": (H,), "pre_conv.norm.weight": (H,),
                  "pre_conv.norm.bias": (H,)})
    for l in range(cfg["layers"]):
        p = f"layers.{l}."
        s.update({
            p + "norm1.norm.weight": (H,), p + "norm1.proj.weight": (2 * H, H),
            p + "norm1.proj.bias": (2 * H,),
            p + "attn.qkv.weight": (3 * H, H), p + "attn.proj.weight": (H, H),
            p + "attn.proj.bias": (H,),
            p + "norm2.weight": (H,),
            p + "cross_attn.q_proj.weight": (H, H), p + "cross_attn.kv_down_proj.weight": (H // 2, H),
            p + "cross_attn.kv_norm.weight": (H // 2,),
            p + "cross_attn.kv_up_proj.weight": (2 * H, H // 2),
            p + "cross_attn.out_proj.weight": (H, H),
            p + "norm3.norm.weight": (H,), p + "norm3.proj.weight": (2 * H, H),
            p + "norm3.proj.bias": (2 * H,),
            p + "ffn.net.0.weight": (2 * F_, H), p + "ffn.net.0.bias": (2 * F_,),
            p + "ffn.net.3.weight": (H, F_), p + "ffn.net.3.bias": (H,),
        })
    s.update({"final_norm.weight": (H,), "final_norm.bias": (H,),
              "out_proj.weight": (M, H), "out_proj.bias": (M,)})
    return s


def position_table(n: int, dim: int, device) -> torch.Tensor:
    """Interleaved sin/cos positions [n, dim]: even columns sin, odd cos."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(n, dim, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """concat(sin, cos) of t * exp(-ln(10^4) k / (dim/2 - 1))."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def rms(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)


class Dropout:
    """Masks from ``generator``: keep with probability 1 - rate, scale 1/(1 - rate)."""

    def __init__(self, rate: float, generator: Optional[torch.Generator]):
        self.rate, self.generator = rate, generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.bernoulli(torch.full(x.shape, keep, dtype=torch.float32, device=x.device),
                               generator=self.generator).bool()
        return torch.where(mask, x / keep, 0.0)


def attention(q, k, v, ops: Ops, mask=None, drop: Optional[Dropout] = None):
    """Softmax attention on [B, heads, T, d]; logits and softmax in float32."""
    s = ops.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    if drop is not None:
        p = drop(p)
    return ops.matmul(p, v)


def time_condition(P, cfg: dict, t: torch.Tensor, step_idx: torch.Tensor, ops: Ops):
    H = cfg["hidden"]
    c = ops.linear(time_embedding(t, H), P["time_emb.1.weight"], P["time_emb.1.bias"])
    c = ops.linear(F.gelu(c), P["time_emb.3.weight"], P["time_emb.3.bias"])
    return c + P["step_emb.weight"][step_idx.clamp(0, MAX_STEP_EMB - 1)]


def token_context(P, tokens: torch.Tensor) -> torch.Tensor:
    """The context of token indices [B, S] (positions added in ``forward``)."""
    return P["token_emb.weight"][tokens]


def feature_context(P, feats: torch.Tensor, ops: Ops) -> torch.Tensor:
    return ops.linear(feats, P["sem_proj.weight"], P["sem_proj.bias"])


def prenet(P, h: torch.Tensor, ops: Ops) -> torch.Tensor:
    """Depthwise k=3 (SAME) -> pointwise -> GroupNorm(8, eps 1e-6) -> GELU, on [B, T, H]."""
    x = h.transpose(1, 2)
    H = x.shape[1]
    x = ops.conv1d(x, P["pre_conv.depthwise.weight"], None, padding=1, groups=H)
    x = ops.conv1d(x, P["pre_conv.pointwise.weight"], P["pre_conv.pointwise.bias"])
    x = F.group_norm(x, 8, P["pre_conv.norm.weight"], P["pre_conv.norm.bias"], eps=1e-6)
    return F.gelu(x).transpose(1, 2)


def forward(P, cfg: dict, x: torch.Tensor, t: torch.Tensor, step_idx: torch.Tensor,
            context: torch.Tensor, ops: Ops, drop: Optional[Dropout] = None) -> torch.Tensor:
    """The decoder's output [B, T, n_mels] (v or eps, as the model was trained)."""
    B, T, _ = x.shape
    S = context.shape[1]
    H, heads = cfg["hidden"], cfg["heads"]
    dh, w = H // heads, cfg["attn_window_size"]
    c = time_condition(P, cfg, t, step_idx, ops)
    ctx = context + position_table(S, H, x.device)
    h = ops.linear(x, P["in_proj.weight"], P["in_proj.bias"])
    if cfg["use_depthwise"]:
        h = h + prenet(P, h, ops)
    h = h + position_table(T, H, x.device)
    idx = torch.arange(T, device=x.device)
    band = ((idx[None, :] - idx[:, None]).abs() <= w)[None, None]

    def heads_of(z, n):
        return z.reshape(B, n, heads, dh).transpose(1, 2)

    def merge(z):
        return z.transpose(1, 2).reshape(B, T, H)

    for l in range(cfg["layers"]):
        p = f"layers.{l}."

        def ada(name, z):
            m = ops.linear(c, P[p + name + ".proj.weight"], P[p + name + ".proj.bias"])
            scale, shift = m[:, :H], m[:, H:]
            return rms(z) * P[p + name + ".norm.weight"] * (1.0 + scale[:, None]) + shift[:, None]

        qkv = ops.linear(ada("norm1", h), P[p + "attn.qkv.weight"]).reshape(B, T, 3, heads, dh)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        a = attention(q, k, v, ops, band, drop)
        h = h + ops.linear(merge(a), P[p + "attn.proj.weight"], P[p + "attn.proj.bias"])

        q = heads_of(ops.linear(rms(h) * P[p + "norm2.weight"], P[p + "cross_attn.q_proj.weight"]), T)
        lat = rms(ops.linear(ctx, P[p + "cross_attn.kv_down_proj.weight"])) \
            * P[p + "cross_attn.kv_norm.weight"]
        kv = ops.linear(lat, P[p + "cross_attn.kv_up_proj.weight"])
        a = attention(q, heads_of(kv[..., :H], S), heads_of(kv[..., H:], S), ops, None, drop)
        h = h + ops.linear(merge(a), P[p + "cross_attn.out_proj.weight"])

        f = ops.linear(ada("norm3", h), P[p + "ffn.net.0.weight"], P[p + "ffn.net.0.bias"])
        value, gate = f.chunk(2, dim=-1)
        f = value * F.silu(gate)
        if drop is not None:
            f = drop(f)
        f = ops.linear(f, P[p + "ffn.net.3.weight"], P[p + "ffn.net.3.bias"])
        if drop is not None:
            f = drop(f)
        h = h + f
    h = F.layer_norm(h, (H,), P["final_norm.weight"], P["final_norm.bias"], eps=1e-6)
    return ops.linear(h, P["out_proj.weight"], P["out_proj.bias"])
