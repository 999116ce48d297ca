"""WavLM's gated relative-position attention (csrc/relpos_attention16.cuh):
the operations and bytes of one layer's call, and the least time of a
synthesis call's layers."""

from __future__ import annotations

from . import least_s


def relpos_attention(B: int, S: int, heads: int, head_dim: int) -> dict:
    """One layer on [B, S] frames: ``products``, 4 B heads S^2 head_dim (q k^T
    and P V, two operations a multiply-add), and ``bytes``: bf16 q, k, v and
    the gate projections (8 a head) read once, bf16 o written once, the
    float32 offset vector [heads, 2S - 1] and gate constants read once."""
    H = heads * head_dim
    return {"products": 4 * B * heads * S * S * head_dim,
            "bytes": 2 * B * S * (3 * H + 8 * heads) + 2 * B * S * H
            + 4 * heads * (2 * S - 1) + 4 * heads}


def call_least_s(h: dict, cfg: dict, B: int, S: int) -> float:
    """The least time of the kernel's launches in one call: one a layer the
    extraction at ``cfg["hubert_layer"]`` runs, bf16 products."""
    n = relpos_attention(B, S, h["num_heads"], h["hidden_size"] // h["num_heads"])
    layers = min(cfg["hubert_layer"], h["num_layers"])
    return layers * least_s(n["products"], "bfloat16", n["bytes"])
