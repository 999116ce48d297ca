"""w2v-BERT 2.0 past its filterbank: the relative-key attention kernel's
operations and bytes (csrc/relpos_attention16.cuh), the least time of a
synthesis call's launches, and the products of a whole audio-in call with
this encoder (every key in every frame's attention)."""

from __future__ import annotations

from . import least_s
from .calls import synth_loop
from .decoder import context_products
from .hubert import projection_products


def table_rows(h: dict) -> int:
    """Rows of a layer's distance table: offsets -left .. right."""
    return h["left_max_position_embeddings"] + h["right_max_position_embeddings"] + 1


def relkey_attention(B: int, S: int, heads: int, head_dim: int, rows: int) -> dict:
    """One layer on [B, S] frames: ``products``, 4 B heads S^2 head_dim (q k^T
    and P V) and 2 B heads S rows head_dim (q E^T), two operations a
    multiply-add; ``bytes``: bf16 q, k and v read once, bf16 o written once,
    the bf16 table read once."""
    H = heads * head_dim
    return {"products": 4 * B * heads * S * S * head_dim + 2 * B * heads * S * rows * head_dim,
            "bytes": 2 * B * S * 3 * H + 2 * B * S * H + 2 * rows * head_dim}


def call_least_s(h: dict, cfg: dict, B: int, S: int) -> float:
    """The least time of the kernel's launches in one call: one a layer the
    extraction at ``cfg["hubert_layer"]`` runs, bf16 products, at the
    larger of the products' time at peak and the bytes' at the HBM rate."""
    n = relkey_attention(B, S, h["num_heads"], h["hidden_size"] // h["num_heads"],
                         table_rows(h))
    return layers_run(h, cfg) * least_s(n["products"], "bfloat16", n["bytes"])


def layers_run(h: dict, cfg: dict) -> int:
    return min(cfg["hubert_layer"], h["num_layers"])


def conformer_products(h: dict, cfg: dict, B: int, S: int) -> int:
    """The feature projection and ``hubert_layer`` Conformer layers on [B, S]
    frames: per layer and frame the two FFNs (8 D Fi), q, k, v and out (8
    D^2), the scores and P V (4 S D), q E^T (2 rows D), the conv module's
    pointwise convs (6 D^2) and its depthwise taps (2 D k)."""
    D, Fi, k = h["hidden_size"], h["intermediate_size"], h["conv_depthwise_kernel_size"]
    per_frame = 2 * h["feature_projection_input_dim"] * D
    per_frame += layers_run(h, cfg) * (8 * D * Fi + 14 * D * D + 4 * S * D
                                       + 2 * table_rows(h) * D + 2 * D * k)
    return B * S * per_frame


def synth_call_flops(info: dict, call: dict) -> float:
    """Every product of an audio-in call behind w2v-BERT: the encoder to its
    layer, the projection and FSQ, the loop's steps and the context's K/V
    (the filterbank's FFT and mel product are not model products)."""
    cfg, h, B, S = info["cfg"], info["hubert"], call["rows"], call["tokens"]
    n = synth_loop(info, call)
    return (n["products"] + n["f32"] + context_products(cfg, B, S)
            + conformer_products(h, cfg, B, S) + projection_products(h, cfg, B, S))
