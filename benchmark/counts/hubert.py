"""HuBERT-base past its conv stack, and the semantic projection and FSQ:
product operations per call (every key in every frame's attention)."""

from __future__ import annotations


def hubert_products(h: dict, cfg: dict, B: int, S: int) -> int:
    """Feature projection, positional convolution and ``hubert_layer``
    layers on [B, S] frames."""
    D, Fi, C = h["hidden_size"], h["intermediate_size"], h["conv_dim"][-1]
    k, g = h["num_conv_pos_embeddings"], h["num_conv_pos_embedding_groups"]
    layers = min(cfg["hubert_layer"], h["num_layers"])
    per_frame = 2 * C * D + 2 * D * (D // g) * k
    per_frame += layers * (8 * D * D + 4 * D * Fi + 4 * S * D)
    return B * S * per_frame


def projection_products(h: dict, cfg: dict, B: int, S: int) -> int:
    """The projection to ``semantic_dim`` and FSQ's two projections."""
    sd, n = cfg["semantic_dim"], len(cfg["fsq_levels"])
    return B * S * (2 * h["hidden_size"] * sd + 2 * sd * sd + 4 * sd * n)


def encoder_products(h: dict, cfg: dict, B: int, S: int) -> int:
    return hubert_products(h, cfg, B, S) + projection_products(h, cfg, B, S)
