"""The edge decoder's operations and bytes (chip_smoke.py's ``fused_flops_bytes``
and ``fused_flops_bf16``, frozen here)."""

from __future__ import annotations


def band_pairs(T: int, window: int, kv_len: int = None) -> int:
    """Admissible (query, key) pairs of the |i - j| <= window band."""
    kv_len = T if kv_len is None else kv_len
    total = 0
    for i in range(T):
        lo, hi = max(0, i - window), min(min(T, kv_len) - 1, i + window)
        total += max(0, hi - lo + 1)
    return total


def dims(cfg: dict) -> dict:
    H, heads = cfg["hidden"], cfg["heads"]
    return dict(H=H, M=cfg["n_mels"], L=cfg["layers"], F=H * cfg["ffn_mult"], heads=heads,
                dh=H // heads, w=cfg["attn_window_size"], prenet=bool(cfg["use_depthwise"]))


def forward_products(cfg: dict, B: int, T: int, S: int) -> int:
    """Product operations of one decoder forward over [B, T] frames and S
    context positions (the context's latent K/V excluded: ``context_products``)."""
    d = dims(cfg)
    H, M, L, F = d["H"], d["M"], d["L"], d["F"]
    per_row = 4 * M * H + L * (2 * H * 3 * H + 6 * H * H + 4 * H * F + 2 * F * H)
    if d["prenet"]:
        per_row += 2 * H * H
    attn = L * d["heads"] * 4 * d["dh"] * (band_pairs(T, d["w"]) + T * S)
    return B * T * per_row + B * attn


def forward_f32(cfg: dict, B: int, T: int) -> int:
    """The pre-net's elementwise work (depthwise taps, GroupNorm, GELU, adds)."""
    return B * T * 16 * dims(cfg)["H"] if dims(cfg)["prenet"] else 0


def context_products(cfg: dict, B: int, S: int) -> int:
    """The cross-attention's latent K/V of the context, every layer:
    kv_down H -> H/2, kv_up H/2 -> 2H."""
    d = dims(cfg)
    H = d["H"]
    return B * S * d["L"] * (2 * H * (H // 2) + 2 * (H // 2) * 2 * H)


def loop_bytes(cfg: dict, B: int, T: int, S: int, steps: int, product_bytes: int) -> int:
    """Bytes the fused loop must move: its packed weights (products' at
    ``product_bytes`` each, the rest float32), the positions, the AdaLN
    table, the context's K/V, the start noise in and x0 out."""
    d = dims(cfg)
    H, M, L, F = d["H"], d["M"], d["L"], d["F"]
    prod = H * M + L * (3 * H * H + 3 * H * H + 2 * F * H + F * H) + M * H
    f32 = H + L * H + L * H + L * 2 * F + L * H + 2 * H + M
    if d["prenet"]:
        prod += H * H
        f32 += 3 * H + 3 * H
    tables = T * H + steps * L * 4 * H + steps * 4
    ckv = L * B * S * 2 * H * product_bytes
    return prod * product_bytes + 4 * (f32 + tables) + ckv + 2 * 4 * B * T * M


def loop(cfg: dict, B: int, T: int, S: int, steps: int, compute: str) -> dict:
    """The fused DDIM loop of one call: ``products``, ``f32`` and ``bytes``."""
    return {"products": steps * forward_products(cfg, B, T, S),
            "f32": steps * forward_f32(cfg, B, T),
            "bytes": loop_bytes(cfg, B, T, S, steps, 2 if compute == "bfloat16" else 4)}
