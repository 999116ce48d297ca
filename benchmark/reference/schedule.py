"""The diffusion schedule and samplers' equations, frozen here for the reference.

Cosine schedule (Nichol & Dhariwal, s = 0.008), its float32 tables computed in
numpy as the configuration's upstream computes them; eta = 0 DDIM over the
strided grid ``range(T - 1, 0, -T // n)[:n]`` with ``t_prev = max(t - stride,
0)`` and x0 clipped to +-3; the v-parameterization; and
``optax.warmup_cosine_decay_schedule(0 -> lr, end 1e-6)`` evaluated in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

X0_CLIP = 3.0


def cosine_tables(T: int) -> dict:
    """float32 numpy tables ``alpha_bar``, ``sqrt_ab``, ``sqrt_1mab``."""
    s = np.float32(0.008)
    x = np.linspace(0.0, T, T + 1, dtype=np.float32)
    ab = np.cos(((x / np.float32(T)) + s) / (1 + s) * np.float32(math.pi) * 0.5)
    ab = (ab * ab).astype(np.float32)
    ab = ab / ab[0]
    betas = np.clip((np.float32(1.0) - (ab[1:] / ab[:-1])).astype(np.float32), 0.0001, 0.9999)
    alpha_bar = np.cumprod((np.float32(1.0) - betas).astype(np.float32), dtype=np.float32)
    return {"alpha_bar": alpha_bar.astype(np.float32),
            "sqrt_ab": np.sqrt(alpha_bar).astype(np.float32),
            "sqrt_1mab": np.sqrt(1.0 - alpha_bar).astype(np.float32)}


def ddim_grid(T: int, num_steps: int):
    """``[(t, t_prev), ...]`` of the eta = 0 DDIM loop."""
    stride = max(T // num_steps, 1)
    ts = list(range(T - 1, 0, -stride))[:num_steps]
    return [(t, max(t - stride, 0)) for t in ts]


def ddim(model, x_T: torch.Tensor, T: int, num_steps: int, prediction: str = "v"):
    """eta = 0 DDIM from ``x_T``; ``model(x, t, i)`` is the decoder at timestep
    ``t`` and stage index ``i``.  Returns the last x0 (clipped to +-3)."""
    tab = cosine_tables(T)
    x, x0 = x_T, torch.zeros_like(x_T)
    for i, (t, tp) in enumerate(ddim_grid(T, num_steps)):
        sab, s1m = float(tab["sqrt_ab"][t]), float(tab["sqrt_1mab"][t])
        sabp, s1mp = float(tab["sqrt_ab"][tp]), float(tab["sqrt_1mab"][tp])
        out = model(x, t, i)
        eps = s1m * x + sab * out if prediction == "v" else out
        x0 = ((x - s1m * eps) / sab).clamp(-X0_CLIP, X0_CLIP)
        x = sabp * x0 + s1mp * eps
    return x0


def warmup_cosine(peak: float, total: int, warmup_frac: float):
    """The learning rate at the 0-based update count."""
    f32 = np.float32
    warmup = max(int(total * warmup_frac), 1)
    decay = max(total, warmup + 1) - warmup
    alpha = 0.0 if peak == 0.0 else 1e-6 / peak

    def lr(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(count) / f32(warmup)
            return float(f32(-peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return float(f32(peak) * (f32(1.0 - alpha) * cosine + f32(alpha)))

    return lr
