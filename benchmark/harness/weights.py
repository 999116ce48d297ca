"""Seeded weights and inputs, made on the device in a few large calls.

The benchmark makes every weight itself, from the seed, as one normal draw
on the device that each tensor takes a slice of, scaled by its kind: a
matrix or convolution N(0, g / fan_in) (g = 2 for the HuBERT conv stack,
whose GELU halves the scale; 1 elsewhere), an embedding table N(0, 1), a
bias 0.02 N(0, 1), a norm's weight 1 + 0.02 N(0, 1).  The zero-initialised
tensors of the upstream (the output head, the AdaLN projections) are drawn
too, so that every path computes something.  The same dict goes to the port
(``load_state_dict``) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .traffic import subseed


def _scale(name: str, shape: tuple):
    if len(shape) >= 2:
        if name.endswith("emb.weight"):
            return 1.0, 0.0
        gain = 2.0 if "feature_extractor.conv_layers" in name else 1.0
        return math.sqrt(gain / (math.prod(shape) // shape[0])), 0.0
    if name.endswith("bias"):
        return 0.02, 0.0
    return 0.02, 1.0


def make(shapes: Dict[str, tuple], seed: int, device, purpose: str = "weights"
         ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} on ``device``, one slice each of one draw."""
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(subseed(seed, purpose))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        std, mean = _scale(name, shape)
        out[name] = flat[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    return out


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, purpose))


def synthetic_wavs(rows: int, samples: int, gen: torch.Generator, device,
                   sr: int = 16000) -> torch.Tensor:
    """chip_smoke.py's ``synthetic_wav`` (frozen here), ``rows`` rows at once
    on ``device``: a voiced-like signal, a gliding harmonic tone (f0 = 110 +
    40 a + 30 sin(2 pi (0.3 + 0.2 b) t), harmonics 1, 2, 3, 5 at 1/k) under a
    slow envelope, plus 0.01 N(0, 1); each row's a, b and noise drawn from
    ``gen``, the phase summed in float64."""
    f64 = torch.float64
    a = torch.rand(rows, 1, generator=gen, device=device, dtype=f64)
    b = torch.rand(rows, 1, generator=gen, device=device, dtype=f64)
    t = torch.arange(samples, device=device, dtype=f64)[None, :] / sr
    f0 = 110 + 40 * a + 30 * torch.sin(2 * math.pi * (0.3 + 0.2 * b) * t)
    phase = 2 * math.pi * torch.cumsum(f0, dim=1) / sr
    tone = sum(torch.sin(k * phase) / k for k in (1, 2, 3, 5))
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * 1.7 * t) ** 2
    noise = torch.randn(rows, samples, generator=gen, device=device)
    return (0.15 * env * tone).float() + 0.01 * noise
