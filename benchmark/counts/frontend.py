"""The HuBERT conv stack's operations and bytes (chip_smoke.py's
``frontend_flops``, frozen here, with its bytes)."""

from __future__ import annotations

KERNELS = (10, 3, 3, 3, 3, 2, 2)
STRIDES = (5, 2, 2, 2, 2, 2, 2)


def frames(samples: int) -> list:
    out = []
    for k, s in zip(KERNELS, STRIDES):
        samples = (samples - k) // s + 1
        out.append(samples)
    return out


def conv_stack(B: int, samples: int, C: int = 512, compute: str = "float32") -> dict:
    """``conv0`` (float32 in either variant), ``rest`` (conv1-6 at
    ``compute``) operations and the ``bytes`` of one call on [B, samples]:
    the wav, the weights, the GroupNorm affine and the features out."""
    f = frames(samples)
    c_in = [1] + [C] * 6
    ops = [2 * B * n * C * k * c for n, k, c in zip(f, KERNELS, c_in)]
    wbytes = 2 if compute == "bfloat16" else 4
    weights = C * 10 * 4 + sum(C * k * C for k in KERNELS[1:]) * wbytes + 2 * C * 4
    return {"conv0": ops[0], "rest": sum(ops[1:]),
            "bytes": 4 * B * samples + weights + 4 * B * f[-1] * C}
