"""Operand precisions of the reference's products.

The reference computes in float32 with every sum in float32.  ``Ops`` rounds
the two operands of each product (matrix products, convolutions, attention)
to a lower precision first when asked: that is how the controls of
``correct`` are made (float32 -> TF32, bfloat16 -> fp8).  TF32 is emulated by
rounding the mantissa to 10 bits, so a control reads the same on the CPU and
on the card whatever cuBLAS would pick; fp8 is e4m3 with one scale per
tensor (its amax mapped to 448), as fp8 products are run in practice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32", "fp8")
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def no_tf32() -> None:
    """Full float32 products in cuBLAS and cuDNN (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` (float32) rounded to ``precision``, returned in float32; the
    gradient passes the rounding unchanged."""
    if precision == "float32":
        return t
    if t.requires_grad:
        return t + (_round(t.detach(), precision) - t.detach())
    return _round(t, precision)


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        bits = t.contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        bits = (bits + 0xFFF + lsb) & ~0x1FFF
        return bits.view(torch.float32)
    if precision == "fp8":
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")


class Ops:
    """The products of the reference at one operand precision; everything
    else (norms, softmax, activations, sums) stays float32."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
        self.precision = precision

    def r(self, t: torch.Tensor) -> torch.Tensor:
        return round_to(t, self.precision)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.r(a), self.r(b))

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        y = torch.matmul(self.r(x), self.r(w).transpose(0, 1))
        return y if b is None else y + b

    def conv1d(self, x, w, b=None, stride: int = 1, padding: int = 0, groups: int = 1):
        return F.conv1d(self.r(x), self.r(w), b, stride=stride, padding=padding, groups=groups)
