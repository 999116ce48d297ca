"""Banded (sliding-window) attention: a CUDA kernel and its plain version.

Replaces the TPU kernel ``edge_diffusion_tts_tpu/ops/window_attention.py::
_band_kernel``: attend iff ``|i - j| <= window`` (and key ``j < seq_len``),
softmax in float32, over q, k, v of shape [B, H, T, d].

On the H100 the work is small (about 4*d*(2w+1) FLOP per query row) and the
kernel is bound by memory traffic and latency, not by arithmetic: every
q/k/v byte has to cross HBM once.  The design (csrc/attention.cuh): one
block per (batch*head, 16-row query tile); the block walks only the key
chunks its band touches, stages each 64-key chunk of K and V in shared
memory with 16-byte cp.async copies, double-buffered (head padded to a
multiple of 8 and zero-masked, rows padded by four floats against bank
conflicts), and four threads per query row each keep an online softmax
(running max, denominator, accumulator) in registers over a quarter of the
keys, merged with warp shuffles at the end.  All arithmetic is float32 FMA.
The same device function serves the fused DDIM kernel's self-attention
(with ``seq_len=T``) and its cross-attention (full window).

``banded_attention`` takes the plain version for CPU tensors only; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build

MAX_HEAD_DIM = 64


def banded_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    seq_len: Optional[int] = None,
) -> torch.Tensor:
    """Dense masked reference: softmax over keys with ``|i-j| <= window`` and
    ``j < seq_len``; a query row with no such key gives zeros."""
    T = q.shape[2]
    seq_len = T if seq_len is None else seq_len
    idx = torch.arange(T, device=q.device)
    mask = ((idx[None, :] - idx[:, None]).abs() <= window) & (idx[None, :] < seq_len)
    scale = q.shape[-1] ** -0.5
    ft = torch.promote_types(q.dtype, torch.float32)  # float64 stays float64
    logits = torch.matmul(q.to(ft), k.to(ft).transpose(-1, -2)) * scale
    logits = logits.masked_fill(~mask, torch.finfo(ft).min)
    probs = torch.softmax(logits, dim=-1) * mask
    return torch.matmul(probs, v.to(ft)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("band_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edt_banded_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.edt_banded_attention.restype = ctypes.c_int
    return lib


def banded_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    seq_len: Optional[int] = None,
) -> torch.Tensor:
    """Sliding-window attention over [B, H, T, d]; returns [B, H, T, d].

    CPU tensors take the plain version; CUDA tensors (float32, contiguous,
    d a multiple of 4 up to 64) launch the kernel, counted in
    ``banded_attention.launches``.
    """
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"q, k, v must share one [B, H, T, d] shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    B, H, T, d = q.shape
    seq_len = T if seq_len is None else int(seq_len)
    if q.device.type == "cpu":
        return banded_attention_plain(q, k, v, window, seq_len)
    if q.device.type != "cuda":
        raise ValueError(f"banded_attention runs on CPU or CUDA, not {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on {q.device}")
    if d > MAX_HEAD_DIM or d % 4 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}, in 16-byte-aligned tensors")
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_banded_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, T, d, min(window, 2 * T), seq_len, stream,
        )
    banded_attention.launches += 1
    _build.check(err, "banded_attention")
    return out


banded_attention.launches = 0
