"""Banded (sliding-window) attention: a CUDA kernel, its launch plan and its
plain version.

Replaces the TPU kernel ``edge_diffusion_tts_tpu/ops/window_attention.py::
_band_kernel``: attend iff ``|i - j| <= window`` (and key ``j < seq_len``),
softmax in float32, over q, k, v of shape [B, H, T, d].

On the H100 the work is about 4*d*(2w+1) FLOP per query row, which float32
FMA bounds, not HBM.  The kernel (csrc/band_attention.cu, whose header
gives the design): one block per (batch, head, ``rows`` query rows), warps
of 16 rows; K and V walked once over the block's band in chunks through a
cp.async ring, S = QKᵀ and O += PV as float32 register tiles, the softmax
once per chunk.  It reads q, k, v and writes o through their strides, so the
attention layer hands it views of its qkv projection and takes o in
[B, T, H, d] memory (``out_layout="bthd"``): no copy kernel around it.

``band_plan`` is the host's launch plan (rows per block, threads, chunk,
shared bytes, blocks, waves); the C side checks it against the geometry it
was built with, and ``band_geometry`` reads that geometry back.  ``banded_attention`` takes the plain version for CPU tensors only;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build

MAX_HEAD_DIM = 64
# The geometry csrc/band_attention.cu is built for.
# Query rows per block: the tiles the kernel is instantiated for, each the
# plan's pick at some shape (128-row tiles, and two warps per 16 rows
# sharing out the keys, measured slower at the long-form shapes, PERF.md).
BAND_ROWS = (32, 64)
BAND_KEYS = 32  # keys per chunk
BAND_STAGES = 3  # chunks in the cp.async ring
WARP_ROWS = 16  # query rows per warp
H100_SMS = 132
SMEM_PER_SM = 233_472  # an SM's shared memory, of which each block costs 1 KB more
# The most ptxas gives a tile up to d = 56 (sm_90a); d = 64 takes 152, where
# shared memory holds fewer blocks than registers would.
REGS_PER_THREAD = 128
LAYOUTS = ("bhtd", "bthd")


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def band_smem_bytes(rows: int, d: int) -> int:
    """Dynamic shared bytes of one block: Q [rows, dp + 4], the ring of K
    and V chunks [stages, 2, keys, dp + 4] and the warps' P tiles
    [rows, keys + 8], floats, dp = d padded to a multiple of 8."""
    dp = _cdiv(d, 8) * 8
    return 4 * (rows * (dp + 4) + 2 * BAND_STAGES * BAND_KEYS * (dp + 4)
                + rows * (BAND_KEYS + 8))


def band_plan(B: int, H: int, T: int, d: int, window: int, sms: int = H100_SMS) -> dict:
    """The host's launch plan for [B, H, T, d] on a card of ``sms`` SMs:
    ``rows`` (query rows per block), ``threads``, ``keys`` per chunk,
    ``stages``, ``smem`` (dynamic shared bytes), ``blocks``, ``resident``
    (blocks an SM holds by shared memory, threads and registers) and
    ``waves`` (blocks over sms * resident).  No tile depends on ``window``
    yet: a block walks its band in chunks whatever its width.

    The tile of ``BAND_ROWS`` with the most blocks that still run as one
    wave; where none does, the fewest waves.  On the H100 this picked the
    fastest tile at [1,4,4000,40] and [2,4,4000,40] (PERF.md): a second wave
    repeats a block's whole staging and softmax, and more blocks in one wave
    keep more warps in flight.
    """
    if not (4 <= d <= MAX_HEAD_DIM and d % 4 == 0):
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 4 up to {MAX_HEAD_DIM}")

    def plan(rows):
        smem = band_smem_bytes(rows, d)
        threads = rows // WARP_ROWS * 32
        blocks = B * H * _cdiv(T, rows)
        resident = min(SMEM_PER_SM // (smem + 1024), 2048 // threads,
                       65536 // (REGS_PER_THREAD * threads), 32)
        return dict(rows=rows, threads=threads, keys=BAND_KEYS, stages=BAND_STAGES, smem=smem,
                    blocks=blocks, resident=resident, waves=blocks / (sms * resident))

    plans = [plan(rows) for rows in BAND_ROWS]
    one_wave = [p for p in plans if p["waves"] <= 1]
    if one_wave:
        return max(one_wave, key=lambda p: p["blocks"])
    return min(plans, key=lambda p: (p["waves"], -p["blocks"]))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("band_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edt_banded_attention.argtypes = [p, p, p, p, p] + [i] * 9 + [p]
    lib.edt_banded_attention.restype = ctypes.c_int
    lib.edt_band_geometry.argtypes = [i, i, p]
    lib.edt_band_geometry.restype = ctypes.c_int
    return lib


def band_geometry(rows: int, d: int) -> dict:
    """The geometry the built library reports for ``rows`` query rows per
    block and head dim ``d`` (threads, keys, stages, smem), to hold
    ``band_plan`` against."""
    out = (ctypes.c_int * 4)()
    _build.check(_lib().edt_band_geometry(rows, d, out), "edt_band_geometry")
    return dict(zip(("threads", "keys", "stages", "smem"), out))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_strided(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name} must be a float32 tensor on {device}, got {t.dtype} on "
                         f"{t.device}")
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes a unit-stride last dimension and rows that "
                         f"start 16-byte aligned (strides {t.stride()})")


def banded_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    seq_len: Optional[int] = None,
    out_layout: str = "bhtd",
) -> torch.Tensor:
    """Sliding-window attention over [B, H, T, d]; returns [B, H, T, d].

    q, k and v may be strided views (on CUDA: float32, the last dimension
    unit-stride, every stride a multiple of 4 floats, 16-byte aligned, d a
    multiple of 4 up to 64).  ``out_layout="bthd"`` has the result written
    in [B, T, H, d] memory and returns its [B, H, T, d] view.  CPU tensors
    take the plain version; CUDA tensors launch the kernel in the tile of
    ``band_plan``, counted in ``banded_attention.launches``, and raise under
    grad mode when one of them requires a gradient (the kernel has no
    backward).
    """
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"q, k, v must share one [B, H, T, d] shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if out_layout not in LAYOUTS:
        raise ValueError(f"out_layout must be one of {LAYOUTS}, got {out_layout!r}")
    B, H, T, d = q.shape
    seq_len = T if seq_len is None else int(seq_len)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"banded_attention runs on CPU or CUDA, not {q.device}")
    if q.device.type == "cpu":
        res = banded_attention_plain(q, k, v, window, seq_len)
        return res if out_layout == "bhtd" else res.transpose(1, 2).contiguous().transpose(1, 2)
    _build.refuse_autograd("banded_attention", q, k, v)
    if q.dtype != torch.float32:
        raise ValueError(f"the banded-attention kernel takes float32 q, k, v, not {q.dtype}: "
                         "its bf16 loads are ROADMAP Queue B item B3.4 (a bf16 decoder's "
                         "long-form windows on the card wait for it)")
    plan = band_plan(B, H, T, d, window, _sm_count(q.device.index or 0))
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_strided(name, t, q.device)
    if out_layout == "bthd":
        out = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    else:
        out = torch.empty((B, H, T, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_banded_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            B, H, T, d, min(window, T), max(0, min(seq_len, T)),
            plan["rows"], plan["threads"], plan["smem"], stream,
        )
    banded_attention.launches += 1
    _build.check(err, "banded_attention")
    return out


banded_attention.launches = 0
