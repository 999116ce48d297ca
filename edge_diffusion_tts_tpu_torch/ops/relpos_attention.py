"""The speech encoders' relative-position attentions on the card: one bf16
launch a layer (``csrc/relpos_attention16.cuh``, built into the loop
library), the route the attention module takes at bfloat16 on CUDA with no
key mask and a head dim of 64: WavLM's gated relative-position attention
(``models/hubert.py::Attention``) and w2v-BERT's relative-key attention
(``models/w2v_bert.py::RelKeyAttention``).

``relpos_attention16(y, rel, gconst)`` reads the layer's packed GEMM output
``y`` [B, S, 3 H + 8 heads] (q, k, v, then each head's 8 gate projections;
``Attention.packed_input``), the call's offset vector ``rel`` [heads, 2S - 1]
and the gate constants, and returns the heads' outputs [B, S, H] before
``out_proj``; ``models/hubert.py::gated_attention``, the module's plain
route, computes the same from the same inputs with tensor ops.

``relkey_attention16(y, E, left)`` reads the layer's packed GEMM output
``y`` [B, S, 3 H] (q, k, v; ``RelKeyAttention.packed_input``) and its
distance table ``E`` [left + right + 1, 64] bf16, and returns the heads'
outputs [B, S, H] before ``linear_out``; ``models/w2v_bert.py::
relkey_attention`` is its plain route.  ``relkey_launches()`` counts its
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

HEAD_DIM = 64
MAX_POSITIONS = 8192  # RP_MAX_S: the block's window of rel fits shared memory
RELKEY_MAX_ROWS = 80  # RK_EROWS: rows of the distance table a block stages


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ddim")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edt_relpos_attention16.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.edt_relpos_attention16.restype = ctypes.c_int
    lib.edt_relkey_attention16.argtypes = [p] * 3 + [i] * 5 + [p]
    lib.edt_relkey_attention16.restype = ctypes.c_int
    lib.edt_relkey_launches.argtypes = []
    lib.edt_relkey_launches.restype = ctypes.c_longlong
    return lib


def relpos_attention16(y: torch.Tensor, rel: torch.Tensor, gconst: torch.Tensor) -> torch.Tensor:
    """The kernel: ``y`` a contiguous bf16 CUDA tensor [B, S, 3 H + 8 heads]
    (H = heads x 64), ``rel`` [heads, 2S - 1] and ``gconst`` (heads values)
    float32 on the same card; returns [B, S, H] bf16.  Raises on anything
    else, and where autograd would need a gradient through it."""
    B, S, ld = y.shape
    heads = rel.shape[0]
    if (y.device.type != "cuda" or y.dtype != torch.bfloat16 or not y.is_contiguous()
            or ld != heads * (3 * HEAD_DIM + 8)):
        raise ValueError(f"y: expected a contiguous CUDA bfloat16 tensor [B, S, "
                         f"{heads * (3 * HEAD_DIM + 8)}], got {y.dtype} {tuple(y.shape)} "
                         f"on {y.device}")
    gconst = gconst.reshape(-1).float().contiguous()
    rel = rel.float().contiguous()
    if tuple(rel.shape) != (heads, 2 * S - 1) or gconst.numel() != heads:
        raise ValueError(f"rel {tuple(rel.shape)} and gconst {tuple(gconst.shape)}: expected "
                         f"[{heads}, {2 * S - 1}] and [{heads}]")
    if S > MAX_POSITIONS:
        raise ValueError(f"{S} positions: the kernel takes at most {MAX_POSITIONS}")
    _build.refuse_autograd("relpos_attention16", y)
    out = torch.empty(B, S, heads * HEAD_DIM, dtype=torch.bfloat16, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().edt_relpos_attention16(y.data_ptr(), rel.data_ptr(), gconst.data_ptr(),
                                            out.data_ptr(), B, heads, S, ld, stream)
    _build.check(err, "relpos_attention16")
    return out


def relkey_attention16(y: torch.Tensor, E: torch.Tensor, left: int) -> torch.Tensor:
    """The relative-key kernel: ``y`` a contiguous bf16 CUDA tensor [B, S, 3 H]
    (H = heads x 64), ``E`` [rows, 64] (at most ``RELKEY_MAX_ROWS`` rows,
    offset d at row clamp(d, -left, rows - 1 - left) + left) on the same
    card, cast to bf16; returns [B, S, H] bf16.  Raises on anything else,
    and where autograd would need a gradient through it."""
    B, S, ld = y.shape
    if (y.device.type != "cuda" or y.dtype != torch.bfloat16 or not y.is_contiguous()
            or ld % (3 * HEAD_DIM)):
        raise ValueError(f"y: expected a contiguous CUDA bfloat16 tensor [B, S, 3 x heads x "
                         f"{HEAD_DIM}], got {y.dtype} {tuple(y.shape)} on {y.device}")
    rows = E.shape[0]
    if E.dim() != 2 or E.shape[1] != HEAD_DIM or not 0 <= left < rows <= RELKEY_MAX_ROWS:
        raise ValueError(f"E {tuple(E.shape)} with left {left}: expected [rows <= "
                         f"{RELKEY_MAX_ROWS}, {HEAD_DIM}] and 0 <= left < rows")
    if S > MAX_POSITIONS:
        raise ValueError(f"{S} positions: the kernel takes at most {MAX_POSITIONS}")
    _build.refuse_autograd("relkey_attention16", y, E)
    E = E.to(torch.bfloat16).contiguous()
    heads = ld // (3 * HEAD_DIM)
    out = torch.empty(B, S, heads * HEAD_DIM, dtype=torch.bfloat16, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().edt_relkey_attention16(y.data_ptr(), E.data_ptr(), out.data_ptr(), B,
                                            heads, S, rows, left, stream)
    _build.check(err, "relkey_attention16")
    return out


def relkey_launches() -> int:
    """Launches of the relative-key kernel since the library was loaded."""
    return int(_lib().edt_relkey_launches())
