"""The speech encoder's positional conv embedding at float32 as one CUDA
launch, and its plain version.

``positional_conv(h, w, bias)`` returns ``h + PositionalConvEmbedding(h)``
(models/hubert.py): a Conv1d of C channels in groups of ``cpg``, 128 taps,
padding 64, the last output frame trimmed, erf-GELU, the residual added.
On CUDA tensors it launches ``csrc/pos_conv.cu`` (float32 FMA products, h
read as [B, S, C]; the design and what bounds it are in its note), on CPU
tensors it runs ``positional_conv_plain``; it never falls back from one to
the other.  The kernel has no backward: where a gradient would flow through
the conv, both raise.  The JAX package has no such kernel: it leaves the
conv to XLA.

The encoder owns the route to it: ``HubertEncoder`` keeps the conv's weight
packed (``pack_pos_conv_weights``) where ``kernel_serves`` says the kernel
takes its conv at its dtype, and calls ``positional_conv`` in place of the
module and its add (models/hubert.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build

TAPS = 128  # the conv's taps (num_conv_pos_embeddings)
WIDTHS = (48, 64)  # channels a group the kernel is built for (HuBERT-base, WavLM-Large)
# csrc/pos_conv.cu's geometry: frames a block, and its threads along the
# frames, which are the tap stride of a weight stage (taps j0, j0 + RT, ...).
ROWS, RT = 128, 16


def kernel_serves(hc, dtype: torch.dtype) -> bool:
    """Whether the kernel takes the positional conv of ``hc`` (a
    ``HubertConfig``) at compute ``dtype``: float32, 128 taps, and channels a
    group in ``WIDTHS`` (HuBERT-base 48, WavLM-Large 64; HuBERT tiny's 4
    and any bfloat16 stack keep the module)."""
    groups = hc.num_conv_pos_embedding_groups
    return (dtype == torch.float32 and hc.num_conv_pos_embeddings == TAPS
            and hc.hidden_size % groups == 0 and hc.hidden_size // groups in WIDTHS)


def pack_pos_conv_weights(weight: torch.Tensor) -> torch.Tensor:
    """The conv's weight [C, cpg, 128] in the kernel's layout, float32:
    [G, 16, cpg / 4, 8, cpg, 4] with ``packed[g, j0, k, u, o, e] =
    weight[g cpg + o, 4 k + e, j0 + 16 u]``, so that each (tap residue j0,
    4-channel chunk k) is one contiguous stage of the kernel's weight ring."""
    C, cpg, taps = weight.shape
    if taps != TAPS or cpg % 4 or C % cpg:
        raise ValueError(f"the kernel packs a [C, cpg, {TAPS}] weight, got {tuple(weight.shape)}")
    w = weight.detach().float().reshape(C // cpg, cpg, cpg // 4, 4, TAPS // RT, RT)
    # [g, o, k, e, u, j0] -> [g, j0, k, u, o, e]
    return w.permute(0, 5, 2, 4, 1, 3).contiguous()


def unpack_pos_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """``pack_pos_conv_weights``' inverse: the conv's weight [C, cpg, 128]."""
    G, cpg = w.shape[0], w.shape[4]
    return w.permute(0, 4, 2, 5, 3, 1).reshape(G * cpg, cpg, TAPS)


def positional_conv_plain(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function with ``F.conv1d`` on the unpacked weight: what
    the module and its add compute, bit for bit on the CPU."""
    weight = unpack_pos_conv_weights(w).contiguous()
    y = F.conv1d(h.transpose(1, 2), weight, bias.float(), padding=TAPS // 2,
                 groups=w.shape[0])[:, :, :-1]
    return h + F.gelu(y).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("pos_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edt_pos_conv.argtypes, lib.edt_pos_conv.restype = [p] * 4 + [i] * 4 + [p], ctypes.c_int
    lib.edt_pos_conv_geometry.argtypes, lib.edt_pos_conv_geometry.restype = [i, p], ctypes.c_int
    lib.edt_pos_conv_launches.argtypes, lib.edt_pos_conv_launches.restype = [], ctypes.c_longlong
    return lib


def launches() -> int:
    """Launches of the kernel since the library was loaded."""
    return _lib().edt_pos_conv_launches()


def geometry(cpg: int) -> dict:
    """The built kernel's geometry at ``cpg`` channels a group, to hold
    ``ROWS``, ``RT`` and ``TAPS`` against, with its shared bytes and the
    blocks an SM of the current card holds."""
    out = (ctypes.c_int * 7)()
    _build.check(_lib().edt_pos_conv_geometry(cpg, out), "edt_pos_conv_geometry")
    keys = ("taps", "rows", "rt", "taps_a_stage", "threads", "smem", "blocks_per_sm")
    return dict(zip(keys, out))


def positional_conv(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """h [B, S, C] float32 -> h + gelu(conv(h) + bias), ``w`` from
    ``pack_pos_conv_weights``, ``bias`` [C].  CPU tensors take
    ``positional_conv_plain``; CUDA tensors launch the kernel (h, w
    contiguous float32 on one card) or raise.  Both raise under grad mode
    where ``h``, ``w`` or ``bias`` requires a gradient: the kernel has no
    backward, and the plain version on the packed copy would drop the
    weight's gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, w, bias)):
        raise RuntimeError(
            "positional_conv has no backward (the kernel has none, and the plain version reads "
            "the packed copy of the weight) and an input requires a gradient: call it under "
            "torch.no_grad(), or take PositionalConvEmbedding, which autograd can follow")
    if h.dim() != 3 or w.dim() != 6:
        raise ValueError(f"h must be [B, S, C] and w packed 6-D, got {tuple(h.shape)} and "
                         f"{tuple(w.shape)}")
    B, S, C = h.shape
    G, cpg = w.shape[0], w.shape[4]
    if G * cpg != C or tuple(w.shape) != (G, RT, cpg // 4, TAPS // RT, cpg, 4) or \
            tuple(bias.shape) != (C,):
        raise ValueError(f"h {tuple(h.shape)}, w {tuple(w.shape)} and bias "
                         f"{tuple(bias.shape)} do not make one conv")
    if h.device.type == "cpu":
        return positional_conv_plain(h, w, bias)
    if h.device.type != "cuda":
        raise ValueError(f"positional_conv runs on CPU or CUDA, not {h.device}")
    if cpg not in WIDTHS:
        raise ValueError(f"the kernel takes {WIDTHS} channels a group, not {cpg}")
    bias = bias.float().contiguous()
    for name, t in (("h", h), ("w", w), ("bias", bias)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != h.device:
            raise ValueError(f"{name}: expected contiguous float32 on {h.device}, got "
                             f"{t.dtype} on {t.device}")
    out = torch.empty_like(h)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().edt_pos_conv(h.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                  B, S, C, cpg, stream)
    _build.check(err, "positional_conv")
    return out
