"""The HuBERT conv feature extractor as one CUDA host call, and its plain version.

Replaces the TPU kernel ``edge_diffusion_tts_tpu/ops/fused_frontend.py::
_frontend_kernel`` (launched by ``fused_conv_frontend``): wav [B, Twav] ->
conv features [B, frames, 512] through the seven hubert-base convs, the
GroupNorm on conv0 and erf-GELU after each, in float32.  The design and what
bounds it on the H100 are in ``csrc/conv_frontend.cu``: seven implicit-GEMM
launches from one C function, GroupNorm and GELU in the epilogues.

The GroupNorm normalizes each channel over the whole time axis.  As in the
JAX kernel its statistics follow analytically from the conv0 input patches
(``groupnorm_fold``): conv0 is linear in its 10-sample patches p_t, so per
channel c, mean = mean_t(p_t) . w_c and E[x^2] = w_c^T E_t[p_t p_t^T] w_c, a
[10, 10] Gram.  Those small statistics are tensor ops outside the kernel,
accumulated in float64 because E[x^2] - mean^2 cancels.

``conv_frontend`` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  ``fast_encode`` is
``SemanticEncoder.encode`` with the frontend routed through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from .. import _build
from ..models.hubert import HubertConfig, conv_frame_lengths

BASE_KERNELS = (10, 3, 3, 3, 3, 2, 2)
BASE_STRIDES = (5, 2, 2, 2, 2, 2, 2)
GN_EPS = 1e-5
FRONTEND_NAMES = ("w0", "wk3", "wk2", "gamma", "beta")


def check_base_specs(hc: HubertConfig) -> None:
    """Raise unless ``hc`` has the hubert-base conv stack the kernel implements."""
    if (tuple(hc.conv_kernel) != BASE_KERNELS or tuple(hc.conv_stride) != BASE_STRIDES
            or len(set(hc.conv_dim)) != 1):
        raise ValueError(
            "the conv-frontend kernel implements the hubert-base stack (kernels "
            f"{BASE_KERNELS}, strides {BASE_STRIDES}, one width), not kernels "
            f"{hc.conv_kernel}, strides {hc.conv_stride}, widths {hc.conv_dim}")


def pack_frontend_weights(feature_extractor) -> Dict[str, torch.Tensor]:
    """The extractor's weights in the kernel's layout: ``w0`` [C, 10], ``wk3``
    [4, C, 3C] (conv1-4) and ``wk2`` [2, C, 2C] (conv5-6), each [C_out,
    k*C_in] with the tap outer, and the GroupNorm's ``gamma``, ``beta`` [C]."""
    check_base_specs(feature_extractor.cfg)
    convs = [layer.conv.weight.detach().float() for layer in feature_extractor.conv_layers]
    C = convs[0].shape[0]
    wk = [w.permute(0, 2, 1).reshape(C, -1) for w in convs[1:]]
    gn = feature_extractor.conv_layers[0].layer_norm
    w = {
        "w0": convs[0][:, 0, :],
        "wk3": torch.stack(wk[:4]),
        "wk2": torch.stack(wk[4:]),
        "gamma": gn.weight.detach(),
        "beta": gn.bias.detach(),
    }
    return {k: v.float().contiguous() for k, v in w.items()}


def frame_counts(num_samples: int) -> list:
    """Frames out of each of the seven convs for ``num_samples`` samples."""
    return conv_frame_lengths(HubertConfig(), num_samples)


def groupnorm_fold(wav: torch.Tensor, w0: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor):
    """conv0's GroupNorm as a per-(batch, channel) ``(scale, shift)`` [B, C]:
    scale = gamma * rsqrt(max(E[x^2] - mean^2, 0) + eps), shift = beta -
    mean * scale, from the patch mean and Gram (float64)."""
    patches = wav.double().unfold(1, BASE_KERNELS[0], BASE_STRIDES[0])  # [B, T0, 10]
    mean_p = patches.mean(1)
    gram = torch.einsum("btj,btk->bjk", patches, patches) / patches.shape[1]
    w = w0.double().T  # [10, C]
    mu = mean_p @ w
    e2 = torch.einsum("bjk,jc,kc->bc", gram, w, w)
    var = (e2 - mu * mu).clamp(min=0.0)
    scale = gamma.double() * torch.rsqrt(var + GN_EPS)
    shift = beta.double() - mu * scale
    return scale.float().contiguous(), shift.float().contiguous()


def conv_frontend_plain(wav: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's computation with ``F.conv1d`` (same inputs, same order)."""
    scale, shift = groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"])
    C = w["w0"].shape[0]
    x = F.conv1d(wav[:, None, :].float(), w["w0"][:, None, :], stride=BASE_STRIDES[0])
    x = F.gelu(x * scale[:, :, None] + shift[:, :, None])
    layers = list(w["wk3"]) + list(w["wk2"])
    for wk, s in zip(layers, BASE_STRIDES[1:]):
        x = F.gelu(F.conv1d(x, wk.reshape(C, -1, C).permute(0, 2, 1), stride=s))
    return x.transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_frontend")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edt_conv_frontend_workspace.argtypes = [i, i, i]
    lib.edt_conv_frontend_workspace.restype = ctypes.c_longlong
    lib.edt_conv_frontend.argtypes = [p] * 8 + [i] * 3 + [p]
    lib.edt_conv_frontend.restype = ctypes.c_int
    return lib


def conv_frontend(wav: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """wav [B, Twav] -> conv features [B, frames, C] (``w`` from
    ``pack_frontend_weights``).

    CPU tensors take ``conv_frontend_plain``; CUDA tensors launch the kernel
    sequence, counted once per call in ``conv_frontend.launches``.
    """
    if wav.dim() != 2:
        raise ValueError(f"wav must be [B, T], got {tuple(wav.shape)}")
    B, Twav = wav.shape
    frames = frame_counts(Twav)[-1]
    if frames < 1:
        raise ValueError(f"{Twav} samples give no frame (hubert-base needs >= 400)")
    if wav.device.type == "cpu":
        return conv_frontend_plain(wav, w)
    if wav.device.type != "cuda":
        raise ValueError(f"conv_frontend runs on CPU or CUDA, not {wav.device}")
    C = w["w0"].shape[0]
    expected = {"wav": (B, Twav), "w0": (C, 10), "wk3": (4, C, 3 * C), "wk2": (2, C, 2 * C),
                "gamma": (C,), "beta": (C,)}
    tensors = dict(w, wav=wav)
    for name, shape in expected.items():
        t = tensors[name]
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != wav.device):
            raise ValueError(f"{name}: expected contiguous float32 {shape} on "
                             f"{wav.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    scale, shift = groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"])
    lib = _lib()
    out = torch.empty((B, frames, C), dtype=torch.float32, device=wav.device)
    work = torch.empty(lib.edt_conv_frontend_workspace(B, Twav, C), dtype=torch.float32,
                       device=wav.device)
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_conv_frontend(
            wav.data_ptr(), out.data_ptr(), work.data_ptr(), w["w0"].data_ptr(),
            w["wk3"].data_ptr(), w["wk2"].data_ptr(), scale.data_ptr(), shift.data_ptr(),
            B, Twav, C, stream,
        )
    conv_frontend.launches += 1
    _build.check(err, "conv_frontend")
    return out


conv_frontend.launches = 0


@torch.no_grad()
def fast_encode(encoder, wav: torch.Tensor, weights: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``SemanticEncoder.encode`` with the conv frontend routed through
    ``conv_frontend`` (wav [B, T] -> token indices [B, S]).

    ``weights`` are ``pack_frontend_weights(encoder.hubert.feature_extractor)``,
    packed once by the caller.  Only the hubert-base conv stack is supported:
    any other raises.
    """
    check_base_specs(encoder.hubert_cfg)
    wav = wav.float().contiguous()
    return encoder.encode(wav, conv_feats=conv_frontend(wav, weights))
