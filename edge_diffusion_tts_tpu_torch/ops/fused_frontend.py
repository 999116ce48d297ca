"""The HuBERT conv feature extractor as one CUDA host call, and its plain version.

Replaces the TPU kernel ``edge_diffusion_tts_tpu/ops/fused_frontend.py::
_frontend_kernel`` (launched by ``fused_conv_frontend``): wav [B, Twav] ->
conv features [B, frames, 512] through the seven hubert-base convs, the
GroupNorm on conv0 and erf-GELU after each, in float32.  The design and what
bounds it on the H100 are in ``csrc/conv_frontend.cu``: one launch per layer
from one C function (plus a split-K reduction for the layers whose grid
would not fill the card), GroupNorm and GELU in the epilogues.

The GroupNorm normalizes each channel over the whole time axis.  As in the
JAX kernel its statistics follow analytically from the conv0 input patches
(``groupnorm_fold``): conv0 is linear in its 10-sample patches p_t, so per
channel c, mean = mean_t(p_t) . w_c and E[x^2] = w_c^T E_t[p_t p_t^T] w_c, a
[10, 10] Gram.  Those small statistics are tensor ops outside the kernel,
accumulated in float64 because E[x^2] - mean^2 cancels.

``frontend_plan`` is the host's launch plan (tile, split-K factor and
blocks per layer); the C side takes its split factors as ints.
``conv_frontend`` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernels or raises.  ``conv_frontend_layer`` launches
one layer alone (a test and timing hook, as ``conv_frontend_layer_plain`` is
its plain version).  ``fast_encode`` is ``SemanticEncoder.encode`` with the
frontend routed through it.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .. import _build
from ..models.hubert import HubertConfig, conv_frame_lengths, valid_mask

BASE_KERNELS = (10, 3, 3, 3, 3, 2, 2)
BASE_STRIDES = (5, 2, 2, 2, 2, 2, 2)
GN_EPS = 1e-5
FRONTEND_NAMES = ("w0", "wk3", "wk2", "gamma", "beta")
LAYERS = len(BASE_KERNELS)

# The launch geometry csrc/conv_frontend.cu is built for.
CONV0_ROWS = 16  # conv0: output frames per block, all channels
TILE = (128, 128)  # conv1-6: output frames x channels per block
CHUNK = 16  # conv1-6: input channels per K step
H100_SMS = 132


def _base_stack(hc: HubertConfig) -> bool:
    return (tuple(hc.conv_kernel) == BASE_KERNELS and tuple(hc.conv_stride) == BASE_STRIDES
            and len(set(hc.conv_dim)) == 1)


def check_base_specs(hc: HubertConfig) -> None:
    """Raise unless ``hc`` has the hubert-base conv stack the kernel implements."""
    if not _base_stack(hc):
        raise ValueError(
            "the conv-frontend kernel implements the hubert-base stack (kernels "
            f"{BASE_KERNELS}, strides {BASE_STRIDES}, one width), not kernels "
            f"{hc.conv_kernel}, strides {hc.conv_stride}, widths {hc.conv_dim}")


def kernel_serves(hc: HubertConfig) -> bool:
    """Whether the frontend kernel takes ``hc``'s conv stack: hubert-base's
    kernels and strides, one width, and that width a multiple of ``TILE[1]``."""
    return _base_stack(hc) and hc.conv_dim[0] % TILE[1] == 0


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


def layer_weight(w: Dict[str, torch.Tensor], layer: int) -> torch.Tensor:
    """Layer ``layer``'s packed weight: ``w0`` [C, 10] or [C_out, k*C_in]."""
    if layer == 0:
        return w["w0"]
    return w["wk3"][layer - 1] if layer <= 4 else w["wk2"][layer - 5]


def frame_counts(num_samples: int) -> list:
    """Frames out of each of the seven convs for ``num_samples`` samples."""
    return conv_frame_lengths(HubertConfig(), num_samples)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def frontend_plan(B: int, num_samples: int, C: int = 512, sms: int = H100_SMS) -> List[dict]:
    """The host's launch plan for wav [B, num_samples] on a card of ``sms``
    SMs: per layer M (output frames), N (channels), K (reduction depth),
    ``tile`` (frames x channels per block), ``splits`` (split-K factor) and
    ``blocks`` of its main launch.

    conv0 has a kernel of its own (``CONV0_ROWS`` frames x all channels per
    block).  conv1-6 run one block per SM (the 4-stage ring takes 131-164 KB
    of shared memory); a layer whose tiles alone would leave SMs idle splits
    K into the most parts whose blocks still run as one wave (tiles x splits
    <= sms), at most one part per chunk.  One wave beat the next factor up
    (>= sms blocks, two waves) at every split layer on the H100 (PERF.md).
    Split ``s`` of S takes the input-channel chunks [s*Q//S, (s+1)*Q//S) of
    Q = C / CHUNK, whole chunks every one.
    """
    frames = frame_counts(num_samples)
    plan = [dict(layer=0, M=frames[0], N=C, K=BASE_KERNELS[0], tile=(CONV0_ROWS, C), splits=1,
                 blocks=B * _cdiv(frames[0], CONV0_ROWS))]
    for i in range(1, LAYERS):
        M = frames[i]
        tiles = B * _cdiv(M, TILE[0]) * _cdiv(C, TILE[1])
        splits = _layer_splits(tiles, C // CHUNK, sms)
        plan.append(dict(layer=i, M=M, N=C, K=BASE_KERNELS[i] * C, tile=TILE, splits=splits,
                         blocks=tiles * splits))
    return plan


def _layer_splits(tiles: int, chunks: int, sms: int) -> int:
    return max(1, min(chunks, sms // tiles))


def frontend_workspace(B: int, plan: List[dict]) -> int:
    """Floats of scratch the frontend needs: conv0's and conv1's outputs
    (every later layer fits in one of the two) and the largest split-K
    layer's partial sums."""
    C = plan[0]["N"]
    partials = max([p["splits"] * p["M"] for p in plan[1:] if p["splits"] > 1] or [0])
    return B * C * (plan[0]["M"] + plan[1]["M"] + partials)


def groupnorm_fold(wav: torch.Tensor, w0: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, wav_len=None):
    """conv0's GroupNorm as a per-(batch, channel) ``(scale, shift)`` [B, C]:
    scale = gamma * rsqrt(max(E[x^2] - mean^2, 0) + eps), shift = beta -
    mean * scale, from the patch mean and Gram (float64).  ``wav_len`` (true
    sample count, int or [B]) takes them over each row's first
    ``(wav_len - 10) // 5 + 1`` patches only, so a zero-padded wav is
    normalized as its unpadded rows (the module's ``MaskedGroupNorm``)."""
    patches = wav.double().unfold(1, BASE_KERNELS[0], BASE_STRIDES[0])  # [B, T0, 10]
    T0 = patches.shape[1]
    if wav_len is None:
        count = torch.full((wav.shape[0], 1), float(T0), dtype=torch.float64, device=wav.device)
    else:
        l0 = conv_frame_lengths(HubertConfig(), torch.as_tensor(wav_len, device=wav.device))[0]
        mask = valid_mask(T0, l0, wav.device)
        patches = patches * mask[:, :, None]
        count = mask.sum(1, keepdim=True).clamp(min=1).double()
    mean_p = patches.sum(1) / count
    gram = torch.einsum("btj,btk->bjk", patches, patches) / count[:, :, None]
    w = w0.double().T  # [10, C]
    mu = mean_p @ w
    e2 = torch.einsum("bjk,jc,kc->bc", gram, w, w)
    var = (e2 - mu * mu).clamp(min=0.0)
    scale = gamma.double() * torch.rsqrt(var + GN_EPS)
    shift = beta.double() - mu * scale
    return scale.float().contiguous(), shift.float().contiguous()


def conv_frontend_plain(wav: torch.Tensor, w: Dict[str, torch.Tensor],
                        wav_len=None) -> torch.Tensor:
    """The kernel's computation with ``F.conv1d`` (same inputs, same order)."""
    scale, shift = groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"], wav_len)
    C = w["w0"].shape[0]
    x = F.conv1d(wav[:, None, :].float(), w["w0"][:, None, :], stride=BASE_STRIDES[0])
    x = F.gelu(x * scale[:, :, None] + shift[:, :, None])
    layers = list(w["wk3"]) + list(w["wk2"])
    for wk, s in zip(layers, BASE_STRIDES[1:]):
        x = F.gelu(F.conv1d(x, wk.reshape(C, -1, C).permute(0, 2, 1), stride=s))
    return x.transpose(1, 2)


def conv_frontend_layer_plain(x: torch.Tensor, layer: int, w: Dict[str, torch.Tensor],
                              scale: Optional[torch.Tensor] = None,
                              shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer of ``conv_frontend_plain``, channels-last in and out: wav
    [B, Twav] (layer 0, with conv0's folded GroupNorm ``scale``, ``shift``
    [B, C]) or [B, Tin, C] -> [B, Tout, C]: one ``F.conv1d``, then GELU."""
    W = layer_weight(w, layer)
    C = W.shape[0]
    if layer == 0:
        y = F.conv1d(x[:, None, :].float(), W[:, None, :], stride=BASE_STRIDES[0])
        y = y * scale[:, :, None] + shift[:, :, None]
    else:
        y = F.conv1d(x.transpose(1, 2).contiguous(),
                     W.reshape(C, -1, C).permute(0, 2, 1), stride=BASE_STRIDES[layer])
    return F.gelu(y).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_frontend")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edt_conv_frontend_workspace.argtypes = [i, i, i, p]
    lib.edt_conv_frontend_workspace.restype = ctypes.c_longlong
    lib.edt_conv_frontend.argtypes = [p] * 8 + [i] * 3 + [p, p]
    lib.edt_conv_frontend.restype = ctypes.c_int
    lib.edt_conv_layer.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.edt_conv_layer.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(tensors: Dict[str, torch.Tensor], expected: Dict[str, tuple], device) -> None:
    for name, shape in expected.items():
        t = tensors[name]
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"{name}: expected contiguous float32 {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _splits(plan: List[dict]):
    return (ctypes.c_int * LAYERS)(*(p["splits"] for p in plan))


def conv_frontend(wav: torch.Tensor, w: Dict[str, torch.Tensor], fold=None,
                  wav_len=None) -> torch.Tensor:
    """wav [B, Twav] -> conv features [B, frames, C] (``w`` from
    ``pack_frontend_weights``).

    CPU tensors take ``conv_frontend_plain``; CUDA tensors launch the kernel
    sequence, counted once per call in ``conv_frontend.launches``, and raise
    under grad mode when one of them requires a gradient.  ``fold``
    is ``groupnorm_fold``'s ``(scale, shift)`` for this wav where the caller
    has it already (timing the kernels alone); by default it is computed,
    over each row's first ``wav_len`` samples where ``wav_len`` is given (a
    zero-padded wav; the frames inside the true length then equal an
    exact-length call's).  The kernels themselves take the fold as it is.
    """
    if wav.dim() != 2:
        raise ValueError(f"wav must be [B, T], got {tuple(wav.shape)}")
    B, Twav = wav.shape
    frames = frame_counts(Twav)[-1]
    if frames < 1:
        raise ValueError(f"{Twav} samples give no frame (hubert-base needs >= 400)")
    if wav.device.type == "cpu":
        return conv_frontend_plain(wav, w, wav_len)
    if wav.device.type != "cuda":
        raise ValueError(f"conv_frontend runs on CPU or CUDA, not {wav.device}")
    _build.refuse_autograd("conv_frontend", wav, *w.values(), *(fold or ()))
    C = w["w0"].shape[0]
    if C % TILE[1]:
        raise ValueError(f"the frontend kernel needs a width that is a multiple of {TILE[1]}, "
                         f"not {C}")
    scale, shift = fold if fold is not None else groupnorm_fold(
        wav, w["w0"], w["gamma"], w["beta"], wav_len)
    _check(dict(w, wav=wav, scale=scale, shift=shift),
           {"wav": (B, Twav), "w0": (C, 10), "wk3": (4, C, 3 * C), "wk2": (2, C, 2 * C),
            "gamma": (C,), "beta": (C,), "scale": (B, C), "shift": (B, C)}, wav.device)
    splits = _splits(frontend_plan(B, Twav, C, _sm_count(wav.device.index or 0)))
    lib = _lib()
    out = torch.empty((B, frames, C), dtype=torch.float32, device=wav.device)
    work = torch.empty(lib.edt_conv_frontend_workspace(B, Twav, C, splits),
                       dtype=torch.float32, device=wav.device)
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_conv_frontend(
            wav.data_ptr(), out.data_ptr(), work.data_ptr(), w["w0"].data_ptr(),
            w["wk3"].data_ptr(), w["wk2"].data_ptr(), scale.data_ptr(), shift.data_ptr(),
            B, Twav, C, splits, stream,
        )
    with _LAUNCHES_LOCK:  # handler threads launch it at once (stream preps)
        conv_frontend.launches += 1
    _build.check(err, "conv_frontend")
    return out


conv_frontend.launches = 0
_LAUNCHES_LOCK = threading.Lock()


def conv_frontend_layer(x: torch.Tensor, layer: int, w: Dict[str, torch.Tensor],
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None,
                        splits: Optional[int] = None) -> torch.Tensor:
    """One layer of the frontend kernel sequence alone, as
    ``conv_frontend_layer_plain`` computes it, in the host plan's tile and,
    unless ``splits`` is given (1 to C / CHUNK, conv1-6), its split-K factor
    for this shape (``frontend_plan``).

    A test and timing hook: it takes CUDA tensors only (contiguous float32)
    and raises on anything else, CPU tensors included; it never falls back.
    Counted in ``conv_frontend_layer.launches``.
    """
    if x.device.type != "cuda":
        raise ValueError(f"conv_frontend_layer runs on CUDA tensors only, not {x.device} "
                         "(its plain version is conv_frontend_layer_plain)")
    if not 0 <= layer < LAYERS:
        raise ValueError(f"layer must be in [0, {LAYERS}), got {layer}")
    W = layer_weight(w, layer)
    _build.refuse_autograd("conv_frontend_layer", x, W, scale, shift)
    C = W.shape[0]
    if C % TILE[1]:
        raise ValueError(f"the frontend kernel needs a width that is a multiple of {TILE[1]}, "
                         f"not {C}")
    if x.dim() != (2 if layer == 0 else 3):
        raise ValueError(f"layer {layer} takes {'[B, Twav]' if layer == 0 else '[B, Tin, C]'}, "
                         f"got {tuple(x.shape)}")
    B, Tin = x.shape[:2]
    k, s = BASE_KERNELS[layer], BASE_STRIDES[layer]
    M = (Tin - k) // s + 1
    if M < 1:
        raise ValueError(f"layer {layer}: {Tin} input frames give no output frame")
    tensors, expected = {"x": x, "W": W}, {"W": (C, k * (1 if layer == 0 else C))}
    expected["x"] = (B, Tin) if layer == 0 else (B, Tin, C)
    if layer == 0:
        if scale is None or shift is None:
            raise ValueError("layer 0 takes conv0's folded GroupNorm scale and shift")
        tensors.update(scale=scale, shift=shift)
        expected.update(scale=(B, C), shift=(B, C))
    _check(tensors, expected, x.device)
    if splits is None:
        splits = 1 if layer == 0 else _layer_splits(
            B * _cdiv(M, TILE[0]) * _cdiv(C, TILE[1]), C // CHUNK, _sm_count(x.device.index or 0))
    elif not (1 <= splits <= C // CHUNK and (layer > 0 or splits == 1)):
        raise ValueError(f"splits must be 1 for conv0 and in [1, {C // CHUNK}] otherwise, "
                         f"got {splits}")
    out = torch.empty((B, M, C), dtype=torch.float32, device=x.device)
    work = torch.empty(splits * B * M * C, dtype=torch.float32, device=x.device) if splits > 1 \
        else None  # the split-K partial sums
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_conv_layer(
            x.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(), W.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), layer, B, Tin, C, splits, stream,
        )
    conv_frontend_layer.launches += 1
    _build.check(err, "conv_frontend_layer")
    return out


conv_frontend_layer.launches = 0


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

