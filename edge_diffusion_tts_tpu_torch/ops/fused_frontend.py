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
its plain version).  The encoder owns the route to it: ``HubertEncoder``
packs its stack's weights once (``pack_frontend_weights``) where
``kernel_serves`` says the kernel takes that stack at its dtype, and runs
``conv_frontend`` in place of its modules (models/hubert.py).

WavLM's stack (``feat_extract_norm="layer"``: a LayerNorm over the channels
of each frame after every conv, no GroupNorm) takes the bf16 variant's
LayerNorm mode: ``pack_frontend_weights`` packs the seven norms' ``gamma``
and ``beta`` as [7, C] (the GroupNorm's are [C]), and that shape selects the
mode everywhere below.  Each conv's norm and GELU run in its kernel's
epilogue from the float32 sums; nothing is rounded between a conv and its
norm, and the wav stays float32 into conv0 (the modules round both to
bf16).  The mode runs at bf16 only: a float32 LayerNorm stack keeps the
modules (``kernel_serves``).

``compute_dtype=torch.bfloat16`` selects the bf16 variant, the TPU kernel at
``compute_dtype=jnp.bfloat16``: conv0, its GroupNorm and GELU in float32, then
bf16 activations and bf16 weights (``pack_frontend_weights(..., dtype=
torch.bfloat16)``) with float32 sums on the card's tensor cores, float32
features out.  Its conv1-6 run in one of ``FRONTEND_BF16_TILES`` per layer,
by ``frontend_tile``: ``wgmma`` with TMA loads (csrc/conv_wgmma.cuh) where
the tiles fill the card, the ``mma.sync`` kernel with split-K where
they do not.  The wrappers check every tensor against the dtype asked for,
so neither variant takes the other's weights.  ``fast_encode`` is the JAX
package's name for the encode ``EdgeInference`` runs: the encoder's own,
at the dtype the encoder was built at (the JAX function's ``compute_dtype``).
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
CHUNK_BF16 = 32  # the bf16 variant's mma.sync tile: input channels per K step
CONV0_ROWS_BF16 = 64  # the bf16 variant's conv0: output frames per chunk
CONV0_GROUPS_BF16 = 4  # ... in 256 / (C / 8) frame groups of C / 8 threads (4 at C = 512)
CONV0_BLOCKS_BF16 = 2112  # ... and the blocks it aims for, each walking several chunks
# The bf16 variant's conv1-6 tiles, by index: the mma.sync kernel (split-K
# over CHUNK_BF16-channel chunks) and the wgmma kernel at 256 and 128
# channels (one block per SM over the tiles); smem is the k = 3 layer's.
# ``fill``: the share of one wave of blocks that a wgmma tile's tiles must
# give before ``frontend_tile`` takes it (PERF.md §6: the wider tile
# was the faster wherever its tiles filled 0.95 of a wave, the narrower
# one, and the mma.sync kernel below it, at half a wave).
FRONTEND_BF16_TILES = (
    dict(kernel="mma.sync", rows=128, cols=128, stages=4, threads=256, smem=164352, fill=0.0),
    dict(kernel="wgmma", rows=128, cols=256, stages=4, threads=288, smem=230464, fill=0.9),
    dict(kernel="wgmma", rows=128, cols=128, stages=6, threads=288, smem=230496, fill=0.45),
)
H100_SMS = 132
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
# The LayerNorm mode's widths (csrc/conv_frontend.cu): conv0's frame groups
# whole warps (a multiple of 256 channels), a cluster of at most 8 blocks.
LN_WIDTH, LN_MAX_WIDTH, LN_EPS = 256, 1024, 1e-5


def _compute_dtype(dtype) -> torch.dtype:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"the frontend computes in float32 or bfloat16, not {dtype}")
    return dtype


def _chunk(dtype) -> int:
    return CHUNK if _compute_dtype(dtype) == torch.float32 else CHUNK_BF16


def _base_stack(hc: HubertConfig) -> bool:
    return (tuple(hc.conv_kernel) == BASE_KERNELS and tuple(hc.conv_stride) == BASE_STRIDES
            and len(set(hc.conv_dim)) == 1)


def check_base_specs(hc: HubertConfig) -> None:
    """Raise unless ``hc`` has the hubert-base conv stack the kernel implements."""
    if not _base_stack(hc):
        raise ValueError(
            "the conv-frontend kernel implements the hubert-base stack (kernels "
            f"{BASE_KERNELS}, strides {BASE_STRIDES}, one width; conv0's GroupNorm or a "
            f"LayerNorm after every conv), not kernels {hc.conv_kernel}, strides "
            f"{hc.conv_stride}, widths {hc.conv_dim}")


def kernel_serves(hc: HubertConfig, dtype: torch.dtype) -> bool:
    """Whether the frontend kernel takes ``hc``'s conv stack at compute
    ``dtype``: hubert-base's kernels and strides, one width, and that width a
    multiple of ``TILE[1]``; a LayerNorm stack (WavLM's) only at bfloat16, in
    the LayerNorm mode's widths (a float32 one takes the modules)."""
    if not (_base_stack(hc) and hc.conv_dim[0] % TILE[1] == 0):
        return False
    C = hc.conv_dim[0]
    return hc.feat_extract_norm == "group" or (
        dtype == torch.bfloat16 and C % LN_WIDTH == 0 and C <= LN_MAX_WIDTH)


def layer_norm_mode(w: Dict[str, torch.Tensor]) -> bool:
    """Whether packed weights ``w`` are a LayerNorm stack's ([7, C] norms)."""
    return "gamma" in w and w["gamma"].dim() == 2


def pack_frontend_weights(feature_extractor, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The extractor's weights in the kernel's layout: ``w0`` [C, 10], ``wk3``
    [4, C, 3C] (conv1-4) and ``wk2`` [2, C, 2C] (conv5-6), each [C_out,
    k*C_in] with the tap outer, and the GroupNorm's ``gamma``, ``beta`` [C]
    (a LayerNorm stack's: the seven norms' [7, C]).  With ``dtype``
    bfloat16, ``wk3`` and ``wk2`` are rounded to bf16 once, here (the TPU
    kernel casts them when it stacks them); ``w0`` and the norms stay
    float32."""
    check_base_specs(feature_extractor.cfg)
    layers = feature_extractor.conv_layers
    convs = [layer.conv.weight.detach().float() for layer in layers]
    C = convs[0].shape[0]
    wk = [w.permute(0, 2, 1).reshape(C, -1) for w in convs[1:]]
    norms = layers if feature_extractor.cfg.feat_extract_norm == "layer" else layers[:1]
    w = {
        "w0": convs[0][:, 0, :],
        "wk3": torch.stack(wk[:4]),
        "wk2": torch.stack(wk[4:]),
        "gamma": torch.stack([n.layer_norm.weight.detach().float() for n in norms]),
        "beta": torch.stack([n.layer_norm.bias.detach().float() for n in norms]),
    }
    if len(norms) == 1:  # conv0's GroupNorm: [C]
        w["gamma"], w["beta"] = w["gamma"][0], w["beta"][0]
    w = {k: v.float().contiguous() for k, v in w.items()}
    if _compute_dtype(dtype) != torch.float32:
        w["wk3"], w["wk2"] = w["wk3"].to(dtype), w["wk2"].to(dtype)
    return w


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


def frontend_plan(B: int, num_samples: int, C: int = 512, sms: int = H100_SMS,
                  dtype=torch.float32) -> List[dict]:
    """The host's launch plan for wav [B, num_samples] on a card of ``sms``
    SMs: per layer M (output frames), N (channels), K (reduction depth),
    ``tile`` (frames x channels per block), ``splits`` (split-K factor) and
    ``blocks`` of its main launch; for ``dtype`` bfloat16 also ``tile_index``
    (into ``FRONTEND_BF16_TILES``, conv1-6).

    conv0 has a kernel of its own (``CONV0_ROWS`` frames x all channels per
    block; at bf16 chunks of ``CONV0_ROWS_BF16`` frames, each block walking
    several, about ``CONV0_BLOCKS_BF16`` blocks in all).  conv1-6 run one
    block per SM (the 4-stage ring takes 131-164 KB of shared memory); a
    layer whose tiles alone would leave SMs idle splits K into the most
    parts whose blocks still run as one wave (tiles x splits <= sms), at
    most one part per chunk.  One wave beat the next factor up (>= sms blocks, two waves) at
    every split layer on the H100 (PERF.md).  Split ``s`` of S takes the
    input-channel chunks [s*Q//S, (s+1)*Q//S) of Q = C / CHUNK, whole
    chunks every one (C / CHUNK_BF16 for the bf16 mma.sync tile, whose ring
    takes 128-160.5 KB).  At bf16, ``frontend_tile`` picks each layer's
    tile; a wgmma tile runs a persistent grid of min(tiles, sms) blocks
    and never splits.
    """
    low = _compute_dtype(dtype) != torch.float32
    chunk = _chunk(dtype)
    frames = frame_counts(num_samples)
    rows0 = CONV0_ROWS_BF16 if low else CONV0_ROWS
    per_row = min(_cdiv(frames[0], rows0), _cdiv(CONV0_BLOCKS_BF16, B)) if low else \
        _cdiv(frames[0], rows0)
    plan = [dict(layer=0, M=frames[0], N=C, K=BASE_KERNELS[0], tile=(rows0, C), splits=1,
                 blocks=B * per_row)]
    for i in range(1, LAYERS):
        M = frames[i]
        index = frontend_tile(B, M, C, sms) if low else 0
        t = FRONTEND_BF16_TILES[index] if low else dict(rows=TILE[0], cols=TILE[1])
        tiles = B * _cdiv(M, t["rows"]) * _cdiv(C, t["cols"])
        if index:
            splits, blocks = 1, min(tiles, sms)
        else:
            splits = _layer_splits(tiles, C // chunk, sms)
            blocks = tiles * splits
        entry = dict(layer=i, M=M, N=C, K=BASE_KERNELS[i] * C, tile=(t["rows"], t["cols"]),
                     splits=splits, blocks=blocks)
        if low:
            entry["tile_index"] = index
        plan.append(entry)
    return plan


def frontend_tile(B: int, M: int, C: int = 512, sms: int = H100_SMS) -> int:
    """The bf16 tile of a conv1-6 layer of M output frames, an index into
    ``FRONTEND_BF16_TILES``: the first wgmma tile (the widest first) whose
    tiles give at least its ``fill`` share of a wave of ``sms`` blocks;
    where none does, the mma.sync tile (0), which splits K to fill the
    card."""
    for index, t in enumerate(FRONTEND_BF16_TILES):
        if t["kernel"] == "wgmma" and C % t["cols"] == 0 and \
                B * _cdiv(M, t["rows"]) * (C // t["cols"]) >= t["fill"] * sms:
            return index
    return 0


def _layer_splits(tiles: int, chunks: int, sms: int) -> int:
    return max(1, min(chunks, sms // tiles))


def frontend_workspace(B: int, plan: List[dict], dtype=torch.float32,
                       layer_norm: bool = False) -> int:
    """Floats of scratch the frontend needs: conv0's and conv1's outputs
    (every later layer fits in one of the two) and the largest split-K
    layer's partial sums.  For ``dtype`` bfloat16 the two outputs are bf16
    (half a float each) and the partial sums stay float32; in the
    ``layer_norm`` mode every layer on the mma.sync tile writes partial
    sums, split or not."""
    C = plan[0]["N"]
    partials = max([p["splits"] * p["M"] for p in plan[1:]
                    if p["splits"] > 1 or (layer_norm and p.get("tile_index") == 0)] or [0])
    if _compute_dtype(dtype) == torch.float32:
        return B * C * (plan[0]["M"] + plan[1]["M"] + partials)
    return B * C * (plan[0]["M"] + plan[1]["M"]) // 2 + B * C * partials


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


def _gelu_round(y: torch.Tensor, dtype) -> torch.Tensor:
    """erf-GELU in float32, then a round to ``dtype`` (RNE, as ``.astype``)."""
    return F.gelu(y).to(dtype)


def conv_frontend_plain(wav: torch.Tensor, w: Dict[str, torch.Tensor], wav_len=None,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """The kernel's computation with ``F.conv1d`` (same inputs, same order).

    With ``compute_dtype`` bfloat16 it rounds where the bf16 kernel rounds:
    each layer's GELU output to bf16 (conv6's stays float32), and conv1-6's
    weights to bf16; the products of those bf16 values are exact in float32
    and summed in float32, as on the tensor cores.  A LayerNorm stack's
    ``w`` normalises each conv's float32 output over its channels before
    the GELU (``wav_len`` then changes nothing: a frame's norm sees that
    frame alone)."""
    if _compute_dtype(compute_dtype) != torch.float32 or layer_norm_mode(w):
        return _conv_frontend_plain_layers(wav, w, wav_len, compute_dtype)
    scale, shift = groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"], wav_len)
    C = w["w0"].shape[0]
    x = F.conv1d(wav[:, None, :].float(), w["w0"][:, None, :], stride=BASE_STRIDES[0])
    x = F.gelu(x * scale[:, :, None] + shift[:, :, None])
    layers = list(w["wk3"]) + list(w["wk2"])
    for wk, s in zip(layers, BASE_STRIDES[1:]):
        x = F.gelu(F.conv1d(x, wk.reshape(C, -1, C).permute(0, 2, 1), stride=s))
    return x.transpose(1, 2)


def _conv_frontend_plain_layers(wav, w, wav_len, dtype) -> torch.Tensor:
    x = wav.float()
    fold = () if layer_norm_mode(w) else groupnorm_fold(x, w["w0"], w["gamma"], w["beta"],
                                                        wav_len)
    x = conv_frontend_layer_plain(x, 0, w, *fold, compute_dtype=dtype)
    for layer in range(1, LAYERS):
        x = conv_frontend_layer_plain(x, layer, w, compute_dtype=dtype)
    return x


def conv_frontend_layer_plain(x: torch.Tensor, layer: int, w: Dict[str, torch.Tensor],
                              scale: Optional[torch.Tensor] = None,
                              shift: Optional[torch.Tensor] = None,
                              compute_dtype=torch.float32) -> torch.Tensor:
    """One layer of ``conv_frontend_plain``, channels-last in and out: wav
    [B, Twav] (layer 0, with conv0's folded GroupNorm ``scale``, ``shift``
    [B, C]) or [B, Tin, C] -> [B, Tout, C]: one ``F.conv1d``, then GELU.
    With ``compute_dtype`` bfloat16 the output is rounded to bf16 (conv6's
    is float32) and conv1-6 take their input and weights at bf16.  For a
    LayerNorm stack's ``w`` (no ``scale``, ``shift``) the float32 conv
    output is normalised over its channels with the layer's ``gamma``,
    ``beta`` (eps 1e-5) before the GELU; conv0 takes the float32 wav."""
    W = layer_weight(w, layer)
    C = W.shape[0]
    low = _compute_dtype(compute_dtype) != torch.float32
    ln = layer_norm_mode(w)
    if layer == 0:
        y = F.conv1d(x[:, None, :].float(), W.float()[:, None, :], stride=BASE_STRIDES[0])
        if not ln:
            y = y * scale[:, :, None] + shift[:, :, None]
    elif low:
        y = F.conv1d(x.to(compute_dtype).float().transpose(1, 2).contiguous(),
                     W.to(compute_dtype).float().reshape(C, -1, C).permute(0, 2, 1),
                     stride=BASE_STRIDES[layer])
    else:
        y = F.conv1d(x.transpose(1, 2).contiguous(),
                     W.reshape(C, -1, C).permute(0, 2, 1), stride=BASE_STRIDES[layer])
    out_dtype = compute_dtype if low and layer < LAYERS - 1 else torch.float32
    if ln:
        y = F.layer_norm(y.transpose(1, 2), (C,), w["gamma"][layer].float(),
                         w["beta"][layer].float(), LN_EPS).transpose(1, 2)
    return _gelu_round(y, out_dtype).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_frontend")
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix in ("", "_bf16"):
        low = bool(suffix)  # the bf16 entries also take the tiles
        ws = getattr(lib, f"edt_conv_frontend{suffix}_workspace")
        ws.argtypes, ws.restype = [i, i, i, p], ctypes.c_longlong
        front = getattr(lib, f"edt_conv_frontend{suffix}")
        front.argtypes, front.restype = [p] * 8 + [i] * 3 + [p] * (3 if low else 2), ctypes.c_int
        layer = getattr(lib, f"edt_conv_layer{suffix}")
        layer.argtypes, layer.restype = [p] * 6 + [i] * (6 if low else 5) + [p], ctypes.c_int
    lib.edt_conv_frontend_ln_workspace.argtypes = [i, i, i, p, p]
    lib.edt_conv_frontend_ln_workspace.restype = ctypes.c_longlong
    lib.edt_conv_frontend_ln.argtypes, lib.edt_conv_frontend_ln.restype = \
        [p] * 8 + [i] * 3 + [p] * 3, ctypes.c_int
    lib.edt_conv_layer_ln.argtypes, lib.edt_conv_layer_ln.restype = [p] * 6 + [i] * 6 + [p], \
        ctypes.c_int
    lib.edt_frontend_geometry.argtypes, lib.edt_frontend_geometry.restype = [i, i, p], ctypes.c_int
    for counter in ("edt_conv_wgmma_launches", "edt_conv_ln_launches"):
        fn = getattr(lib, counter)
        fn.argtypes, fn.restype = [], ctypes.c_longlong
    return lib


def frontend_geometry(tile: int, C: int = 512) -> dict:
    """The bf16 geometry the built library reports, to hold the plan's
    constants against: for a conv1-6 ``tile`` (an index into
    ``FRONTEND_BF16_TILES``) its rows, cols, stages, threads and smem; for
    ``tile`` -1, conv0's rows (frames per chunk), channels per thread,
    groups, threads at width ``C`` and the blocks it aims for."""
    out = (ctypes.c_int * 5)()
    _build.check(_lib().edt_frontend_geometry(tile, C, out), "edt_frontend_geometry")
    keys = ("rows", "channels", "groups", "threads", "blocks") if tile == -1 else (
        "rows", "cols", "stages", "threads", "smem")
    return dict(zip(keys, out))


def wgmma_launches() -> int:
    """Launches of the bf16 wgmma conv kernel since the library was loaded."""
    return _lib().edt_conv_wgmma_launches()


def ln_launches() -> int:
    """Layer launches of the LayerNorm mode (seven a call) since the library
    was loaded."""
    return _lib().edt_conv_ln_launches()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(tensors: Dict[str, torch.Tensor], expected: Dict[str, tuple], device,
           dtypes: Optional[Dict[str, torch.dtype]] = None) -> None:
    """Each tensor contiguous, of its shape, on ``device`` and of its dtype in
    ``dtypes`` (float32 where it has none)."""
    for name, shape in expected.items():
        t = tensors[name]
        dtype = (dtypes or {}).get(name, torch.float32)
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"{name}: expected contiguous {str(dtype)[6:]} {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _splits(plan: List[dict]):
    return (ctypes.c_int * LAYERS)(*(p["splits"] for p in plan))


def _tiles(plan: List[dict]):
    return (ctypes.c_int * LAYERS)(*(p.get("tile_index", 0) for p in plan))


def conv_frontend(wav: torch.Tensor, w: Dict[str, torch.Tensor], fold=None,
                  wav_len=None, compute_dtype=torch.float32) -> torch.Tensor:
    """wav [B, Twav] -> conv features [B, frames, C] (``w`` from
    ``pack_frontend_weights``), float32.

    CPU tensors take ``conv_frontend_plain``; CUDA tensors launch the kernel
    sequence, counted once per call in ``conv_frontend.launches`` (the
    float32 variant) or ``conv_frontend.bf16_launches`` (``compute_dtype``
    bfloat16, whose ``w`` holds bf16 ``wk3``/``wk2``: each variant raises on
    the other's weights), and raise under grad mode when one of them
    requires a gradient.  ``fold``
    is ``groupnorm_fold``'s ``(scale, shift)`` for this wav where the caller
    has it already (timing the kernels alone); by default it is computed,
    over each row's first ``wav_len`` samples where ``wav_len`` is given (a
    zero-padded wav; the frames inside the true length then equal an
    exact-length call's).  The kernels themselves take the fold as it is.
    A LayerNorm stack's ``w`` runs the LayerNorm mode, at bfloat16 only on
    the card, with no fold (``wav_len`` changes nothing there).
    """
    low = _compute_dtype(compute_dtype) != torch.float32
    ln = layer_norm_mode(w)
    if wav.dim() != 2:
        raise ValueError(f"wav must be [B, T], got {tuple(wav.shape)}")
    B, Twav = wav.shape
    frames = frame_counts(Twav)[-1]
    if frames < 1:
        raise ValueError(f"{Twav} samples give no frame (hubert-base needs >= 400)")
    if wav.device.type == "cpu":
        return conv_frontend_plain(wav, w, wav_len, compute_dtype)
    if wav.device.type != "cuda":
        raise ValueError(f"conv_frontend runs on CPU or CUDA, not {wav.device}")
    _build.refuse_autograd("conv_frontend", wav, *w.values(), *(fold or ()))
    C = w["w0"].shape[0]
    if C % TILE[1]:
        raise ValueError(f"the frontend kernel needs a width that is a multiple of {TILE[1]}, "
                         f"not {C}")
    if ln:  # the kernels take the seven norms where the GroupNorm's fold goes
        _check_ln(C, low, fold)
        scale, shift = w["gamma"], w["beta"]
    else:
        scale, shift = fold if fold is not None else groupnorm_fold(
            wav, w["w0"], w["gamma"], w["beta"], wav_len)
    norm, affine = ((LAYERS, C), (LAYERS, C)) if ln else ((C,), (B, C))
    _check(dict(w, wav=wav, scale=scale, shift=shift),
           {"wav": (B, Twav), "w0": (C, 10), "wk3": (4, C, 3 * C), "wk2": (2, C, 2 * C),
            "gamma": norm, "beta": norm, "scale": affine, "shift": affine}, wav.device,
           {"wk3": compute_dtype, "wk2": compute_dtype})
    plan = frontend_plan(B, Twav, C, _sm_count(wav.device.index or 0), compute_dtype)
    splits, tiles = _splits(plan), _tiles(plan)
    lib = _lib()
    suffix = "_ln" if ln else "_bf16" if low else ""
    out = torch.empty((B, frames, C), dtype=torch.float32, device=wav.device)
    nbytes = getattr(lib, f"edt_conv_frontend{suffix}_workspace")(
        B, Twav, C, splits, *((tiles,) if ln else ()))
    work = torch.empty(nbytes if low else nbytes * 4, dtype=torch.uint8, device=wav.device)
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"edt_conv_frontend{suffix}")(
            wav.data_ptr(), out.data_ptr(), work.data_ptr(), w["w0"].data_ptr(),
            w["wk3"].data_ptr(), w["wk2"].data_ptr(), scale.data_ptr(), shift.data_ptr(),
            B, Twav, C, splits, *((tiles,) if low else ()), stream,
        )
    with _LAUNCHES_LOCK:  # handler threads launch it at once (stream preps)
        if low:
            conv_frontend.bf16_launches += 1
        else:
            conv_frontend.launches += 1
    _build.check(err, "conv_frontend")
    return out


conv_frontend.launches = 0
conv_frontend.bf16_launches = 0
_LAUNCHES_LOCK = threading.Lock()


def _check_ln(C: int, low: bool, fold) -> None:
    """Raise unless the LayerNorm mode takes a call at width ``C``."""
    if not low:
        raise ValueError("the frontend kernel's LayerNorm mode runs at bfloat16 (a float32 "
                         "LayerNorm stack takes the modules)")
    if C % LN_WIDTH or C > LN_MAX_WIDTH:
        raise ValueError(f"the LayerNorm mode needs a width that is a multiple of {LN_WIDTH}, "
                         f"at most {LN_MAX_WIDTH}, not {C}")
    if fold is not None:
        raise ValueError("a LayerNorm stack has no GroupNorm fold")


def conv_frontend_layer(x: torch.Tensor, layer: int, w: Dict[str, torch.Tensor],
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None,
                        splits: Optional[int] = None,
                        compute_dtype=torch.float32,
                        tile: Optional[int] = None) -> torch.Tensor:
    """One layer of the frontend kernel sequence alone, as
    ``conv_frontend_layer_plain`` computes it, in the host plan's tile and,
    unless ``splits`` is given (1 to C / CHUNK, conv1-6; C / CHUNK_BF16 for
    bf16), its split-K factor for this shape (``frontend_plan``).

    At bf16, conv1-6 take ``tile``, an index into ``FRONTEND_BF16_TILES``:
    by default ``frontend_tile``'s pick, or the mma.sync tile (0) where
    ``splits`` is given, the only one that splits K (a wgmma tile takes
    ``splits`` 1 alone).

    A test and timing hook: it takes CUDA tensors only (contiguous float32;
    with ``compute_dtype`` bfloat16, bf16 input and weights for conv1-6 and a
    bf16 output for conv0-5) and raises on anything else, CPU tensors
    included; it never falls back.  Counted in
    ``conv_frontend_layer.launches`` (``.bf16_launches``).  A LayerNorm
    stack's ``w`` runs the layer in the LayerNorm mode (bfloat16, no
    ``scale`` or ``shift``: the layer's norm comes from ``w``; its mma.sync
    tile writes partial sums whatever ``splits``).
    """
    low = _compute_dtype(compute_dtype) != torch.float32
    ln = layer_norm_mode(w)
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
    dtypes = {"x": compute_dtype, "W": compute_dtype} if low and layer > 0 else {}
    if ln:
        _check_ln(C, low, None if scale is None and shift is None else (scale, shift))
        scale, shift = w["gamma"][layer], w["beta"][layer]
        tensors.update(scale=scale, shift=shift)
        expected.update(scale=(C,), shift=(C,))
    elif layer == 0:
        if scale is None or shift is None:
            raise ValueError("layer 0 takes conv0's folded GroupNorm scale and shift")
        tensors.update(scale=scale, shift=shift)
        expected.update(scale=(B, C), shift=(B, C))
    _check(tensors, expected, x.device, dtypes)
    sms = _sm_count(x.device.index or 0)
    tile = _layer_tile(tile, splits, low, layer, B, M, C, sms)
    chunks = C // _chunk(compute_dtype)
    if splits is None:
        splits = 1 if layer == 0 or tile else _layer_splits(
            B * _cdiv(M, TILE[0]) * _cdiv(C, TILE[1]), chunks, sms)
    elif not (1 <= splits <= chunks and (layer > 0 or splits == 1)):
        raise ValueError(f"splits must be 1 for conv0 and in [1, {chunks}] otherwise, "
                         f"got {splits}")
    elif tile and splits != 1:
        raise ValueError(f"splits must be 1 in the wgmma tile {tile}, got {splits}")
    out_dtype = compute_dtype if low and layer < LAYERS - 1 else torch.float32
    out = torch.empty((B, M, C), dtype=out_dtype, device=x.device)
    partials = splits > 1 or (ln and layer > 0 and tile == 0)
    work = torch.empty(splits * B * M * C, dtype=torch.float32, device=x.device) if partials \
        else None  # the split-K partial sums
    lib = _lib()
    entry = lib.edt_conv_layer_ln if ln else lib.edt_conv_layer_bf16 if low else \
        lib.edt_conv_layer
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(
            x.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(), W.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), layer, B, Tin, C, splits,
            *((tile,) if low else ()), stream,
        )
    if low:
        conv_frontend_layer.bf16_launches += 1
    else:
        conv_frontend_layer.launches += 1
    _build.check(err, "conv_frontend_layer")
    return out


def _layer_tile(tile, splits, low: bool, layer: int, B: int, M: int, C: int, sms: int) -> int:
    """The bf16 tile index ``conv_frontend_layer`` launches (0 for float32
    and for conv0, which have one tile)."""
    if tile is not None:
        if not (low and layer > 0):
            raise ValueError("tile selects a conv1-6 tile of the bf16 variant")
        if not 0 <= tile < len(FRONTEND_BF16_TILES):
            raise ValueError(f"tile must be in [0, {len(FRONTEND_BF16_TILES)}), got {tile}")
        if C % FRONTEND_BF16_TILES[tile]["cols"]:
            raise ValueError(f"tile {tile} needs a width that is a multiple of "
                             f"{FRONTEND_BF16_TILES[tile]['cols']}, not {C}")
        return tile
    if not (low and layer > 0) or splits is not None:
        return 0
    return frontend_tile(B, M, C, sms)


conv_frontend_layer.launches = 0
conv_frontend_layer.bf16_launches = 0


@torch.no_grad()
def fast_encode(encoder, wav: torch.Tensor) -> torch.Tensor:
    """wav [B, T] -> token indices [B, S]: ``encoder.encode``, whose HuBERT
    takes its conv frontend's route itself (the kernel where it serves the
    stack, the modules elsewhere)."""
    return encoder.encode(wav)
