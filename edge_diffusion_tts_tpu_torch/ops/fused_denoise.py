"""The decoder's sampling loops as CUDA host calls, and their plain versions.

``fused_ddim`` replaces the TPU kernel ``edge_diffusion_tts_tpu/ops/
fused_denoise.py::_denoise_kernel`` (launched by ``fused_generate_mel``):
noise -> [decoder forward -> DDIM update] x num_steps -> x0.
``fused_ddpm`` replaces ``_ddpm_kernel`` (launched by ``fused_ddpm_sample``):
full-schedule ancestral DDPM, t = T-1 .. 0, with a Gaussian draw per step
from an in-kernel Philox4x32-10 generator, or from an injected ``noise``
tensor.  The design and what bounds them on the H100 are in
``csrc/fused_ddim.cu``: one C function runs the whole loop as a fixed
sequence of hand-written float32 kernels on PyTorch's current stream; both
loops share one decoder step of 2 + 8L launches plus the update: GEMMs
(``csrc/gemm.cuh``) with the row norms in their prologue and the bias,
SwiGLU, positional and residual terms in their epilogue, and the banded
attention of ``csrc/attention.cuh``.  A decoder with the depthwise pre-net
(``use_depthwise``) adds three launches to the step: the depthwise conv,
the pointwise GEMM and the GroupNorm / GELU / residual / positional pass.

``decoder_gemm`` launches that GEMM alone and ``decoder_prenet`` the
pre-net's three kernels alone (test and timing hooks, never on the main
path); ``decoder_gemm_plain`` and ``decoder_prenet_plain`` are their plain
versions, and ``decoder_step_plain`` calls them in the kernels' order.

As in the JAX package, everything that does not depend on x is computed once
per call outside the loop with plain tensor ops: context embedding and the
per-layer cross-attention K/V, the per-(step, layer) AdaLN scale/shift folded
with the RMSNorm weights (for DDPM a [1000, L, 4, H] table, 10.24 MB at the
flagship shape, which the JAX kernel recomputes per step because it does not
fit VMEM beside the weights), and the sampler's coefficients.

``philox4x32_10`` is the generator's integer arithmetic in torch int64 ops,
the same bits as the kernel's.  ``fused_ddim`` and ``fused_ddpm`` take the
plain version for CPU tensors only; for CUDA tensors they launch the kernel
or raise.  The plain versions keep the dtype they are given, so a float64
run of them is a witness of float32 rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..config import CFG, resolve_device
from ..layers.attention import sdpa
from ..layers.ffn import swiglu as _swiglu
from ..schedule import DiffusionSchedule
from .window_attention import banded_attention_plain

X0_CLIP = 3.0  # the DDIM update clips x0 to +-X0_CLIP, as the JAX kernel does

# Names, in the C entry point's order, of the packed decoder weights.
WEIGHT_NAMES = (
    "in_w", "in_b", "n2w", "qkv_w", "proj_w", "proj_b", "cq_w", "co_w",
    "fc1_w", "fc1_b", "fc2_w", "fc2_b", "fn_s", "fn_b", "out_w", "out_b",
)
# The depthwise pre-net's (``use_depthwise``), packed after WEIGHT_NAMES:
# depthwise taps [H, 3] (tap 0 reads row t-1), pointwise weight [H, H] and
# bias [H], GroupNorm scale and bias [H].
PRENET_NAMES = ("pc_dw", "pc_pw", "pc_pb", "pc_gs", "pc_gb")
PRENET_GROUPS = 8  # GroupNorm(min(8, H)) groups; the kernel takes H % 8 == 0


def pack_decoder_weights(decoder) -> Dict[str, torch.Tensor]:
    """The decoder's step-invariant weights, stacked over layers, contiguous.

    Linear weights keep torch's [out, in] layout.  The fused form is the
    AdaLN decoder (``use_adaln=True``); with ``use_depthwise`` the pre-net's
    weights follow under ``PRENET_NAMES`` (kernel size 3, stride 1, hidden
    a multiple of 8, so 8 GroupNorm groups).
    """
    cfg = decoder.cfg
    if not cfg.use_adaln:
        raise ValueError("the fused loop implements the AdaLN decoder (use_adaln=True)")
    blocks = list(decoder.layers)

    def stack(get):
        return torch.stack([get(b).detach().float() for b in blocks]).contiguous()

    w = {
        "in_w": decoder.in_proj.weight,
        "in_b": decoder.in_proj.bias,
        "n2w": stack(lambda b: b.norm2.weight),
        "qkv_w": stack(lambda b: b.attn.qkv.weight),
        "proj_w": stack(lambda b: b.attn.proj.weight),
        "proj_b": stack(lambda b: b.attn.proj.bias),
        "cq_w": stack(lambda b: b.cross_attn.q_proj.weight),
        "co_w": stack(lambda b: b.cross_attn.out_proj.weight),
        "fc1_w": stack(lambda b: b.ffn.net[0].weight),
        "fc1_b": stack(lambda b: b.ffn.net[0].bias),
        "fc2_w": stack(lambda b: b.ffn.net[3].weight),
        "fc2_b": stack(lambda b: b.ffn.net[3].bias),
        "fn_s": decoder.final_norm.weight,
        "fn_b": decoder.final_norm.bias,
        "out_w": decoder.out_proj.weight,
        "out_b": decoder.out_proj.bias,
    }
    if cfg.use_depthwise:
        pc = decoder.pre_conv
        H = cfg.hidden
        if pc.kernel_size != 3 or pc.stride != 1:
            raise ValueError(f"the fused pre-net takes a depthwise kernel of 3 at stride 1, "
                             f"not {pc.kernel_size} at stride {pc.stride}")
        if pc.norm.num_groups != PRENET_GROUPS:  # GroupNorm(min(8, H)): H < 8
            raise ValueError(f"the fused pre-net takes {PRENET_GROUPS} GroupNorm groups over a "
                             f"hidden width that is a multiple of {PRENET_GROUPS}, not "
                             f"{pc.norm.num_groups} over {H}")
        w.update(pc_dw=pc.depthwise.weight[:, 0, :], pc_pw=pc.pointwise.weight[:, :, 0],
                 pc_pb=pc.pointwise.bias, pc_gs=pc.norm.weight, pc_gb=pc.norm.bias)
    return {k: v.detach().float().contiguous() for k, v in w.items()}


def ddim_coefficients(schedule: DiffusionSchedule, num_steps: int):
    """``(ts, coef)``: the strided grid and [steps, 4] float32 coefficients
    (sqrt ab_t, sqrt(1-ab_t), sqrt ab_prev, sqrt(1-ab_prev)), t_prev =
    max(t - stride, 0)."""
    stride = max(schedule.T // num_steps, 1)
    ts = schedule.get_schedule_for_steps(num_steps)
    ab = schedule.alpha_bar.detach().cpu().numpy()
    coef = np.zeros((len(ts), 4), np.float32)
    for i, t in enumerate(ts):
        t_prev = max(t - stride, 0)
        coef[i] = (
            np.sqrt(ab[t]), np.sqrt(1.0 - ab[t]),
            np.sqrt(ab[t_prev]), np.sqrt(1.0 - ab[t_prev]),
        )
    return ts, torch.from_numpy(coef)


def ddpm_coefficients(schedule: DiffusionSchedule) -> torch.Tensor:
    """[T, 5] float32 per loop index i (t = T-1-i): sqrt ab, sqrt(1-ab),
    1/sqrt(alpha), beta/sqrt(1-ab), and sigma = sqrt(posterior variance),
    0 at t = 0 (no noise on the last step); computed as the JAX package does."""
    ab = schedule.alpha_bar.detach().cpu().numpy()
    alphas = schedule.alphas.detach().cpu().numpy()
    betas = schedule.betas.detach().cpu().numpy()
    pvar = schedule.posterior_variance.detach().cpu().numpy()
    coef = np.zeros((schedule.T, 5), np.float32)
    for i, t in enumerate(range(schedule.T - 1, -1, -1)):
        coef[i] = (
            np.sqrt(ab[t]), np.sqrt(1.0 - ab[t]), 1.0 / np.sqrt(alphas[t]),
            betas[t] / np.sqrt(1.0 - ab[t]), np.sqrt(pvar[t]) if t > 0 else 0.0,
        )
    return torch.from_numpy(coef)


@torch.no_grad()
def prepare_loop_inputs(decoder, sem_idx: torch.Tensor, T: int, ts,
                        step_idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Per-call, step-invariant tensors: ``pos`` [T, H], ``mods``
    [steps, L, 4, H] and ``ckv`` [L, B, S, 2H].  ``step_idx`` [steps] is the
    stage index each step's time conditioning gets (default: 0, 1, ...;
    DDPM drives every step with 0)."""
    device = sem_idx.device
    ctx = decoder.context(sem_idx=sem_idx)
    ckv = []
    for b in decoder.layers:
        ca = b.cross_attn
        ckv.append(ca.kv_up_proj(ca.kv_norm(ca.kv_down_proj(ctx))))
    n = len(ts)
    te = decoder.time_cond(
        torch.tensor(ts, dtype=torch.float32, device=device),
        torch.arange(n, device=device) if step_idx is None else step_idx.to(device),
    )
    mods = []
    for b in decoder.layers:
        per_layer = []
        for norm in (b.norm1, b.norm3):
            scale, shift = norm.proj(te).chunk(2, dim=-1)
            per_layer += [norm.norm.weight * (1.0 + scale), shift]
        mods.append(torch.stack(per_layer, dim=1))  # [steps, 4, H]
    if T > decoder.pos_emb.max_len:
        raise ValueError(f"{T} mel frames exceed the positional table's "
                         f"{decoder.pos_emb.max_len} rows")
    return {
        "pos": decoder.pos_emb.table[:T].contiguous(),
        "mods": torch.stack(mods, dim=1).contiguous(),
        "ckv": torch.stack(ckv).contiguous(),
    }


def decoder_gemm_plain(
    a, w, *, bias=None, pos=None, residual=None, norm: Optional[str] = None,
    scale=None, shift=None, swiglu: bool = False,
) -> torch.Tensor:
    """``decoder_gemm``'s computation in plain tensor ops, in its order.

    a [..., K] is normed over K when ``norm`` is "rms" (x / sqrt(mean(x^2) +
    1e-6) * scale (+ shift)) or "ln" (``F.layer_norm``, eps 1e-6); then
    c = a @ w.T (+ bias); with ``swiglu`` the halves of c give value *
    silu(gate); then + pos[m % pos.shape[0]] over the flattened rows m, then
    residual + c.  Keeps a's dtype.
    """
    K = a.shape[-1]
    if norm == "rms":
        a = a * torch.rsqrt(a.square().mean(-1, keepdim=True) + 1e-6) * scale
        if shift is not None:
            a = a + shift
    elif norm == "ln":
        a = F.layer_norm(a, (K,), scale, shift, eps=1e-6)
    elif norm is not None:
        raise ValueError(f"norm must be None, 'rms' or 'ln', not {norm!r}")
    c = a @ w.T
    if bias is not None:
        c = c + bias
    if swiglu:
        c = _swiglu(c)
    if pos is not None:
        rows = torch.arange(c.numel() // c.shape[-1], device=c.device) % pos.shape[0]
        c = c + pos[rows].reshape(c.shape)
    if residual is not None:
        c = residual + c
    return c


def decoder_prenet_plain(h, pos, w) -> torch.Tensor:
    """The depthwise pre-net and the positional rows on h [B, T, H], in the
    kernels' order: d = the k=3 depthwise conv along T within each row of
    the batch (rows outside [0, T) read as zero), u = d @ pc_pw.T + pc_pb,
    GroupNorm over each (batch row, group of H/8 channels) with the mean
    first and the variance around it (eps 1e-6), then h + gelu_erf(norm(u) *
    pc_gs + pc_gb) + pos.  Keeps h's dtype."""
    B, T, H = h.shape
    dw = w["pc_dw"]
    hp = F.pad(h, (0, 0, 1, 1))
    d = hp[:, :-2] * dw[:, 0] + hp[:, 1:-1] * dw[:, 1] + hp[:, 2:] * dw[:, 2]
    u = decoder_gemm_plain(d, w["pc_pw"], bias=w["pc_pb"])
    g = u.reshape(B, T, PRENET_GROUPS, H // PRENET_GROUPS)
    mean = g.mean(dim=(1, 3), keepdim=True)
    c = g - mean
    rstd = 1.0 / torch.sqrt(c.square().mean(dim=(1, 3), keepdim=True) + 1e-6)
    y = (c * rstd).reshape(B, T, H) * w["pc_gs"] + w["pc_gb"]
    return h + F.gelu(y) + pos


def decoder_step_plain(x, pos, mods_i, ckv, w, *, heads: int, window: int) -> torch.Tensor:
    """One decoder forward of x [B, T, M] with this step's AdaLN table
    ``mods_i`` [L, 4, H], in plain tensor ops in the kernel's order; the
    pre-net runs when ``w`` holds its weights."""
    B, T, M = x.shape
    H = pos.shape[1]
    L, S = ckv.shape[0], ckv.shape[2]
    dh = H // heads

    def split(t, n):
        return t.reshape(B, n, heads, dh).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(B, T, H)

    gemm = decoder_gemm_plain
    if "pc_pw" in w:
        h = decoder_prenet_plain(gemm(x, w["in_w"], bias=w["in_b"]), pos, w)
    else:
        h = gemm(x, w["in_w"], bias=w["in_b"], pos=pos)
    for l in range(L):
        m = mods_i[l]
        qkv = gemm(h, w["qkv_w"][l], norm="rms", scale=m[0], shift=m[1])
        q, k, v = (split(qkv[..., j * H:(j + 1) * H], T) for j in range(3))
        a = merge(banded_attention_plain(q, k, v, window))
        h = gemm(a, w["proj_w"][l], bias=w["proj_b"][l], residual=h)
        q = split(gemm(h, w["cq_w"][l], norm="rms", scale=w["n2w"][l]), T)
        a = merge(sdpa(q, split(ckv[l, ..., :H], S), split(ckv[l, ..., H:], S)))
        h = gemm(a, w["co_w"][l], residual=h)
        f = gemm(h, w["fc1_w"][l], bias=w["fc1_b"][l], norm="rms", scale=m[2], shift=m[3],
                 swiglu=True)
        h = gemm(f, w["fc2_w"][l], bias=w["fc2_b"][l], residual=h)
    return gemm(h, w["out_w"], bias=w["out_b"], norm="ln", scale=w["fn_s"], shift=w["fn_b"])


def fused_ddim_plain(
    x_T, pos, mods, ckv, coef, w, *, heads: int, window: int, prediction: str = "eps",
) -> torch.Tensor:
    """The kernel's computation in plain tensor ops (same inputs, same order)."""
    x, x0 = x_T, torch.zeros_like(x_T)
    for i in range(coef.shape[0]):
        pred = decoder_step_plain(x, pos, mods[i], ckv, w, heads=heads, window=window)
        sab, s1m, sabp, s1mp = coef[i]
        eps = s1m * x + sab * pred if prediction == "v" else pred
        x0 = ((x - s1m * eps) / sab).clamp(-X0_CLIP, X0_CLIP)
        x = sabp * x0 + s1mp * eps
    return x0


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for b in [0, 2^32), in int64 without
    overflow: b is split into 16-bit halves."""
    p_lo = a * (b & 0xFFFF)  # < 2^48
    p_hi = a * (b >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _U32


def philox4x32_10(counter: torch.Tensor, key) -> torch.Tensor:
    """Philox4x32-10 (Random123's constants): counter [..., 4] int64 words in
    [0, 2^32), key two such ints -> [..., 4] int64 words.  The same bits as
    ``philox4x32_10`` in csrc/fused_ddim.cu."""
    c0, c1, c2, c3 = counter.long().unbind(-1)
    k0, k1 = (int(k) & _U32 for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], -1)


def philox_normal(shape, step: int, key, device=None) -> torch.Tensor:
    """The DDPM kernel's draws for loop index ``step``: element e of the
    flattened ``shape`` takes counter (e, step, 0, 0); words 0 and 1 become
    uniforms u1, u2 in [0, 1) (top 23 bits) and z = sqrt(-2 log1p(-u1)) *
    cos(2 pi u2)."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    words = philox4x32_10(torch.stack([idx, torch.full_like(idx, step), zero, zero], -1), key)
    u1, u2 = ((words[:, j] >> 9).float() * (1.0 / 8388608.0) for j in (0, 1))
    z = torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(6.283185307179586 * u2)
    return z.reshape(shape)


def fused_ddpm_plain(
    x_T, pos, mods, ckv, coef, w, *, heads: int, window: int, prediction: str = "eps",
    noise: Optional[torch.Tensor] = None, key=(0, 0),
) -> torch.Tensor:
    """The DDPM kernel's computation in plain tensor ops: per loop index i,
    x <- coef[i, 2] (x - coef[i, 3] eps) + coef[i, 4] z, with z =
    ``noise[:, i]`` or ``philox_normal(x.shape, i, key)``."""
    x = x_T
    for i in range(coef.shape[0]):
        pred = decoder_step_plain(x, pos, mods[i], ckv, w, heads=heads, window=window)
        c = coef[i]
        eps = c[1] * x + c[0] * pred if prediction == "v" else pred
        mean = c[2] * (x - c[3] * eps)
        z = noise[:, i] if noise is not None else philox_normal(x.shape, i, key, x.device)
        x = mean + c[4] * z.to(x.dtype)
    return x


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ddim")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edt_fused_ddim_workspace.argtypes = [i, i, i, i, i]
    lib.edt_fused_ddim_workspace.restype = ctypes.c_longlong
    lib.edt_fused_ddim.argtypes = [p] * 28 + [i] * 11 + [ctypes.c_float, p]
    lib.edt_fused_ddim.restype = ctypes.c_int
    lib.edt_fused_ddpm.argtypes = [p] * 29 + [i] * 11 + [ctypes.c_uint] * 2 + [p]
    lib.edt_fused_ddpm.restype = ctypes.c_int
    lib.edt_decoder_gemm.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.edt_decoder_gemm.restype = ctypes.c_int
    lib.edt_decoder_prenet.argtypes = [p] * 9 + [i] * 3 + [p]
    lib.edt_decoder_prenet.restype = ctypes.c_int
    lib.edt_decoder_gemm_tile.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.edt_decoder_gemm_tile.restype = None
    lib.edt_kernel_launches.argtypes = []
    lib.edt_kernel_launches.restype = ctypes.c_longlong
    return lib


def kernel_launches() -> int:
    """Kernels the loop library has launched in this process (every GEMM,
    attention, pre-net and update launch, the loops' and the hooks')."""
    return int(_lib().edt_kernel_launches())


def decoder_gemm_tile(m: int, n: int):
    """``(rows, columns)`` of the output tile the host picks for an m x n
    output of ``decoder_gemm`` and of the decoder step's GEMMs."""
    bm_bn = (ctypes.c_int * 2)()
    _lib().edt_decoder_gemm_tile(m, n, bm_bn)
    return bm_bn[0], bm_bn[1]


def decoder_gemm(
    a, w, *, bias=None, pos=None, residual=None, norm: Optional[str] = None,
    scale=None, shift=None, swiglu: bool = False, out=None,
) -> torch.Tensor:
    """One launch of the decoder step's GEMM (csrc/gemm.cuh), as
    ``decoder_gemm_plain`` computes it; ``out`` may be ``residual`` (updated
    in place, as the step does).  Its tile is the host's pick
    (``decoder_gemm_tile``).

    A test and timing hook: it takes CUDA tensors only (contiguous float32,
    a [..., K] with K % 4 == 0, w [N, K] or [2N, K] with ``swiglu``) and
    raises on anything else, CPU tensors included; it never falls back.
    Counted in ``decoder_gemm.launches``.
    """
    if a.device.type != "cuda":
        raise ValueError(f"decoder_gemm runs on CUDA tensors only, not {a.device} "
                         "(its plain version is decoder_gemm_plain)")
    K = a.shape[-1]
    rows = a.numel() // K if K else 0
    n_out = w.shape[0] // 2 if swiglu else w.shape[0]
    out_shape = (*a.shape[:-1], n_out)
    if norm not in (None, "rms", "ln") or (norm is None) != (scale is None) or (
            shift is not None and norm is None):
        raise ValueError(f"norm {norm!r}: 'rms' or 'ln' take a scale (and an optional "
                         "shift); no norm takes neither")
    expected = {
        "a": (a, tuple(a.shape)), "w": (w, (2 * n_out if swiglu else n_out, K)),
        "bias": (bias, (w.shape[0],)), "residual": (residual, out_shape),
        "out": (out, out_shape), "scale": (scale, (K,)), "shift": (shift, (K,)),
        "pos": (pos, (None if pos is None else pos.shape[0], n_out)),
    }
    for name, (t, shape) in expected.items():
        if t is not None and (tuple(t.shape) != shape or t.dtype != torch.float32
                              or not t.is_contiguous() or t.device != a.device):
            raise ValueError(f"{name}: expected contiguous float32 {shape} on {a.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if w.dim() != 2 or K % 4 or (pos is not None and pos.shape[0] == 0) or any(
            t.data_ptr() % 16 for t in (a, w, scale, shift) if t is not None):
        raise ValueError(f"a [..., {K}] and w {tuple(w.shape)}: K must be a multiple of 4, "
                         "a, w, scale and shift 16-byte aligned, pos non-empty")
    _build.refuse_autograd("decoder_gemm", a, w, bias, pos, residual, out, scale, shift)
    if out is None:
        out = torch.empty(out_shape, dtype=torch.float32, device=a.device)
    elif out.data_ptr() in (a.data_ptr(), w.data_ptr()):
        raise ValueError("out may alias residual only")

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_decoder_gemm(
            a.data_ptr(), w.data_ptr(), ptr(bias), ptr(pos), ptr(residual), out.data_ptr(),
            ptr(scale), ptr(shift), rows, n_out, K, 1 if pos is None else pos.shape[0],
            int(swiglu), int(norm == "ln"), stream,
        )
    decoder_gemm.launches += 1
    _build.check(err, "decoder_gemm")
    return out


decoder_gemm.launches = 0


def _check_prenet(T: int, H: int, device, pos, w) -> None:
    """Raise unless pos and the pre-net weights in ``w`` fit [T, H] rows on
    ``device`` as the kernels take them."""
    expected = {"pos": (pos, (T, H)), "pc_dw": (w["pc_dw"], (H, 3)),
                "pc_pw": (w["pc_pw"], (H, H)), **{n: (w[n], (H,)) for n in PRENET_NAMES[2:]}}
    for name, (t, shape) in expected.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{name}: expected contiguous float32 {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if H % PRENET_GROUPS:
        raise ValueError(f"hidden {H}: the fused pre-net takes a multiple of "
                         f"{PRENET_GROUPS} (its GroupNorm groups)")


def decoder_prenet(h, pos, w) -> torch.Tensor:
    """One run of the pre-net's three kernels (depthwise conv, pointwise
    GEMM, GroupNorm / GELU / residual / positional pass) on h [B, T, H], as
    ``decoder_prenet_plain`` computes it; returns a new tensor.

    A test and timing hook: CUDA tensors only (contiguous float32), it
    raises on anything else, CPU tensors included; it never falls back.
    Counted in ``decoder_prenet.launches``.
    """
    if h.device.type != "cuda":
        raise ValueError(f"decoder_prenet runs on CUDA tensors only, not {h.device} "
                         "(its plain version is decoder_prenet_plain)")
    if h.dim() != 3 or h.dtype != torch.float32 or not h.is_contiguous():
        raise ValueError(f"h: expected contiguous float32 [B, T, H], got {h.dtype} "
                         f"{tuple(h.shape)}")
    _check_prenet(h.shape[1], h.shape[2], h.device, pos, w)
    _build.refuse_autograd("decoder_prenet", h, pos, *(w[n] for n in PRENET_NAMES))
    B, T, H = h.shape
    out = torch.empty_like(h)
    work = torch.empty(2 * B * T * H, dtype=torch.float32, device=h.device)
    lib = _lib()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_decoder_prenet(h.data_ptr(), out.data_ptr(), work.data_ptr(),
                                     pos.data_ptr(), *_prenet_ptrs(w), B, T, H, stream)
    decoder_prenet.launches += 1
    _build.check(err, "decoder_prenet")
    return out


decoder_prenet.launches = 0


def _check_loop_args(x_T, pos, mods, ckv, coef, w, heads: int, n_coef: int) -> None:
    """Raise unless every tensor has the shape, type and device the loop
    kernels take."""
    B, T, M = x_T.shape
    steps, L, _, H = mods.shape
    S = ckv.shape[2]
    F2 = w["fc1_w"].shape[1]
    expected = {
        "x_T": (B, T, M), "pos": (T, H), "mods": (steps, L, 4, H),
        "ckv": (L, B, S, 2 * H), "coef": (steps, n_coef),
        "in_w": (H, M), "in_b": (H,), "n2w": (L, H), "qkv_w": (L, 3 * H, H),
        "proj_w": (L, H, H), "proj_b": (L, H), "cq_w": (L, H, H), "co_w": (L, H, H),
        "fc1_w": (L, F2, H), "fc1_b": (L, F2), "fc2_w": (L, H, F2 // 2),
        "fc2_b": (L, H), "fn_s": (H,), "fn_b": (H,), "out_w": (M, H), "out_b": (M,),
    }
    tensors = dict(w, x_T=x_T, pos=pos, mods=mods, ckv=ckv, coef=coef)
    for name, shape in expected.items():
        t = tensors[name]
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x_T.device):
            raise ValueError(f"{name}: expected contiguous float32 {shape} on "
                             f"{x_T.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if H % heads or H // heads > 64 or (H // heads) % 4:
        raise ValueError(f"hidden {H} / heads {heads}: the head dim must divide, be a "
                         "multiple of 4 and be <= 64")
    if M % 4 or F2 % 8:
        raise ValueError(f"n_mels {M} and ffn width {F2 // 2} must be multiples of 4 (the "
                         "kernels stage rows as 16-byte copies)")
    if any(n in w for n in PRENET_NAMES):
        missing = [n for n in PRENET_NAMES if n not in w]
        if missing:
            raise ValueError(f"pre-net weights {missing} missing: pack them with "
                             "pack_decoder_weights")
        _check_prenet(T, H, x_T.device, pos, w)


def _weight_ptrs(w, first: int, last: Optional[int] = None):
    return [w[n].data_ptr() for n in WEIGHT_NAMES[first:last]]


def _prenet_ptrs(w):
    """The pre-net weights' pointers in the C functions' order, or five nulls
    for a decoder without it."""
    return [w[n].data_ptr() if n in w else None for n in PRENET_NAMES]


def fused_ddim(
    x_T, pos, mods, ckv, coef, w, *, heads: int, window: int, prediction: str = "eps",
) -> torch.Tensor:
    """Run the whole DDIM loop; returns the last x0 [B, T, M].

    ``prediction="v"`` reads the decoder output as v; anything else as eps,
    as the JAX kernel does.

    CPU tensors take ``fused_ddim_plain``; CUDA tensors launch the kernel
    sequence, counted once per call in ``fused_ddim.launches``, and raise
    under grad mode when one of them requires a gradient (no backward).
    """
    if x_T.device.type == "cpu":
        return fused_ddim_plain(x_T, pos, mods, ckv, coef, w, heads=heads,
                                window=window, prediction=prediction)
    if x_T.device.type != "cuda":
        raise ValueError(f"fused_ddim runs on CPU or CUDA, not {x_T.device}")
    _build.refuse_autograd("fused_ddim", x_T, pos, mods, ckv, coef, *w.values())
    _check_loop_args(x_T, pos, mods, ckv, coef, w, heads, 4)
    B, T, M = x_T.shape
    steps, L, _, H = mods.shape
    S = ckv.shape[2]
    lib = _lib()
    ffn = w["fc1_w"].shape[1] // 2
    out = torch.empty_like(x_T)
    work = torch.empty(lib.edt_fused_ddim_workspace(B, T, H, ffn, M),
                       dtype=torch.float32, device=x_T.device)
    with torch.cuda.device(x_T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_fused_ddim(
            x_T.data_ptr(), out.data_ptr(), work.data_ptr(), pos.data_ptr(),
            *_weight_ptrs(w, 0, 2), mods.data_ptr(), *_weight_ptrs(w, 2, 7),
            ckv.data_ptr(), *_weight_ptrs(w, 7), coef.data_ptr(), *_prenet_ptrs(w),
            B, T, S, M, H, heads, L, ffn, window, steps, int(prediction == "v"),
            X0_CLIP, stream,
        )
    fused_ddim.launches += 1
    _build.check(err, "fused_ddim")
    return out


fused_ddim.launches = 0


def fused_ddpm(
    x_T, pos, mods, ckv, coef, w, *, heads: int, window: int, prediction: str = "eps",
    noise: Optional[torch.Tensor] = None, key=(0, 0),
) -> torch.Tensor:
    """Run the whole ancestral DDPM loop (``coef`` [steps, 5] from
    ``ddpm_coefficients``); returns the final x [B, T, M].

    The per-step draws are ``noise`` [B, steps, T, M] when given, else Philox
    normals under ``key`` (two 32-bit ints).  CPU tensors take
    ``fused_ddpm_plain``; CUDA tensors launch the kernel sequence, counted
    once per call in ``fused_ddpm.launches``.
    """
    kw = dict(heads=heads, window=window, prediction=prediction, noise=noise, key=key)
    if x_T.device.type == "cpu":
        return fused_ddpm_plain(x_T, pos, mods, ckv, coef, w, **kw)
    if x_T.device.type != "cuda":
        raise ValueError(f"fused_ddpm runs on CPU or CUDA, not {x_T.device}")
    _build.refuse_autograd("fused_ddpm", x_T, pos, mods, ckv, coef, noise, *w.values())
    _check_loop_args(x_T, pos, mods, ckv, coef, w, heads, 5)
    B, T, M = x_T.shape
    steps, L, _, H = mods.shape
    S = ckv.shape[2]
    if noise is not None and (
            tuple(noise.shape) != (B, steps, T, M) or noise.dtype != torch.float32
            or not noise.is_contiguous() or noise.device != x_T.device):
        raise ValueError(f"noise: expected contiguous float32 {(B, steps, T, M)} on "
                         f"{x_T.device}, got {noise.dtype} {tuple(noise.shape)}")
    lib = _lib()
    ffn = w["fc1_w"].shape[1] // 2
    out = torch.empty_like(x_T)
    work = torch.empty(lib.edt_fused_ddim_workspace(B, T, H, ffn, M),
                       dtype=torch.float32, device=x_T.device)
    k0, k1 = (int(k) & 0xFFFFFFFF for k in key)
    with torch.cuda.device(x_T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_fused_ddpm(
            x_T.data_ptr(), out.data_ptr(), work.data_ptr(), pos.data_ptr(),
            *_weight_ptrs(w, 0, 2), mods.data_ptr(), *_weight_ptrs(w, 2, 7),
            ckv.data_ptr(), *_weight_ptrs(w, 7), coef.data_ptr(),
            None if noise is None else noise.data_ptr(), *_prenet_ptrs(w),
            B, T, S, M, H, heads, L, ffn, window, steps, int(prediction == "v"),
            k0, k1, stream,
        )
    fused_ddpm.launches += 1
    _build.check(err, "fused_ddpm")
    return out


fused_ddpm.launches = 0


def _float32_only(compute_dtype, what: str, item: str) -> None:
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"{what} runs the float32 decoder step only: its {compute_dtype} variant (a "
            f"tensor-core step in gemm.cuh and attention.cuh) is ROADMAP Queue B item {item}")


def fused_generate_mel(
    cfg: CFG,
    schedule: DiffusionSchedule,
    decoder,
    sem_idx: torch.Tensor,
    x_T: torch.Tensor,
    num_steps: int,
    prediction: str = "eps",
    weights: Optional[Dict[str, torch.Tensor]] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """x_T [B, T, n_mels] + tokens [B, S] -> x0 through ``fused_ddim``.

    ``weights`` are ``pack_decoder_weights(decoder)``, packed here if not
    given.  The strided grid may hold fewer than ``num_steps`` steps; the loop
    runs what exists, as the JAX package does.  ``compute_dtype`` is the JAX
    function's: float32 only so far (bf16 raises NotImplementedError).
    """
    _float32_only(compute_dtype, "fused_generate_mel", "B2.3")
    ts, coef = ddim_coefficients(schedule, num_steps)
    with torch.no_grad():
        w = weights if weights is not None else pack_decoder_weights(decoder)
        loop = prepare_loop_inputs(decoder, sem_idx, x_T.shape[1], ts)
        return fused_ddim(
            x_T.float().contiguous(), loop["pos"], loop["mods"], loop["ckv"],
            coef.to(x_T.device), w, heads=cfg.heads, window=cfg.attn_window_size,
            prediction=prediction,
        )


def fused_ddpm_sample(
    cfg: CFG,
    schedule: DiffusionSchedule,
    decoder,
    sem_idx: torch.Tensor,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    prediction: str = "eps",
    noise: Optional[torch.Tensor] = None,
    weights: Optional[Dict[str, torch.Tensor]] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Full-schedule (``schedule.T`` steps) ancestral DDPM through ``fused_ddpm``.

    The semantics of ``schedule.ddpm_sample``: t = T-1 .. 0, the model
    called with step_idx 0, no noise at t = 0.  ``noise`` [B, schedule.T,
    T_mel, n_mels] injects the per-step draws; otherwise the kernel's Philox
    generator draws them under a 64-bit key taken from ``generator`` (a
    fresh one seeded 0 on ``sem_idx``'s device when None).  ``weights`` are
    ``pack_decoder_weights(decoder)``, packed here if not given.
    ``compute_dtype`` is the JAX function's: float32 only so far (bf16
    raises NotImplementedError).
    """
    _float32_only(compute_dtype, "fused_ddpm_sample", "B1.4")
    coef = ddpm_coefficients(schedule).to(x_T.device)
    ts = list(range(schedule.T - 1, -1, -1))
    key = (0, 0)
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=sem_idx.device).manual_seed(0)
        key = torch.randint(0, 2**32, (2,), generator=generator, dtype=torch.int64,
                            device=generator.device).tolist()
    with torch.no_grad():
        w = weights if weights is not None else pack_decoder_weights(decoder)
        loop = prepare_loop_inputs(decoder, sem_idx, x_T.shape[1], ts,
                                   step_idx=torch.zeros(len(ts), dtype=torch.long))
        return fused_ddpm(
            x_T.float().contiguous(), loop["pos"], loop["mods"], loop["ckv"], coef, w,
            heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction,
            noise=None if noise is None else noise.float().contiguous(), key=key,
        )


class FusedEdgeInference:
    """``generate_mel`` (DDIM) and ``sample_ddpm`` straight through the fused
    loops.

    Runs on CUDA unless ``device`` names another device; raises without a
    card.  The decoder's weights are packed once, when the object is built.
    """

    def __init__(self, cfg: CFG, schedule: DiffusionSchedule, decoder, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.schedule = schedule.to(self.device)
        self.decoder = decoder.to(self.device).eval()
        self.weights = pack_decoder_weights(self.decoder)

    @torch.inference_mode()
    def generate_mel(
        self,
        sem_idx,
        num_steps: Optional[int] = None,
        temperature: float = 1.0,
        generator: Optional[torch.Generator] = None,
        prediction: str = "eps",
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Tokens [B, S] -> normalized log-mel [B, 2S, n_mels]."""
        num_steps = num_steps or self.cfg.inference_steps
        sem_idx = torch.as_tensor(sem_idx, device=self.device).long()
        if x_T is None:
            x_T = start_noise(sem_idx, self.cfg.n_mels, temperature, generator)
        return fused_generate_mel(
            self.cfg, self.schedule, self.decoder, sem_idx,
            torch.as_tensor(x_T, dtype=torch.float32, device=self.device),
            num_steps, prediction, weights=self.weights,
        )

    @torch.inference_mode()
    def sample_ddpm(
        self,
        sem_idx,
        temperature: float = 1.0,
        generator: Optional[torch.Generator] = None,
        prediction: str = "eps",
    ) -> torch.Tensor:
        """Tokens [B, S] -> mel [B, 2S, n_mels] by full-schedule ancestral DDPM
        (``schedule.T`` steps) in one ``fused_ddpm`` call.  The start noise
        and then the Philox key come from ``generator`` (seeded 0 when None)."""
        sem_idx = torch.as_tensor(sem_idx, device=self.device).long()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        x_T = start_noise(sem_idx, self.cfg.n_mels, temperature, generator)
        return fused_ddpm_sample(self.cfg, self.schedule, self.decoder, sem_idx, x_T,
                                 generator=generator, prediction=prediction,
                                 weights=self.weights)


def start_noise(sem_idx: torch.Tensor, n_mels: int, temperature: float,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x_T = normal(B, 2S, n_mels) * temperature, drawn from ``generator``
    (a fresh one seeded 0 on ``sem_idx``'s device when None)."""
    B, S = sem_idx.shape
    if generator is None:
        generator = torch.Generator(device=sem_idx.device).manual_seed(0)
    x = torch.randn((B, 2 * S, n_mels), generator=generator, device=sem_idx.device)
    return x * temperature
