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

``decoder_gemm`` launches that GEMM alone, ``decoder_prenet`` the
pre-net's three kernels alone and ``step_attention`` the step's attention
alone (test and timing hooks, never on the main path);
``decoder_gemm_plain`` and ``decoder_prenet_plain`` are their plain
versions, and ``decoder_step_plain`` calls them in the kernels' order.

As in the JAX package, everything that does not depend on x is computed once
per call outside the loop with plain tensor ops: context embedding and the
per-layer cross-attention K/V, the per-(step, layer) AdaLN scale/shift folded
with the RMSNorm weights (for DDPM a [1000, L, 4, H] table, 10.24 MB at the
flagship shape, which the JAX kernel recomputes per step because it does not
fit VMEM beside the weights), and the sampler's coefficients.

``compute_dtype=torch.bfloat16`` is the TPU kernels' ``compute_dtype``:
both operands of every product rounded to bf16 and the sums in float32
(the kernels' bf16 variant, on tensor cores: the step GEMM of
``csrc/gemm_wgmma.cuh`` (wgmma, TMA) or ``csrc/gemm.cuh``'s
``gemm16_kernel`` (mma.sync) by the tile rule, the attention of
``csrc/attention16.cuh``); the residual stream, the norms, the softmax, the
biases, the AdaLN table and the updates stay float32.  The products'
weights and the cross K/V are packed in bf16 (rounding once is rounding at
every use).  Float32 is the default everywhere, as in the JAX package.

``philox4x32_10`` is the generator's integer arithmetic in torch int64 ops,
the same bits as the kernel's.  ``fused_ddim`` and ``fused_ddpm`` take the
plain version for CPU tensors only; for CUDA tensors they launch the kernel
or raise.  The plain versions keep the dtype they are given (rounding to
bf16 where ``compute_dtype`` says so), so a float64 run of them is a witness
of float32 rounding.

An unmasked CUDA call of ``fused_generate_mel`` on packed weights replays a
CUDA graph of its call shape (``LoopPlans``): the preparation and the whole
loop's launches, captured the second time the shape is seen, so the host
makes one graph launch where it made about a hundred small ops.  The
DDIM grid and coefficients are made once per schedule on the device
(``ddim_grid``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import weakref
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build
from ..config import CFG, resolve_device
from ..layers.attention import sdpa
from ..layers.ffn import swiglu as _swiglu
from ..schedule import DiffusionSchedule
from ..utils.speed import span
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
# The weights that only products read: packed at the compute dtype.
PRODUCT_NAMES = ("in_w", "qkv_w", "proj_w", "cq_w", "co_w", "fc1_w", "fc2_w", "out_w", "pc_pw")
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _compute_dtype(compute_dtype, what: str) -> torch.dtype:
    """``compute_dtype`` if the loops take it (float32 or bfloat16, the JAX
    kernels' choices), else raise naming it."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"{what} computes in float32 or bfloat16, not {compute_dtype}")
    return compute_dtype


def _rd(t: torch.Tensor, compute_dtype: torch.dtype, dtype: torch.dtype) -> torch.Tensor:
    """t as a product's operand at ``compute_dtype``, in the working ``dtype``:
    rounded to bf16 for bf16 compute, t itself for float32."""
    if compute_dtype == torch.float32:
        return t
    return t.to(compute_dtype).to(dtype)


def pack_decoder_weights(decoder, compute_dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    """The decoder's step-invariant weights, stacked over layers, contiguous.

    Linear weights keep torch's [out, in] layout.  The fused form is the
    AdaLN decoder (``use_adaln=True``); with ``use_depthwise`` the pre-net's
    weights follow under ``PRENET_NAMES`` (kernel size 3, stride 1, hidden
    a multiple of 8, so 8 GroupNorm groups).  The weights under
    ``PRODUCT_NAMES`` are stored at ``compute_dtype``, the rest in float32.
    """
    _compute_dtype(compute_dtype, "pack_decoder_weights")
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
    return {k: v.detach().float().to(compute_dtype if k in PRODUCT_NAMES else torch.float32)
            .contiguous() for k, v in w.items()}


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


_DDIM_GRIDS = WeakIdKeyDictionary()  # schedule.alpha_bar -> {(steps, device): (ts, coef)}


def ddim_grid(schedule: DiffusionSchedule, num_steps: int, device):
    """``ddim_coefficients`` as tensors on ``device``: ts [steps] and coef
    [steps, 4], float32, made once per (schedule, num_steps, device) and
    kept while the schedule's tables live, so that a call copies nothing
    between the host and the device."""
    device = torch.device(device)
    grids = _DDIM_GRIDS.setdefault(schedule.alpha_bar, {})
    grid = grids.get((num_steps, device))
    if grid is None:
        ts, coef = ddim_coefficients(schedule, num_steps)
        grid = grids[num_steps, device] = (
            torch.tensor(ts, dtype=torch.float32, device=device), coef.to(device))
    return grid


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
                        step_idx: Optional[torch.Tensor] = None,
                        mods_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Per-call, step-invariant tensors: ``pos`` [T, H], ``mods``
    [steps, L, 4, H] and ``ckv`` [L, B, S, 2H], all float32.  ``ts`` is the
    timestep grid, a list or a float32 tensor on ``sem_idx``'s device
    (``ddim_grid``'s: nothing is then copied from the host).  ``step_idx``
    [steps] is the stage index each step's time conditioning gets (default:
    0, 1, ...; DDPM drives every step with 0).

    They are computed in float32 whatever the decoder's compute dtype, as
    the JAX package's ``_prep_static`` and ``_time_cond`` compute them in
    XLA.  The AdaLN table is (norm weight * (1 + scale), shift) of the
    modules' projection; with ``mods_dtype`` it is computed instead as the
    TPU DDPM kernel computes it in its loop at that compute dtype
    (``_ddpm_kernel``, the fold in ``fused_ddpm_sample``): the time
    conditioning and the projection already folded with the RMSNorm weight
    (w * ker for the scale) rounded to ``mods_dtype``, the sums in float32,
    then + w * (1 + bias) for the scale and + bias for the shift.
    """
    device, f32 = sem_idx.device, torch.float32
    ctx = decoder.context(sem_idx=sem_idx, dtype=f32)
    ckv = [b.cross_attn.latent_kv(ctx, f32) for b in decoder.layers]
    n = len(ts)
    te = decoder.time_cond(
        torch.as_tensor(ts, dtype=f32, device=device),
        torch.arange(n, device=device) if step_idx is None else step_idx.to(device),
        dtype=f32,
    )
    mods = []
    for b in decoder.layers:
        per_layer = []
        for norm in (b.norm1, b.norm3):
            wn = norm.norm.weight.float()
            if mods_dtype is None:
                scale, shift = norm.modulation(te, f32)
                per_layer += [wn * (1.0 + scale), shift]
            else:
                H = wn.shape[0]
                ker, bias = norm.proj.weight.float(), norm.proj.bias.float()
                t = _rd(te, mods_dtype, torch.float32)
                per_layer += [t @ _rd(ker[:H] * wn[:, None], mods_dtype, torch.float32).T
                              + wn * (1.0 + bias[:H]),
                              t @ _rd(ker[H:], mods_dtype, torch.float32).T + bias[H:]]
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
    scale=None, shift=None, swiglu: bool = False, compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``decoder_gemm``'s computation in plain tensor ops, in its order.

    a [..., K] is normed over K when ``norm`` is "rms" (x / sqrt(mean(x^2) +
    1e-6) * scale (+ shift)) or "ln" (``F.layer_norm``, eps 1e-6); then
    c = a @ w.T (+ bias); with ``swiglu`` the halves of c give value *
    silu(gate); then + pos[m % pos.shape[0]] over the flattened rows m, then
    residual + c.  At bf16 ``compute_dtype`` the normed a and w are rounded
    to bf16 before the product, everything else as at float32.  Works in
    a's dtype (float32 for a bf16 a), which it returns.
    """
    K = a.shape[-1]
    dt = torch.promote_types(a.dtype, torch.float32)
    a = a.to(dt)
    if norm == "rms":
        a = a * torch.rsqrt(a.square().mean(-1, keepdim=True) + 1e-6) * scale
        if shift is not None:
            a = a + shift
    elif norm == "ln":
        a = F.layer_norm(a, (K,), scale, shift, eps=1e-6)
    elif norm is not None:
        raise ValueError(f"norm must be None, 'rms' or 'ln', not {norm!r}")
    c = _rd(a, compute_dtype, dt) @ _rd(w, compute_dtype, dt).T
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


def decoder_prenet_plain(h, pos, w, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The depthwise pre-net and the positional rows on h [B, T, H], in the
    kernels' order: d = the k=3 depthwise conv along T within each row of
    the batch (rows outside [0, T) read as zero), u = d @ pc_pw.T + pc_pb,
    GroupNorm over each (batch row, group of H/8 channels) with the mean
    first and the variance around it (eps 1e-6), then h + gelu_erf(norm(u) *
    pc_gs + pc_gb) + pos.  At bf16 ``compute_dtype`` only the pointwise
    product rounds its operands.  Keeps h's dtype."""
    B, T, H = h.shape
    dw = w["pc_dw"]
    hp = F.pad(h, (0, 0, 1, 1))
    d = hp[:, :-2] * dw[:, 0] + hp[:, 1:-1] * dw[:, 1] + hp[:, 2:] * dw[:, 2]
    u = decoder_gemm_plain(d, w["pc_pw"], bias=w["pc_pb"], compute_dtype=compute_dtype)
    g = u.reshape(B, T, PRENET_GROUPS, H // PRENET_GROUPS)
    mean = g.mean(dim=(1, 3), keepdim=True)
    c = g - mean
    rstd = 1.0 / torch.sqrt(c.square().mean(dim=(1, 3), keepdim=True) + 1e-6)
    y = (c * rstd).reshape(B, T, H) * w["pc_gs"] + w["pc_gb"]
    return h + F.gelu(y) + pos


def _attention_rounded(q, k, v, compute_dtype, mask=None) -> torch.Tensor:
    """Attention as the TPU kernel computes it at a bf16 ``compute_dtype``:
    S from the rounded q and k, the softmax in q's dtype, then the
    normalised P and v rounded before their product."""
    dt = q.dtype
    s = (_rd(q, compute_dtype, dt) @ _rd(k, compute_dtype, dt).transpose(-1, -2)
         ) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(dt).min)
    p = torch.softmax(s, dim=-1)
    return _rd(p, compute_dtype, dt) @ _rd(v, compute_dtype, dt)


def decoder_step_plain(x, pos, mods_i, ckv, w, *, heads: int, window: int,
                       compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One decoder forward of x [B, T, M] with this step's AdaLN table
    ``mods_i`` [L, 4, H], in plain tensor ops in the kernel's order; the
    pre-net runs when ``w`` holds its weights.  At bf16 ``compute_dtype``
    every product's operands are rounded to bf16 (the TPU kernel's ``mm``)
    and ``w``'s product weights and ``ckv`` may be bf16."""
    B, T, M = x.shape
    H = pos.shape[1]
    L, S = ckv.shape[0], ckv.shape[2]
    dh = H // heads
    low = compute_dtype != torch.float32
    if low:
        ckv = ckv.to(x.dtype)

    def split(t, n):
        return t.reshape(B, n, heads, dh).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(B, T, H)

    def gemm(*args, **kw):
        return decoder_gemm_plain(*args, compute_dtype=compute_dtype, **kw)

    if "pc_pw" in w:
        h = decoder_prenet_plain(gemm(x, w["in_w"], bias=w["in_b"]), pos, w, compute_dtype)
    else:
        h = gemm(x, w["in_w"], bias=w["in_b"], pos=pos)
    if low:
        idx = torch.arange(T, device=x.device)
        band = (idx[None, :] - idx[:, None]).abs() <= window
    for l in range(L):
        m = mods_i[l]
        qkv = gemm(h, w["qkv_w"][l], norm="rms", scale=m[0], shift=m[1])
        q, k, v = (split(qkv[..., j * H:(j + 1) * H], T) for j in range(3))
        if low:
            a = merge(_attention_rounded(q, k, v, compute_dtype, band))
        else:
            a = merge(banded_attention_plain(q, k, v, window))
        h = gemm(a, w["proj_w"][l], bias=w["proj_b"][l], residual=h)
        q = split(gemm(h, w["cq_w"][l], norm="rms", scale=w["n2w"][l]), T)
        ck, cv = split(ckv[l, ..., :H], S), split(ckv[l, ..., H:], S)
        a = merge(_attention_rounded(q, ck, cv, compute_dtype) if low else sdpa(q, ck, cv))
        h = gemm(a, w["co_w"][l], residual=h)
        f = gemm(h, w["fc1_w"][l], bias=w["fc1_b"][l], norm="rms", scale=m[2], shift=m[3],
                 swiglu=True)
        h = gemm(f, w["fc2_w"][l], bias=w["fc2_b"][l], residual=h)
    return gemm(h, w["out_w"], bias=w["out_b"], norm="ln", scale=w["fn_s"], shift=w["fn_b"])


def fused_ddim_plain(
    x_T, pos, mods, ckv, coef, w, *, heads: int, window: int, prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The kernel's computation in plain tensor ops (same inputs, same order)."""
    x, x0 = x_T, torch.zeros_like(x_T)
    for i in range(coef.shape[0]):
        pred = decoder_step_plain(x, pos, mods[i], ckv, w, heads=heads, window=window,
                                  compute_dtype=compute_dtype)
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
    noise: Optional[torch.Tensor] = None, key=(0, 0), compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The DDPM kernel's computation in plain tensor ops: per loop index i,
    x <- coef[i, 2] (x - coef[i, 3] eps) + coef[i, 4] z, with z =
    ``noise[:, i]`` or ``philox_normal(x.shape, i, key)``."""
    x = x_T
    for i in range(coef.shape[0]):
        pred = decoder_step_plain(x, pos, mods[i], ckv, w, heads=heads, window=window,
                                  compute_dtype=compute_dtype)
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
    lib.edt_fused_ddim_workspace.argtypes = [i] * 6
    lib.edt_fused_ddim_workspace.restype = ctypes.c_longlong
    lib.edt_fused_ddim.argtypes = [p] * 28 + [i] * 11 + [ctypes.c_float, i, p]
    lib.edt_fused_ddim.restype = ctypes.c_int
    lib.edt_fused_ddpm.argtypes = [p] * 29 + [i] * 11 + [ctypes.c_uint] * 2 + [i, p]
    lib.edt_fused_ddpm.restype = ctypes.c_int
    lib.edt_decoder_gemm.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.edt_decoder_gemm.restype = ctypes.c_int
    lib.edt_gemm_bf16_tile.argtypes = [i] * 5
    lib.edt_gemm_bf16_tile.restype = ctypes.c_int
    lib.edt_gemm_bf16_tile_shape.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.edt_gemm_bf16_tile_shape.restype = ctypes.c_int
    lib.edt_kernel_launches_of.argtypes = [i]
    lib.edt_kernel_launches_of.restype = ctypes.c_longlong
    lib.edt_zero_kernel_launches.argtypes = []
    lib.edt_zero_kernel_launches.restype = None
    lib.edt_decoder_prenet.argtypes = [p] * 9 + [i] * 4 + [p]
    lib.edt_decoder_prenet.restype = ctypes.c_int
    lib.edt_step_attention.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.edt_step_attention.restype = ctypes.c_int
    lib.edt_step_attention_fma.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.edt_step_attention_fma.restype = ctypes.c_int
    lib.edt_decoder_gemm_tile.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.edt_decoder_gemm_tile.restype = None
    lib.edt_kernel_launches.argtypes = []
    lib.edt_kernel_launches.restype = ctypes.c_longlong
    lib.edt_attention16_pick_tile.argtypes = [i] * 3
    lib.edt_attention16_pick_tile.restype = ctypes.c_int
    lib.edt_attention16_tile_launches.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.edt_attention16_tile_launches.restype = ctypes.c_int
    return lib


# The bf16 kernels whose launches the library counts one by one.
KERNEL_KINDS = {"gemm_wgmma": 1, "gemm16": 2, "attention16": 3, "relpos_attention16": 4}


def kernel_launches(kind: Optional[str] = None) -> int:
    """Kernels the loop library has launched in this process (every GEMM,
    attention, pre-net and update launch, the loops' and the hooks'); with
    ``kind`` (a key of ``KERNEL_KINDS``) the launches of that bf16 kernel
    alone since ``zero_kernel_launches``: ``gemm_wgmma`` (csrc/
    gemm_wgmma.cuh), ``gemm16`` (gemm.cuh's mma.sync kernel),
    ``attention16`` (csrc/attention16.cuh), ``relpos_attention16`` (the
    encoder's csrc/relpos_attention16.cuh, outside the total).  The host
    counts launches as it makes them: a CUDA graph's capture counts its
    kernels once and its replays count none (``fused_generate_mel.replays``)."""
    if kind is None:
        return int(_lib().edt_kernel_launches())
    if kind not in KERNEL_KINDS:
        raise ValueError(f"kind {kind!r}: one of {sorted(KERNEL_KINDS)}")
    return int(_lib().edt_kernel_launches_of(KERNEL_KINDS[kind]))


def zero_kernel_launches() -> None:
    """Set the counts of ``kernel_launches(kind)`` and of
    ``attention16_tile_launches()`` to 0 (not the total)."""
    _lib().edt_zero_kernel_launches()


def zero_plan_counts() -> None:
    """Set ``fused_generate_mel``'s counts of its routes to 0: ``.eager``
    (calls that launched the loop's ops one by one), ``.captures`` (calls
    that captured their shape's graph, then replayed it) and ``.replays``."""
    fused_generate_mel.eager = fused_generate_mel.captures = fused_generate_mel.replays = 0


# The tiles of the bf16 step attention (csrc/attention16.cuh), by the
# library's index: "keys", a block of 16 query rows whose 4 warps split the
# keys (the B = 1 tile); "rows", a block of 64 rows, a warp's 16 each, K and
# V streamed through a ring (the batched tile).
ATTENTION16_TILES = {"keys": 0, "rows": 1}


def attention16_tile_launches() -> dict:
    """Launches of the bf16 step attention by tile since
    ``zero_kernel_launches``: ``{"keys": n, "rows": n}``, summing to
    ``kernel_launches("attention16")``."""
    out = (ctypes.c_longlong * len(ATTENTION16_TILES))()
    _lib().edt_attention16_tile_launches(out)
    return {name: int(out[i]) for name, i in ATTENTION16_TILES.items()}


def attention16_tile(batch: int, heads: int, tq: int) -> str:
    """The tile (a key of ``ATTENTION16_TILES``) the host's rule takes for a
    bf16 step attention over ``batch`` x ``heads`` pairs of ``tq`` query
    rows: "rows" where its 64-row blocks fill the card, else "keys"."""
    index = _lib().edt_attention16_pick_tile(batch, heads, tq)
    return next(name for name, i in ATTENTION16_TILES.items() if i == index)


def decoder_gemm_tile(m: int, n: int, compute_dtype: torch.dtype = torch.float32):
    """``(rows, columns)`` of the output tile the host picks for an m x n
    output of ``decoder_gemm`` and of the decoder step's GEMMs, in the
    float32 kernel or its bf16 variant from a float32 A
    (``decoder_gemm16_tile`` for a bf16 A)."""
    bm_bn = (ctypes.c_int * 2)()
    low = _compute_dtype(compute_dtype, "decoder_gemm_tile") != torch.float32
    _lib().edt_decoder_gemm_tile(m, n, int(low), bm_bn)
    return bm_bn[0], bm_bn[1]


# The bf16 variant's rules (``decoder_gemm16_tile``'s ``rule``).
GEMM16_RULES = {"host": 0, "mma": 1, "wgmma": 2}


def gemm16_tiles():
    """The bf16 variant's tiles, by index: ``(rows, columns, kernel,
    warpgroups)`` of a block, kernel "mma" (gemm.cuh's ``gemm16_kernel``) or
    "wgmma" (csrc/gemm_wgmma.cuh), warpgroups of 128 threads."""
    lib, out, tiles = _lib(), (ctypes.c_int * 4)(), []
    while lib.edt_gemm_bf16_tile_shape(len(tiles), out) > 0:
        tiles.append((out[0], out[1], "wgmma" if out[2] else "mma", out[3]))
    return tiles


def decoder_gemm16_tile(m: int, n: int, rule: str = "host",
                        a_dtype: torch.dtype = torch.float32, swiglu: bool = False) -> int:
    """The index in ``gemm16_tiles()`` of the tile picked for an m x n output
    of the bf16 variant (SwiGLU's with ``swiglu``) from an ``a_dtype``
    (float32 or bf16) A: by the host's rule (the decoder step's), or by the
    rule of the mma.sync kernel alone ("mma") or of the wgmma
    kernel alone ("wgmma")."""
    if rule not in GEMM16_RULES:
        raise ValueError(f"rule {rule!r}: one of {sorted(GEMM16_RULES)}")
    return int(_lib().edt_gemm_bf16_tile(m, n, int(a_dtype == torch.bfloat16), int(swiglu),
                                         GEMM16_RULES[rule]))


def decoder_gemm(
    a, w, *, bias=None, pos=None, residual=None, norm: Optional[str] = None,
    scale=None, shift=None, swiglu: bool = False, out=None,
    compute_dtype: torch.dtype = torch.float32, out_dtype: torch.dtype = torch.float32,
    tile: Optional[int] = None,
) -> torch.Tensor:
    """One launch of the decoder step's GEMM (csrc/gemm.cuh), as
    ``decoder_gemm_plain`` computes it; ``out`` may be ``residual`` (updated
    in place, as the step does).  Its tile is the host's pick
    (``decoder_gemm_tile``), or at bf16 ``tile``, an index into
    ``gemm16_tiles()`` (the launch raises if that tile's shared memory does
    not fit).

    A test and timing hook: it takes CUDA tensors only (contiguous float32,
    a [..., K] with K % 4 == 0, w [N, K] or [2N, K] with ``swiglu``) and
    raises on anything else, CPU tensors included; it never falls back.
    At bf16 ``compute_dtype`` it launches the bf16 variant: w bf16, a float32
    or (without a norm) bf16, the result written at ``out_dtype`` (float32
    or bf16), K % 8 == 0.  Counted in ``decoder_gemm.launches``.
    """
    low = _compute_dtype(compute_dtype, "decoder_gemm") != torch.float32
    if tile is not None and not (low and 0 <= tile):
        raise ValueError(f"tile {tile}: an index into gemm16_tiles(), for bf16 compute only")
    if a.device.type != "cuda":
        raise ValueError(f"decoder_gemm runs on CUDA tensors only, not {a.device} "
                         "(its plain version is decoder_gemm_plain)")
    if out_dtype not in COMPUTE_DTYPES or (out_dtype != torch.float32 and not low):
        raise ValueError(f"out_dtype {out_dtype}: float32, or bfloat16 for bf16 compute")
    a_low = a.dtype == torch.bfloat16
    if a_low and (not low or norm is not None):
        raise ValueError("a bf16 a takes bf16 compute and no norm (the norm reads float32 h)")
    K = a.shape[-1]
    rows = a.numel() // K if K else 0
    n_out = w.shape[0] // 2 if swiglu else w.shape[0]
    out_shape = (*a.shape[:-1], n_out)
    if norm not in (None, "rms", "ln") or (norm is None) != (scale is None) or (
            shift is not None and norm is None):
        raise ValueError(f"norm {norm!r}: 'rms' or 'ln' take a scale (and an optional "
                         "shift); no norm takes neither")
    f32 = torch.float32
    expected = {
        "a": (a, tuple(a.shape), torch.bfloat16 if a_low else f32),
        "w": (w, (2 * n_out if swiglu else n_out, K), compute_dtype),
        "bias": (bias, (w.shape[0],), f32), "residual": (residual, out_shape, f32),
        "out": (out, out_shape, out_dtype), "scale": (scale, (K,), f32),
        "shift": (shift, (K,), f32),
        "pos": (pos, (None if pos is None else pos.shape[0], n_out), f32),
    }
    for name, (t, shape, dtype) in expected.items():
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype
                              or not t.is_contiguous() or t.device != a.device):
            raise ValueError(f"{name}: expected contiguous {dtype} {shape} on {a.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if w.dim() != 2 or K % (8 if low else 4) or (pos is not None and pos.shape[0] == 0) or any(
            t.data_ptr() % 16 for t in (a, w, scale, shift) if t is not None):
        raise ValueError(f"a [..., {K}] and w {tuple(w.shape)}: K must be a multiple of "
                         f"{8 if low else 4}, a, w, scale and shift 16-byte aligned, pos "
                         "non-empty")
    if residual is not None and out_dtype != f32:
        raise ValueError("a residual sum is written in float32")
    _build.refuse_autograd("decoder_gemm", a, w, bias, pos, residual, out, scale, shift)
    if out is None:
        out = torch.empty(out_shape, dtype=out_dtype, device=a.device)
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
            int(swiglu), int(norm == "ln"), int(low), int(a_low), int(out_dtype != f32),
            -1 if tile is None else tile, stream,
        )
    decoder_gemm.launches += 1
    _build.check(err, "decoder_gemm")
    return out


decoder_gemm.launches = 0


def _check_prenet(T: int, H: int, device, pos, w, compute_dtype=torch.float32) -> None:
    """Raise unless pos and the pre-net weights in ``w`` fit [T, H] rows on
    ``device`` as the kernels take them (``pc_pw`` at ``compute_dtype``)."""
    expected = {"pos": (pos, (T, H)), "pc_dw": (w["pc_dw"], (H, 3)),
                "pc_pw": (w["pc_pw"], (H, H)), **{n: (w[n], (H,)) for n in PRENET_NAMES[2:]}}
    for name, (t, shape) in expected.items():
        dtype = compute_dtype if name in PRODUCT_NAMES else torch.float32
        if (tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{name}: expected contiguous {dtype} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if H % PRENET_GROUPS:
        raise ValueError(f"hidden {H}: the fused pre-net takes a multiple of "
                         f"{PRENET_GROUPS} (its GroupNorm groups)")


def decoder_prenet(h, pos, w, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One run of the pre-net's three kernels (depthwise conv, pointwise
    GEMM, GroupNorm / GELU / residual / positional pass) on h [B, T, H], as
    ``decoder_prenet_plain`` computes it; returns a new tensor.  At bf16
    ``compute_dtype`` the pointwise GEMM is the bf16 variant (``pc_pw``
    bf16).

    A test and timing hook: CUDA tensors only (contiguous float32), it
    raises on anything else, CPU tensors included; it never falls back.
    Counted in ``decoder_prenet.launches``.
    """
    low = _compute_dtype(compute_dtype, "decoder_prenet") != torch.float32
    if h.device.type != "cuda":
        raise ValueError(f"decoder_prenet runs on CUDA tensors only, not {h.device} "
                         "(its plain version is decoder_prenet_plain)")
    if h.dim() != 3 or h.dtype != torch.float32 or not h.is_contiguous():
        raise ValueError(f"h: expected contiguous float32 [B, T, H], got {h.dtype} "
                         f"{tuple(h.shape)}")
    _check_prenet(h.shape[1], h.shape[2], h.device, pos, w, compute_dtype)
    _build.refuse_autograd("decoder_prenet", h, pos, *(w[n] for n in PRENET_NAMES))
    B, T, H = h.shape
    out = torch.empty_like(h)
    work = torch.empty(2 * B * T * H, dtype=torch.float32, device=h.device)
    lib = _lib()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_decoder_prenet(h.data_ptr(), out.data_ptr(), work.data_ptr(),
                                     pos.data_ptr(), *_prenet_ptrs(w), B, T, H, int(low),
                                     stream)
    decoder_prenet.launches += 1
    _build.check(err, "decoder_prenet")
    return out


decoder_prenet.launches = 0


def step_attention(q, k, v, window: Optional[int] = None,
                   compute_dtype: torch.dtype = torch.float32, fma: bool = False,
                   tile: Optional[str] = None) -> torch.Tensor:
    """The decoder step's attention kernel alone: q [B, heads, tq, d]
    attends k, v [B, heads, tk, d] over |i - j| <= ``window``, or every key
    with None (the cross-attention).  At bf16 ``compute_dtype`` q, k and v
    are bf16 and the tensor-core kernel (csrc/attention16.cuh) rounds the
    normalised P to bf16 before it weights v, as the TPU kernel and
    ``_attention_rounded`` do; the output has q's dtype.  ``fma`` launches
    csrc/attention.cuh's float32-FMA kernel at either dtype instead (at bf16
    the kernel the bf16 step ran before, which rounds each probability
    against its thread's running max): a yardstick, never on the main path.
    ``tile`` (a key of ``ATTENTION16_TILES``, bf16 only) forces the
    tensor-core kernel's tile; None takes the host's rule
    (``attention16_tile``), as the decoder step does.

    A test and timing hook: contiguous CUDA tensors of the compute dtype
    only; it raises on anything else, CPU tensors included.  Counted in
    ``step_attention.launches``.
    """
    low = _compute_dtype(compute_dtype, "step_attention") != torch.float32
    if tile is not None and (tile not in ATTENTION16_TILES or not low or fma):
        raise ValueError(f"tile {tile!r}: one of {sorted(ATTENTION16_TILES)}, for the bf16 "
                         "tensor-core kernel only")
    B, heads, tq, d = q.shape
    tk = k.shape[2]
    for name, t, rows in (("q", q, tq), ("k", k, tk), ("v", v, tk)):
        if (t.device.type != "cuda" or t.dtype != compute_dtype or not t.is_contiguous()
                or tuple(t.shape) != (B, heads, rows, d)):
            raise ValueError(f"{name}: expected a contiguous CUDA {compute_dtype} tensor "
                             f"[{B}, {heads}, {rows}, {d}], got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if d % (8 if low else 4) or d > 64:
        raise ValueError(f"head dim {d}: a multiple of {8 if low else 4} up to 64")
    _build.refuse_autograd("step_attention", q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, heads, tq, tk, d,
                -1 if window is None else window, int(low))
        if fma:
            err = _lib().edt_step_attention_fma(*args, stream)
        else:
            err = _lib().edt_step_attention(*args, ATTENTION16_TILES.get(tile, -1), stream)
    step_attention.launches += 1
    _build.check(err, "step_attention")
    return out


step_attention.launches = 0


def _check_loop_args(x_T, pos, mods, ckv, coef, w, heads: int, n_coef: int,
                     compute_dtype: torch.dtype) -> None:
    """Raise unless every tensor has the shape, type and device the loop
    kernels take: float32, but for ``ckv`` and the ``PRODUCT_NAMES`` weights
    at ``compute_dtype``."""
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
        dtype = compute_dtype if name in PRODUCT_NAMES + ("ckv",) else torch.float32
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != x_T.device):
            raise ValueError(f"{name}: expected contiguous {dtype} {shape} on "
                             f"{x_T.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    # 16-byte copies: 4 float32 or 8 bf16 elements
    q = 4 if compute_dtype == torch.float32 else 8
    if H % heads or H // heads > 64 or (H // heads) % q:
        raise ValueError(f"hidden {H} / heads {heads}: the head dim must divide, be a "
                         f"multiple of {q} and be <= 64")
    if M % q or F2 % (2 * q):
        raise ValueError(f"n_mels {M} and ffn width {F2 // 2} must be multiples of {q} (the "
                         "kernels stage rows as 16-byte copies)")
    if any(n in w for n in PRENET_NAMES):
        missing = [n for n in PRENET_NAMES if n not in w]
        if missing:
            raise ValueError(f"pre-net weights {missing} missing: pack them with "
                             "pack_decoder_weights")
        _check_prenet(T, H, x_T.device, pos, w, compute_dtype)


def _weight_ptrs(w, first: int, last: Optional[int] = None):
    return [w[n].data_ptr() for n in WEIGHT_NAMES[first:last]]


def _prenet_ptrs(w):
    """The pre-net weights' pointers in the C functions' order, or five nulls
    for a decoder without it."""
    return [w[n].data_ptr() if n in w else None for n in PRENET_NAMES]


def _launch_counts(fn, low: bool) -> None:
    if low:
        fn.bf16_launches += 1
    else:
        fn.launches += 1


def fused_ddim(
    x_T, pos, mods, ckv, coef, w, *, heads: int, window: int, prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Run the whole DDIM loop; returns the last x0 [B, T, M].

    ``prediction="v"`` reads the decoder output as v; anything else as eps,
    as the JAX kernel does.  ``compute_dtype`` bfloat16 runs the bf16
    variant, on ``w`` packed at bf16 and a bf16 ``ckv``.

    CPU tensors take ``fused_ddim_plain``; CUDA tensors launch the kernel
    sequence, counted once per call in ``fused_ddim.launches`` (float32) or
    ``fused_ddim.bf16_launches`` (bf16), and raise under grad mode when one
    of them requires a gradient (no backward).
    """
    with span("prep:launch"):  # opened first: the CPU route carries it too
        low = _compute_dtype(compute_dtype, "fused_ddim") != torch.float32
        if x_T.device.type == "cpu":
            return fused_ddim_plain(x_T, pos, mods, ckv, coef, w, heads=heads, window=window,
                                    prediction=prediction, compute_dtype=compute_dtype)
        if x_T.device.type != "cuda":
            raise ValueError(f"fused_ddim runs on CPU or CUDA, not {x_T.device}")
        _build.refuse_autograd("fused_ddim", x_T, pos, mods, ckv, coef, *w.values())
        _check_loop_args(x_T, pos, mods, ckv, coef, w, heads, 4, compute_dtype)
        B, T, M = x_T.shape
        steps, L, _, H = mods.shape
        S = ckv.shape[2]
        lib = _lib()
        ffn = w["fc1_w"].shape[1] // 2
        out = torch.empty_like(x_T)
        work = torch.empty(lib.edt_fused_ddim_workspace(B, T, H, ffn, M, int(low)),
                           dtype=torch.float32, device=x_T.device)
        with torch.cuda.device(x_T.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.edt_fused_ddim(
                x_T.data_ptr(), out.data_ptr(), work.data_ptr(), pos.data_ptr(),
                *_weight_ptrs(w, 0, 2), mods.data_ptr(), *_weight_ptrs(w, 2, 7),
                ckv.data_ptr(), *_weight_ptrs(w, 7), coef.data_ptr(), *_prenet_ptrs(w),
                B, T, S, M, H, heads, L, ffn, window, steps, int(prediction == "v"),
                X0_CLIP, int(low), stream,
            )
        _launch_counts(fused_ddim, low)
        _build.check(err, "fused_ddim")
        return out


fused_ddim.launches = 0
fused_ddim.bf16_launches = 0


def fused_ddpm(
    x_T, pos, mods, ckv, coef, w, *, heads: int, window: int, prediction: str = "eps",
    noise: Optional[torch.Tensor] = None, key=(0, 0), compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Run the whole ancestral DDPM loop (``coef`` [steps, 5] from
    ``ddpm_coefficients``); returns the final x [B, T, M].

    The per-step draws are ``noise`` [B, steps, T, M] when given, else Philox
    normals under ``key`` (two 32-bit ints).  ``compute_dtype`` as
    ``fused_ddim``'s.  CPU tensors take ``fused_ddpm_plain``; CUDA tensors
    launch the kernel sequence, counted once per call in
    ``fused_ddpm.launches`` (float32) or ``fused_ddpm.bf16_launches``.
    """
    low = _compute_dtype(compute_dtype, "fused_ddpm") != torch.float32
    kw = dict(heads=heads, window=window, prediction=prediction, noise=noise, key=key)
    if x_T.device.type == "cpu":
        return fused_ddpm_plain(x_T, pos, mods, ckv, coef, w, compute_dtype=compute_dtype, **kw)
    if x_T.device.type != "cuda":
        raise ValueError(f"fused_ddpm runs on CPU or CUDA, not {x_T.device}")
    _build.refuse_autograd("fused_ddpm", x_T, pos, mods, ckv, coef, noise, *w.values())
    _check_loop_args(x_T, pos, mods, ckv, coef, w, heads, 5, compute_dtype)
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
    work = torch.empty(lib.edt_fused_ddim_workspace(B, T, H, ffn, M, int(low)),
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
            k0, k1, int(low), stream,
        )
    _launch_counts(fused_ddpm, low)
    _build.check(err, "fused_ddpm")
    return out


fused_ddpm.launches = 0
fused_ddpm.bf16_launches = 0


PLANS_PER_DECODER = 32  # call shapes a decoder keeps graphs of; the least recently used go


class LoopPlans:
    """The route of each call shape of one decoder's ``fused_generate_mel``,
    and the plans of the shapes it captured.

    A call's ``key`` is its shape, its ``addrs`` the addresses of every
    tensor a graph of it reads.  A key whose plan was captured at the same
    addresses replays it.  A plan whose addresses no longer match (the
    decoder moved, new packed weights) is dropped and the call runs
    eagerly.  A key seen once before at the same addresses is captured.
    Any other call runs eagerly and is remembered.  Past ``limit`` keys the
    least recently used plan, or sighting, is forgotten.  This is host
    bookkeeping alone: ``fused_generate_mel`` makes and replays the graphs,
    one call of a decoder at a time (``lock``), in one memory ``pool``.
    """

    def __init__(self, slots=()):
        self.slots = list(slots)  # (dict, name) of the decoder's tensors: ``_tensor_slots``
        self.limit = PLANS_PER_DECODER
        self.seen: "OrderedDict[tuple, tuple]" = OrderedDict()  # key -> addresses
        self.plans: "OrderedDict[tuple, object]" = OrderedDict()  # key -> plan with .addrs
        self.lock = threading.Lock()
        self.pool = None  # the graphs' memory pool, made at the first capture
        self.done = None  # (stream, event) recorded after the last replay's result

    def route(self, key, addrs) -> str:
        """"replay" (``plans[key]``), "capture" or "eager"."""
        plan = self.plans.get(key)
        if plan is not None:
            if plan.addrs == addrs:
                self.plans.move_to_end(key)
                return "replay"
            del self.plans[key]
        if self.seen.pop(key, None) == addrs:
            return "capture"
        self.seen[key] = addrs
        if len(self.seen) > self.limit:
            self.seen.popitem(last=False)
        return "eager"

    def keep(self, key, plan) -> None:
        """Hold ``plan``, captured at ``plan.addrs``, under ``key``."""
        self.plans[key] = plan
        if len(self.plans) > self.limit:
            self.plans.popitem(last=False)


_LOOP_PLANS = weakref.WeakKeyDictionary()  # decoder -> LoopPlans, dropped with the decoder
_LOOP_PLANS_LOCK = threading.Lock()


def _tensor_slots(module):
    """``(dict, name)`` of each parameter and buffer of ``module``: looked up
    again at every call, so a tensor moved (``.to()``) or reassigned shows
    in the addresses; a submodule replaced after the first call does not."""
    return [(d, n) for m in module.modules() for d in (m._parameters, m._buffers)
            for n, t in d.items() if t is not None]


def loop_plans(decoder) -> LoopPlans:
    """The decoder's ``LoopPlans``, made at its first planned call."""
    with _LOOP_PLANS_LOCK:
        plans = _LOOP_PLANS.get(decoder)
        if plans is None:
            plans = _LOOP_PLANS[decoder] = LoopPlans(_tensor_slots(decoder))
        return plans


class _LoopPlan:
    """One call shape's CUDA graph, the inputs it reads and the x0 it writes."""

    def __init__(self, addrs, sem_idx, x_T):
        self.addrs = addrs
        with torch.inference_mode(False):  # written in place in and out of inference mode
            self.sem_idx = torch.empty(sem_idx.shape, dtype=torch.long, device=x_T.device)
            self.x_T = torch.empty(x_T.shape, dtype=torch.float32, device=x_T.device)
        self.graph = torch.cuda.CUDAGraph()
        self.out = None


def _loop_inputs(decoder, sem_idx, x_T, ts, compute_dtype):
    """``fused_ddim``'s pos, mods and ckv (at ``compute_dtype``) for a call."""
    loop = prepare_loop_inputs(decoder, sem_idx, x_T.shape[1], ts)
    return loop["pos"], loop["mods"], loop["ckv"].to(compute_dtype)


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

    ``weights`` are ``pack_decoder_weights(decoder, compute_dtype)``, packed
    here if not given.  The strided grid may hold fewer than ``num_steps``
    steps; the loop runs what exists, as the JAX package does.
    ``compute_dtype`` is the JAX function's: float32, or bfloat16 for bf16
    operands in every product with float32 sums (the residual stream stays
    float32); the loop's inputs are computed in float32 either way.

    On CUDA tensors with ``weights`` given, a call takes its shape's plan
    (``LoopPlans``): the first call of a shape runs eagerly, the second
    captures the loop's inputs and the loop in a CUDA graph, and each later
    one copies its tokens and noise in and replays it.  The result is a new
    tensor, bit-equal to the eager route's, whose kernels the graph holds in
    the same order.  CPU tensors and ``weights=None`` run eagerly.  Counted
    in ``fused_generate_mel.eager``, ``.captures`` and ``.replays``.
    """
    _compute_dtype(compute_dtype, "fused_generate_mel")
    device = x_T.device
    plans = (loop_plans(decoder) if weights is not None and device.type == "cuda"
             and sem_idx.device == device else None)
    kw = dict(heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction,
              compute_dtype=compute_dtype)
    with torch.no_grad(), plans.lock if plans is not None else contextlib.nullcontext():
        with span("prep:loop_inputs"):
            ts, coef = ddim_grid(schedule, num_steps, device)
            w = weights if weights is not None else pack_decoder_weights(decoder, compute_dtype)
            route = "eager"
            if plans is not None:
                key = (*sem_idx.shape, *x_T.shape[1:], num_steps, compute_dtype, prediction,
                       cfg.heads, cfg.attn_window_size, device)
                addrs = (*(d[n].data_ptr() for d, n in plans.slots),
                         *(t.data_ptr() for t in w.values()), ts.data_ptr(), coef.data_ptr())
                route = plans.route(key, addrs)
            if route == "eager":
                x_T = x_T.float().contiguous()
                loop = _loop_inputs(decoder, sem_idx, x_T, ts, compute_dtype)
            else:
                plan = plans.plans[key] if route == "replay" else _LoopPlan(addrs, sem_idx, x_T)
                stream = torch.cuda.current_stream(device)
                if plans.done is not None and plans.done[0] != stream:
                    stream.wait_event(plans.done[1])  # the last result, taken on another stream
                plan.sem_idx.copy_(sem_idx)
                plan.x_T.copy_(x_T)  # as float32, contiguous
        if route == "eager":
            fused_generate_mel.eager += 1
            return fused_ddim(x_T, *loop, coef, w, **kw)
        with span("prep:launch"):
            if route == "capture":
                if plans.pool is None:
                    plans.pool = torch.cuda.graph_pool_handle()
                # serving and the pipeline run CUDA work on other threads meanwhile
                with torch.cuda.graph(plan.graph, pool=plans.pool,
                                      capture_error_mode="thread_local"):
                    plan.out = fused_ddim(plan.x_T, *_loop_inputs(
                        decoder, plan.sem_idx, plan.x_T, ts, compute_dtype), coef, w, **kw)
                plans.keep(key, plan)
                fused_generate_mel.captures += 1
            else:
                _launch_counts(fused_ddim, compute_dtype != torch.float32)
                fused_generate_mel.replays += 1
            with span("prep:graph_replay"):
                plan.graph.replay()
            out = plan.out.clone()  # the next call of any shape overwrites plan.out
            plans.done = (stream, stream.record_event())
            return out


zero_plan_counts()


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
    ``pack_decoder_weights(decoder, compute_dtype)``, packed here if not
    given.  ``compute_dtype`` is the JAX function's, as
    ``fused_generate_mel``'s; at bfloat16 the AdaLN table is the one the JAX
    kernel computes in its loop (``prepare_loop_inputs``' ``mods_dtype``).
    """
    low = _compute_dtype(compute_dtype, "fused_ddpm_sample") != torch.float32
    coef = ddpm_coefficients(schedule).to(x_T.device)
    ts = list(range(schedule.T - 1, -1, -1))
    key = (0, 0)
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=sem_idx.device).manual_seed(0)
        key = torch.randint(0, 2**32, (2,), generator=generator, dtype=torch.int64,
                            device=generator.device).tolist()
    with torch.no_grad():
        w = weights if weights is not None else pack_decoder_weights(decoder, compute_dtype)
        loop = prepare_loop_inputs(decoder, sem_idx, x_T.shape[1], ts,
                                   step_idx=torch.zeros(len(ts), dtype=torch.long),
                                   mods_dtype=compute_dtype if low else None)
        return fused_ddpm(
            x_T.float().contiguous(), loop["pos"], loop["mods"], loop["ckv"].to(compute_dtype),
            coef, w, heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction,
            noise=None if noise is None else noise.float().contiguous(), key=key,
            compute_dtype=compute_dtype,
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
