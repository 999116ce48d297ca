"""The few-step DDIM denoise loop as one CUDA host call, and its plain version.

Replaces the TPU kernel ``edge_diffusion_tts_tpu/ops/fused_denoise.py::
_denoise_kernel`` (launched by ``fused_generate_mel``): noise ->
[decoder forward -> DDIM update] x num_steps -> x0.  The kernel's design and
what bounds it on the H100 are in ``csrc/fused_ddim.cu``: one C function runs
the whole loop as a fixed sequence of hand-written float32 kernels (tiled
GEMMs with fused epilogues, row norms, the banded attention of
``csrc/attention.cuh``, the DDIM update) on PyTorch's current stream.

As in the JAX package, everything that does not depend on x is computed once
per call outside the loop with plain tensor ops: context embedding and the
per-layer cross-attention K/V, the per-(step, layer) AdaLN scale/shift folded
with the RMSNorm weights, and the DDIM coefficients.

``fused_ddim`` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
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
from ..layers.ffn import swiglu
from ..layers.norms import rms_normalize
from ..schedule import DiffusionSchedule
from .window_attention import banded_attention_plain

X0_CLIP = 3.0  # the DDIM update clips x0 to +-X0_CLIP, as the JAX kernel does

# Names, in the C entry point's order, of the packed decoder weights.
WEIGHT_NAMES = (
    "in_w", "in_b", "n2w", "qkv_w", "proj_w", "proj_b", "cq_w", "co_w",
    "fc1_w", "fc1_b", "fc2_w", "fc2_b", "fn_s", "fn_b", "out_w", "out_b",
)


def pack_decoder_weights(decoder) -> Dict[str, torch.Tensor]:
    """The decoder's step-invariant weights, stacked over layers, contiguous.

    Linear weights keep torch's [out, in] layout.  Only the default decoder
    (AdaLN, no depthwise pre-net) has a fused form.
    """
    cfg = decoder.cfg
    if cfg.use_depthwise or not cfg.use_adaln:
        raise ValueError("the fused loop implements the AdaLN decoder without "
                         "the depthwise pre-net (use_adaln=True, use_depthwise=False)")
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


@torch.no_grad()
def prepare_loop_inputs(decoder, sem_idx: torch.Tensor, T: int, ts) -> Dict[str, torch.Tensor]:
    """Per-call, step-invariant tensors: ``pos`` [T, H], ``mods``
    [steps, L, 4, H] and ``ckv`` [L, B, S, 2H]."""
    device = sem_idx.device
    ctx = decoder.context(sem_idx=sem_idx)
    ckv = []
    for b in decoder.layers:
        ca = b.cross_attn
        ckv.append(ca.kv_up_proj(ca.kv_norm(ca.kv_down_proj(ctx))))
    n = len(ts)
    te = decoder.time_cond(
        torch.tensor(ts, dtype=torch.float32, device=device),
        torch.arange(n, device=device),
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


def fused_ddim_plain(
    x_T, pos, mods, ckv, coef, w, *, heads: int, window: int, prediction: str = "eps",
) -> torch.Tensor:
    """The kernel's computation in plain tensor ops (same inputs, same order)."""
    B, T, M = x_T.shape
    H = pos.shape[1]
    L, S = ckv.shape[0], ckv.shape[2]
    dh = H // heads

    def split(t, n):
        return t.reshape(B, n, heads, dh).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(B, T, H)

    x, x0 = x_T, torch.zeros_like(x_T)
    for i in range(coef.shape[0]):
        h = x @ w["in_w"].T + w["in_b"] + pos
        for l in range(L):
            m = mods[i, l]
            hn = rms_normalize(h) * m[0] + m[1]
            qkv = hn @ w["qkv_w"][l].T
            q, k, v = (split(qkv[..., j * H:(j + 1) * H], T) for j in range(3))
            h = h + (merge(banded_attention_plain(q, k, v, window)) @ w["proj_w"][l].T
                     + w["proj_b"][l])
            hn = rms_normalize(h) * w["n2w"][l]
            q = split(hn @ w["cq_w"][l].T, T)
            a = sdpa(q, split(ckv[l, ..., :H], S), split(ckv[l, ..., H:], S))
            h = h + merge(a) @ w["co_w"][l].T
            hn = rms_normalize(h) * m[2] + m[3]
            f = swiglu(hn @ w["fc1_w"][l].T + w["fc1_b"][l])
            h = h + (f @ w["fc2_w"][l].T + w["fc2_b"][l])
        hn = F.layer_norm(h, (H,), w["fn_s"], w["fn_b"], eps=1e-6)
        pred = hn @ w["out_w"].T + w["out_b"]
        sab, s1m, sabp, s1mp = coef[i]
        eps = s1m * x + sab * pred if prediction == "v" else pred
        x0 = ((x - s1m * eps) / sab).clamp(-X0_CLIP, X0_CLIP)
        x = sabp * x0 + s1mp * eps
    return x0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ddim")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edt_fused_ddim_workspace.argtypes = [i, i, i, i, i]
    lib.edt_fused_ddim_workspace.restype = ctypes.c_longlong
    lib.edt_fused_ddim.argtypes = [p] * 23 + [i] * 11 + [ctypes.c_float, p]
    lib.edt_fused_ddim.restype = ctypes.c_int
    return lib


def fused_ddim(
    x_T, pos, mods, ckv, coef, w, *, heads: int, window: int, prediction: str = "eps",
) -> torch.Tensor:
    """Run the whole DDIM loop; returns the last x0 [B, T, M].

    ``prediction="v"`` reads the decoder output as v; anything else as eps,
    as the JAX kernel does.

    CPU tensors take ``fused_ddim_plain``; CUDA tensors launch the kernel
    sequence, counted once per call in ``fused_ddim.launches``.
    """
    if x_T.device.type == "cpu":
        return fused_ddim_plain(x_T, pos, mods, ckv, coef, w, heads=heads,
                                window=window, prediction=prediction)
    if x_T.device.type != "cuda":
        raise ValueError(f"fused_ddim runs on CPU or CUDA, not {x_T.device}")
    B, T, M = x_T.shape
    steps, L, _, H = mods.shape
    S = ckv.shape[2]
    F2 = w["fc1_w"].shape[1]
    expected = {
        "x_T": (B, T, M), "pos": (T, H), "mods": (steps, L, 4, H),
        "ckv": (L, B, S, 2 * H), "coef": (steps, 4),
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
    if H % heads or H // heads > 64:
        raise ValueError(f"hidden {H} / heads {heads}: head dim must divide and be <= 64")
    lib = _lib()
    ffn = F2 // 2
    out = torch.empty_like(x_T)
    work = torch.empty(lib.edt_fused_ddim_workspace(B, T, H, ffn, M),
                       dtype=torch.float32, device=x_T.device)
    with torch.cuda.device(x_T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_fused_ddim(
            x_T.data_ptr(), out.data_ptr(), work.data_ptr(), pos.data_ptr(),
            *(w[n].data_ptr() for n in WEIGHT_NAMES[:2]),
            mods.data_ptr(),
            *(w[n].data_ptr() for n in WEIGHT_NAMES[2:7]),
            ckv.data_ptr(),
            *(w[n].data_ptr() for n in WEIGHT_NAMES[7:]),
            coef.data_ptr(),
            B, T, S, M, H, heads, L, ffn, window, steps, int(prediction == "v"),
            X0_CLIP, stream,
        )
    fused_ddim.launches += 1
    _build.check(err, "fused_ddim")
    return out


fused_ddim.launches = 0


def fused_generate_mel(
    cfg: CFG,
    schedule: DiffusionSchedule,
    decoder,
    sem_idx: torch.Tensor,
    x_T: torch.Tensor,
    num_steps: int,
    prediction: str = "eps",
    weights: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """x_T [B, T, n_mels] + tokens [B, S] -> x0 through ``fused_ddim``.

    ``weights`` are ``pack_decoder_weights(decoder)``, packed here if not
    given.  The strided grid may hold fewer than ``num_steps`` steps; the loop
    runs what exists, as the JAX package does.
    """
    ts, coef = ddim_coefficients(schedule, num_steps)
    with torch.no_grad():
        w = weights if weights is not None else pack_decoder_weights(decoder)
        loop = prepare_loop_inputs(decoder, sem_idx, x_T.shape[1], ts)
        return fused_ddim(
            x_T.float().contiguous(), loop["pos"], loop["mods"], loop["ckv"],
            coef.to(x_T.device), w, heads=cfg.heads, window=cfg.attn_window_size,
            prediction=prediction,
        )


class FusedEdgeInference:
    """``generate_mel`` straight through the fused loop (DDIM only).

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


def start_noise(sem_idx: torch.Tensor, n_mels: int, temperature: float,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x_T = normal(B, 2S, n_mels) * temperature, drawn from ``generator``
    (a fresh one seeded 0 on ``sem_idx``'s device when None)."""
    B, S = sem_idx.shape
    if generator is None:
        generator = torch.Generator(device=sem_idx.device).manual_seed(0)
    x = torch.randn((B, 2 * S, n_mels), generator=generator, device=sem_idx.device)
    return x * temperature
