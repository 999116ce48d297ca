"""The decoder step's GEMM in plain tensor ops, and the plain loops in float64.

``decoder_gemm_plain`` (the plain version of csrc/gemm.cuh, which
``decoder_step_plain`` calls in the kernel's order) is held, in each of its
prologue and epilogue variants, to the plain torch composition the decoder's
modules use (``rms_normalize``, ``F.layer_norm``, ``swiglu``, a Linear) at a
small size.  The plain loops keep float64 end to end, which is what makes a
float64 run of them a witness of float32 rounding on the card.  The CUDA
kernel against ``decoder_gemm_plain`` is in test_torch_kernels_gpu.py; the
loops' plain versions against the JAX kernels are in
test_torch_fused_denoise.py and test_torch_ddpm.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.layers.attention import sdpa
from edge_diffusion_tts_tpu_torch.layers.ffn import swiglu
from edge_diffusion_tts_tpu_torch.layers.norms import rms_normalize
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder
from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
from edge_diffusion_tts_tpu_torch.ops.window_attention import banded_attention_plain
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

B, T, N, K = 2, 6, 12, 8


def _t(rng, *shape, s=1.0):
    return torch.from_numpy((s * rng.randn(*shape)).astype(np.float32))


@pytest.mark.parametrize(
    "variant", ["plain", "bias_pos", "residual", "swiglu", "adaln_rms", "rms_w", "ln"])
def test_decoder_gemm_plain_matches_torch_composition(variant):
    rng = np.random.RandomState(len(variant))
    a = _t(rng, B, T, K)
    w = _t(rng, 2 * N if variant == "swiglu" else N, K)
    bias, pos, res = _t(rng, w.shape[0]), _t(rng, T, N), _t(rng, B, T, N)
    scale, shift = 1.0 + _t(rng, K, s=0.1), _t(rng, K, s=0.1)
    kw, want = {
        "plain": ({}, lambda: F.linear(a, w)),
        "bias_pos": (dict(bias=bias, pos=pos), lambda: F.linear(a, w, bias) + pos),
        "residual": (dict(residual=res), lambda: res + F.linear(a, w)),
        "swiglu": (dict(bias=bias, swiglu=True), lambda: swiglu(F.linear(a, w, bias))),
        "adaln_rms": (dict(norm="rms", scale=scale, shift=shift),
                      lambda: F.linear(rms_normalize(a) * scale + shift, w)),
        "rms_w": (dict(norm="rms", scale=scale), lambda: F.linear(rms_normalize(a) * scale, w)),
        "ln": (dict(norm="ln", scale=scale, shift=shift, bias=bias[:N]),
               lambda: F.linear(F.layer_norm(a, (K,), scale, shift, eps=1e-6), w, bias[:N])),
    }[variant]
    got = fd.decoder_gemm_plain(a, w, **kw)
    assert got.shape == (B, T, N)
    torch.testing.assert_close(got, want(), atol=1e-6, rtol=1e-6)


def test_decoder_gemm_plain_positional_rows_wrap():
    """pos[m % P] over the flattened rows, also when P does not divide them."""
    rng = np.random.RandomState(0)
    a, w, pos = _t(rng, 7, K), _t(rng, N, K), _t(rng, 3, N)
    got = fd.decoder_gemm_plain(a, w, pos=pos)
    want = F.linear(a, w) + pos[torch.arange(7) % 3]
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_decoder_gemm_plain_rejects_an_unknown_norm():
    with pytest.raises(ValueError, match="norm"):
        fd.decoder_gemm_plain(torch.zeros(2, K), torch.zeros(N, K), norm="group",
                              scale=torch.ones(K))


def test_decoder_gemm_refuses_cpu_tensors():
    """The kernel's hook never falls back to its plain version."""
    before = fd.decoder_gemm.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fd.decoder_gemm(torch.zeros(4, K), torch.zeros(N, K))
    assert fd.decoder_gemm.launches == before


def test_plain_attention_keeps_float64():
    """Banded and full attention in float64 agree with a float64 numpy
    softmax to 1e-12 (a float32 step inside would leave ~1e-7)."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(1, 2, 9, 4) for _ in range(3))
    logits = np.einsum("bhid,bhjd->bhij", q, k) / 2.0
    i = np.arange(9)
    band = np.abs(i[:, None] - i[None, :]) <= 2
    for mask, got in (
        (band, banded_attention_plain(*map(torch.from_numpy, (q, k, v)), 2)),
        (np.ones_like(band), sdpa(*map(torch.from_numpy, (q, k, v)))),
    ):
        e = np.where(mask, np.exp(logits - np.where(mask, logits, -np.inf).max(-1, keepdims=True)),
                     0.0)
        want = np.einsum("bhij,bhjd->bhid", e / e.sum(-1, keepdims=True), v)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)


def test_ddpm_plain_in_float64_tracks_float32():
    """The float64 witness of chip_smoke.py phase 8 at a small size: the
    plain DDPM loop cast to float64 (Philox draws as in float32) stays
    float64 and ends within float32 rounding of the float32 loop."""
    cfg = CFG(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8)
    torch.manual_seed(2)
    dec = EdgeDiffusionDecoder(cfg).eval()
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn(p.shape))
    rng = np.random.RandomState(6)
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (1, 6)))
    x_T = torch.from_numpy(rng.randn(1, 12, 80).astype(np.float32))
    steps = 8
    loop = fd.prepare_loop_inputs(dec, sem_idx, 12, list(range(steps - 1, -1, -1)),
                                  step_idx=torch.zeros(steps, dtype=torch.long))
    args = (x_T, loop["pos"], loop["mods"], loop["ckv"],
            fd.ddpm_coefficients(DiffusionSchedule.create(steps)), fd.pack_decoder_weights(dec))
    kw = dict(heads=cfg.heads, window=cfg.attn_window_size, key=(11, 12))
    x32 = fd.fused_ddpm_plain(*args, **kw)
    args64 = [t.double() for t in args[:5]] + [{n: t.double() for n, t in args[5].items()}]
    x64 = fd.fused_ddpm_plain(*args64, **kw)
    assert x64.dtype == torch.float64 and torch.isfinite(x64).all()
    scale = x64.abs().max().item()
    assert 0 < (x32.double() - x64).abs().max().item() <= 1e-5 * scale
