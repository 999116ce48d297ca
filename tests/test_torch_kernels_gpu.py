"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; ``tests/conftest.py`` imports JAX, so run it there as

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder
from edge_diffusion_tts_tpu_torch.models.hubert import FeatureExtractor, HubertConfig
from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
from edge_diffusion_tts_tpu_torch.ops import window_attention as wa
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


BAND_SHAPES = [(1, 4, 500, 40, 64, None), (2, 4, 200, 40, 64, 150), (1, 2, 300, 32, 16, None),
               (1, 2, 256, 64, 200, None), (1, 1, 130, 16, 0, None), (1, 3, 77, 24, 5, None),
               (1, 4, 4000, 40, 64, None), (2, 4, 4000, 40, 64, None),
               (1, 2, 1000, 48, 200, 900), (1, 2, 333, 20, 16, 100), (1, 1, 64, 36, 5, 0)]


def _band_inputs(B, H, T, d, device):
    rng = np.random.RandomState(T + d)
    return [torch.from_numpy(rng.randn(B, H, T, d).astype(np.float32)).to(device)
            for _ in range(3)]


@pytest.mark.parametrize("B,H,T,d,window,seq_len", BAND_SHAPES)
def test_banded_kernel_matches_plain(cuda, B, H, T, d, window, seq_len):
    """Windows 0 to 200, head dims 16 to 64, seq_len < T (0: no key at
    all), T from 64 to 4000, in the plan's tile: atol 2e-5."""
    q, k, v = _band_inputs(B, H, T, d, cuda)
    before = wa.banded_attention.launches
    got = wa.banded_attention(q, k, v, window, seq_len=seq_len)
    torch.cuda.synchronize()
    assert wa.banded_attention.launches == before + 1
    want = wa.banded_attention_plain(q, k, v, window, seq_len=seq_len)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("rows", wa.BAND_ROWS)
@pytest.mark.parametrize("B,H,T,d,window,seq_len", [BAND_SHAPES[i] for i in (1, 3, 5, 7, 10)])
def test_banded_kernel_every_tile(cuda, monkeypatch, rows, B, H, T, d, window, seq_len):
    """Each built tile, the plan narrowed to it."""
    monkeypatch.setattr(wa, "BAND_ROWS", (rows,))
    q, k, v = _band_inputs(B, H, T, d, cuda)
    got = wa.banded_attention(q, k, v, window, seq_len=seq_len)
    torch.testing.assert_close(got, wa.banded_attention_plain(q, k, v, window, seq_len=seq_len),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("B,T", [(1, 4000), (2, 500)])
def test_banded_kernel_strided_views_bthd_output(cuda, B, T):
    """q, k, v as views of a [B, T, 3, H, d] buffer; o in [B, T, H, d]
    memory, as the attention layer calls it."""
    H, d, w = 4, 40, 64
    rng = np.random.RandomState(B * T)
    qkv = torch.from_numpy(rng.randn(B, T, 3, H, d).astype(np.float32)).to(cuda)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    got = wa.banded_attention(q, k, v, w, out_layout="bthd")
    torch.cuda.synchronize()
    assert got.shape == (B, H, T, d) and got.transpose(1, 2).is_contiguous()
    want = wa.banded_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), w)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    assert torch.equal(got, wa.banded_attention(q.contiguous(), k.contiguous(),
                                                v.contiguous(), w))


def test_banded_kernel_gives_the_same_bits_twice(cuda):
    q, k, v = _band_inputs(2, 4, 4000, 40, cuda)
    assert torch.equal(wa.banded_attention(q, k, v, 64), wa.banded_attention(q, k, v, 64))


@pytest.mark.parametrize("d", range(4, wa.MAX_HEAD_DIM + 1, 4))
@pytest.mark.parametrize("rows", wa.BAND_ROWS)
def test_band_geometry_of_the_library_is_the_plan(cuda, monkeypatch, rows, d):
    monkeypatch.setattr(wa, "BAND_ROWS", (rows,))
    plan = wa.band_plan(1, 4, 4000, d, 64)
    assert wa.band_geometry(rows, d) == {k: plan[k] for k in ("threads", "keys", "stages", "smem")}


def test_banded_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 1, 8, 72, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        wa.banded_attention(q, q, q, 2)
    q = torch.zeros(1, 1, 8, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        wa.banded_attention(q, q, q, 2)
    q = torch.zeros(1, 1, 8, 42, device=cuda)[..., :40]  # rows 168 bytes apart
    with pytest.raises(ValueError, match="16-byte aligned"):
        wa.banded_attention(q, q, q, 2)
    q = torch.zeros(1, 1, 8, 44, device=cuda)[..., 1:41]  # every row 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        wa.banded_attention(q, q, q, 2)
    q = torch.zeros(1, 1, 40, 8, device=cuda).transpose(2, 3)  # d not unit-stride
    with pytest.raises(ValueError, match="unit-stride"):
        wa.banded_attention(q, q, q, 2)


GEMM_VARIANTS = ("plain", "bias_pos", "residual_aliased", "swiglu", "adaln_rms", "rms_w", "ln")


def _gemm_case(variant, M, N, K, device, seed):
    """Inputs of one decoder_gemm variant: (a, w, keyword arguments), at the
    decoder's scales: unit activations, weights U(-1/sqrt(K), 1/sqrt(K)) as
    torch's Linear draws them."""
    rng = np.random.RandomState(seed)

    def t(*shape, s=1.0):
        return torch.from_numpy((s * rng.randn(*shape)).astype(np.float32)).to(device)

    a = t(M, K)
    rows = 2 * N if variant == "swiglu" else N
    w = torch.from_numpy(rng.uniform(-1, 1, (rows, K)).astype(np.float32) * K ** -0.5).to(device)
    kw = {
        "plain": {},
        "bias_pos": dict(bias=t(N), pos=t(50, N)),
        "residual_aliased": dict(residual=t(M, N)),
        "swiglu": dict(bias=t(2 * N), swiglu=True),
        "adaln_rms": dict(norm="rms", scale=1.0 + t(K, s=0.1), shift=t(K, s=0.1)),
        "rms_w": dict(norm="rms", scale=1.0 + t(K, s=0.1)),
        "ln": dict(norm="ln", scale=1.0 + t(K, s=0.1), shift=t(K, s=0.1), bias=t(N)),
    }[variant]
    return a, w, kw


def _check_decoder_gemm(variant, M, N, K, device):
    a, w, kw = _gemm_case(variant, M, N, K, device, seed=M * 7 + N * 3 + K)
    want = fd.decoder_gemm_plain(a, w, **kw)
    if variant == "residual_aliased":
        kw["out"] = kw["residual"]  # updated in place, as the decoder step does
    before = fd.decoder_gemm.launches
    got = fd.decoder_gemm(a, w, **kw)
    torch.cuda.synchronize()
    assert fd.decoder_gemm.launches == before + 1
    if variant == "residual_aliased":
        assert got.data_ptr() == kw["residual"].data_ptr()
    assert got.shape == (M, N)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("K", [80, 160, 320])
@pytest.mark.parametrize("N", [80, 160, 480])
@pytest.mark.parametrize("M", [77, 500, 1000])
@pytest.mark.parametrize("variant", GEMM_VARIANTS)
def test_decoder_gemm_matches_plain(cuda, variant, M, N, K):
    """The decoder step's GEMM in each prologue and epilogue variant, the
    host's tile, ragged M and N: atol 1e-5, rtol 1e-5 (another float32
    summation order of the norms; the products sum in k order)."""
    _check_decoder_gemm(variant, M, N, K, cuda)


# Shapes whose output the host gives each of the kernel's tiles on a 132-SM
# H100 (the largest tile with at least 132 blocks): 32x64, 32x32, 16x32, 8x32.
TILE_SHAPES = {(2000, 160, 160): (32, 64), (500, 480, 160): (32, 32),
               (500, 160, 320): (16, 32), (500, 80, 80): (8, 32)}


@pytest.mark.parametrize("M,N,K", list(TILE_SHAPES))
@pytest.mark.parametrize("variant", GEMM_VARIANTS)
def test_decoder_gemm_every_tile(cuda, variant, M, N, K):
    _check_decoder_gemm(variant, M, N, K, cuda)


def test_decoder_gemm_tiles_fill_the_card_at_the_flagship_rows(cuda):
    """Every product of the flagship decoder step (500 rows) launches at
    least one block per SM, and TILE_SHAPES reach every tile on the H100."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in (80, 160, 320, 480):
        bm, bn = fd.decoder_gemm_tile(500, n)
        assert -(-500 // bm) * -(-n // bn) >= sms, (n, bm, bn)
    if sms == 132:
        assert {(M, N): fd.decoder_gemm_tile(M, N) for M, N, _ in TILE_SHAPES} == {
            (M, N): tile for (M, N, _), tile in TILE_SHAPES.items()}


def test_decoder_gemm_rejects_what_it_cannot_take(cuda):
    a = torch.zeros(8, 6, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        fd.decoder_gemm(a, torch.zeros(4, 6, device=cuda))
    a = torch.zeros(8, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fd.decoder_gemm(a.double(), torch.zeros(4, 8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fd.decoder_gemm(a, torch.zeros(8, 4, device=cuda).T)
    with pytest.raises(ValueError, match="bias"):
        fd.decoder_gemm(a, torch.zeros(4, 8, device=cuda), bias=torch.zeros(5, device=cuda))
    with pytest.raises(ValueError, match="norm"):
        fd.decoder_gemm(a, torch.zeros(4, 8, device=cuda), norm="rms")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fd.decoder_gemm(a.cpu(), torch.zeros(4, 8))


def test_fused_loops_launch_35_kernels_per_step_at_4_layers(cuda):
    """The decoder step is 2 + 8L launches (26 GEMMs and 8 attentions at
    L = 4, the norms folded into the GEMMs), plus the sampler's update."""
    cfg = CFG(layers=4, hidden=32, heads=2, dropout=0.0, attn_window_size=8)
    dec = EdgeDiffusionDecoder(cfg).to(cuda).eval()
    sem_idx = torch.zeros(1, 8, dtype=torch.long, device=cuda)
    x_T = torch.zeros(1, 16, 80, device=cuda)
    ts, coef = fd.ddim_coefficients(DiffusionSchedule.create(1000), 3)
    loop = fd.prepare_loop_inputs(dec, sem_idx, 16, ts)
    before = fd.kernel_launches()
    fd.fused_ddim(x_T, loop["pos"], loop["mods"], loop["ckv"], coef.to(cuda),
                  fd.pack_decoder_weights(dec), heads=cfg.heads, window=cfg.attn_window_size)
    torch.cuda.synchronize()
    assert fd.kernel_launches() - before == 3 * 35


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_fused_kernel_matches_plain(cuda, prediction):
    """Small decoder (hidden 32, 2 layers, 2 heads of 16, window 8), B=2,
    S=40.  DDIM divides by sqrt(alpha_bar[999]) = 1.56e-5 at its first step,
    so last-bit differences between the two summation orders move a few
    elements by up to a rounding quantum (chip_smoke.py's docstring): at
    most 0.1% of elements beyond 2e-4, none beyond 0.05."""
    cfg = CFG(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8)
    torch.manual_seed(0)
    dec = EdgeDiffusionDecoder(cfg)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn(p.shape))
    dec = dec.to(cuda).eval()
    rng = np.random.RandomState(3)
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (2, 40))).to(cuda)
    x_T = torch.from_numpy(rng.randn(2, 80, 80).astype(np.float32)).to(cuda)
    ts, coef = fd.ddim_coefficients(DiffusionSchedule.create(1000), 4)
    loop = fd.prepare_loop_inputs(dec, sem_idx, 80, ts)
    args = (x_T, loop["pos"], loop["mods"], loop["ckv"], coef.to(cuda),
            fd.pack_decoder_weights(dec))
    kw = dict(heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction)
    before = fd.fused_ddim.launches
    got = fd.fused_ddim(*args, **kw)
    torch.cuda.synchronize()
    assert fd.fused_ddim.launches == before + 1
    want = fd.fused_ddim_plain(*args, **kw)
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert (diff > 2e-4).float().mean().item() <= 1e-3 and diff.max().item() <= 0.05


@pytest.mark.parametrize("B,samples", [(1, 8000), (2, 32000), (1, 80000), (3, 4321)])
def test_conv_frontend_kernel_matches_plain(cuda, B, samples):
    """Full hubert-base conv stack with default-init weights; held to atol
    2e-4, rtol 1e-3 (the JAX fused kernel's bar), and to the module route."""
    torch.manual_seed(samples)
    fe = FeatureExtractor(HubertConfig()).to(cuda).eval()
    w = ff.pack_frontend_weights(fe)
    rng = np.random.RandomState(B + samples)
    wav = torch.from_numpy((0.2 * rng.randn(B, samples)).astype(np.float32)).to(cuda)
    before = ff.conv_frontend.launches
    got = ff.conv_frontend(wav, w)
    torch.cuda.synchronize()
    assert ff.conv_frontend.launches == before + 1
    assert got.shape == (B, ff.frame_counts(samples)[-1], 512)
    torch.testing.assert_close(got, ff.conv_frontend_plain(wav, w), atol=2e-4, rtol=1e-3)
    with torch.no_grad():
        torch.testing.assert_close(got, fe(wav), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("noise_mode", ["injected", "philox"])
@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_fused_ddpm_kernel_matches_plain(cuda, prediction, noise_mode):
    """Small decoder (hidden 32, 2 layers, window 8), B=2, S=20, the 50-step
    schedule; relative tolerance as the JAX DDPM test (rtol 1e-4, atol
    1e-3): the unclamped recurrence grows to O(1e3)."""
    cfg = CFG(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8)
    torch.manual_seed(1)
    dec = EdgeDiffusionDecoder(cfg)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn(p.shape))
    dec = dec.to(cuda).eval()
    sched = DiffusionSchedule.create(50)
    rng = np.random.RandomState(4)
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (2, 20))).to(cuda)
    x_T = torch.from_numpy(rng.randn(2, 40, 80).astype(np.float32)).to(cuda)
    noise = None
    if noise_mode == "injected":
        noise = torch.from_numpy(rng.randn(2, 50, 40, 80).astype(np.float32)).to(cuda)
    ts = list(range(49, -1, -1))
    loop = fd.prepare_loop_inputs(dec, sem_idx, 40, ts,
                                  step_idx=torch.zeros(50, dtype=torch.long))
    args = (x_T, loop["pos"], loop["mods"], loop["ckv"], fd.ddpm_coefficients(sched).to(cuda),
            fd.pack_decoder_weights(dec))
    kw = dict(heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction,
              noise=noise, key=(123456789, 987654321))
    before = fd.fused_ddpm.launches
    got = fd.fused_ddpm(*args, **kw)
    torch.cuda.synchronize()
    assert fd.fused_ddpm.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, fd.fused_ddpm_plain(*args, **kw), rtol=1e-4, atol=1e-3)


def _prenet_decoder(cuda, seed, layers=2):
    """A small decoder with the depthwise pre-net (hidden 32, 2 heads of 16,
    window 8), every weight moved by 0.02 N(0, 1) from its init."""
    cfg = CFG(hidden=32, layers=layers, heads=2, dropout=0.0, attn_window_size=8,
              use_depthwise=True)
    torch.manual_seed(seed)
    dec = EdgeDiffusionDecoder(cfg)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn(p.shape))
    return cfg, dec.to(cuda).eval()


@pytest.mark.parametrize("B,T", [(2, 41), (2, 1), (1, 500)])
def test_decoder_prenet_kernels_match_plain(cuda, B, T):
    """The pre-net's three kernels alone (``decoder_prenet``) against
    ``decoder_prenet_plain``: odd T at B=2 (the depthwise taps stop at each
    batch row's edges), T=1 (both taps outside), and 500 rows at hidden 32;
    atol 1e-5 (float32 sums in two orders over 32 channels and T x 4
    GroupNorm elements)."""
    _, dec = _prenet_decoder(cuda, 5)
    w = fd.pack_decoder_weights(dec)
    rng = np.random.RandomState(T)
    h = torch.from_numpy(rng.randn(B, T, 32).astype(np.float32)).to(cuda)
    pos = dec.pos_emb.table[:T].contiguous()
    before = fd.decoder_prenet.launches
    got = fd.decoder_prenet(h, pos, w)
    torch.cuda.synchronize()
    assert fd.decoder_prenet.launches == before + 1
    torch.testing.assert_close(got, fd.decoder_prenet_plain(h, pos, w), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="pc_dw"):
        fd.decoder_prenet(h, pos, dict(w, pc_dw=w["pc_dw"].t().contiguous()))


def _prenet_step_args(cuda, dec, B, S, T, t):
    """One DDIM step from t (a well-conditioned coefficient row: the first
    step's t = 999 would divide by sqrt(alpha_bar) = 1.56e-5)."""
    sched = DiffusionSchedule.create(1000)
    ab = sched.alpha_bar[t].item()
    coef = torch.tensor([[ab ** 0.5, (1 - ab) ** 0.5, 1.0, 0.0]], device=cuda)
    rng = np.random.RandomState(B * 1000 + T)
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (B, S))).to(cuda)
    x_T = torch.from_numpy(rng.randn(B, T, 80).astype(np.float32)).to(cuda)
    loop = fd.prepare_loop_inputs(dec, sem_idx, T, [t])
    return (x_T, loop["pos"], loop["mods"], loop["ckv"], coef, fd.pack_decoder_weights(dec))


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_fused_step_with_prenet_matches_plain(cuda, prediction):
    """One decoder step with the pre-net in the fused loop (one DDIM step
    from t = 500, x0 = (x - sqrt(1-ab) eps) / sqrt(ab), sqrt(ab) ~ 0.28)
    against ``decoder_step_plain`` through ``fused_ddim_plain``, B=2, odd T
    = 41: atol 1e-4; two calls bit-equal."""
    cfg, dec = _prenet_decoder(cuda, 0)
    args = _prenet_step_args(cuda, dec, 2, 21, 41, 500)
    kw = dict(heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction)
    before = fd.fused_ddim.launches
    got = fd.fused_ddim(*args, **kw)
    again = fd.fused_ddim(*args, **kw)
    torch.cuda.synchronize()
    assert fd.fused_ddim.launches == before + 2
    assert torch.equal(got, again), "the pre-net step differs between two calls"
    torch.testing.assert_close(got, fd.fused_ddim_plain(*args, **kw), atol=1e-4, rtol=0)


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_fused_kernel_with_prenet_matches_plain(cuda, prediction):
    """The 4-step DDIM loop with the pre-net, B=2, S=40, under the rule of
    ``test_fused_kernel_matches_plain``: at most 0.1% of elements beyond
    2e-4, none beyond 0.05."""
    cfg, dec = _prenet_decoder(cuda, 0)
    rng = np.random.RandomState(3)
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (2, 40))).to(cuda)
    x_T = torch.from_numpy(rng.randn(2, 80, 80).astype(np.float32)).to(cuda)
    ts, coef = fd.ddim_coefficients(DiffusionSchedule.create(1000), 4)
    loop = fd.prepare_loop_inputs(dec, sem_idx, 80, ts)
    args = (x_T, loop["pos"], loop["mods"], loop["ckv"], coef.to(cuda),
            fd.pack_decoder_weights(dec))
    kw = dict(heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction)
    got = fd.fused_ddim(*args, **kw)
    torch.cuda.synchronize()
    diff = (got - fd.fused_ddim_plain(*args, **kw)).abs()
    assert torch.isfinite(got).all()
    assert (diff > 2e-4).float().mean().item() <= 1e-3 and diff.max().item() <= 0.05


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_fused_ddpm_kernel_with_prenet_matches_plain(cuda, prediction):
    """The 50-step DDPM loop with the pre-net, B=2, S=20, injected noise,
    under ``test_fused_ddpm_kernel_matches_plain``'s bar (rtol 1e-4, atol
    1e-3)."""
    cfg, dec = _prenet_decoder(cuda, 1)
    rng = np.random.RandomState(4)
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (2, 20))).to(cuda)
    x_T = torch.from_numpy(rng.randn(2, 40, 80).astype(np.float32)).to(cuda)
    noise = torch.from_numpy(rng.randn(2, 50, 40, 80).astype(np.float32)).to(cuda)
    loop = fd.prepare_loop_inputs(dec, sem_idx, 40, list(range(49, -1, -1)),
                                  step_idx=torch.zeros(50, dtype=torch.long))
    args = (x_T, loop["pos"], loop["mods"], loop["ckv"],
            fd.ddpm_coefficients(DiffusionSchedule.create(50)).to(cuda),
            fd.pack_decoder_weights(dec))
    kw = dict(heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction,
              noise=noise)
    got = fd.fused_ddpm(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, fd.fused_ddpm_plain(*args, **kw), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("loop", ["ddim", "ddpm"])
def test_fused_loops_launch_3_more_kernels_per_step_with_the_prenet(cuda, loop):
    """At 4 layers a step with the pre-net is 35 + 3 = 38 launches (its
    update included); the same decoder without the pre-net's weights (the
    step of a config without it) launches today's 35."""
    cfg, dec = _prenet_decoder(cuda, 2, layers=4)
    B, S, T, steps = 1, 8, 16, 3
    sem_idx = torch.zeros(B, S, dtype=torch.long, device=cuda)
    x_T = torch.zeros(B, T, 80, device=cuda)
    ts = list(range(steps - 1, -1, -1))
    pre = fd.pack_decoder_weights(dec)
    plain = {k: v for k, v in pre.items() if k not in fd.PRENET_NAMES}
    loop_in = fd.prepare_loop_inputs(dec, sem_idx, T, ts)
    coef = (fd.ddim_coefficients(DiffusionSchedule.create(1000), steps)[1] if loop == "ddim"
            else fd.ddpm_coefficients(DiffusionSchedule.create(steps))).to(cuda)
    run = fd.fused_ddim if loop == "ddim" else fd.fused_ddpm
    for w, per_step in ((pre, 38), (plain, 35)):
        before = fd.kernel_launches()
        run(x_T, loop_in["pos"], loop_in["mods"], loop_in["ckv"], coef, w, heads=cfg.heads,
            window=cfg.attn_window_size)
        torch.cuda.synchronize()
        assert fd.kernel_launches() - before == steps * per_step


# Shapes whose plan reaches every path of the frontend kernels on a 132-SM
# H100: one split (GELU in the GEMM's epilogue), even and uneven split-K (2,
# 4, 5, 8, 11, 16 and 32 splits; 32 = one chunk per split, fewer than the
# ring's stages), 3- and 2-tap layers, ragged last tiles, B = 1 to 4.
FRONTEND_SHAPES = [(1, 8000), (3, 4321), (2, 32000), (1, 80000), (4, 32000)]


@pytest.fixture(scope="module")
def frontend():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(11)
    fe = FeatureExtractor(HubertConfig()).to("cuda").eval()
    return ff.pack_frontend_weights(fe)


def _frontend_wav(B, samples):
    rng = np.random.RandomState(B * 7 + samples)
    return torch.from_numpy((0.2 * rng.randn(B, samples)).astype(np.float32)).to("cuda")


@pytest.mark.parametrize("layer", range(7))
@pytest.mark.parametrize("B,samples", FRONTEND_SHAPES)
def test_conv_frontend_layer_matches_plain(frontend, B, samples, layer):
    """Each layer alone in the plan's tile and split, on the plain chain's
    input for it: atol 2e-4, rtol 1e-3."""
    w = frontend
    wav = _frontend_wav(B, samples)
    fold = ff.groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"])
    x = wav
    for i in range(layer):
        x = ff.conv_frontend_layer_plain(x, i, w, *(fold if i == 0 else ()))
    extra = fold if layer == 0 else ()
    before = ff.conv_frontend_layer.launches
    got = ff.conv_frontend_layer(x, layer, w, *extra)
    torch.cuda.synchronize()
    assert ff.conv_frontend_layer.launches == before + 1
    want = ff.conv_frontend_layer_plain(x, layer, w, *extra)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("splits", [1, 3, 7, 32])
def test_conv_frontend_layer_any_split_is_the_same_sum(frontend, splits):
    """A 3-tap and a 2-tap layer at split factors the plan does not pick;
    splits partition the channels, so the results agree to float32
    reassociation."""
    w = frontend
    rng = np.random.RandomState(splits)
    for layer, T in ((2, 801), (5, 300)):
        x = torch.from_numpy(rng.rand(2, T, 512).astype(np.float32)).to("cuda")
        got = ff.conv_frontend_layer(x, layer, w, splits=splits)
        torch.testing.assert_close(got, ff.conv_frontend_layer_plain(x, layer, w),
                                   atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("B,samples", [(1, 80000), (3, 4321)])
def test_conv_frontend_gives_the_same_bits_twice(frontend, B, samples):
    wav = _frontend_wav(B, samples)
    first = ff.conv_frontend(wav, frontend)
    assert torch.equal(first, ff.conv_frontend(wav, frontend))
    torch.testing.assert_close(first, ff.conv_frontend_plain(wav, frontend), atol=2e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("B,samples", FRONTEND_SHAPES)
def test_conv_frontend_workspace_matches_the_plan(frontend, B, samples):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ff.frontend_plan(B, samples, sms=sms)
    lib = ff._lib()
    assert lib.edt_conv_frontend_workspace(B, samples, 512, ff._splits(plan)) == \
        ff.frontend_workspace(B, plan)


def test_conv_frontend_layer_rejects_what_it_cannot_take(frontend):
    w = frontend
    x = torch.zeros(1, 100, 512, device="cuda")
    with pytest.raises(ValueError, match="splits"):
        ff.conv_frontend_layer(x, 1, w, splits=33)
    with pytest.raises(ValueError, match="layer 1 takes"):
        ff.conv_frontend_layer(torch.zeros(1, 100, device="cuda"), 1, w)
    with pytest.raises(ValueError, match="scale and shift"):
        ff.conv_frontend_layer(torch.zeros(1, 800, device="cuda"), 0, w)
    with pytest.raises(ValueError, match="float32"):
        ff.conv_frontend_layer(x.double(), 1, w)
    with pytest.raises(ValueError, match="layer must be"):
        ff.conv_frontend_layer(x, 7, w)


@pytest.mark.parametrize("B,samples,wav_len", [(2, 128000, (80000, 128000)), (1, 32000, (20000,)),
                                               (3, 4321, (4321, 1000, 401))])
def test_conv_frontend_with_wav_len_matches_plain(frontend, B, samples, wav_len):
    """A zero-padded wav with the GroupNorm fold over each row's first
    wav_len samples: the kernel against its plain version (atol 2e-4, rtol
    1e-3), and each row's frames inside its true length against an
    exact-length call."""
    w = frontend
    lens = torch.as_tensor(wav_len, device="cuda")
    wav = _frontend_wav(B, samples) * (torch.arange(samples, device="cuda")[None] < lens[:, None])
    before = ff.conv_frontend.launches
    got = ff.conv_frontend(wav, w, wav_len=lens)
    torch.cuda.synchronize()
    assert ff.conv_frontend.launches == before + 1
    torch.testing.assert_close(got, ff.conv_frontend_plain(wav, w, wav_len=lens), atol=2e-4,
                               rtol=1e-3)
    for i, n in enumerate(wav_len):
        exact = ff.conv_frontend(wav[i:i + 1, :n].contiguous(), w)
        torch.testing.assert_close(got[i:i + 1, :exact.shape[1]], exact, atol=2e-4, rtol=1e-3)


def _chirp(n, sr=16000):
    t = np.arange(n) / sr
    return (0.5 * np.sin(2 * np.pi * (100 * t + 3900 * t ** 2 / (2 * t[-1])))).astype(np.float32)


def test_dsp_on_the_card_matches_the_cpu(cuda):
    """The DSP modules (cuFFT, cuDNN) against themselves on the CPU, at the
    tolerances their CPU tests hold against the JAX package."""
    from edge_diffusion_tts_tpu_torch.ops import mel
    from edge_diffusion_tts_tpu_torch.ops.resample import resample
    from edge_diffusion_tts_tpu_torch.ops.vocoder import griffin_lim
    from edge_diffusion_tts_tpu_torch.utils.audio import normalize_mel

    wav = torch.from_numpy(np.stack([_chirp(16000), _chirp(16000)[::-1].copy()]))
    front_cpu, front = mel.MelFrontend(), mel.MelFrontend().to(cuda)
    pow_cpu = mel.stft_power(wav)
    torch.testing.assert_close(mel.stft_power(wav.to(cuda)).cpu(), pow_cpu,
                               atol=1e-6 * pow_cpu.max().item(), rtol=0)
    mp = front_cpu.mel_power(wav)
    torch.testing.assert_close(front.mel_power(wav.to(cuda)).cpu(), mp, atol=1e-6 * mp.max().item(),
                               rtol=0)
    torch.testing.assert_close(front(wav.to(cuda)).cpu(), front_cpu(wav), atol=2e-3, rtol=0)
    re, im = mel.stft_complex(wav)
    torch.testing.assert_close(mel.istft(re.to(cuda), im.to(cuda)).cpu(), mel.istft(re, im),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(resample(wav.to(cuda), 22050, 16000).cpu(),
                               resample(wav, 22050, 16000), atol=1e-6, rtol=0)
    angle = torch.rand(pow_cpu.shape, generator=torch.Generator().manual_seed(0)) * 6.2831855
    gl = griffin_lim(pow_cpu, n_iter=4, angle=angle)
    torch.testing.assert_close(griffin_lim(pow_cpu.to(cuda), n_iter=4, angle=angle.to(cuda)).cpu(),
                               gl, atol=2e-5 * gl.abs().max().item(), rtol=0)
    for a, b in zip(normalize_mel(front(wav.to(cuda))), normalize_mel(front_cpu(wav))):
        torch.testing.assert_close(a.cpu(), b, atol=2e-3, rtol=0)


def test_refine_on_the_card_matches_the_cpu(cuda):
    """The long-form refine (the decoder once per step, CFG as one batch)
    on injected noise: the card against the CPU, atol 1e-4."""
    from edge_diffusion_tts_tpu_torch.pipeline import LongFormPipeline

    cfg = CFG(hidden=32, layers=2, heads=2, diff_steps=50, dropout=0.0)
    torch.manual_seed(5)
    dec = EdgeDiffusionDecoder(cfg)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn(p.shape))
    kw = dict(strength=0.6, steps=4, cfg_scale=2.0)
    out = {}
    for device in ("cpu", "cuda"):
        pipe = LongFormPipeline(cfg, DiffusionSchedule.create(50), dec, device=device)
        T, S = pipe.chunk_frames, pipe.chunk_samples // pipe.sem_stride
        r = np.random.RandomState(1)
        args = (r.randn(2, T, 80), r.randn(2, S, 128), r.randn(2, T, 80), [True, False],
                r.randn(2, kw["steps"] + 1, T, 80))
        out[device] = pipe.refine_chunk_batch(*args, **kw).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-4, rtol=0)


def test_two_threads_first_lib_call_load_one_library(cuda, monkeypatch, tmp_path):
    """Two threads that make the first ``_lib()`` call at once build the
    libraries once (into a fresh build directory) and share one handle."""
    import threading

    from edge_diffusion_tts_tpu_torch import _build

    builds = []
    real = _build._build_missing
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_build_missing", lambda: builds.append(1) or real())
    ff._lib.cache_clear()
    barrier, got = threading.Barrier(2), []

    def first_call():
        barrier.wait()
        got.append(ff._lib())

    try:
        threads = [threading.Thread(target=first_call) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
        assert len(builds) == 1 and len(got) == 2 and got[0] is got[1]
        assert str(got[0]._name).startswith(str(tmp_path))
    finally:
        ff._lib.cache_clear()


# ---- training ------------------------------------------------------------------------


def _seeded_hubert_base_encoder(cfg, seed):
    """A hubert-base SemanticEncoder with weights from a CPU generator: each
    matrix N(0, g/fan_in) (g = 2 for the convs), each vector its default +
    0.02 N(0, 1), as chip_smoke.py seeds its encoder."""
    from edge_diffusion_tts_tpu_torch.models import SemanticEncoder

    enc = SemanticEncoder(cfg, HubertConfig())
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if p.dim() >= 2:
                g = 2.0 if "conv" in name else 1.0
                p.copy_(torch.randn(p.shape, generator=gen) * (g / p[0].numel()) ** 0.5)
            else:
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    enc.hubert.pack_frontend()
    return enc


def test_training_step_on_the_card_matches_the_cpu(cuda):
    """One diffusion loss and its gradients at tiny width (depthwise pre-net
    on, the tiny HuBERT on its modules), injected t and noise, dropout 0: the
    card against the CPU, loss rtol 1e-4, every gradient cosine >= 0.99999."""
    import copy

    from edge_diffusion_tts_tpu_torch.models import SemanticEncoder
    from edge_diffusion_tts_tpu_torch.training import Trainer, TrainState
    from edge_diffusion_tts_tpu_torch.training.state import trainable_parameters

    cfg = CFG(hidden=32, layers=1, heads=2, segment_secs=0.1, diff_steps=50, max_timestep=48,
              dropout=0.0, cfg_dropout=0.0, use_depthwise=True)
    torch.manual_seed(3)
    enc, dec = SemanticEncoder(cfg, HubertConfig.tiny()), EdgeDiffusionDecoder(cfg)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn(p.shape))
    rs = np.random.RandomState(4)
    batch = {"wav": (0.1 * rs.randn(2, cfg.segment_len)).astype(np.float32),
             "t": np.array([5, 40]),
             "noise": rs.randn(2, cfg.segment_mel_frames, cfg.n_mels).astype(np.float32)}
    results = {}
    for device in ("cpu", cuda):
        trainer = Trainer(cfg, copy.deepcopy(enc), copy.deepcopy(dec),
                          DiffusionSchedule.create(cfg.diff_steps), device=device)
        state = TrainState(trainer.encoder, trainer.decoder, optimizer=None)
        state.train()
        loss, _ = trainer.make_diffusion_loss()(state, trainer.put_batch(batch), None)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double().cpu()
                 for n, p in trainable_parameters(trainer.encoder, trainer.decoder).items()}
        results[str(device)] = (loss.item(), grads)
    (l_cpu, g_cpu), (l_card, g_card) = results["cpu"], results["cuda"]
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
    for name, a in g_cpu.items():
        b = g_card[name]
        if a.norm() < 1e-12:
            assert b.norm() < 1e-9, name
            continue
        cos = ((a * b).sum() / (a.norm() * b.norm())).item()
        assert cos >= 0.99999, (name, cos)


@pytest.mark.parametrize("route", ["banded_attention", "decoder_gemm", "conv_frontend"])
def test_kernel_routes_refuse_autograd(cuda, frontend, route):
    """Under grad mode an input that requires a gradient is refused (the
    kernels have no backward); under torch.no_grad() the same call runs."""
    rng = np.random.RandomState(8)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)

    if route == "banded_attention":
        q, k, v = t(1, 2, 64, 16), t(1, 2, 64, 16), t(1, 2, 64, 16)
        call = lambda a: wa.banded_attention(a, k, v, 8)
    elif route == "decoder_gemm":
        a, w = t(8, 16), t(16, 16)
        q = a
        call = lambda x: fd.decoder_gemm(x, w)
    else:
        q = 0.2 * t(1, 8000)
        call = lambda x: ff.conv_frontend(x, frontend)
    x = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        call(x)
    with torch.no_grad():
        out = call(x)
    assert torch.isfinite(out).all() and out.grad_fn is None
    torch.testing.assert_close(out, call(q), atol=0, rtol=0)


def test_decoder_kernel_route_refuses_autograd(cuda):
    """The decoder's banded route (eval mode at the kernel's length) refuses
    a forward that autograd would follow; the same call under no_grad runs."""
    cfg = CFG(hidden=32, layers=1, heads=2, dropout=0.0)
    dec = EdgeDiffusionDecoder(cfg, use_kernel=True).to(cuda).eval()
    x, t = torch.randn(1, 64, cfg.n_mels, device=cuda), torch.tensor([10], device=cuda)
    sem = torch.zeros(1, 32, dtype=torch.long, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        dec(x, t, sem_idx=sem)
    with torch.no_grad():
        assert torch.isfinite(dec(x, t, sem_idx=sem)).all()


def _modules_features(encoder, wav):
    """The encoder's layer features with its conv stack on the modules."""
    with torch.no_grad():
        return encoder.extract_hubert(wav, conv_feats=encoder.hubert.feature_extractor(wav))


def test_trainer_kernel_route_encode_matches_modules(cuda):
    """The trainer's encode route for the hubert-base stack (the frontend
    kernel at [4, 32000], one launch) against the modules route: layer
    features atol 1e-3, FSQ tokens >= 99% equal (phase 7's bars)."""
    from edge_diffusion_tts_tpu_torch.training import Trainer, TrainState

    cfg = CFG(dropout=0.0)
    enc = _seeded_hubert_base_encoder(cfg, 7)
    trainer = Trainer(cfg, enc, EdgeDiffusionDecoder(cfg), DiffusionSchedule.create(1000),
                      device=cuda)
    assert trainer.encoder.hubert.frontend_kernel
    state = TrainState(trainer.encoder, trainer.decoder, optimizer=None)
    rng = np.random.RandomState(9)
    wav = torch.from_numpy((0.2 * rng.randn(4, 32000)).astype(np.float32)).to(cuda)
    before = ff.conv_frontend.launches
    h_kernel = trainer.hubert_features(state, wav)
    assert ff.conv_frontend.launches == before + 1
    with torch.no_grad():
        h_modules = _modules_features(state.encoder, wav)
        tok_k = state.encoder.vq.encode(state.encoder._project(h_kernel))
        tok_m = state.encoder.vq.encode(state.encoder._project(h_modules))
    assert h_kernel.shape == (4, 99, 768)
    assert (h_kernel - h_modules).abs().max().item() <= 1e-3
    assert (tok_k == tok_m).float().mean().item() >= 0.99


def _perturbed(module, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.02 * torch.randn(p.shape))
    return module


def test_generate_sample_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """demo.generate_sample on the card against the CPU on the same noise:
    the mel it vocodes (DPM-Solver++, well conditioned; a small HuBERT with
    a 320-sample hop on the modules route, so no token sits on a
    kernel-vs-plain edge), 1e-4."""
    from scipy.io import wavfile

    from edge_diffusion_tts_tpu_torch import demo
    from edge_diffusion_tts_tpu_torch import inference as pinference
    from edge_diffusion_tts_tpu_torch.models import SemanticEncoder
    from edge_diffusion_tts_tpu_torch.weights import save_checkpoint

    cfg = CFG(hidden=32, layers=2, heads=2, dropout=0.0)
    dec = _perturbed(EdgeDiffusionDecoder(cfg), 3)
    enc = _perturbed(SemanticEncoder(cfg, HubertConfig.tiny320()), 4)
    save_checkpoint(str(tmp_path / "ck"), cfg, dec, enc)
    wav = str(tmp_path / "in.wav")
    wavfile.write(wav, 16000, (_chirp(16000) * 32767).astype(np.int16))
    def noise(sem, *a, **kw):
        B, S = sem.shape
        x = np.random.RandomState(5).randn(B, 2 * S, 80).astype(np.float32)
        return torch.from_numpy(x).to(sem.device)

    monkeypatch.setattr(pinference, "start_noise", noise)
    mels = {}

    def capture(cfg, mel_log, *a, **kw):
        mels[mel_log.device.type] = mel_log.cpu()
        return np.zeros((1, 160), np.float32)

    monkeypatch.setattr(demo, "vocode_mel", capture)
    for device in ("cpu", "cuda"):
        demo.generate_sample(str(tmp_path / "ck"), wav_path=wav, num_steps=4,
                             out_path=str(tmp_path / f"{device}.wav"), sampler="dpmpp",
                             device=device)
    assert mels["cuda"].shape == mels["cpu"].shape and mels["cpu"].shape[1] > 50
    torch.testing.assert_close(mels["cuda"], mels["cpu"], atol=1e-4, rtol=0)


def test_exported_program_on_the_card(cuda, tmp_path):
    """The .pt2 (utils/export.py) loaded on the card against the eager
    decoder on the card, at (1, 37, 19) and (2, 500, 250): atol 1e-5."""
    from edge_diffusion_tts_tpu_torch.utils.export import export_for_edge, load_exported

    cfg = CFG(hidden=32, layers=2, heads=2, dropout=0.0)
    dec = _perturbed(EdgeDiffusionDecoder(cfg), 6).eval()
    program = load_exported(export_for_edge(cfg, dec, str(tmp_path / "dec.pt2")), device=cuda)
    dec = dec.to(cuda)
    rng = np.random.RandomState(7)
    for B, T, S in ((1, 37, 19), (2, 500, 250)):
        x = torch.from_numpy(rng.randn(B, T, 80).astype(np.float32)).to(cuda)
        t = torch.from_numpy(rng.randint(0, 1000, B)).to(cuda)
        sem = torch.from_numpy(rng.randint(0, 2304, (B, S))).to(cuda)
        step = torch.from_numpy(rng.randint(0, 4, B)).to(cuda)
        with torch.no_grad():
            got = program(x, t, sem, step)
            want = dec(x, t, sem_idx=sem, step_idx=step)
        assert got.device.type == "cuda"
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def prep_pipe():
    """A long-form pipeline on the card with the hubert-base conv stack (the
    frontend kernel's route) under a 2-layer transformer, prep buckets of
    8/16 s; and a 6 s wav (the 8 s bucket)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from edge_diffusion_tts_tpu_torch.models import SemanticEncoder
    from edge_diffusion_tts_tpu_torch.pipeline import LongFormPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CFG(hidden=32, layers=1, heads=2, dropout=0.0)
    torch.manual_seed(12)
    enc = SemanticEncoder(cfg, HubertConfig(num_layers=2, hidden_size=64, num_heads=2,
                                            intermediate_size=128))
    pipe = LongFormPipeline(cfg, DiffusionSchedule.create(cfg.diff_steps),
                            EdgeDiffusionDecoder(cfg), enc, prep_buckets=(128000, 256000),
                            device="cuda")
    assert pipe.encoder.hubert.frontend_kernel
    wav = (0.2 * np.random.RandomState(13).randn(1, 96000)).astype(np.float32)
    return pipe, wav


def _default_stream_prep(pipe, wav, seed):
    """The prep's device work run inline on the default stream."""
    with torch.inference_mode():
        z, mean, std = pipe._prep(torch.from_numpy(wav).cuda(), pipe.num_chunks(wav.shape[1]),
                                  pipe.prep_buckets[0])
        out = [t.cpu().numpy() for t in (z, mean, std)]
    g = torch.Generator().manual_seed(seed)
    return out + [torch.randint(0, (1 << 63) - 1, (len(out[1]),), generator=g).numpy()]


def test_async_prep_on_the_card_equals_the_default_stream_prep(prep_pipe):
    """The side stream's prep (and ``stream_prep``, its fetch) equals the
    same work on the default stream bit for bit, at the 8 s bucket."""
    pipe, wav = prep_pipe
    got = pipe.stream_prep_async(wav, seed=3)()
    want = _default_stream_prep(pipe, wav, 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    for g, w in zip(pipe.stream_prep(wav, seed=3), want):
        np.testing.assert_array_equal(g, w)


def test_async_prep_launches_the_frontend_on_the_side_stream(prep_pipe, monkeypatch):
    pipe, wav = prep_pipe
    streams = []
    launch = ff.conv_frontend

    def recording(*a, **kw):
        streams.append(torch.cuda.current_stream())
        return launch(*a, **kw)

    recording.launches = 0  # the wrapper counts under the module's name
    monkeypatch.setattr(ff, "conv_frontend", recording)
    pipe.stream_prep_async(wav, seed=1)()
    assert recording.launches == 1
    assert streams == [pipe.prep_stream] and streams[0] != torch.cuda.default_stream()


def test_async_prep_dispatch_does_not_wait_for_the_card(prep_pipe):
    """Once warm, the dispatch makes no synchronizing CUDA call."""
    pipe, wav = prep_pipe
    want = pipe.stream_prep(wav, seed=2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        realize = pipe.stream_prep_async(wav, seed=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, w in zip(realize(), want):
        np.testing.assert_array_equal(g, w)


def test_async_prep_runs_beside_the_default_streams_queued_work(prep_pipe):
    """The side stream waits for the weights, not for what the caller's
    stream queued before the dispatch: the fetch returns while a kernel
    queued earlier on the default stream still spins.  The first dispatch
    makes new pinned blocks (``want``'s views hold the cached ones)."""
    pipe, wav = prep_pipe
    want = pipe.stream_prep(wav, seed=4)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # about a second on the default stream
    for _ in range(2):
        got = pipe.stream_prep_async(wav, seed=4)()
        assert not torch.cuda.default_stream().query(), "the prep waited for the default stream"
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    torch.cuda.synchronize()


def test_async_preps_from_four_threads_equal_each_alone(prep_pipe):
    """Four threads dispatch at once while the default stream is busy;
    each fetch equals that stream's prep alone."""
    import threading

    pipe, wav = prep_pipe
    wavs = [wav[:, :n] for n in (96000, 90000, 80000, 70000)]
    alone = [pipe.stream_prep(w, seed=i) for i, w in enumerate(wavs)]
    busy = torch.randn((4096, 4096), device="cuda")
    realizes = {}

    def submit(i):
        realizes[i] = pipe.stream_prep_async(wavs[i], seed=i)

    for _ in range(8):
        busy = busy @ busy / 64.0
    threads = [threading.Thread(target=submit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for i, w in enumerate(alone):
        for g, a in zip(realizes[i](), w):
            np.testing.assert_array_equal(g, a)
    assert torch.isfinite(busy).all()


# -- the conv frontend's bf16 variant (tensor cores) ---------------------------------------

BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def frontend_bf16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(11)
    fe = FeatureExtractor(HubertConfig()).to("cuda").eval()
    return ff.pack_frontend_weights(fe, BF16)


def _bf16_close(what, got, want):
    """Sums in another order than the plain version's flip a bf16 rounding
    now and then: normwise 1e-3, and at most 1e-4 of the elements farther
    than 2^-7 of their value (+1e-5) from it."""
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all(), what
    assert ((g - w).norm() / w.norm()).item() <= 1e-3, what
    over = ((g - w).abs() > 2.0 ** -7 * w.abs() + 1e-5).float().mean().item()
    assert over <= 1e-4, (what, over)


@pytest.mark.parametrize("layer", range(7))
@pytest.mark.parametrize("B,samples", FRONTEND_SHAPES)
def test_conv_frontend_bf16_layer_matches_plain(frontend_bf16, B, samples, layer):
    """Each bf16 layer alone in the plan's tile and split (bf16 in and out;
    conv0 takes the float32 wav, conv6 writes float32) on the bf16 plain
    chain's input for it."""
    w = frontend_bf16
    wav = _frontend_wav(B, samples)
    fold = ff.groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"])
    x = wav
    for i in range(layer):
        x = ff.conv_frontend_layer_plain(x, i, w, *(fold if i == 0 else ()), compute_dtype=BF16)
    extra = fold if layer == 0 else ()
    before = ff.conv_frontend_layer.bf16_launches, ff.conv_frontend_layer.launches
    got = ff.conv_frontend_layer(x, layer, w, *extra, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert (ff.conv_frontend_layer.bf16_launches, ff.conv_frontend_layer.launches) == (
        before[0] + 1, before[1])
    want = ff.conv_frontend_layer_plain(x, layer, w, *extra, compute_dtype=BF16)
    assert got.dtype == (torch.float32 if layer == 6 else BF16)
    _bf16_close(f"layer {layer} [{B},{samples}]", got, want)


@pytest.mark.parametrize("splits", [1, 3, 7, 16])
def test_conv_frontend_bf16_layer_any_split(frontend_bf16, splits):
    w = frontend_bf16
    rng = np.random.RandomState(splits)
    for layer, T in ((2, 801), (5, 300), (6, 300)):
        x = torch.from_numpy(rng.rand(2, T, 512).astype(np.float32)).to("cuda").to(BF16)
        got = ff.conv_frontend_layer(x, layer, w, splits=splits, compute_dtype=BF16)
        _bf16_close(f"layer {layer} splits {splits}", got,
                    ff.conv_frontend_layer_plain(x, layer, w, compute_dtype=BF16))


@pytest.mark.parametrize("B,samples", [(1, 80000), (3, 4321), (4, 32000)])
def test_conv_frontend_bf16_bits_twice_and_witness(frontend, frontend_bf16, B, samples):
    """Two bf16 calls give the same bits; the features are held by the
    witness rule against the float32 plain version, the bf16 plain version
    as the witness (rounding flips compound over six layers, so no
    elementwise bar holds), and within 1e-2 of the bf16 plain version."""
    wav = _frontend_wav(B, samples)
    before = ff.conv_frontend.bf16_launches, ff.conv_frontend.launches
    first = ff.conv_frontend(wav, frontend_bf16, compute_dtype=BF16)
    assert (ff.conv_frontend.bf16_launches, ff.conv_frontend.launches) == (before[0] + 1,
                                                                          before[1])
    assert first.dtype == torch.float32
    assert torch.equal(first, ff.conv_frontend(wav, frontend_bf16, compute_dtype=BF16))
    plain = ff.conv_frontend_plain(wav, frontend_bf16, compute_dtype=BF16)
    f32 = ff.conv_frontend_plain(wav, frontend)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    assert rel(first, f32) <= 1.5 * rel(plain, f32) + 1e-3, (rel(first, f32), rel(plain, f32))
    assert rel(first, plain) <= 1e-2


@pytest.mark.parametrize("B,samples", FRONTEND_SHAPES)
def test_conv_frontend_bf16_workspace_matches_the_plan(frontend_bf16, B, samples):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ff.frontend_plan(B, samples, sms=sms, dtype=BF16)
    lib = ff._lib()
    assert lib.edt_conv_frontend_bf16_workspace(B, samples, 512, ff._splits(plan)) == \
        4 * ff.frontend_workspace(B, plan, BF16)


def test_frontend_variants_refuse_each_others_weights(frontend, frontend_bf16):
    """The float32 entry points refuse bf16 weights and inputs, the bf16 ones
    float32 weights; the band kernel refuses float16 q, k, v (it takes
    float32 and bf16)."""
    wav = _frontend_wav(1, 8000)
    with pytest.raises(ValueError, match="float32"):
        ff.conv_frontend(wav, frontend_bf16)
    with pytest.raises(ValueError, match="bfloat16"):
        ff.conv_frontend(wav, frontend, compute_dtype=BF16)
    x = torch.zeros(1, 100, 512, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        ff.conv_frontend_layer(x.to(BF16), 1, frontend)
    with pytest.raises(ValueError, match="bfloat16"):
        ff.conv_frontend_layer(x, 1, frontend_bf16, compute_dtype=BF16)
    with pytest.raises(ValueError, match="splits"):
        ff.conv_frontend_layer(x.to(BF16), 1, frontend_bf16, splits=17, compute_dtype=BF16)
    q = torch.zeros(1, 2, 64, 16, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        wa.banded_attention(q, q, q, 8)


def test_trainer_bf16_kernel_route_witness(cuda):
    """A bf16 trainer's encode on the kernel route (the frontend's bf16
    variant, conv0 in float32) against its bf16 modules route (the wav cast
    to bf16 before conv0, as JAX's bf16 trainer), at [32, 32000] over six
    sets of random weights: per set, the layer features by the witness rule
    with the modules route as the witness and the float32 modules as the
    reference; over all sets together (19,008 tokens), the share of tokens
    equal to the float32 tokens within 0.02 of the modules route's.  The
    paired gap (kernel share minus modules share) of one set of 3,168 tokens
    ranged from -0.002 to +0.012 over these sets on an H100, and by +-0.03 at
    396 tokens, so the bar is held on the pooled share; each set's gap is
    printed."""
    from edge_diffusion_tts_tpu_torch.models import SemanticEncoder
    from edge_diffusion_tts_tpu_torch.training import Trainer, TrainState

    cfg = CFG(dropout=0.0)
    wav = torch.from_numpy((0.2 * np.random.RandomState(9).randn(32, 32000))
                           .astype(np.float32)).to(cuda)
    equal = torch.zeros(2, dtype=torch.float64)
    count = 0
    for seed in (0, 1, 2, 3, 7, 8):
        torch.manual_seed(seed)  # the default init the seeding adds to (the biases)
        enc32 = _seeded_hubert_base_encoder(cfg, seed)
        enc = SemanticEncoder(cfg, HubertConfig(), dtype=BF16)
        enc.load_state_dict(enc32.state_dict())
        trainer = Trainer(cfg, enc, EdgeDiffusionDecoder(cfg, dtype=BF16),
                          DiffusionSchedule.create(1000), device=cuda)
        hubert = trainer.encoder.hubert
        assert hubert.frontend_kernel and hubert.packed_frontend()["wk3"].dtype == BF16
        state = TrainState(trainer.encoder, trainer.decoder, optimizer=None)
        before = ff.conv_frontend.bf16_launches
        h_kernel = trainer.hubert_features(state, wav)
        assert ff.conv_frontend.bf16_launches == before + 1 and h_kernel.dtype == BF16
        enc32 = enc32.to(cuda).eval()
        with torch.no_grad():
            h_modules = _modules_features(state.encoder, wav)
            h32 = _modules_features(enc32, wav)
            tok = [e.vq.encode(e._project(h)) for e, h in (
                (state.encoder, h_kernel), (state.encoder, h_modules), (enc32, h32))]

        def rel(a):
            return ((a.float() - h32).norm() / h32.norm()).item()

        assert rel(h_kernel) <= 1.5 * rel(h_modules) + 1e-3, (seed, rel(h_kernel),
                                                              rel(h_modules))
        same = torch.stack([(t == tok[2]).double().sum().cpu() for t in tok[:2]])
        equal += same
        count += tok[2].numel()
        share = (same / tok[2].numel()).tolist()
        print(f"weights {seed}: token share equal to float32, kernel {share[0]:.4f}, modules "
              f"{share[1]:.4f}, paired gap {share[0] - share[1]:+.4f} ({tok[2].numel()} tokens); "
              f"features rel {rel(h_kernel):.5f} vs {rel(h_modules):.5f}")
        del enc32, enc, trainer, state
    share = (equal / count).tolist()
    print(f"pooled over {count} tokens: kernel {share[0]:.4f}, modules {share[1]:.4f}, "
          f"gap {share[0] - share[1]:+.4f}")
    assert share[0] >= share[1] - 0.02, share


def test_bf16_training_step_on_the_card_matches_the_cpu(cuda):
    """One bf16 diffusion loss and its gradients at tiny width on the card
    against the CPU, by the witness rule with the CPU's bf16 run as the
    witness and its float32 run as the reference: loss (1.5x + 1e-3),
    every gradient's cosine (- 0.01)."""
    import copy

    from edge_diffusion_tts_tpu_torch.models import SemanticEncoder
    from edge_diffusion_tts_tpu_torch.training import Trainer, TrainState
    from edge_diffusion_tts_tpu_torch.training.state import trainable_parameters

    cfg = CFG(hidden=32, layers=1, heads=2, segment_secs=0.1, diff_steps=50, max_timestep=48,
              dropout=0.0, cfg_dropout=0.0, use_depthwise=True)
    torch.manual_seed(3)
    enc, dec = SemanticEncoder(cfg, HubertConfig.tiny()), EdgeDiffusionDecoder(cfg)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn(p.shape))
    rs = np.random.RandomState(4)
    batch = {"wav": (0.1 * rs.randn(2, cfg.segment_len)).astype(np.float32),
             "t": np.array([5, 40]),
             "noise": rs.randn(2, cfg.segment_mel_frames, cfg.n_mels).astype(np.float32)}
    results = {}
    for device, dtype in (("cpu", torch.float32), ("cpu", BF16), (cuda, BF16)):
        e = SemanticEncoder(cfg, HubertConfig.tiny(), dtype=dtype)
        e.load_state_dict(enc.state_dict())
        d = EdgeDiffusionDecoder(cfg, dtype=dtype)
        d.load_state_dict(copy.deepcopy(dec.state_dict()))
        trainer = Trainer(cfg, e, d, DiffusionSchedule.create(cfg.diff_steps), device=device)
        state = TrainState(trainer.encoder, trainer.decoder, optimizer=None)
        state.train()
        loss, _ = trainer.make_diffusion_loss()(state, trainer.put_batch(batch), None)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double().cpu()
                 for n, p in trainable_parameters(trainer.encoder, trainer.decoder).items()}
        results[(str(device), dtype)] = (loss.item(), grads)
    (l32, g32), (lw, gw), (lc, gc) = (results[("cpu", torch.float32)], results[("cpu", BF16)],
                                      results[("cuda", BF16)])
    assert abs(lc - l32) / abs(l32) <= 1.5 * abs(lw - l32) / abs(l32) + 1e-3, (lc, lw, l32)

    def cos(a, b):
        return ((a * b).sum() / (a.norm() * b.norm())).item()

    for name, ref in g32.items():
        if ref.norm() < 1e-12 or gw[name].norm() < 1e-12:
            continue
        assert cos(gc[name], ref) >= cos(gw[name], ref) - 0.01, name


# -- the fused decoder step's and the band kernel's bf16 variants ---------------------------

# (variant, a's dtype, the output's dtype) the bf16 GEMM takes: a bf16 a has
# no norm (the norm reads float32 h); a residual sum is written in float32.
GEMM16_CASES = [(v, torch.float32, torch.float32) for v in GEMM_VARIANTS] + [
    (v, BF16, torch.float32) for v in ("plain", "bias_pos", "residual_aliased", "swiglu")] + [
    (v, torch.float32, BF16) for v in GEMM_VARIANTS if v != "residual_aliased"] + [
    (v, BF16, BF16) for v in ("plain", "bias_pos", "swiglu")]
# The bf16 variant's tiles (fd.gemm16_tiles()): gemm16_kernel's four, then the
# wgmma kernel's three.
GEMM16_NTILES = 7
# Shapes whose output the host's rule gives each tile on a 132-SM H100 from
# a float32 A, (rows, columns, kernel, warpgroups), and a ragged M with K =
# 88 (not a multiple of the products' 16: the staged rows are zero-padded);
# GEMM16_CASES's bf16 A and SwiGLU variants reach the other wgmma tiles
# (GEMM16_RULE_CASES).
GEMM16_TILE_SHAPES = {(4000, 160, 160): (64, 96, "wgmma", 4), (1000, 640, 160): (64, 64, "mma", 1),
                      (1000, 320, 160): (32, 64, "mma", 1), (500, 480, 160): (32, 32, "mma", 1),
                      (500, 160, 320): (16, 32, "mma", 1), (77, 80, 88): (16, 32, "mma", 1)}
# (M, N, A's dtype, SwiGLU) -> the host's tile.
GEMM16_RULE_CASES = [(500, 160, BF16, False, (64, 16, "wgmma", 1)),
                     (77, 80, BF16, False, (64, 16, "wgmma", 1)),
                     (4000, 160, BF16, False, (64, 96, "wgmma", 4)),
                     (4000, 320, torch.float32, True, (64, 160, "wgmma", 4)),
                     (4000, 80, torch.float32, False, (64, 96, "wgmma", 4))]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significand bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


def _gemm16_close(what, got, want, normed: bool):
    """Both sides take the same bf16 operands and sum their exact products
    in float32 in two orders: every element within 1e-5 + 1e-5 |want| (+
    one bf16 ulp of it for a bf16 output, which rounds its sum once).  A
    float32 A under a norm is normed in two summation orders before its
    rounding, and an element on a bf16 rounding edge rounds the other way,
    moving its whole output row by up to one operand ulp times the weights:
    then the result is held normwise (1e-3), at most 1% of the elements may
    leave that bar, and none by more than 4e-3."""
    d = (got.float() - want).abs()
    bar = 1e-5 + 1e-5 * want.abs() + (_bf16_ulp(want) if got.dtype == BF16 else 0.0)
    frac, worst = (d > bar).float().mean().item(), (d - bar).max().item()
    if not normed:
        assert frac == 0.0, f"{what}: {frac:.2e} over the bar, worst {worst:.3g}"
        return
    want_out = want.to(got.dtype).double()  # a bf16 output against the sum rounded once
    rel = ((got.double() - want_out).norm() / want_out.norm()).item()
    assert rel <= 1e-3 and frac <= 1e-2 and worst <= 4e-3, (
        f"{what}: rel {rel:.3g}, {frac:.2e} over the bar, worst {worst:.3g}")


def _gemm16_close_rows(what, got, want, normed: bool):
    """``_gemm16_close`` with its share of elements past the bar counted in
    rows, for a normed product at any M: a bf16 rounding flip of one A
    element moves its whole row (1/37 of the output at M = 37), so at most
    1% of the rows, or one, may leave the elementwise bar; the normwise bar
    and the 4e-3 ceiling stay."""
    if not normed:
        _gemm16_close(what, got, want, normed)
        return
    d = (got.float() - want).abs()
    bar = 1e-5 + 1e-5 * want.abs() + (_bf16_ulp(want) if got.dtype == BF16 else 0.0)
    rows = (d > bar).reshape(-1, d.shape[-1]).any(-1)
    want_out = want.to(got.dtype).double()
    rel = ((got.double() - want_out).norm() / want_out.norm()).item()
    worst = (d - bar).max().item()
    assert rel <= 1e-3 and rows.sum().item() <= max(1, rows.numel() // 100) and worst <= 4e-3, (
        f"{what}: rel {rel:.3g}, {rows.sum().item()} of {rows.numel()} rows over the bar, "
        f"worst {worst:.3g}")


def _check_gemm16(variant, a_dtype, out_dtype, M, N, K, device, tile=None, close=_gemm16_close):
    """One bf16 GEMM launch (in the host's tile, or ``tile``) against
    ``decoder_gemm_plain`` at bf16 compute on the same operands (``close``:
    ``_gemm16_close``), counted once, and the same bits twice."""
    a, w, kw = _gemm_case(variant, M, N, K, device, seed=M * 7 + N * 3 + K)
    a, w = a.to(a_dtype), w.to(BF16)
    want = fd.decoder_gemm_plain(a, w, compute_dtype=BF16, **kw)
    again = fd.decoder_gemm(a, w, compute_dtype=BF16, out_dtype=out_dtype, tile=tile, **kw)
    if variant == "residual_aliased":
        kw["out"] = kw["residual"]  # updated in place, as the decoder step does
    before = fd.decoder_gemm.launches
    got = fd.decoder_gemm(a, w, compute_dtype=BF16, out_dtype=out_dtype, tile=tile, **kw)
    torch.cuda.synchronize()
    assert fd.decoder_gemm.launches == before + 1
    assert got.shape == (M, N) and got.dtype == out_dtype
    close(f"{variant} {a_dtype} -> {out_dtype} [{M},{N},{K}] tile {tile}", got, want, "norm" in kw)
    assert torch.equal(got, again)  # the same bits twice (and in place)


@pytest.mark.parametrize("M,N,K", list(GEMM16_TILE_SHAPES))
@pytest.mark.parametrize("variant,a_dtype,out_dtype", GEMM16_CASES)
def test_decoder_gemm_bf16_matches_plain(cuda, variant, a_dtype, out_dtype, M, N, K):
    """The bf16 GEMM (tensor cores) in each prologue and epilogue variant,
    float32 or bf16 A and C, in every tile the host's rule picks, against
    ``decoder_gemm_plain`` at bf16 compute on the same operands."""
    _check_gemm16(variant, a_dtype, out_dtype, M, N, K, cuda)


def test_decoder_gemm_bf16_tiles(cuda):
    """The host's rule reaches each tile of GEMM16_TILE_SHAPES and
    GEMM16_RULE_CASES (on the 132-SM H100), so every tile of the list,
    which the tests also force by index."""
    tiles = fd.gemm16_tiles()
    assert [t[2] for t in tiles] == ["mma"] * 4 + ["wgmma"] * (GEMM16_NTILES - 4)
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the tile table is the 132-SM H100's")
    assert {(M, N): tiles[fd.decoder_gemm16_tile(M, N)] for M, N, _ in GEMM16_TILE_SHAPES} == {
        (M, N): tile for (M, N, _), tile in GEMM16_TILE_SHAPES.items()}
    assert {(M, N): fd.decoder_gemm_tile(M, N, BF16) for M, N, _ in GEMM16_TILE_SHAPES} == {
        (M, N): tile[:2] for (M, N, _), tile in GEMM16_TILE_SHAPES.items()}
    for M, N, a_dtype, swiglu, tile in GEMM16_RULE_CASES:
        assert tiles[fd.decoder_gemm16_tile(M, N, "host", a_dtype, swiglu)] == tile, (M, N)
    reached = {tiles[fd.decoder_gemm16_tile(M, N)] for M, N, _ in GEMM16_TILE_SHAPES}
    assert reached | {case[-1] for case in GEMM16_RULE_CASES} == set(tiles)


# The step's shapes and ragged rows: M x N x K, and SwiGLU at 2 x 320.
GEMM16_GRID = [(M, N, K) for M in (37, 500, 4000) for N in (80, 160, 480)
               for K in (80, 160, 320)] + [(M, 320, 160) for M in (37, 500, 4000)]


@pytest.mark.parametrize("M,N,K", GEMM16_GRID)
def test_decoder_gemm_bf16_grid(cuda, M, N, K):
    """Every case of GEMM16_CASES (SwiGLU alone at N = 320) in the host's
    tile at the step's shapes, held by ``_gemm16_close_rows``."""
    for variant, a_dtype, out_dtype in GEMM16_CASES:
        if N != 320 or variant == "swiglu":
            _check_gemm16(variant, a_dtype, out_dtype, M, N, K, cuda, close=_gemm16_close_rows)


@pytest.mark.parametrize("tile", range(GEMM16_NTILES))
@pytest.mark.parametrize("M,N,K", [(500, 160, 160), (4000, 480, 160), (77, 80, 88),
                                   (37, 160, 160)])
def test_decoder_gemm_bf16_every_tile_index(cuda, tile, M, N, K):
    """Each tile of the list forced by index (gemm16_kernel's four, the wgmma
    kernel's three), every case of GEMM16_CASES: the sums do not depend on
    the tile's shape beyond the bar."""
    for variant, a_dtype, out_dtype in GEMM16_CASES:
        _check_gemm16(variant, a_dtype, out_dtype, M, N, K, cuda, tile=tile,
                      close=_gemm16_close_rows)


def test_decoder_gemm_bf16_rejects_what_it_cannot_take(cuda):
    a, w = torch.zeros(8, 12, device=cuda), torch.zeros(4, 12, device=cuda, dtype=BF16)
    with pytest.raises(ValueError, match="multiple of 8"):
        fd.decoder_gemm(a, w, compute_dtype=BF16)
    a, w = torch.zeros(8, 16, device=cuda), torch.zeros(4, 16, device=cuda, dtype=BF16)
    with pytest.raises(ValueError, match="bfloat16"):
        fd.decoder_gemm(a, w.float(), compute_dtype=BF16)
    with pytest.raises(ValueError, match="no norm"):
        fd.decoder_gemm(a.to(BF16), w, compute_dtype=BF16, norm="rms",
                        scale=torch.ones(16, device=cuda))
    with pytest.raises(ValueError, match="out_dtype"):
        fd.decoder_gemm(a, w.float(), out_dtype=BF16)
    with pytest.raises(ValueError, match="float16"):
        fd.decoder_gemm(a, w.half(), compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="tile"):
        fd.decoder_gemm(a, w.float(), tile=0)
    with pytest.raises(RuntimeError, match="CUDA error 1"):  # no such tile
        fd.decoder_gemm(a, w, compute_dtype=BF16, tile=GEMM16_NTILES)
    a, w = torch.zeros(8, 1024, device=cuda), torch.zeros(256, 1024, device=cuda, dtype=BF16)
    with pytest.raises(RuntimeError, match="CUDA error 1"):  # its shared memory does not fit
        fd.decoder_gemm(a, w, compute_dtype=BF16, swiglu=True, tile=4)
    # SwiGLU at K = 320 from a float32 A: the 64 x 160 wgmma tile does not fit
    # when forced; the host's pick, that tile at 4,000 rows, takes gemm16_kernel.
    a, w = torch.ones(4000, 320, device=cuda), torch.zeros(640, 320, device=cuda, dtype=BF16)
    assert fd.gemm16_tiles()[fd.decoder_gemm16_tile(4000, 320, swiglu=True)][2] == "wgmma"
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fd.decoder_gemm(a, w, compute_dtype=BF16, swiglu=True, tile=5)
    assert bool((fd.decoder_gemm(a, w, compute_dtype=BF16, swiglu=True) == 0).all())


def _bf16_band_close(what, got, want):
    """Both compute in float32 on the same bf16 inputs and round the output
    once: within the float32 kernel's bar (2e-5) plus one bf16 ulp of the
    larger of the two outputs."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    bar = 2e-5 + _bf16_ulp(torch.maximum(g.abs(), w.abs()))
    assert bool((d <= bar).all()), f"{what}: max err {d.max().item():.3g}, over by " \
        f"{(d - bar).max().item():.3g}"


def _band_inputs16(B, H, T, d, device):
    """The float32 inputs rounded to bf16.  A head dim that is not a
    multiple of 8 leaves contiguous bf16 rows off the 16-byte grid, so it
    comes as views of a buffer padded to a multiple of 8 (the kernel then
    reads the head's last 8 bytes alone)."""
    out = []
    for t in _band_inputs(B, H, T, d, device):
        buf = torch.zeros(B, H, T, -(-d // 8) * 8, device=device, dtype=BF16)
        buf[..., :d] = t
        out.append(buf[..., :d])
    return out


@pytest.mark.parametrize("B,H,T,d,window,seq_len", BAND_SHAPES)
def test_banded_kernel_bf16_matches_plain(cuda, B, H, T, d, window, seq_len):
    """bf16 q, k, v (windows 0 to 200, head dims 16 to 64, seq_len < T) in
    the plan's tile against the plain version on the same bf16 inputs."""
    q, k, v = _band_inputs16(B, H, T, d, cuda)
    before = wa.banded_attention.launches, wa.banded_attention.bf16_launches
    got = wa.banded_attention(q, k, v, window, seq_len=seq_len)
    torch.cuda.synchronize()
    assert (wa.banded_attention.launches, wa.banded_attention.bf16_launches) == (
        before[0], before[1] + 1)
    assert got.dtype == BF16
    _bf16_band_close(f"[{B},{H},{T},{d}] w={window}", got,
                     wa.banded_attention_plain(q, k, v, window, seq_len=seq_len))


@pytest.mark.parametrize("rows", wa.BAND_ROWS)
@pytest.mark.parametrize("B,H,T,d,window,seq_len", [BAND_SHAPES[i] for i in (1, 3, 5, 7, 10)])
def test_banded_kernel_bf16_every_tile(cuda, monkeypatch, rows, B, H, T, d, window, seq_len):
    monkeypatch.setattr(wa, "BAND_ROWS", (rows,))
    q, k, v = _band_inputs16(B, H, T, d, cuda)
    got = wa.banded_attention(q, k, v, window, seq_len=seq_len)
    _bf16_band_close(f"rows {rows}", got,
                     wa.banded_attention_plain(q, k, v, window, seq_len=seq_len))


@pytest.mark.parametrize("B,T,d", [(1, 4000, 40), (2, 500, 40), (1, 300, 16), (1, 256, 64)])
def test_banded_kernel_bf16_strided_views_bthd_output(cuda, B, T, d):
    """bf16 q, k, v as views of a [B, T, 3, H, d] buffer, o in [B, T, H, d]
    memory (a bf16 decoder's attention layer); two calls bit-equal."""
    H, w = 4, 64
    rng = np.random.RandomState(B * T + d)
    qkv = torch.from_numpy(rng.randn(B, T, 3, H, d).astype(np.float32)).to(cuda).to(BF16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    got = wa.banded_attention(q, k, v, w, out_layout="bthd")
    torch.cuda.synchronize()
    assert got.shape == (B, H, T, d) and got.transpose(1, 2).is_contiguous()
    _bf16_band_close("strided", got, wa.banded_attention_plain(q, k, v, w))
    assert torch.equal(got, wa.banded_attention(q, k, v, w, out_layout="bthd"))


@pytest.mark.parametrize("d", range(4, wa.MAX_HEAD_DIM + 1, 4))
@pytest.mark.parametrize("rows", wa.BAND_ROWS)
def test_band_geometry_of_the_library_is_the_plan_bf16(cuda, monkeypatch, rows, d):
    monkeypatch.setattr(wa, "BAND_ROWS", (rows,))
    plan = wa.band_plan(1, 4, 4000, d, 64, dtype=BF16)
    assert wa.band_geometry(rows, d, BF16) == {
        k: plan[k] for k in ("threads", "keys", "stages", "smem")}


def test_banded_kernel_bf16_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 1, 8, 44, device=cuda, dtype=BF16)[..., :40]  # rows 88 bytes apart
    with pytest.raises(ValueError, match="16-byte aligned"):
        wa.banded_attention(q, q, q, 2)
    q = torch.zeros(1, 1, 8, 20, device=cuda, dtype=BF16)  # contiguous rows 40 bytes apart
    with pytest.raises(ValueError, match="16-byte aligned"):
        wa.banded_attention(q, q, q, 2)
    q = torch.zeros(1, 1, 8, 16, device=cuda, dtype=BF16)
    with pytest.raises(ValueError, match="bfloat16"):
        wa.banded_attention(q, q.float(), q, 2)


def _rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _witness16(what, kernel, plain16, plain32, strict=False):
    """The witness rule: the bf16 kernel no farther (normwise) from the
    float32 plain version than 1.5 times the bf16 plain version is, + 1e-3.
    With ``strict`` (a well-conditioned path: v, DDPM) also two-sided: the
    kernel at least half as far from float32 as the bf16 plain version,
    and nearer the bf16 plain version than 0.8 times the bf16 plain
    version's distance from float32 (chip_smoke.py's ``witness16`` bars: a
    float32 step fails both; on the H100 these read 0.99-1.03 and
    0.48-0.60)."""
    e_k, e_p, e_kp = _rel(kernel, plain32), _rel(plain16, plain32), _rel(kernel, plain16)
    print(f"{what}: kernel {e_k:.4g} from float32, bf16 plain {e_p:.4g}, kernel vs bf16 "
          f"plain {e_kp:.4g}")
    assert e_k <= 1.5 * e_p + 1e-3, f"{what}: kernel {e_k:.3g}, bf16 plain {e_p:.3g}"
    if strict:
        assert e_k >= 0.5 * e_p, f"{what}: kernel {e_k:.3g} from float32, bf16 plain {e_p:.3g}"
        assert e_kp <= 0.8 * e_p, f"{what}: kernel {e_kp:.3g} from bf16 plain, its {e_p:.3g}"


def _loop16_args(cuda, dec, loop, B, S, T, steps):
    rng = np.random.RandomState(B * 100 + T)
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (B, S))).to(cuda)
    x_T = torch.from_numpy(rng.randn(B, T, 80).astype(np.float32)).to(cuda)
    if loop == "ddim":
        ts, coef = fd.ddim_coefficients(DiffusionSchedule.create(1000), steps)
        mods16 = li = fd.prepare_loop_inputs(dec, sem_idx, T, ts)
    else:
        ts, coef = list(range(steps - 1, -1, -1)), fd.ddpm_coefficients(
            DiffusionSchedule.create(steps))
        zeros = torch.zeros(steps, dtype=torch.long)
        li = fd.prepare_loop_inputs(dec, sem_idx, T, ts, step_idx=zeros)
        mods16 = fd.prepare_loop_inputs(dec, sem_idx, T, ts, step_idx=zeros, mods_dtype=BF16)
    a32 = (x_T, li["pos"], li["mods"], li["ckv"], coef.to(cuda), fd.pack_decoder_weights(dec))
    a16 = (x_T, li["pos"], mods16["mods"], li["ckv"].to(BF16), coef.to(cuda),
           fd.pack_decoder_weights(dec, BF16))
    return a32, a16


@pytest.mark.parametrize("prenet", [False, True])
@pytest.mark.parametrize("loop,prediction", [("ddim", "eps"), ("ddim", "v"), ("ddpm", "eps")])
def test_fused_loops_bf16_witness(cuda, loop, prediction, prenet):
    """The bf16 DDIM loop (4 steps, B=2, S=40) and 50-step DDPM loop
    (injected noise) on the card, with and without the pre-net, held by the
    witness rule against the float32 plain version with the bf16 plain
    version as the witness; one launch counted per call; two calls
    bit-equal."""
    cfg, dec = _prenet_decoder(cuda, 6, layers=2)
    if not prenet:
        cfg = CFG(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8)
        dec2 = EdgeDiffusionDecoder(cfg).to(cuda).eval()
        dec2.load_state_dict({k: v for k, v in dec.state_dict().items()
                              if not k.startswith("pre_conv")})
        dec = dec2
    steps = 4 if loop == "ddim" else 50
    a32, a16 = _loop16_args(cuda, dec, loop, 2, 40, 80, steps)
    kw = dict(heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction)
    run, plain = ((fd.fused_ddim, fd.fused_ddim_plain) if loop == "ddim"
                  else (fd.fused_ddpm, fd.fused_ddpm_plain))
    if loop == "ddpm":
        kw["noise"] = torch.from_numpy(np.random.RandomState(9).randn(2, 50, 80, 80)
                                       .astype(np.float32)).to(cuda)
    before = run.launches, run.bf16_launches
    got = run(*a16, compute_dtype=BF16, **kw)
    again = run(*a16, compute_dtype=BF16, **kw)
    torch.cuda.synchronize()
    assert (run.launches, run.bf16_launches) == (before[0], before[1] + 2)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    _witness16(f"{loop} {prediction} prenet={prenet}", got,
               plain(*a16, compute_dtype=BF16, **kw), plain(*a32, **kw),
               strict=prediction == "v" or loop == "ddpm")


def _attention_inputs(cuda, B, H, T, S, d, seed):
    """q, k, v [B, H, T or S, d] at bf16 for ``step_attention``: q at a
    quarter scale (the softmax near uniform), v alternating in sign over
    the keys, so that the output cancels and the probabilities' rounding
    shows above the output's own."""
    g = torch.Generator().manual_seed(seed)
    q = 0.25 * torch.randn(B, H, T, d, generator=g)
    k = torch.randn(B, H, S, d, generator=g)
    sign = (-1.0) ** torch.arange(S, dtype=torch.float32)[:, None]
    v = sign * (1.0 + 0.25 * torch.rand(B, H, S, d, generator=g))
    return (t.to(cuda).to(BF16) for t in (q, k, v))


STEP_ATTENTION_CASES = [(2, 2, 80, 80, 16, 8), (2, 2, 80, 40, 16, None), (1, 4, 500, 500, 40, 64),
                        (1, 4, 500, 250, 40, None), (2, 2, 200, 200, 64, 8)]


@pytest.mark.parametrize("B,H,T,S,d,window",
                         STEP_ATTENTION_CASES + [(16, 4, 1000, 500, 40, None)])
def test_step_attention_bf16_rounds_p_as_the_tpu_kernel(cuda, B, H, T, S, d, window):
    """The bf16 step's attention alone against ``_attention_rounded`` (P
    normalised, then rounded to bf16 before PV, the output rounded) and
    the float32 attention on the same bf16 values, two-sided: from float32
    between 0.45 and 1.25 times the plain version's distance, and within 2
    times that distance of the plain version.  The tensor-core kernel
    rounds the normalised P as the plain version does (on the H100: 1.00
    and 0-0.03; with P left in float32 the FMA kernel read 0.25-0.31)."""
    q, k, v = _attention_inputs(cuda, B, H, T, S, d, seed=T + S + d)
    mask = None
    if window is not None:
        i = torch.arange(T, device=cuda)
        mask = (i[:, None] - torch.arange(S, device=cuda)[None, :]).abs() <= window
    q32, k32, v32 = q.float(), k.float(), v.float()
    exact = fd._attention_rounded(q32, k32, v32, torch.float32, mask)
    plain = fd._attention_rounded(q32, k32, v32, BF16, mask).to(BF16)
    before = fd.step_attention.launches
    got = fd.step_attention(q, k, v, window, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert fd.step_attention.launches == before + 1 and got.dtype == BF16
    e_k, e_p, e_kp = _rel(got, exact), _rel(plain, exact), _rel(got, plain)
    print(f"step attention bf16 {B, H, T, S, d, window}: kernel {e_k:.4g} from float32, "
          f"plain {e_p:.4g}, kernel vs plain {e_kp:.4g}")
    assert 0.45 * e_p <= e_k <= 1.25 * e_p, (e_k, e_p)
    assert e_kp <= 2.0 * e_p, (e_kp, e_p)
    assert torch.equal(got, fd.step_attention(q, k, v, window, compute_dtype=BF16))


# Self- and cross-attention at heads of 40 and 32 (and 64), T and S not
# multiples of 16, B up to 8 (four warps a block), a cross-attention over
# more keys than a warp's registers hold (700: three passes in the key
# tile) and one over more than a block stages at once (1100: chunk by
# chunk); then the batched shapes the rule sends to the row tile: the bf16
# token cell's largest call (T = 1000, S = 500: the cross keys streamed
# through the ring), its band over 1000 keys, T not a multiple of 64, and
# a cross-attention past 512 keys.
STEP_ATTENTION16_CASES = [(1, 4, 500, 500, 40, 64), (1, 4, 500, 250, 40, None),
                          (2, 4, 77, 77, 40, 64), (2, 4, 77, 29, 40, None),
                          (1, 5, 133, 133, 32, 8), (1, 5, 133, 251, 32, None),
                          (8, 4, 500, 500, 40, 64), (8, 4, 500, 250, 40, None),
                          (1, 2, 130, 700, 40, None), (1, 2, 70, 1100, 64, None),
                          (2, 2, 45, 45, 24, 0),
                          (16, 4, 1000, 500, 40, None), (16, 4, 1000, 1000, 40, 64),
                          (32, 4, 201, 101, 40, None), (16, 4, 333, 333, 40, 64),
                          (8, 2, 300, 700, 40, None)]


@pytest.mark.parametrize("tile", [None, "keys", "rows"])
@pytest.mark.parametrize("B,H,T,S,d,window", STEP_ATTENTION16_CASES)
def test_step_attention16_matches_plain(cuda, B, H, T, S, d, window, tile):
    """The tensor-core step attention (csrc/attention16.cuh) against
    ``_attention_rounded`` at bf16 on the same bf16 q, k, v: the same
    roundings in the same order but for the float32 sums of S, the row sum
    and PV (their order flips an output's rounding, or a probability's on
    its rounding edge), so normwise within 0.1 of the plain version's
    distance from float32 (on the H100 0-0.035) and every element within
    4 bf16 ulps of the larger output plus 2^-8 of the largest |v| (what a
    probability's flip moves an output by: ulp(p) |v| <= 2^-8 |v| for p <
    1; these inputs cancel, so an output may sit near 0); counted per kind
    and per tile; the same bits twice.  In the host's tile (None) and in
    each tile forced."""
    q, k, v = _attention_inputs(cuda, B, H, T, S, d, seed=3 * T + S + d)
    mask = None
    if window is not None:
        i = torch.arange(T, device=cuda)
        mask = (i[:, None] - torch.arange(S, device=cuda)[None, :]).abs() <= window
    q32, k32, v32 = q.float(), k.float(), v.float()
    plain = fd._attention_rounded(q32, k32, v32, BF16, mask)
    exact = fd._attention_rounded(q32, k32, v32, torch.float32, mask)
    fd.zero_kernel_launches()
    got = fd.step_attention(q, k, v, window, compute_dtype=BF16, tile=tile)
    torch.cuda.synchronize()
    assert fd.kernel_launches("attention16") == 1
    ran = tile or fd.attention16_tile(B, H, T)
    assert fd.attention16_tile_launches() == {t: int(t == ran) for t in fd.ATTENTION16_TILES}
    plain = plain.to(BF16)  # the output rounded once, as the kernel rounds it
    g, p = got.float(), plain.float()
    bar = 4 * _bf16_ulp(torch.maximum(g.abs(), p.abs())) + v32.abs().amax() / 256
    assert bool(((g - p).abs() <= bar).all()), (g - p).abs().max().item()
    assert _rel(got, plain) <= 0.1 * _rel(plain, exact) + 1e-6
    assert torch.equal(got, fd.step_attention(q, k, v, window, compute_dtype=BF16, tile=tile))


def test_attention16_tile_rule_and_the_batched_loop(cuda):
    """The host's rule takes the key tile for the edge call (B = 1, T =
    500) and the row tile for the bf16 token cell's largest call (B = 64, T
    = 1000); a bf16 DDIM call at a batched shape launches all of its 2L x
    steps attentions in the row tile, one at B = 1 all in the key tile."""
    assert fd.attention16_tile(1, 4, 500) == "keys"
    assert fd.attention16_tile(64, 4, 1000) == "rows"
    cfg, dec = _prenet_decoder(cuda, 2, layers=4)
    S, steps = 300, 3
    w16 = fd.pack_decoder_weights(dec, BF16)
    coef = fd.ddim_coefficients(DiffusionSchedule.create(1000), steps)[1].to(cuda)
    for B, T, tile in ((64, 2 * S, "rows"), (1, 16, "keys")):
        sem_idx = torch.zeros(B, S, dtype=torch.long, device=cuda)
        li = fd.prepare_loop_inputs(dec, sem_idx, T, list(range(steps - 1, -1, -1)))
        assert fd.attention16_tile(B, cfg.heads, T) == tile
        fd.zero_kernel_launches()
        fd.fused_ddim(torch.zeros(B, T, 80, device=cuda), li["pos"], li["mods"],
                      li["ckv"].to(BF16), coef, w16, heads=cfg.heads,
                      window=cfg.attn_window_size, compute_dtype=BF16)
        torch.cuda.synchronize()
        want = steps * 2 * cfg.layers
        assert fd.kernel_launches("attention16") == want
        assert fd.attention16_tile_launches() == {t: want * (t == tile)
                                                  for t in fd.ATTENTION16_TILES}


def test_fused_loops_bf16_launch_the_tensor_core_kernels(cuda):
    """A bf16 DDIM call launches the tensor-core attention 2L times a step
    and its 2 + 6L GEMMs (one more with the pre-net) in gemm_wgmma_kernel
    or gemm16_kernel, as the tile rule picks; no float32 kernel."""
    cfg, dec = _prenet_decoder(cuda, 2, layers=4)
    B, S, T, steps = 1, 8, 16, 3
    sem_idx = torch.zeros(B, S, dtype=torch.long, device=cuda)
    x_T = torch.zeros(B, T, 80, device=cuda)
    li = fd.prepare_loop_inputs(dec, sem_idx, T, list(range(steps - 1, -1, -1)))
    coef = fd.ddim_coefficients(DiffusionSchedule.create(1000), steps)[1].to(cuda)
    fd.zero_kernel_launches()
    fd.fused_ddim(x_T, li["pos"], li["mods"], li["ckv"].to(BF16), coef,
                  fd.pack_decoder_weights(dec, BF16), heads=cfg.heads,
                  window=cfg.attn_window_size, compute_dtype=BF16)
    torch.cuda.synchronize()
    kinds = {k: fd.kernel_launches(k) for k in fd.KERNEL_KINDS}
    assert kinds["attention16"] == steps * 2 * cfg.layers
    assert kinds["gemm_wgmma"] + kinds["gemm16"] == steps * (3 + 6 * cfg.layers)


@pytest.mark.parametrize("B,H,T,S,d,window", STEP_ATTENTION_CASES)
def test_step_attention_float32_matches_plain(cuda, B, H, T, S, d, window):
    """The float32 step's attention alone against the plain attention: atol
    1e-5, rtol 1e-5; the hook refuses a bf16 tensor at float32 compute."""
    q, k, v = (t.float() for t in _attention_inputs(cuda, B, H, T, S, d, seed=T + S + d))
    mask = None
    if window is not None:
        i = torch.arange(T, device=cuda)
        mask = (i[:, None] - torch.arange(S, device=cuda)[None, :]).abs() <= window
    got = fd.step_attention(q, k, v, window)
    torch.cuda.synchronize()
    want = fd._attention_rounded(q, k, v, torch.float32, mask)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="k:"):
        fd.step_attention(q, k.to(BF16), v, window)


@pytest.mark.parametrize("loop", ["ddim", "ddpm"])
def test_fused_loops_bf16_launch_35_or_38_kernels_per_step(cuda, loop):
    """The bf16 step runs the float32 step's launches: 35 at 4 layers, 38
    with the pre-net."""
    cfg, dec = _prenet_decoder(cuda, 2, layers=4)
    B, S, T, steps = 1, 8, 16, 3
    sem_idx = torch.zeros(B, S, dtype=torch.long, device=cuda)
    x_T = torch.zeros(B, T, 80, device=cuda)
    ts = list(range(steps - 1, -1, -1))
    pre = fd.pack_decoder_weights(dec, BF16)
    plain = {k: v for k, v in pre.items() if k not in fd.PRENET_NAMES}
    li = fd.prepare_loop_inputs(dec, sem_idx, T, ts)
    coef = (fd.ddim_coefficients(DiffusionSchedule.create(1000), steps)[1] if loop == "ddim"
            else fd.ddpm_coefficients(DiffusionSchedule.create(steps))).to(cuda)
    run = fd.fused_ddim if loop == "ddim" else fd.fused_ddpm
    for w, per_step in ((pre, 38), (plain, 35)):
        before = fd.kernel_launches()
        run(x_T, li["pos"], li["mods"], li["ckv"].to(BF16), coef, w, heads=cfg.heads,
            window=cfg.attn_window_size, compute_dtype=BF16)
        torch.cuda.synchronize()
        assert fd.kernel_launches() - before == steps * per_step


@pytest.mark.parametrize("B,T", [(2, 41), (1, 500)])
def test_decoder_prenet_bf16_matches_plain(cuda, B, T):
    """The pre-net's kernels with the pointwise GEMM at bf16 against the
    plain version at bf16 (the same rounded operands; the GroupNorm's float32
    sums in two orders): atol 1e-4."""
    _, dec = _prenet_decoder(cuda, 5)
    w = fd.pack_decoder_weights(dec, BF16)
    h = torch.from_numpy(np.random.RandomState(T).randn(B, T, 32).astype(np.float32)).to(cuda)
    pos = dec.pos_emb.table[:T].contiguous()
    got = fd.decoder_prenet(h, pos, w, compute_dtype=BF16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fd.decoder_prenet_plain(h, pos, w, BF16), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="pc_pw"):
        fd.decoder_prenet(h, pos, w)  # bf16 weights, float32 compute


def test_fused_generate_mel_bf16_on_the_card_launches_the_bf16_kernel(cuda):
    """The entry point at bf16 on CUDA tensors launches the bf16 loop (no
    plain or float32 fallback), and refuses float16."""
    cfg, dec = _prenet_decoder(cuda, 3)
    sched = DiffusionSchedule.create(1000).to(cuda)
    sem_idx = torch.zeros(1, 10, dtype=torch.long, device=cuda)
    x_T = torch.randn(1, 20, 80, device=cuda)
    before = fd.fused_ddim.launches, fd.fused_ddim.bf16_launches
    mel = fd.fused_generate_mel(cfg, sched, dec, sem_idx, x_T, 4, compute_dtype=BF16)
    assert (fd.fused_ddim.launches, fd.fused_ddim.bf16_launches) == (before[0], before[1] + 1)
    assert mel.dtype == torch.float32 and torch.isfinite(mel).all()
    with pytest.raises(ValueError, match="float16"):
        fd.fused_generate_mel(cfg, sched, dec, sem_idx, x_T, 4, compute_dtype=torch.float16)


# -- the bf16 frontend's wgmma tiles (csrc/conv_wgmma.cuh) --------------------------------

WGMMA_TILES = [i for i, t in enumerate(ff.FRONTEND_BF16_TILES) if t["kernel"] == "wgmma"]


def _bf16_acts(B, T, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.rand(B, T, 512).astype(np.float32)).to("cuda").to(BF16)


@pytest.mark.parametrize("tile", WGMMA_TILES)
@pytest.mark.parametrize("Tin", [201, 1001, 1002])
@pytest.mark.parametrize("layer", range(1, 7))
def test_conv_frontend_bf16_wgmma_layer_odd_and_even(frontend_bf16, layer, Tin, tile):
    """Each of conv1-6 in each wgmma tile at odd and even input lengths, B=3
    (a stage's boxes end inside a batch row and at its end, where TMA fills
    zeros; at Tin 201 one tile per row), against the bf16 plain layer; one
    wgmma launch."""
    x = _bf16_acts(3, Tin, layer * Tin + tile)
    before = ff.wgmma_launches()
    got = ff.conv_frontend_layer(x, layer, frontend_bf16, compute_dtype=BF16, tile=tile)
    torch.cuda.synchronize()
    assert ff.wgmma_launches() == before + 1
    _bf16_close(f"layer {layer} Tin {Tin} tile {tile}", got,
                ff.conv_frontend_layer_plain(x, layer, frontend_bf16, compute_dtype=BF16))


@pytest.mark.parametrize("tile", range(len(ff.FRONTEND_BF16_TILES)))
@pytest.mark.parametrize("layer,T", [(1, 6399), (3, 799), (5, 199), (6, 99)])
def test_conv_frontend_bf16_every_tile_index(frontend_bf16, tile, layer, T):
    """Every tile of the rule's table forced by index, at the input lengths
    of [2, 32000]'s layers: against the bf16 plain layer."""
    x = _bf16_acts(2, T, T + tile)
    got = ff.conv_frontend_layer(x, layer, frontend_bf16, compute_dtype=BF16, tile=tile)
    _bf16_close(f"layer {layer} tile {tile}", got,
                ff.conv_frontend_layer_plain(x, layer, frontend_bf16, compute_dtype=BF16))


def test_conv_frontend_bf16_wgmma_bits_twice_and_witness(frontend, frontend_bf16):
    """Each wgmma tile twice on one input, bit-equal; the whole frontend at
    [16, 32000] (conv1-2 on wgmma) twice bit-equal, within 1e-2 of the bf16
    plain version and by the witness rule against the float32 one."""
    x = _bf16_acts(4, 3199, 1)
    for tile in WGMMA_TILES:
        first = ff.conv_frontend_layer(x, 2, frontend_bf16, compute_dtype=BF16, tile=tile)
        assert torch.equal(first, ff.conv_frontend_layer(x, 2, frontend_bf16, compute_dtype=BF16,
                                                         tile=tile)), tile
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ff.frontend_plan(16, 32000, sms=sms, dtype=BF16)
    assert plan[1]["tile_index"] in WGMMA_TILES and plan[2]["tile_index"] in WGMMA_TILES
    wav = _frontend_wav(16, 32000)
    before = ff.wgmma_launches()
    got = ff.conv_frontend(wav, frontend_bf16, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert ff.wgmma_launches() - before == sum(p.get("tile_index", 0) > 0 for p in plan)
    assert torch.equal(got, ff.conv_frontend(wav, frontend_bf16, compute_dtype=BF16))
    plain = ff.conv_frontend_plain(wav, frontend_bf16, compute_dtype=BF16)
    f32 = ff.conv_frontend_plain(wav, frontend)
    assert _rel(got, plain) <= 1e-2
    assert _rel(got, f32) <= 1.5 * _rel(plain, f32) + 1e-3, (_rel(got, f32), _rel(plain, f32))


def test_conv_frontend_bf16_rows_ending_on_different_frames(frontend, frontend_bf16):
    """A zero-padded batch of 8 whose rows end on different frames (odd and
    even true lengths; conv1-2 on wgmma), with ``wav_len``: the batch
    against the bf16 plain version (1e-2, the witness rule), and each row's
    frames inside its true length against an exact-length call (1e-2)."""
    lens = (32000, 31999, 24001, 20000, 16005, 12345, 8000, 4000)
    B, n = len(lens), lens[0]
    L = torch.as_tensor(lens, device="cuda")
    wav = _frontend_wav(B, n) * (torch.arange(n, device="cuda")[None] < L[:, None])
    got = ff.conv_frontend(wav, frontend_bf16, wav_len=L, compute_dtype=BF16)
    plain = ff.conv_frontend_plain(wav, frontend_bf16, L, compute_dtype=BF16)
    f32 = ff.conv_frontend_plain(wav, frontend, L)
    assert _rel(got, plain) <= 1e-2
    assert _rel(got, f32) <= 1.5 * _rel(plain, f32) + 1e-3, (_rel(got, f32), _rel(plain, f32))
    for i, m in enumerate(lens):
        exact = ff.conv_frontend(wav[i:i + 1, :m].contiguous(), frontend_bf16, compute_dtype=BF16)
        assert _rel(got[i:i + 1, :exact.shape[1]], exact) <= 1e-2, (i, m)


def test_frontend_geometry_of_the_library_is_the_plan(frontend_bf16):
    """The C tile constants (edt_frontend_geometry) equal the Python table
    the plan is built from, every plan's tiles are the library's, and the
    workspace the C side asks for is the plan's."""
    for i, t in enumerate(ff.FRONTEND_BF16_TILES):
        assert ff.frontend_geometry(i) == {k: t[k] for k in ("rows", "cols", "stages", "threads",
                                                             "smem")}, i
    assert ff.frontend_geometry(-1) == dict(rows=ff.CONV0_ROWS_BF16, channels=8,
                                            groups=ff.CONV0_GROUPS_BF16,
                                            threads=512 // 8 * ff.CONV0_GROUPS_BF16,
                                            blocks=ff.CONV0_BLOCKS_BF16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, samples in FRONTEND_SHAPES + [(256, 32000), (16, 32000)]:
        plan = ff.frontend_plan(B, samples, sms=sms, dtype=BF16)
        assert plan[0]["tile"][0] == ff.frontend_geometry(-1)["rows"]
        for p in plan[1:]:
            g = ff.frontend_geometry(p["tile_index"])
            assert p["tile"] == (g["rows"], g["cols"])
        assert ff._lib().edt_conv_frontend_bf16_workspace(B, samples, 512, ff._splits(plan)) == \
            4 * ff.frontend_workspace(B, plan, BF16)
    with pytest.raises(RuntimeError, match="edt_frontend_geometry"):
        ff.frontend_geometry(len(ff.FRONTEND_BF16_TILES))


def test_conv_frontend_bf16_tile_refusals(frontend_bf16):
    x = torch.zeros(1, 100, 512, device="cuda", dtype=BF16)
    with pytest.raises(ValueError, match="splits must be 1"):
        ff.conv_frontend_layer(x, 1, frontend_bf16, splits=2, compute_dtype=BF16, tile=1)
    with pytest.raises(ValueError, match="tile must be"):
        ff.conv_frontend_layer(x, 1, frontend_bf16, compute_dtype=BF16, tile=3)
    got = ff.conv_frontend_layer(x, 1, frontend_bf16, splits=1, compute_dtype=BF16, tile=2)
    assert bool((got == 0).all())  # gelu(0) = 0


# -- the bf16 band kernel on tensor cores (csrc/band16.cuh) -----------------------------


def _flat_band_inputs(B, H, T, d, device):
    """bf16 q, k, v where rounding P shows: q small (every weight near its
    row's max, none a power of two), V of magnitude 8 with alternating sign
    (an output much smaller than V, so is its ulp)."""
    rng = np.random.RandomState(T + d)
    q, k, v = (rng.randn(B, H, T, d).astype(np.float32) for _ in range(3))
    v = 8.0 * np.where(np.arange(T) % 2, -1.0, 1.0)[:, None] * (1 + 0.05 * v)
    return [torch.from_numpy(t.astype(np.float32)).to(device).to(BF16) for t in (0.1 * q, k, v)]


def _band_p_rounded(q, k, v, window):
    """The band's arithmetic in float32 with P rounded to bf16 before P V
    (the decoder step's attention16.cuh, not the band kernel)."""
    T, d = q.shape[-2:]
    i = torch.arange(T, device=q.device)
    mask = (i[None, :] - i[:, None]).abs() <= window
    s = ((q.float() @ k.float().transpose(-1, -2)) * d ** -0.5).masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return ((p.to(BF16).float() @ v.float()) / p.sum(-1, keepdim=True)).to(BF16)


@pytest.mark.parametrize("B,H,T,d,window", [(1, 2, 300, 40, 64), (1, 2, 256, 64, 100),
                                            (1, 4, 4000, 40, 64), (2, 2, 333, 20, 16)])
def test_banded_kernel_bf16_keeps_p_unrounded(cuda, B, H, T, d, window):
    """The opposite of ``test_step_attention_bf16_rounds_p_as_the_tpu_kernel``:
    on inputs where rounding P shows, the kernel keeps ``_bf16_band_close``'s
    bar against the plain version (P float32), and the P-rounded emulation
    breaks it."""
    q, k, v = _flat_band_inputs(B, H, T, d, cuda)
    if d % 8:
        q, k, v = (torch.nn.functional.pad(t, (0, 8 - d % 8))[..., :d] for t in (q, k, v))
    want = wa.banded_attention_plain(q, k, v, window)
    _bf16_band_close("kernel", wa.banded_attention(q, k, v, window), want)
    with pytest.raises(AssertionError):
        _bf16_band_close("P rounded", _band_p_rounded(q, k, v, window), want)
