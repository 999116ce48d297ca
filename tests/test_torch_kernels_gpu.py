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


def test_trainer_kernel_route_encode_matches_modules(cuda):
    """The trainer's encode route for the hubert-base stack (the frontend
    kernel at [4, 32000], one launch) against the modules route: layer
    features atol 1e-3, FSQ tokens >= 99% equal (phase 7's bars)."""
    from edge_diffusion_tts_tpu_torch.training import Trainer, TrainState

    cfg = CFG(dropout=0.0)
    enc = _seeded_hubert_base_encoder(cfg, 7)
    trainer = Trainer(cfg, enc, EdgeDiffusionDecoder(cfg), DiffusionSchedule.create(1000),
                      device=cuda)
    assert trainer.encode_route == "kernel"
    state = TrainState(trainer.encoder, trainer.decoder, optimizer=None)
    rng = np.random.RandomState(9)
    wav = torch.from_numpy((0.2 * rng.randn(4, 32000)).astype(np.float32)).to(cuda)
    before = ff.conv_frontend.launches
    h_kernel = trainer.hubert_features(state, wav)
    assert ff.conv_frontend.launches == before + 1
    with torch.no_grad():
        h_modules = state.encoder.extract_hubert(wav)
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
    assert pipe.encode_route == "kernel"
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
