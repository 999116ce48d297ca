"""Port parity: the DSP modules (utils/audio.py, ops/mel.py, ops/resample.py,
ops/vocoder.py) against the JAX package on the same inputs.

Tolerances, each stated against the output's scale:
- framing, overlap-add and the filterbank: equal (no arithmetic, or the same
  float64 numpy);
- STFT power and the complex STFT: 1e-6 of their peak (two FFT libraries,
  float32);
- iSTFT: 1e-6 absolute on a waveform of peak 0.5;
- mel power: 1e-6 of its peak; log-mel: 2e-3 absolute, since the log
  magnifies a near-empty bin's float32 rounding (power 1e-4 of the peak
  carries a relative error ~1e-3);
- inverse mel scale: 1e-5 absolute at peak ~3 (JAX takes a float32 pinv of
  the filterbank, the port keeps one computed in float64; they differ by
  6e-7);
- resampling: 1e-6 absolute (one strided convolution each);
- Griffin-Lim from JAX's start phase, handed in: 2e-5 of the peak after 4
  and 8 iterations (every iteration renormalizes phases by norms of
  near-zero components); from a zero phase (``rand_init=False``) 1e-3 of the
  peak, because the first projection divides by those near-zero norms;
- normalize_mel: 1e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.ops import mel as jmel
from edge_diffusion_tts_tpu.utils import audio as jaudio
from edge_diffusion_tts_tpu_torch.ops import mel as pmel
from edge_diffusion_tts_tpu_torch.utils import audio as paudio

# The packages' ops/__init__ re-export functions under the module names.
jres = importlib.import_module("edge_diffusion_tts_tpu.ops.resample")
jvoc = importlib.import_module("edge_diffusion_tts_tpu.ops.vocoder")
pres = importlib.import_module("edge_diffusion_tts_tpu_torch.ops.resample")
pvoc = importlib.import_module("edge_diffusion_tts_tpu_torch.ops.vocoder")

# Odd lengths, and lengths between n_fft // 2 + 1 and n_fft.
LENGTHS = [513, 700, 1023, 1601, 4001]


def _chirp(n, sr=16000, f0=100.0, f1=4000.0):
    t = np.arange(n) / sr
    return (0.5 * np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * t[-1])))).astype(
        np.float32)


def _both(wav):
    return jnp.asarray(wav), torch.from_numpy(np.ascontiguousarray(wav))


def test_hann_window():
    np.testing.assert_allclose(pmel.hann_window(1024).numpy(), np.asarray(jmel.hann_window(1024)),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("n", LENGTHS)
def test_frame_signal_equal(n):
    j, p = _both(_chirp(n)[None])
    want = np.asarray(jmel.frame_signal(j, 1024, 160))
    got = pmel.frame_signal(p, 1024, 160).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,n_fft,hop", [(5, 16, 4), (2, 8, 3), (9, 16, 5)])
def test_frame_signal_reflects_past_a_short_signal(n, n_fft, hop):
    """Reflect padding longer than the signal repeats the reflection, as
    numpy's (and the JAX package's) pad does."""
    j, p = _both(np.random.RandomState(n).randn(2, n).astype(np.float32))
    np.testing.assert_array_equal(pmel.frame_signal(p, n_fft, hop).numpy(),
                                  np.asarray(jmel.frame_signal(j, n_fft, hop)))


@pytest.mark.parametrize("T,W,hop", [(5, 1024, 160), (9, 16, 4), (3, 7, 3), (1, 10, 4)])
def test_overlap_add(T, W, hop):
    fr = np.random.RandomState(T * W).randn(2, T, W).astype(np.float32)
    j, p = _both(fr)
    np.testing.assert_allclose(pmel.overlap_add(p, hop).numpy(),
                               np.asarray(jmel.overlap_add(j, hop)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", LENGTHS)
def test_stft_and_istft(n):
    j, p = _both(_chirp(n)[None])
    want = np.asarray(jmel.stft_power(j))
    got = pmel.stft_power(p).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * want.max(), rtol=0)
    jre, jim = jmel.stft_complex(j)
    pre, pim = pmel.stft_complex(p)
    peak = float(np.abs(np.asarray(jre)).max())
    np.testing.assert_allclose(pre.numpy(), np.asarray(jre), atol=1e-6 * peak, rtol=0)
    np.testing.assert_allclose(pim.numpy(), np.asarray(jim), atol=1e-6 * peak, rtol=0)
    # The inverse, on the same spectrum, and its round trip.
    want_wav = np.asarray(jmel.istft(jnp.asarray(pre.numpy()), jnp.asarray(pim.numpy()),
                                     length=n))
    got_wav = pmel.istft(pre, pim, length=n).numpy()
    np.testing.assert_allclose(got_wav, want_wav, atol=1e-6, rtol=0)
    assert got_wav.shape == (1, (n // 160) * 160)  # (frames - 1) * hop samples
    np.testing.assert_allclose(got_wav, _chirp(n)[None, :got_wav.shape[1]], atol=1e-5, rtol=0)


def test_istft_keeps_the_edges_where_the_window_sum_fails():
    """hop > win_length leaves samples no window covers: torch.istft raises
    there (NOLA), the port divides by clip(win_sq, 1e-11) as JAX does."""
    rng = np.random.RandomState(3)
    re, im = rng.randn(1, 6, 33).astype(np.float32), rng.randn(1, 6, 33).astype(np.float32)
    want = np.asarray(jmel.istft(jnp.asarray(re), jnp.asarray(im), 64, 48, 32))
    got = pmel.istft(torch.from_numpy(re), torch.from_numpy(im), 64, 48, 32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_mel_filterbank_equal():
    for args in ((513, 0.0, 8000.0, 80, 16000), (257, 50.0, 7600.0, 40, 16000)):
        np.testing.assert_array_equal(pmel.mel_filterbank(*args), jmel.mel_filterbank(*args))
    np.testing.assert_array_equal(pmel.mel_filterbank(513, 0.0, 8000.0, 80, 16000, "slaney"),
                                  jmel.mel_filterbank(513, 0.0, 8000.0, 80, 16000, "slaney"))


@pytest.mark.parametrize("n", [4001, 16000])
def test_mel_frontend(n):
    wav = np.stack([_chirp(n), 0.1 * np.random.RandomState(n).randn(n).astype(np.float32)])
    j, p = _both(wav)
    jfront, pfront = jmel.MelFrontend(), pmel.MelFrontend()
    want = np.asarray(jfront.mel_power(j))
    np.testing.assert_allclose(pfront.mel_power(p).numpy(), want, atol=1e-6 * want.max(), rtol=0)
    np.testing.assert_allclose(pfront(p).numpy(), np.asarray(jfront(j)), atol=2e-3, rtol=0)


def test_inverse_mel_scale():
    front = pmel.MelFrontend()
    mel_power = np.abs(np.random.RandomState(2).randn(2, 20, 80)).astype(np.float32)
    want = np.asarray(jmel.inverse_mel_scale(jnp.asarray(mel_power),
                                             jnp.asarray(np.asarray(front.fbank))))
    got = pmel.inverse_mel_scale(torch.from_numpy(mel_power), front.fbank_pinv).numpy()
    assert got.shape == want.shape == (2, 20, 513)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got >= 0).all()


@pytest.mark.parametrize("n", [1000, 4411, 16001])
@pytest.mark.parametrize("orig,new", [(24000, 16000), (22050, 16000), (16000, 16000)])
def test_resample(orig, new, n):
    wav = np.stack([_chirp(n, sr=orig), _chirp(n, sr=orig, f0=300.0)])
    j, p = _both(wav)
    want = np.asarray(jres.resample(j, orig, new))
    got = pres.resample(p, orig, new).numpy()
    g = np.gcd(orig, new)
    assert got.shape == want.shape == (2, -(-(new // g) * n // (orig // g)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(pres.resample(p[0], orig, new).numpy(), want[0], atol=1e-6, rtol=0)
    kernel, width = pres._sinc_kernel(orig // g, new // g)
    jkernel, jwidth = jres._sinc_kernel(orig // g, new // g)
    assert width == jwidth
    np.testing.assert_array_equal(kernel, jkernel)


@pytest.mark.parametrize("n_iter", [4, 8])
def test_griffin_lim_from_jax_start_phase(n_iter):
    spec = np.array(jmel.stft_power(jnp.asarray(_chirp(4000)[None])))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jvoc.griffin_lim(jnp.asarray(spec), key, n_iter=n_iter, length=3900))
    # JAX's start phase, drawn as its griffin_lim draws it, handed to the port.
    angle = np.array(jax.random.uniform(key, spec.shape, minval=0.0, maxval=2 * jnp.pi))
    got = pvoc.griffin_lim(torch.from_numpy(spec), n_iter=n_iter, length=3900,
                           angle=torch.from_numpy(angle)).numpy()
    assert got.shape == want.shape == (1, 3900)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)
    zero_want = np.asarray(jvoc.griffin_lim(jnp.asarray(spec), key, n_iter=n_iter,
                                            rand_init=False))
    zero_got = pvoc.griffin_lim(torch.from_numpy(spec), n_iter=n_iter, rand_init=False).numpy()
    np.testing.assert_allclose(zero_got, zero_want, atol=1e-3 * np.abs(zero_want).max(), rtol=0)


def test_griffin_lim_seeded_start_phase():
    spec = torch.from_numpy(np.array(jmel.stft_power(jnp.asarray(_chirp(3000)[None]))))

    def run(seed):
        return pvoc.griffin_lim(spec, torch.Generator().manual_seed(seed), n_iter=2)

    assert torch.equal(run(1), run(1))
    assert (run(1) - run(2)).abs().max() > 1e-3


def test_normalize_mel():
    mel = np.random.RandomState(4).randn(2, 30, 80).astype(np.float32)
    mel[1, :, 5] = 0.25  # a constant bin: std clipped at eps
    want = jaudio.normalize_mel(jnp.asarray(mel))
    got = paudio.normalize_mel(torch.from_numpy(mel))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    back = paudio.denormalize_mel(*got)
    np.testing.assert_allclose(back.numpy(), mel, atol=1e-5, rtol=0)
