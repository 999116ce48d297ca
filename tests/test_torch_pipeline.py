"""Port parity: the long-form pipeline (pipeline.py) against the JAX package,
and the conv-frontend fold with ``wav_len``.

A small decoder (hidden 32, 1 layer, diff_steps 50) with the same weights in
both packages; 0.5 s chunks with 0.125 s overlap (51 frames, 13 of overlap);
3 refine steps.  JAX draws its refine noise from keys inside its program;
the port is handed the same draws (``refine_chunk_batch(..., noise=)``).
Encoders: a fake one (features read off the wav, the same formula in both
packages), ``HubertConfig.tiny320()`` (the modules route) and the hubert-base
conv stack under a 2-layer, 64-wide transformer (the kernel route, whose
plain version runs here).  Tolerances: the refine and the stream's mel
1e-4; bucketed = exact encode 1e-5 at valid frames; chunk statistics
against JAX 1e-5 relative (plus 1e-5): a chunk's log-mel mean near -10 sums
bins whose power is ~1e-4 of the peak, where two float32 FFTs differ by
~1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models import SemanticEncoder as JEncoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.models.hubert import _FeatureExtractor
from edge_diffusion_tts_tpu.pipeline import ChunkStream as JChunkStream
from edge_diffusion_tts_tpu.pipeline import LongFormPipeline as JPipeline
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.models import HubertConfig as PHC
from edge_diffusion_tts_tpu_torch.models import SemanticEncoder as PEncoder
from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
from edge_diffusion_tts_tpu_torch.pipeline import ChunkStream, LongFormPipeline, fold_seed
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule as PSchedule
from edge_diffusion_tts_tpu_torch.utils.audio import denormalize_mel, normalize_mel
from edge_diffusion_tts_tpu_torch.weights import encoder_state_dict_from_jax, state_dict_from_jax

SMALL = dict(hidden=32, layers=1, heads=2, diff_steps=50, dropout=0.0)
GEOMETRY = dict(chunk_seconds=0.5, overlap_seconds=0.125)
HUBERT = dict(num_layers=2, hidden_size=64, num_heads=2, intermediate_size=128)
SR = 16000
BUCKETS = (int(0.8 * SR), int(1.6 * SR))


@jax.jit
def _jitter(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(
        treedef, [p + 0.02 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])


def _sine(secs, f=220.0):
    t = np.arange(int(secs * SR)) / SR
    return (0.2 * np.sin(2 * np.pi * f * t) + 0.05 * np.sin(2 * np.pi * 3.1 * f * t)).astype(
        np.float32)


def _fake_features(wav, xp):
    """1 latent of 128 features per 320 samples: the first 128 samples of each."""
    B = wav.shape[0]
    return xp.reshape(wav, (B, -1, 320))[:, :, :128] * 3.0


@pytest.fixture(scope="module")
def small():
    jcfg, pcfg = JCFG(**SMALL), PCFG(**SMALL)
    jdec = JDecoder(jcfg)
    # Initialised under jit: op by op it takes ~10 s on the CPU.
    init = jax.jit(lambda k: init_decoder_params(jdec, k, jcfg)["params"])
    params = _jitter(init(jax.random.PRNGKey(0)), 5)
    pdec = PDecoder(pcfg)
    pdec.load_state_dict(state_dict_from_jax(params, pcfg))
    dec_apply = lambda p, x, t, **kw: jdec.apply({"params": p}, x, t, **kw)  # noqa: E731
    jpipe = JPipeline(jcfg, JSchedule.create(50), dec_apply, params,
                      encoder_apply=lambda _, w: _fake_features(w, jnp), encoder_params={},
                      **GEOMETRY)
    ppipe = LongFormPipeline(pcfg, PSchedule.create(50), pdec, device="cpu",
                             encoder_apply=lambda w: _fake_features(w, torch), **GEOMETRY)
    return dict(jcfg=jcfg, pcfg=pcfg, jdec=jdec, dec_apply=dec_apply, params=params, pdec=pdec,
                jpipe=jpipe, ppipe=ppipe)


def _jax_draws(rng, T, M, steps):
    """The draws JAX's refine makes from one row's key: the initial q_sample
    noise, then one per step (pipeline.py:191-215)."""
    k_init, keys = jax.random.split(rng)
    out = [jax.random.normal(k_init, (T, M))]
    for _ in range(steps):
        keys, k = jax.random.split(keys)
        out.append(jax.random.normal(k, (T, M)))
    return np.stack([np.asarray(a) for a in out])


@pytest.mark.parametrize("have", [(False, False), (True, False)])
@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_refine_matches_jax_on_its_draws(small, cfg_scale, have):
    jpipe, ppipe = small["jpipe"], small["ppipe"]
    T, M, S, steps = jpipe.chunk_frames, 80, jpipe.chunk_samples // 320, 3
    kw = dict(strength=0.4, steps=steps, cfg_scale=cfg_scale)
    r = np.random.RandomState(int(cfg_scale) + 7)
    x = r.randn(2, T, M).astype(np.float32)
    z = r.randn(2, S, 128).astype(np.float32)
    known = r.randn(2, T, M).astype(np.float32)
    rngs = jax.random.split(jax.random.PRNGKey(10), 2)
    want = np.asarray(jpipe.refine_chunk_batch(x, z, known, jnp.asarray(have), rngs, **kw))
    noise = np.stack([_jax_draws(k, T, M, steps) for k in rngs])
    got = ppipe.refine_chunk_batch(x, z, known, have, noise, **kw).numpy()
    assert got.shape == want.shape == (2, T, M)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if have[0]:  # the known overlap is written back as it was
        np.testing.assert_array_equal(got[0, :ppipe.overlap_frames], known[0, :ppipe.overlap_frames])


def test_refine_rows_independent_of_the_batch(small):
    """Three rows (mixed inpainting flags) in one batch equal each alone: a
    row's noise comes from its own seed."""
    ppipe = small["ppipe"]
    T, M, S = ppipe.chunk_frames, 80, ppipe.chunk_samples // 320
    kw = dict(strength=0.4, steps=3, cfg_scale=2.0)
    r = np.random.RandomState(3)
    z = r.randn(3, S, 128).astype(np.float32)
    known = r.randn(3, T, M).astype(np.float32)
    have = np.asarray([True, False, True])
    seeds = np.asarray([11, 12, 13])
    batched = ppipe.refine_chunk_batch_seeds(seeds, z, known, have, **kw).numpy()
    for i in range(3):
        solo = ppipe.refine_chunk_batch_seeds(seeds[i:i + 1], z[i:i + 1], known[i:i + 1],
                                              have[i:i + 1], **kw).numpy()
        np.testing.assert_allclose(batched[i], solo[0], rtol=1e-5, atol=1e-6)
    # The seeded variant is the injected one fed the row's own draws.
    g = torch.Generator().manual_seed(12)
    draws = torch.randn((kw["steps"] + 2, T, M), generator=g)
    fed = ppipe.refine_chunk_batch(draws[:1], z[1:2], known[1:2], have[1:2], draws[None, 1:], **kw)
    np.testing.assert_array_equal(fed.numpy()[0], batched[1])
    # refine_chunk pads a short known overlap and draws from the seed alone.
    x = torch.randn((1, T, M), generator=g)
    a = ppipe.refine_chunk(x, z[:1], known[:1, :10], seed=5, **kw)
    np.testing.assert_array_equal(a[0, :10].numpy(), known[0, :10])
    assert torch.equal(a, ppipe.refine_chunk(x, z[:1], known[:1, :10], seed=5, **kw))


def test_stream_prep_matches_jax(small):
    jpipe, ppipe = small["jpipe"], small["ppipe"]
    wav = _sine(0.9)[None]
    z, mean, std, _, _ = jpipe.stream_prep(wav, jax.random.PRNGKey(5))
    pz, pmean, pstd, seeds = ppipe.stream_prep(wav, seed=5)
    n = ppipe.num_chunks(wav.shape[1])
    assert pmean.shape == pstd.shape == mean.shape == (n, 1, 80) and seeds.shape == (n,)
    np.testing.assert_allclose(pz, z, atol=1e-6, rtol=0)
    np.testing.assert_allclose(pmean, mean, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pstd, std, atol=1e-5, rtol=1e-5)
    # Seeds: one per chunk, drawn in order, the same for the same seed.
    again = ppipe.stream_prep(_sine(2.0)[None], seed=5)[3]
    np.testing.assert_array_equal(again[:n], seeds)
    assert not np.array_equal(ppipe.stream_prep(wav, seed=6)[3], seeds)


@pytest.fixture(scope="module")
def encoders(small):
    """JAX and port SemanticEncoders with the same weights: the hubert-base
    conv stack under a small transformer (the port's kernel route), and
    tiny320 (its modules route)."""
    jcfg, pcfg = small["jcfg"], small["pcfg"]
    out = {}
    for i, (name, jhc, phc) in enumerate((("base", JHC(**HUBERT), PHC(**HUBERT)),
                                          ("tiny320", JHC.tiny320(), PHC.tiny320()))):
        jenc = JEncoder(jcfg, jhc)
        evars = jax.jit(lambda k, e=jenc: e.init(
            {"params": k, "dropout": jax.random.PRNGKey(5), "vq": jax.random.PRNGKey(6)},
            jnp.zeros((1, 3200)), train=False))(jax.random.PRNGKey(4 + i))
        evars = dict(evars, params=_jitter(evars["params"], 12 + i))
        penc = PEncoder(pcfg, phc)
        penc.load_state_dict(encoder_state_dict_from_jax(evars))
        out[name] = (jenc, evars, penc)
    return out


def _pipes(small, encoders, name):
    jenc, evars, penc = encoders[name]

    def jmake(buckets):
        return JPipeline(small["jcfg"], JSchedule.create(50), small["dec_apply"], small["params"],
                         encoder_apply=lambda v, w, **kw: jenc.apply(v, w, train=False, **kw)[0],
                         encoder_params=evars, prep_buckets=buckets, **GEOMETRY)

    def pmake(buckets):
        return LongFormPipeline(small["pcfg"], PSchedule.create(50), small["pdec"], penc,
                                prep_buckets=buckets, device="cpu", **GEOMETRY)

    return jmake, pmake


@pytest.mark.parametrize("name,route", [("base", "kernel"), ("tiny320", "modules")])
def test_bucketed_prep_equals_exact_and_jax(small, encoders, name, route):
    jmake, pmake = _pipes(small, encoders, name)
    exact, bucketed = pmake(None), pmake(BUCKETS)
    assert (exact.encoder.hubert.frontend_kernel == bucketed.encoder.hubert.frontend_kernel
            == (route == "kernel"))
    jb = jmake(BUCKETS)
    for secs in (0.7, 1.3):
        wav = _sine(secs, 180.0 + 100 * secs)[None]
        z, mean, std, seeds = exact.stream_prep(wav, seed=7)
        zb, mean_b, std_b, seeds_b = bucketed.stream_prep(wav, seed=7)
        S = z.shape[1]
        assert zb.shape[1] > S  # the bucket's latents, zero past the stream's
        np.testing.assert_allclose(zb[:, :S], z, atol=1e-5, rtol=0)
        assert np.all(zb[:, S:] == 0.0)
        np.testing.assert_array_equal(seeds_b, seeds)
        np.testing.assert_allclose(mean_b, mean, atol=1e-6, rtol=0)
        np.testing.assert_allclose(std_b, std, atol=1e-6, rtol=0)
        # JAX's bucketed prep: the same features where the quantizer's
        # rounding agrees (a difference of summation order can move a value
        # that sits on an FSQ level's edge by one level), the same statistics.
        jz, jmean, jstd, _, _ = jb.stream_prep(wav, jax.random.PRNGKey(7))
        assert jz.shape == zb.shape
        close = np.isclose(zb, jz, atol=1e-5, rtol=0)
        assert close.mean() >= (1.0 if route == "modules" else 0.99), close.mean()
        np.testing.assert_allclose(mean_b, jmean, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(std_b, jstd, atol=1e-5, rtol=1e-5)


def test_bucketed_prep_oversize_warns_and_encodes_at_length(small, encoders):
    _, pmake = _pipes(small, encoders, "tiny320")
    wav = _sine(2.0)[None]
    with pytest.warns(UserWarning, match="exceeds the largest prep bucket"):
        zb, mean_b, _, seeds_b = pmake(BUCKETS).stream_prep(wav, seed=5)
    z, mean, _, seeds = pmake(None).stream_prep(wav, seed=5)
    np.testing.assert_array_equal(seeds_b, seeds)
    np.testing.assert_allclose(zb, z, atol=1e-6, rtol=0)
    np.testing.assert_allclose(mean_b, mean, atol=1e-6, rtol=0)


@pytest.mark.parametrize("wav_len", [6001, [8000, 5123]])
def test_fold_with_wav_len_matches_jax_feature_extractor(encoders, wav_len):
    """conv_frontend_plain (the kernel's plain version, GroupNorm folded
    analytically over the first (wav_len - 10) // 5 + 1 patches) against JAX's
    masked module stack on the same zero-padded wav."""
    jenc, evars, penc = encoders["base"]
    lens = np.broadcast_to(np.asarray(wav_len), (2,))
    wav = np.zeros((2, 8000), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = _sine(n / SR, 200.0 + 50 * i)[:n]
    fe_params = {"params": evars["params"]["hubert"]["feature_extractor"]}
    want = np.asarray(_FeatureExtractor(JHC(**HUBERT)).apply(
        fe_params, jnp.asarray(wav), wav_len=jnp.asarray(wav_len)))
    w = ff.pack_frontend_weights(penc.hubert.feature_extractor)
    got = ff.conv_frontend(torch.from_numpy(wav), w, wav_len=torch.as_tensor(wav_len)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # Without wav_len the statistics cover the padding and move.
    whole = ff.conv_frontend(torch.from_numpy(wav), w).numpy()
    assert np.abs(whole - want).max() > 1e-3


def test_chunk_stream_on_jax_draws_matches_jax_stream(small):
    """The port's ChunkStream driven step by step, each chunk refined on the
    draws JAX's stream makes for it, against JAX's own stream."""
    jpipe, ppipe = small["jpipe"], small["ppipe"]
    kw = dict(strength=0.4, steps=3, cfg_scale=2.0)
    wav = _sine(1.3, 260.0)
    jst = JChunkStream(jpipe, wav, rng=jax.random.PRNGKey(3), **kw)
    pst = ChunkStream(ppipe, wav, seed=3, **kw)
    T, M = jpipe.chunk_frames, 80
    assert pst.num_chunks == jst.num_chunks >= 3
    jsegs, psegs = [], []
    while not jst.done:
        k_noise, jz, jknown, jhave, k_ref = jst.next_job()
        _, pz, pknown, phave = pst.next_job()
        np.testing.assert_allclose(pz, jz, atol=1e-6, rtol=0)
        np.testing.assert_allclose(pknown, jknown, atol=1e-4, rtol=0)
        assert phave == jhave
        jx = np.asarray(jpipe.refine_chunk_batch_keys(k_noise[None], jz, jknown,
                                                      np.asarray([jhave]), k_ref[None], **kw))
        coarse = np.asarray(jax.random.normal(jnp.asarray(k_noise), (T, M)))[None]
        px = ppipe.refine_chunk_batch(coarse, pz, pknown, [phave],
                                      _jax_draws(jnp.asarray(k_ref), T, M, kw["steps"])[None], **kw)
        np.testing.assert_allclose(px.numpy(), jx, atol=1e-4, rtol=0)
        jsegs += jst.complete(jx)
        psegs += pst.complete(px.numpy())
    assert [o for _, o in psegs] == [o for _, o in jsegs]
    for (p, _), (j, _) in zip(psegs, jsegs):
        np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-4 * np.abs(j).max())
    assert pst.done
    with pytest.raises(RuntimeError, match="exhausted"):
        pst.next_job()


def test_streaming_matches_offline(small):
    ppipe = small["ppipe"]
    wav = _sine(1.2, 300.0)
    kw = dict(steps=2, strength=0.3, cfg_scale=1.0)
    offline, audio = ppipe.generate(wav, vocode=True, seed=3, griffin_lim_iters=4, **kw)
    chunks = list(ppipe.generate_streaming(wav, seed=3, **kw))
    assert len(chunks) >= 2 and chunks[0][1] == 0
    assert all(b > a for a, b in zip([o for _, o in chunks], [o for _, o in chunks[1:]]))
    np.testing.assert_allclose(np.concatenate([s for s, _ in chunks], axis=1), offline, atol=1e-5)
    assert offline.shape == (80, wav.size // 160 + 1) and np.isfinite(offline).all()
    assert audio.shape[0] <= wav.size and np.isfinite(audio).all()
    # Streaming audio: contiguous increments that cover the input, finite.
    inc = list(ppipe.generate_streaming_audio(wav, seed=3, griffin_lim_iters=4, **kw))
    offs = [o for _, o in inc]
    assert offs[0] == 0 and all(o2 == o1 + len(a) for (a, o1), o2 in zip(inc, offs[1:]))
    assert sum(len(a) for a, _ in inc) == (wav.size // 160) * 160
    assert all(np.isfinite(a).all() for a, _ in inc)
    # The vocoder's start phase follows the seed.
    mel = offline[:, :40]
    np.testing.assert_array_equal(ppipe.vocode(mel, 9, n_iter=2), ppipe.vocode(mel, 9, n_iter=2))
    assert np.abs(ppipe.vocode(mel, 9, n_iter=2) - ppipe.vocode(mel, 10, n_iter=2)).max() > 0
    assert fold_seed(3, 1) != fold_seed(3, 1, 0) and fold_seed(3, 1) == fold_seed(3, 1)


def test_streaming_overlap_add_oracle(small, monkeypatch):
    """The chunk assembly (slicing, crossfade, overlap-add, finalization,
    renormalization) against an independent numpy oracle, the model patched
    out by a deterministic stand-in."""
    ppipe, cfg = small["ppipe"], small["pcfg"]
    wav = _sine(1.1, 250.0)

    def fake_refine(seeds, z_chunk, known_mel, have, **kw):
        ramp = torch.linspace(-1.0, 1.0, np.shape(known_mel)[1])[None, :, None]
        return ramp.expand(np.shape(known_mel)) + 0.01 * float(np.sum(z_chunk))

    monkeypatch.setattr(ppipe, "refine_chunk_batch_seeds", fake_refine)
    streamed = np.concatenate([s for s, _ in ppipe.generate_streaming(wav, steps=1)], axis=1)

    w = wav.reshape(1, -1)
    total = w.shape[1]
    total_frames = total // cfg.hop_length + 1
    num_chunks = max(1, int(np.ceil((total - ppipe.overlap_samples) / ppipe.hop_samples)))
    assert num_chunks >= 3
    cf, fade = ppipe.chunk_frames, ppipe.overlap_frames
    window = np.ones((1, cf), np.float32)
    window[0, :fade] = np.linspace(0, 1, fade)
    window[0, -fade:] = np.linspace(1, 0, fade)
    z_global = ppipe.encode_global(w).numpy()
    per = ppipe.chunk_samples // 320
    acc = np.zeros((cfg.n_mels, total_frames + cf), np.float32)
    wsum = np.zeros((1, total_frames + cf), np.float32)
    for i in range(num_chunks):
        s0 = i * ppipe.hop_samples
        chunk = np.pad(w[:, s0:s0 + ppipe.chunk_samples],
                       ((0, 0), (0, max(0, ppipe.chunk_samples - (total - s0)))))
        z_chunk = z_global[:, s0 // 320:s0 // 320 + per]
        z_chunk = np.pad(z_chunk, ((0, 0), (0, per - z_chunk.shape[1]), (0, 0)))
        x_ref = fake_refine(None, z_chunk, np.zeros((1, cf, cfg.n_mels)), None)
        _, mean, std = normalize_mel(ppipe.mel_frontend(torch.from_numpy(chunk)))
        lin = torch.exp(denormalize_mel(x_ref, mean, std)).numpy()[0].T
        win = window.copy()
        if i == 0:
            win[0, :fade] = 1.0
        if i == num_chunks - 1:
            win[0, -fade:] = 1.0
        f0 = i * ppipe.hop_frames
        acc[:, f0:f0 + cf] += lin * win
        wsum[:, f0:f0 + cf] += win
    expected = acc[:, :total_frames] / np.clip(wsum[:, :total_frames], 1e-5, None)
    assert streamed.shape == expected.shape == (cfg.n_mels, total_frames)
    np.testing.assert_allclose(streamed, expected, rtol=1e-5, atol=1e-5)
    assert np.abs(streamed[:, 0]).max() > 0.0 and np.abs(streamed[:, -1]).max() > 0.0


def test_sem_stride_guard_and_errors(small):
    """An encoder whose latent rate disagrees with sem_stride fails loudly
    at the first job; no encoder, a mesh, or both encoder kinds raise."""
    ppipe = small["ppipe"]
    bad = LongFormPipeline(small["pcfg"], PSchedule.create(50), small["pdec"], device="cpu",
                           encoder_apply=lambda w: torch.zeros((1, w.shape[-1] // 20, 128)),
                           **GEOMETRY)
    wav = np.zeros((1, 8000), np.float32)
    with pytest.raises(ValueError, match="sem_stride"):
        ChunkStream(bad, wav, steps=2).next_job()
    ChunkStream(ppipe, wav, steps=2).next_job()
    none = LongFormPipeline(small["pcfg"], PSchedule.create(50), small["pdec"], device="cpu")
    with pytest.raises(ValueError, match="without an encoder"):
        none.stream_prep(wav)
    with pytest.raises(ValueError, match="list of devices"):
        LongFormPipeline(small["pcfg"], PSchedule.create(50), small["pdec"], device="cpu",
                         mesh=object())
    with pytest.raises(ValueError, match="not both"):
        LongFormPipeline(small["pcfg"], PSchedule.create(50), small["pdec"], device="cpu",
                         encoder=PEncoder(small["pcfg"], PHC.tiny320()), encoder_apply=len)
    assert ppipe.row_quantum == 1
    assert (ppipe.chunk_frames, ppipe.overlap_frames, ppipe.hop_frames) == (51, 13, 38)
    flagship = LongFormPipeline(small["pcfg"], PSchedule.create(50), small["pdec"], device="cpu")
    assert (flagship.chunk_frames, flagship.overlap_frames, flagship.hop_frames) == (201, 51, 150)
    assert flagship.chunk_samples // flagship.sem_stride == 100
