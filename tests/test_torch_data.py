"""The port's data pipeline against the JAX package's (both numpy code).

A synthetic corpus in the LJSpeech layout (22,050 Hz int16 wavs, so every
collate resamples) gives the same split, the same batches bit for bit for a
seed (with and without worker threads), the same precomputed-feature crops
and the same resampling; the native reader is held to scipy and to the
Python collate; a missing corpus raises.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.data import Collate as JCollate
from edge_diffusion_tts_tpu.data import CollatePrecomputed as JCollatePre
from edge_diffusion_tts_tpu.data import DataLoader as JLoader
from edge_diffusion_tts_tpu.data import LJSpeechDataset as JDataset
from edge_diffusion_tts_tpu.data import resample_np as j_resample
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.data import (
    Collate,
    CollatePrecomputed,
    DataLoader,
    LJSpeechDataset,
    LJSpeechPrecomputedDataset,
    NativeCollate,
    ensure_ljspeech,
    native_available,
    read_wav_native,
    resample_np,
)

N_UTT = 24


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lj") / "LJSpeech-1.1")
    os.makedirs(os.path.join(root, "wavs"))
    rng = np.random.RandomState(0)
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        for i in range(N_UTT):
            n = int(22050 * (0.08 + 0.15 * rng.rand()))
            t = np.arange(n) / 22050
            w = 0.4 * np.sin(2 * np.pi * (120 + 10 * i) * t) + 0.05 * rng.randn(n)
            wavfile.write(os.path.join(root, "wavs", f"LJ001-{i:04d}.wav"), 22050,
                          (np.clip(w, -1, 1) * 32767).astype(np.int16))
            f.write(f"LJ001-{i:04d}|text {i}|text {i}\n")
    return root


CFGKW = dict(segment_secs=0.1)


@pytest.mark.parametrize("split,kw", [("train", {}), ("val", {}), ("val", {"val_frac": 0.25}),
                                      ("train", {"max_samples": 9}), ("train", {"val_frac": 0.0})])
def test_split_matches_jax(corpus, split, kw):
    assert LJSpeechDataset(corpus, split, **kw).ids == JDataset(corpus, split, **kw).ids
    assert len(LJSpeechDataset(corpus, "val", val_frac=0.0)) == 0


# Several worker threads share one crop generator in either package, so their
# random crops follow the threads' interleaving: that case crops from 0.
@pytest.mark.parametrize("workers,shuffle,deterministic", [(0, True, False), (1, True, False),
                                                           (3, True, True), (1, False, True)])
def test_batches_bit_equal_to_jax(corpus, workers, shuffle, deterministic):
    pcfg, jcfg = PCFG(**CFGKW), JCFG(**CFGKW)
    port = DataLoader(LJSpeechDataset(corpus, "train"), 4,
                      Collate(pcfg, deterministic=deterministic, seed=5), shuffle=shuffle,
                      seed=7, workers=workers)
    ref = JLoader(JDataset(corpus, "train"), 4,
                  JCollate(jcfg, deterministic=deterministic, seed=5), shuffle=shuffle, seed=7,
                  workers=workers)
    assert len(port) == len(ref) == (N_UTT - 1) // 4
    for _ in range(2):  # two epochs: a fresh order each
        got, want = list(port), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert set(a) == set(b) == {"wav"}
            assert a["wav"].dtype == np.float32 and a["wav"].shape == (4, pcfg.segment_len)
            np.testing.assert_array_equal(a["wav"], b["wav"])


def test_pinned_batches_keep_values(corpus):
    """pin_memory hands tensors (pinned and copied on a CUDA device; made on
    the CPU here) with the unpinned loader's values."""
    cfg = PCFG(**CFGKW)
    plain = DataLoader(LJSpeechDataset(corpus, "train"), 4, Collate(cfg, seed=1), seed=2)
    pinned = DataLoader(LJSpeechDataset(corpus, "train"), 4, Collate(cfg, seed=1), seed=2,
                        pin_memory=True, device="cpu")
    for a, b in zip(plain, pinned):
        assert torch.is_tensor(b["wav"])
        np.testing.assert_array_equal(a["wav"], b["wav"].numpy())


def test_abandoned_iteration_releases_the_producer(corpus):
    cfg = PCFG(**CFGKW)
    loader = DataLoader(LJSpeechDataset(corpus, "train"), 2, Collate(cfg), prefetch=1)
    for _ in range(3):
        it = iter(loader)
        next(it)
        it.close()  # the consumer breaks out; the producer must stop


def test_collate_precomputed_matches_jax():
    pcfg, jcfg = PCFG(segment_secs=0.2), JCFG(segment_secs=0.2)
    rng = np.random.RandomState(3)
    items = []
    for n in (2000, 3200, 6400, 9000):
        frames = max((n - 400) // 320 + 1, 1)
        items.append((rng.randn(n).astype(np.float32),
                      rng.randn(frames, 16).astype(np.float32)))
    for deterministic in (False, True):
        got = CollatePrecomputed(pcfg, deterministic=deterministic, seed=4)
        want = JCollatePre(jcfg, deterministic=deterministic, seed=4)
        for _ in range(3):
            a, b = got(items), want(items)
            assert set(a) == set(b) == {"wav", "hubert_features"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("orig,new,n", [(22050, 16000, 5000), (16000, 22050, 3001),
                                        (48000, 16000, 4800), (16000, 16000, 100)])
def test_resample_np_matches_jax(orig, new, n):
    wav = np.random.RandomState(n).randn(n).astype(np.float32)
    got, want = resample_np(wav, orig, new), j_resample(wav, orig, new)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_native_reader_matches_scipy_and_collate(corpus):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native ingest library cannot be built")
    assert native_available()
    ds = LJSpeechDataset(corpus, "train")
    for uid in ds.ids[:4]:
        path = os.path.join(corpus, "wavs", uid + ".wav")
        wav, sr = read_wav_native(path)
        sr_ref, data = wavfile.read(path)
        assert sr == sr_ref == 22050
        np.testing.assert_array_equal(wav, data.astype(np.float32) / 32768.0)
    cfg = PCFG(**CFGKW)
    paths = [os.path.join(corpus, "wavs", uid + ".wav") for uid in ds.ids[:5]]
    got = NativeCollate(cfg, deterministic=True)(paths)["wav"]
    want = Collate(cfg, deterministic=True)([ds[i] for i in range(5)])["wav"]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # The port builds its own copy of the library under build/, never in native/.
    from edge_diffusion_tts_tpu_torch.data import native

    assert os.path.join("build", "native") in native._LIB_PATH


def test_missing_corpus_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="LJSpeech not found"):
        ensure_ljspeech(str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="LJSpeech not found"):
        LJSpeechDataset(str(tmp_path / "nowhere"))
    os.makedirs(tmp_path / "lj" / "wavs")
    (tmp_path / "lj" / "metadata.csv").write_text("LJ1|a|a\n")
    with pytest.raises(FileNotFoundError, match="hubert_features"):
        LJSpeechPrecomputedDataset(str(tmp_path / "lj"))
