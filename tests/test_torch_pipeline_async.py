"""The long-form stream prep dispatched without waiting
(``LongFormPipeline.stream_prep_async``), its deferred fetch in
``ChunkStream`` and ``LongFormScheduler``, and the port's package surface,
on the CPU.

The pipelines are ``test_torch_pipeline``'s (a decoder of hidden 32, 0.5 s
chunks).  The async prep is held bit for bit to the prep computed inline,
step by step, as the synchronous prep computed it, on both encode routes
(the hubert-base conv stack, whose frontend takes its plain version here,
and ``tiny320``), bucketed and not; and to JAX's ``stream_prep_async`` on
the fake encoder: z atol 1e-6, chunk mean and std atol and rtol 1e-5 (the
tolerances of ``test_stream_prep_matches_jax``).
"""

import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import edge_diffusion_tts_tpu
import edge_diffusion_tts_tpu.models
import edge_diffusion_tts_tpu.ops
import edge_diffusion_tts_tpu_torch
import edge_diffusion_tts_tpu_torch.models
import edge_diffusion_tts_tpu_torch.ops
from edge_diffusion_tts_tpu.pipeline import LongFormPipeline as JPipeline
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu_torch.pipeline import ChunkStream, LongFormPipeline
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule as PSchedule
from edge_diffusion_tts_tpu_torch.serving import LongFormScheduler
from edge_diffusion_tts_tpu_torch.utils.audio import normalize_mel
from test_torch_pipeline import (  # noqa: F401  (module-scoped fixtures)
    BUCKETS,
    GEOMETRY,
    _fake_features,
    _pipes,
    _sine,
    encoders,
    small,
)

KW = dict(strength=0.4, steps=2, cfg_scale=2.0)


def _inline_prep(pipe, wav, seed):
    """The prep as the synchronous code computed it, step by step: the
    encode with an integer ``wav_len``, the chunks' statistics, the seeds."""
    wav_t = torch.tensor(np.asarray(wav, np.float32).reshape(1, -1))
    total = wav_t.shape[1]
    n = pipe.num_chunks(total)
    st = pipe.sem_stride
    enc_len = total + (st - total % st) % st
    pad_to = next((b for b in pipe.prep_buckets if b >= total), None) \
        if pipe.prep_buckets else None
    with torch.inference_mode():
        if pad_to is None:
            z = pipe.encode(F.pad(wav_t, (0, enc_len - total)))
        else:
            z = pipe.encode(F.pad(wav_t, (0, pad_to - total)), wav_len=enc_len)
        cs, hop = pipe.chunk_samples, pipe.hop_samples
        padded = F.pad(wav_t[0], (0, max(0, (n - 1) * hop + cs - total)))
        idx = (torch.arange(n) * hop)[:, None] + torch.arange(cs)[None, :]
        _, mean, std = normalize_mel(pipe.mel_frontend(padded[idx]))
    seeds = torch.randint(0, (1 << 63) - 1, (n,), generator=torch.Generator().manual_seed(seed),
                          dtype=torch.int64)
    return z.numpy(), mean.numpy(), std.numpy(), seeds.numpy()


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("name,route", [("base", "kernel"), ("tiny320", "modules")])
def test_async_prep_equals_the_synchronous_prep(small, encoders, name, route, bucketed):
    _, pmake = _pipes(small, encoders, name)
    pipe = pmake(BUCKETS if bucketed else None)
    assert pipe.encoder.hubert.frontend_kernel == (route == "kernel")
    assert pipe.prep_stream is None
    for secs in (0.7, 1.3):
        wav = _sine(secs, 150.0 + 90 * secs)[None]
        realize = pipe.stream_prep_async(wav, seed=4)
        got = realize()
        want = _inline_prep(pipe, wav, 4)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        for g, s in zip(realize(), pipe.stream_prep(wav, seed=4)):  # a second fetch too
            np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("bucketed", [False, True])
def test_async_prep_matches_jax_async_prep(small, bucketed):
    buckets = BUCKETS if bucketed else None
    jpipe = JPipeline(small["jcfg"], JSchedule.create(50), small["dec_apply"], small["params"],
                      encoder_apply=lambda _, w, **kw: _fake_features(w, jnp), encoder_params={},
                      prep_buckets=buckets, **GEOMETRY)
    ppipe = LongFormPipeline(small["pcfg"], PSchedule.create(50), small["pdec"], device="cpu",
                             encoder_apply=lambda w, **kw: _fake_features(w, torch),
                             prep_buckets=buckets, **GEOMETRY)
    wav = _sine(0.9, 240.0)[None]
    z, mean, std, _, _ = jpipe.stream_prep_async(wav, jax.random.PRNGKey(5))()
    pz, pmean, pstd, seeds = ppipe.stream_prep_async(wav, seed=5)()
    n = ppipe.num_chunks(wav.shape[1])
    assert pz.shape == z.shape and pmean.shape == pstd.shape == mean.shape == (n, 1, 80)
    assert seeds.shape == (n,)
    np.testing.assert_allclose(pz, z, atol=1e-6, rtol=0)
    np.testing.assert_allclose(pmean, mean, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pstd, std, atol=1e-5, rtol=1e-5)


def _counting(pipe, monkeypatch, gate=None, fail_seeds=()):
    """Wrap ``pipe.stream_prep_async``: each realize is counted, waits for
    ``gate`` when given, and raises for a seed in ``fail_seeds``."""
    calls = []
    dispatch = pipe.stream_prep_async

    def wrapped(wav, seed=0):
        realize = dispatch(wav, seed)

        def counted():
            calls.append(seed)
            if gate is not None:
                assert gate.wait(timeout=60)
            if seed in fail_seeds:
                raise RuntimeError(f"prep of stream {seed} failed")
            return realize()

        return counted

    monkeypatch.setattr(pipe, "stream_prep_async", wrapped)
    return calls


def test_chunk_stream_realizes_the_prep_once_at_its_first_job(small, monkeypatch):
    pipe = small["ppipe"]
    wav = _sine(1.1, 200.0)
    want = pipe.stream_prep(wav, seed=3)
    calls = _counting(pipe, monkeypatch)
    stream = ChunkStream(pipe, wav, seed=3, **KW)
    assert calls == [] and not hasattr(stream, "z_q_global")
    first = stream.next_job()
    assert calls == [3]
    assert stream.next_job()[0] == first[0]
    T, M = pipe.chunk_frames, pipe.cfg.n_mels
    stream.complete(np.zeros((1, T, M), np.float32))
    stream.next_job()
    assert calls == [3]
    np.testing.assert_array_equal(stream.z_q_global, want[0])
    np.testing.assert_array_equal(stream._seeds, want[3])
    # complete() fetches it too when it comes first.
    other = ChunkStream(pipe, wav, seed=4, **KW)
    other.complete(np.zeros((1, T, M), np.float32))
    assert calls == [3, 4] and other.i == 1


def test_bad_sem_stride_raises_at_the_first_job_not_at_construction(small):
    bad = LongFormPipeline(small["pcfg"], PSchedule.create(50), small["pdec"], device="cpu",
                           encoder_apply=lambda w: torch.zeros((1, w.shape[-1] // 20, 128)),
                           **GEOMETRY)
    stream = ChunkStream(bad, np.zeros((1, 8000), np.float32), steps=2)
    for _ in range(2):  # a caller that catches the error cannot go on
        with pytest.raises(ValueError, match="sem_stride"):
            stream.next_job()


def _drain(it, out, key):
    try:
        out[key] = list(it)
    except Exception as e:  # the stream's own error, read by the test
        out[key] = e


def test_scheduler_submit_does_not_wait_for_the_prep(small, monkeypatch):
    """Both submits return while every fetch is held back; the streams then
    complete and equal their solo generation."""
    pipe = small["ppipe"]
    gate = threading.Event()
    calls = _counting(pipe, monkeypatch, gate=gate)
    wavs = {1: _sine(1.1, 210.0), 2: _sine(0.8, 330.0)}
    sched = LongFormScheduler(pipe, max_streams=2)
    try:
        its = {k: sched.submit(w, seed=k, **KW) for k, w in wavs.items()}
        assert len(calls) <= 1  # the scheduler's first fetch, held at the gate
        out = {}
        threads = [threading.Thread(target=_drain, args=(it, out, k)) for k, it in its.items()]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sched.close()
    assert sorted(calls) == [1, 2]
    for k, w in wavs.items():
        solo = np.concatenate([s for s, _ in pipe.generate_streaming(w, seed=k, **KW)], 1)
        got = np.concatenate([s for s, _ in out[k]], 1)
        np.testing.assert_allclose(got, solo, rtol=1e-5, atol=1e-6)


def test_scheduler_fails_a_bad_prep_alone(small, monkeypatch):
    """A stream whose fetched prep raises ends with that error; a second
    stream of the same group, taken into the same tick, completes."""
    pipe = small["ppipe"]
    _counting(pipe, monkeypatch, fail_seeds=(1,))
    sched = LongFormScheduler(pipe, max_streams=2)
    # Hold the worker before it takes streams in, so both ride one tick.
    gate, absorb = threading.Event(), sched._absorb
    sched._absorb = lambda block: (gate.wait(timeout=60), absorb(block))
    time.sleep(0.1)  # past any take-in that began before the hold
    try:
        bad = sched.submit(_sine(1.1, 210.0), seed=1, **KW)
        good = sched.submit(_sine(0.8, 330.0), seed=2, **KW)
        out = {}
        threads = [threading.Thread(target=_drain, args=(it, out, k))
                   for k, it in (("bad", bad), ("good", good))]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert isinstance(out["bad"], RuntimeError) and "stream 1" in str(out["bad"])
        solo = np.concatenate([s for s, _ in pipe.generate_streaming(
            _sine(0.8, 330.0), seed=2, **KW)], 1)
        np.testing.assert_allclose(np.concatenate([s for s, _ in out["good"]], 1), solo,
                                   rtol=1e-5, atol=1e-6)
        assert sched.stats()["streams_active"] == 0
    finally:
        gate.set()
        sched.close()


# -- the package surface ---------------------------------------------------------

_RENAMED = {"get_device": "resolve_device"}
# (package, name, listed in __all__): every name of JAX's three __all__ lists,
# then the top-level names JAX resolves lazily without listing them.
SURFACE = [(pkg, name, True) for pkg, mod in (("", edge_diffusion_tts_tpu),
                                              ("ops", edge_diffusion_tts_tpu.ops),
                                              ("models", edge_diffusion_tts_tpu.models))
           for name in mod.__all__]
SURFACE += [("", name, False) for name in ("DPMSolverPP", "ddim_sample", "ddpm_sample", "FSQ",
                                           "FSQEncoder", "HubertEncoder", "serve_tcp",
                                           "request_tts", "train", "train_v2")]


@pytest.mark.parametrize("pkg,name,listed", SURFACE)
def test_every_jax_export_resolves_in_the_port(pkg, name, listed):
    port = {"": edge_diffusion_tts_tpu_torch, "ops": edge_diffusion_tts_tpu_torch.ops,
            "models": edge_diffusion_tts_tpu_torch.models}[pkg]
    name = _RENAMED.get(name, name)
    assert getattr(port, name) is not None
    assert not listed or name in port.__all__


def test_the_port_exports_are_its_own_objects():
    from edge_diffusion_tts_tpu_torch import inference, pipeline, training
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend
    from edge_diffusion_tts_tpu_torch.weights import hubert_state_dict_from_hf

    port = edge_diffusion_tts_tpu_torch
    assert port.EdgeInference is inference.EdgeInference
    assert port.LongFormPipeline is pipeline.LongFormPipeline
    assert port.ConsistencyTrainer is port.Trainer is training.Trainer
    assert port.ops.fused_conv_frontend is port.ops.conv_frontend is fused_frontend.conv_frontend
    assert port.models.load_hubert_params_from_torch is hubert_state_dict_from_hf
    with pytest.raises(AttributeError):
        port.get_device  # noqa: B018  (JAX's; the port's is resolve_device)


def test_importing_the_package_loads_neither_ops_nor_the_build():
    code = ("import sys, edge_diffusion_tts_tpu_torch as p; p.CFG; p.resolve_device; "
            "import edge_diffusion_tts_tpu_torch.ops; "
            "print(sorted(m for m in sys.modules if m.startswith('edge_diffusion_tts_tpu') "
            "or m == 'jax'))")
    mods = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True, timeout=120).stdout.strip()
    assert mods == str(["edge_diffusion_tts_tpu_torch", "edge_diffusion_tts_tpu_torch.config",
                        "edge_diffusion_tts_tpu_torch.ops"]), mods
