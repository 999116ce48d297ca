"""The port's serving path (serving.py): the micro-batcher, the long-form
scheduler, ``run_server`` from a port checkpoint, and the line-JSON protocol
against the JAX package's own clients and server.

The model is small (hidden 32, 2 layers, diff_steps 50) with a
``HubertConfig.tiny320()`` encoder, served on the CPU (``device="cpu"``).
Long-form streams use 0.5 s chunks with 0.125 s overlap and 2 refine steps.
A stream over TCP equals ``pipe.generate`` with the same seed to 1e-5 (the
same code on the same seeds, every refine at the server's 2 rows; the
scheduler's rows are computed apart).
"""

import base64
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu import serving as jserving
from edge_diffusion_tts_tpu_torch import _build, serving
from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, HubertConfig, SemanticEncoder
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
from edge_diffusion_tts_tpu_torch.serving import MicroBatcher, Overloaded, pick_bucket
from edge_diffusion_tts_tpu_torch.weights import load_checkpoint, save_checkpoint

SMALL = dict(hidden=32, layers=2, heads=2, diff_steps=50, dropout=0.0)
LF = dict(steps=2, strength=0.3, cfg_scale=2.0)


def _fake_generate(sem_idx, sem_mask):
    # Frames 2t and 2t+1 carry token t, so crops can be checked.
    B, S = sem_idx.shape
    mel = np.repeat(sem_idx.astype(np.float32), 2, axis=1)[..., None]
    return np.broadcast_to(mel, (B, 2 * S, 4)).copy()


def _sine(secs, f):
    t = np.arange(int(secs * 16000)) / 16000
    return (0.1 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _jittered(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    return module.eval()


# -- MicroBatcher ------------------------------------------------------------


def test_pick_bucket():
    assert [pick_bucket(n, (4, 8)) for n in (1, 4, 5, 8)] == [4, 4, 8, 8]
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        pick_bucket(9, (4, 8))


def test_micro_batcher_batches_and_crops():
    calls = []

    def gen(sem_idx, sem_mask):
        calls.append((sem_idx.shape, int(sem_mask.sum())))
        return _fake_generate(sem_idx, sem_mask)

    mb = MicroBatcher(gen, buckets=(4, 8), max_batch=4, max_wait_ms=100.0)
    try:
        toks = [np.arange(1, n + 1, dtype=np.int32) for n in (2, 3, 4)]
        outs = [t.wait(30.0) for t in [mb.submit(t) for t in toks]]
        for tk, out in zip(toks, outs):
            assert out.shape == (2 * tk.size, 4)
            np.testing.assert_array_equal(out[::2, 0], tk.astype(np.float32))
        assert mb.batches_run == 1 and calls == [((4, 4), 9)]
        s = mb.stats()
        assert s["requests_served"] == 3 and s["per_bucket"]["4"]["rows"] == 3
        with pytest.raises(ValueError, match="non-empty"):
            mb.submit(np.zeros((0,), np.int32))
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.arange(1, 3))


def test_micro_batcher_bucket_split_and_error():
    def gen(sem_idx, sem_mask):
        if sem_idx.shape[1] == 8:
            raise RuntimeError("boom")
        return _fake_generate(sem_idx, sem_mask)

    mb = MicroBatcher(gen, buckets=(4, 8), max_batch=4, max_wait_ms=100.0)
    try:
        ok = mb.submit(np.arange(1, 4, dtype=np.int32))
        bad = mb.submit(np.arange(1, 7, dtype=np.int32))
        assert ok.wait(30.0).shape == (6, 4)
        with pytest.raises(RuntimeError, match="boom"):
            bad.wait(30.0)
        with pytest.raises(ValueError):
            mb.submit(np.arange(100, dtype=np.int32))
    finally:
        mb.close()


def test_micro_batcher_slo_sheds_overload():
    def slow_gen(sem_idx, sem_mask):
        time.sleep(0.05)
        return _fake_generate(sem_idx, sem_mask)

    mb = MicroBatcher(slow_gen, buckets=(8,), max_batch=2, max_wait_ms=1.0,
                      max_queue_delay_ms=120.0)
    try:
        mb.generate(np.arange(1, 4, dtype=np.int32), timeout=30.0)  # the mean batch time
        tickets, shed = [], 0
        for _ in range(30):
            try:
                tickets.append(mb.submit(np.arange(1, 4, dtype=np.int32)))
            except Overloaded:
                shed += 1
        assert shed > 0 and tickets
        for t in tickets:
            t.wait(30.0)
        assert max(t.queue_delay_ms for t in tickets) < 400.0
        s = mb.stats()
        assert s["shed_count"] == shed and s["queue_delay_ms"]["max"] < 400.0
    finally:
        mb.close()


def test_micro_batcher_oldest_first_bucket_order():
    order = []

    def gen(sem_idx, sem_mask):
        order.append(sem_idx.shape[1])
        return _fake_generate(sem_idx, sem_mask)

    mb = MicroBatcher(gen, buckets=(4, 8), max_batch=2, max_wait_ms=200.0)
    try:
        big = mb.submit(np.arange(1, 7, dtype=np.int32))  # bucket 8, older
        time.sleep(0.02)
        small = mb.submit(np.arange(1, 3, dtype=np.int32))  # bucket 4, newer
        big.wait(30.0)
        small.wait(30.0)
        assert order == [8, 4]
    finally:
        mb.close()


def test_masked_batch_equals_each_row_alone():
    """The serving premise: at temperature 0 a masked, padded row equals its
    unpadded single-request generation (atol 1e-5)."""
    cfg = CFG(**SMALL)
    dec = _jittered(EdgeDiffusionDecoder(cfg), 1)
    engine = EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), dec, prediction="v",
                           device="cpu")
    lens, S = (5, 8, 3), 8
    rng = np.random.RandomState(0)
    toks = [rng.randint(0, 2304, n) for n in lens]
    sem_idx = np.zeros((3, S), np.int64)
    sem_mask = np.zeros((3, S), bool)
    for i, tk in enumerate(toks):
        sem_idx[i, :tk.size] = tk
        sem_mask[i, :tk.size] = True
    batched = engine.generate_mel(sem_idx, num_steps=2, temperature=0.0, sem_mask=sem_mask)
    for i, tk in enumerate(toks):
        single = engine.generate_mel(tk[None], num_steps=2, temperature=0.0)
        np.testing.assert_allclose(batched[i, :2 * tk.size].numpy(), single[0].numpy(),
                                   atol=1e-5, rtol=0)


# -- the server --------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """run_server from a port checkpoint: token path and long-form."""
    cfg = CFG(**SMALL)
    dec = _jittered(EdgeDiffusionDecoder(cfg), 2)
    enc = _jittered(SemanticEncoder(cfg, HubertConfig.tiny320()), 3)
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    save_checkpoint(ckpt, cfg, dec, enc)
    server, batcher = serving.run_server(
        ckpt, port=0, steps=2, buckets=(8, 16, 4096), max_batch=4, max_wait_ms=20.0,
        longform=True, longform_streams=2, chunk_seconds=0.5, overlap_seconds=0.125,
        longform_prep_buckets=(0.8, 1.6), device="cpu", verbose=False)
    yield ckpt, server, batcher, dec, enc
    server.shutdown()
    batcher.close()


def test_run_server_loads_a_port_checkpoint(served):
    ckpt, server, batcher, dec, enc = served
    assert sorted(os.listdir(ckpt)) == ["cfg.json", "decoder.pt", "encoder.pt", "hubert.json"]
    cfg, dstate, hc, estate = load_checkpoint(ckpt, with_encoder=True)
    assert cfg.hidden == 32 and hc == HubertConfig.tiny320()
    for k, v in dec.state_dict().items():
        assert torch.equal(dstate[k], v) and torch.equal(batcher.inference.decoder.state_dict()[k], v)
    assert all(torch.equal(estate[k], v) for k, v in enc.state_dict().items())
    assert load_checkpoint(ckpt)[2:] == (None, None)
    # Buckets past the positional capacity (512 tokens) are dropped.
    assert batcher.buckets == (8, 16)
    pipe = server.longform_fn.scheduler.pipe
    assert pipe.encode_route == "modules" and pipe.sem_stride == 320
    assert pipe.prep_buckets == (12800, 25600)
    assert pipe.row_quantum == 1  # no refine is padded
    with pytest.raises(ValueError, match="2 CUDA devices"):
        serving.run_server(ckpt, mesh=2, device="cpu", verbose=False)


def test_jax_clients_against_the_port_server(served):
    """Protocol compatibility: the JAX package's request_tts (binary and
    JSON) and request_longform, and a stats line, against the port."""
    _, server, batcher, _, _ = served
    host, port = server.server_address
    results = {}

    def ask(i, n, binary):
        results[i] = jserving.request_tts(list(range(1, n + 1)), host=host, port=port,
                                          binary=binary)

    threads = [threading.Thread(target=ask, args=(i, n, i % 2 == 0))
               for i, n in enumerate((3, 5, 8, 12, 16, 7))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert sorted(results) == list(range(6))
    for i, n in enumerate((3, 5, 8, 12, 16, 7)):
        assert results[i].shape == (2 * n, 80) and np.isfinite(results[i]).all()
    with pytest.raises(RuntimeError, match="exceeds the largest bucket"):
        jserving.request_tts(list(range(20)), host=host, port=port)
    segs = list(jserving.request_longform(_sine(0.9, 240.0), host=host, port=port, seed=4, **LF))
    assert segs and [o for _, o in segs][0] == 0 and all(s.shape[0] == 80 for s, _ in segs)
    with socket.create_connection((host, port), timeout=30) as s:
        s.sendall(b'{"stats": true}\n')
        resp = json.loads(s.makefile().readline())
    assert resp["stats"]["requests_served"] >= 6 and "longform" in resp


def test_port_clients_against_the_jax_server():
    """The port's request_tts and request_longform against the JAX package's
    TCP front-end (a numpy stand-in model behind it)."""
    def longform_fn(wav, opts):
        for k in range(3):
            yield np.full((80, 4), float(k + opts.get("seed", 0)), np.float32), 4 * k

    mb = jserving.MicroBatcher(_fake_generate, buckets=(8,), max_batch=2, max_wait_ms=5.0)
    server = jserving.serve_tcp(mb, port=0, longform_fn=longform_fn)
    try:
        host, port = server.server_address
        for binary in (True, False):
            mel = serving.request_tts([3, 1, 2], host=host, port=port, binary=binary)
            np.testing.assert_array_equal(mel[::2, 0], [3.0, 1.0, 2.0])
        segs = list(serving.request_longform(np.zeros(100, np.float32), host=host, port=port,
                                             seed=5))
        assert [(s[0, 0], o) for s, o in segs] == [(5.0, 0), (6.0, 4), (7.0, 8)]
    finally:
        server.shutdown()
        mb.close()


def test_tcp_longform_matches_offline_and_audio(served):
    _, server, _, _, _ = served
    host, port = server.server_address
    pipe = server.longform_fn.scheduler.pipe
    wav = _sine(1.3, 270.0)
    got = list(serving.request_longform(wav, host=host, port=port, seed=21, **LF))
    offline, _ = pipe.generate(wav, vocode=False, seed=21, **LF)
    np.testing.assert_allclose(np.concatenate([s for s, _ in got], axis=1), offline,
                               rtol=1e-5, atol=1e-5)
    audio = list(serving.request_longform(wav, host=host, port=port, seed=21, audio=True,
                                          griffin_lim_iters=2, **LF))
    offs = [o for _, o in audio]
    assert offs[0] == 0 and all(o2 == o1 + len(a) for (a, o1), o2 in zip(audio, offs[1:]))
    assert all(a.ndim == 1 and np.isfinite(a).all() for a, _ in audio)
    with pytest.raises(RuntimeError, match="no audio"):
        list(serving.request_longform(np.zeros(0, np.float32), host=host, port=port))


def test_scheduler_batches_streams_and_equals_solo(served, monkeypatch):
    """Two streams submitted together share ticks of 2 rows, and each equals
    its own offline generation."""
    _, server, _, _, _ = served
    sched = server.longform_fn.scheduler
    pipe = sched.pipe
    wavs = {11: _sine(1.2, 200.0), 12: _sine(0.7, 330.0)}
    before = dict(sched.tick_ms)
    # Hold the first tick until both streams are in: each submit runs its
    # prep first, and stream 11 must not finish before stream 12 arrives.
    gate, run_batch = threading.Event(), sched._run_batch

    def gated(batch, group):
        assert gate.wait(timeout=60)
        run_batch(batch, group)

    monkeypatch.setattr(sched, "_run_batch", gated)
    iters = {seed: sched.submit(w, seed=seed, **LF) for seed, w in wavs.items()}
    gate.set()
    got = {seed: np.concatenate([s for s, _ in it], axis=1) for seed, it in iters.items()}
    assert len(sched.tick_ms.get(2, [])) > len(before.get(2, []))  # a shared tick ran
    for seed, w in wavs.items():
        offline, _ = pipe.generate(w, vocode=False, seed=seed, **LF)
        np.testing.assert_allclose(got[seed], offline, rtol=1e-5, atol=1e-5)
    stats = sched.stats()
    assert stats["chunks_run"] >= 5 and "2" in stats["tick_ms_by_rows"]


def test_tcp_longform_client_disconnect_mid_stream(served):
    """A client that drops its connection after the first increment leaves
    the streams beside it untouched, and the scheduler serves on."""
    _, server, _, _, _ = served
    host, port = server.server_address
    pipe = server.longform_fn.scheduler.pipe
    wav_keep, wav_drop = _sine(1.3, 270.0), _sine(1.3, 350.0)
    results = {}

    def survivor():
        segs = list(serving.request_longform(wav_keep, host=host, port=port, seed=31, **LF))
        results["keep"] = np.concatenate([s for s, _ in segs], axis=1)

    def dropper():
        req = {"longform": dict(LF, seed=32, wav_b64=base64.b64encode(
            wav_drop.astype("<f4").tobytes()).decode("ascii"))}
        with socket.create_connection((host, port), timeout=60) as s:
            s.sendall((json.dumps(req) + "\n").encode())
            s.recv(1 << 16)  # the first line(s), then gone

    threads = [threading.Thread(target=dropper), threading.Thread(target=survivor)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and "keep" in results
    offline, _ = pipe.generate(wav_keep, vocode=False, seed=31, **LF)
    np.testing.assert_allclose(results["keep"], offline, rtol=1e-5, atol=1e-5)
    segs = list(serving.request_longform(wav_keep, host=host, port=port, seed=33, **LF))
    assert segs and all(np.isfinite(s).all() for s, _ in segs)


def test_build_lock_loads_each_library_once(monkeypatch, tmp_path):
    """Threads that reach a library's first use together build it once and
    share one handle (``_build.load`` under the process-wide lock)."""
    builds = []

    def fake_build_all():
        builds.append(threading.get_ident())
        time.sleep(0.1)  # a slow build: the other threads arrive meanwhile
        for name in _build.SOURCES:
            _build.library_path(name).write_bytes(b"")
        return {}

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    _build.build_dir().mkdir(parents=True)
    barrier = threading.Barrier(8)
    got = []

    def first_use(name):
        barrier.wait()
        got.append((name, _build.load(name)))

    threads = [threading.Thread(target=first_use, args=(n,))
               for n in list(_build.SOURCES) * 2 + ["conv_frontend"] * 2]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(got) == 8
    for name in _build.SOURCES:
        assert len({id(lib) for n, lib in got if n == name}) == 1
