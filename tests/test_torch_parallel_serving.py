"""Data-parallel inference in one process over a device list (CPU), the
long-form pipeline and scheduler under a mesh, ``run_server``'s mesh
checks, ``init_multihost`` without a cluster, and the no-JAX guard's reach.

A device listed twice runs two shares on one device: that exercises the
split and the gather where only one device exists.  Bars: the DDIM
generation (a 50-step schedule, so the first step divides by sqrt(alpha_bar)
= 0.07, not 1.6e-5) at atol 1e-5 against the unsharded call; long-form rows
at the row-independence test's rtol 1e-5 atol 1e-6 against each row alone.
"""

import os

import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu_torch import serving
from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder
from edge_diffusion_tts_tpu_torch.parallel import init_multihost, make_dp_generate
from edge_diffusion_tts_tpu_torch.parallel.launch import free_port
from edge_diffusion_tts_tpu_torch.pipeline import LongFormPipeline
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
from edge_diffusion_tts_tpu_torch.weights import save_checkpoint

TINY = dict(hidden=32, layers=1, heads=2, diff_steps=50, dropout=0.0)
CPU2 = ["cpu", "cpu"]


def _decoder(cfg, seed=0):
    torch.manual_seed(seed)
    dec = EdgeDiffusionDecoder(cfg)
    with torch.no_grad():  # the zero-init head would make every output 0
        dec.out_proj.weight.normal_(0, 0.05)
    return dec.eval()


@pytest.fixture(scope="module")
def engine():
    cfg = CFG(**TINY)
    return EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), _decoder(cfg),
                         backend="fused", device="cpu")


def _tokens(B=4, S=12, seed=1):
    return torch.as_tensor(np.random.RandomState(seed).randint(0, 100, (B, S)))


def test_dp_generate_unmasked_equals_unsharded(engine):
    gen = make_dp_generate(engine, CPU2)
    sem = _tokens()
    got = gen(sem, num_steps=4, generator=torch.Generator().manual_seed(3))
    want = engine.generate_mel(sem, 4, generator=torch.Generator().manual_seed(3))
    assert got.shape == want.shape == (4, 24, 80)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_dp_generate_masked_equals_unsharded(engine):
    gen = make_dp_generate(engine, CPU2, masked=True)
    sem = _tokens()
    mask = torch.ones(sem.shape, dtype=torch.bool)
    mask[1, 7:], mask[2, 3:] = False, False
    got = gen(sem, num_steps=4, generator=torch.Generator().manual_seed(4), sem_mask=mask)
    want = engine.generate_mel(sem, 4, generator=torch.Generator().manual_seed(4),
                               sem_mask=mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_dp_generate_refusals(engine):
    sem = _tokens(B=3)
    with pytest.raises(ValueError, match="divide"):
        make_dp_generate(engine, CPU2)(sem, num_steps=2)
    with pytest.raises(ValueError, match="masked=True"):
        make_dp_generate(engine, CPU2)(_tokens(), num_steps=2,
                                       sem_mask=torch.ones(4, 12, dtype=torch.bool))
    with pytest.raises(ValueError, match="needs sem_mask"):
        make_dp_generate(engine, CPU2, masked=True)(_tokens(), num_steps=2)


@pytest.fixture(scope="module")
def pipes():
    cfg = CFG(**TINY)
    dec = _decoder(cfg, 2)
    feats = lambda w: w.reshape(w.shape[0], -1, 320)[:, :, :128] * 3.0  # noqa: E731
    geo = dict(chunk_seconds=0.5, overlap_seconds=0.125, encoder_apply=feats, device="cpu")
    solo = LongFormPipeline(cfg, DiffusionSchedule.create(50), dec, **geo)
    meshed = LongFormPipeline(cfg, DiffusionSchedule.create(50), dec, mesh=CPU2, **geo)
    return solo, meshed


def test_longform_mesh_pads_rows_and_keeps_each_row(pipes):
    solo, meshed = pipes
    assert (solo.row_quantum, meshed.row_quantum) == (1, 2)
    T, M, S = solo.chunk_frames, 80, solo.chunk_samples // 320
    r = np.random.RandomState(5)
    z = r.randn(3, S, 128).astype(np.float32)
    known = r.randn(3, T, M).astype(np.float32)
    have = np.asarray([True, False, True])
    seeds = np.asarray([21, 22, 23])
    kw = dict(strength=0.4, steps=3, cfg_scale=2.0)
    calls = []
    refine_rows = meshed._refine_rows

    def counting(decoder, sched, noise, *a, **k):
        calls.append(noise.shape[0])
        return refine_rows(decoder, sched, noise, *a, **k)

    meshed._refine_rows = counting
    try:
        got = meshed.refine_chunk_batch_seeds(seeds, z, known, have, **kw).numpy()
    finally:
        del meshed._refine_rows
    assert got.shape == (3, T, M) and calls == [2, 2]  # 3 rows padded to 4, 2 per device
    for i in range(3):
        want = solo.refine_chunk_batch_seeds(seeds[i:i + 1], z[i:i + 1], known[i:i + 1],
                                             have[i:i + 1], **kw).numpy()
        np.testing.assert_allclose(got[i], want[0], rtol=1e-5, atol=1e-6)


def test_longform_scheduler_checks_the_row_quantum(pipes):
    _, meshed = pipes
    with pytest.raises(ValueError, match="row_quantum=2"):
        serving.LongFormScheduler(meshed, max_streams=3)
    sched = serving.LongFormScheduler(meshed, max_streams=4)
    assert sched.row_quantum == 2
    sched.close()


def test_run_server_mesh_checks(tmp_path):
    cfg = CFG(**TINY)
    save_checkpoint(str(tmp_path / "ckpt"), cfg, _decoder(cfg))
    with pytest.raises(ValueError, match="divisible by mesh"):
        serving.run_server(str(tmp_path / "ckpt"), mesh=3, max_batch=8, verbose=False)
    with pytest.raises(ValueError, match="4 CUDA devices"):
        serving.run_server(str(tmp_path / "ckpt"), mesh=4, max_batch=8, verbose=False)


def test_init_multihost_without_a_cluster():
    assert not any(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    assert init_multihost() == (0, 1)
    with pytest.raises(ValueError, match="coordinator_address"):
        init_multihost(num_processes=2)
    # Explicit arguments never degrade: a coordinator that does not answer raises.
    with pytest.raises(RuntimeError):
        init_multihost(f"127.0.0.1:{free_port()}", 2, 1, backend="gloo", timeout=2.0)
    assert not torch.distributed.is_initialized()


def test_no_jax_guard_walks_parallel():
    """tests/test_torch_guard.py's walk of the package reaches parallel/."""
    import test_torch_guard

    files = {os.path.relpath(f, test_torch_guard.ROOT) for f in test_torch_guard._port_files()}
    for name in ("__init__", "mesh", "data_parallel", "sequence_parallel", "tensor_parallel",
                 "multihost", "pipeline_parallel", "launch"):
        assert os.path.join("edge_diffusion_tts_tpu_torch", "parallel", name + ".py") in files
