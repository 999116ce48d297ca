"""The token call's graph route on the card: ``fused_generate_mel`` on packed
weights replays one CUDA graph per call shape (ops/fused_denoise.py,
``LoopPlans``), and must give what the eager route gives, bit for bit.

The eager route here is the composition the call ran before it had plans:
``prepare_loop_inputs`` on the host's grid, the cross K/V cast, then
``fused_ddim``.  Decoders are configs/flagship.json's (float32) and
configs/tpu_large_batch.json's (bf16 compute), their parameters drawn from a
seed; shapes are the synthesis cells' (64 rows of 1-5 s of tokens, 32 rows
of 2.5 s).

Every test here carries the ``gpu`` marker and skips without a CUDA device.
This file imports neither JAX nor the JAX package; run it as

    python -m pytest --noconftest -m gpu tests/test_torch_loop_graph_gpu.py
"""

import json
from pathlib import Path

import pytest
import torch

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder
from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {torch.float32: "configs/flagship.json", torch.bfloat16: "configs/tpu_large_batch.json"}
SHAPES = [(64, 100), (64, 300), (64, 500), (32, 250)]  # (rows, tokens)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _decoder(device, compute_dtype, seed=0):
    with open(ROOT / CONFIGS[compute_dtype]) as f:
        cfg = CFG.from_dict(json.load(f))
    torch.manual_seed(seed)
    dec = EdgeDiffusionDecoder(cfg, dtype=compute_dtype)
    _perturb(dec, seed)
    return cfg, dec.to(device).eval(), DiffusionSchedule.create(cfg.diff_steps).to(device)


def _perturb(dec, seed):
    """Move every parameter off its init (the output head starts at zero)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g).to(p.device))


def _inputs(cfg, device, B, S, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.effective_codebook_size(), (B, S), generator=g, device=device)
    return tokens, torch.randn(B, 2 * S, cfg.n_mels, generator=g, device=device)


def _eager(cfg, schedule, dec, tokens, x, steps, prediction, packed, compute_dtype):
    """The call's eager composition, on the host-built grid."""
    ts, coef = fd.ddim_coefficients(schedule, steps)
    loop = fd.prepare_loop_inputs(dec, tokens, x.shape[1], ts)
    return fd.fused_ddim(x, loop["pos"], loop["mods"], loop["ckv"].to(compute_dtype),
                         coef.to(x.device), packed, heads=cfg.heads,
                         window=cfg.attn_window_size, prediction=prediction,
                         compute_dtype=compute_dtype)


def _call(cfg, schedule, dec, tokens, x, steps, prediction, packed, compute_dtype):
    return fd.fused_generate_mel(cfg, schedule, dec, tokens, x, steps, prediction,
                                 weights=packed, compute_dtype=compute_dtype)


def _routes():
    c = fd.fused_generate_mel
    return c.eager, c.captures, c.replays


@pytest.mark.parametrize("B,S", SHAPES)
@pytest.mark.parametrize("prediction", ["v", "eps"])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_replayed_calls_equal_the_eager_route(cuda, compute_dtype, prediction, B, S):
    """Calls 1-3 of a shape, on new tokens and noise each: eager, capture
    and replay, replay; each torch.equal to the eager composition, and the
    loop's launch counted once a call."""
    cfg, dec, sched = _decoder(cuda, compute_dtype)
    packed = fd.pack_decoder_weights(dec, compute_dtype)
    steps = cfg.inference_steps
    fd.zero_plan_counts()
    counted = "bf16_launches" if compute_dtype == torch.bfloat16 else "launches"
    launches = getattr(fd.fused_ddim, counted)
    for i in range(3):
        tokens, x = _inputs(cfg, cuda, B, S, seed=10 * B + S + i)
        got = _call(cfg, sched, dec, tokens, x, steps, prediction, packed, compute_dtype)
        want = _eager(cfg, sched, dec, tokens, x, steps, prediction, packed, compute_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"call {i + 1}"
    assert _routes() == (1, 1, 1)
    assert getattr(fd.fused_ddim, counted) - launches == 3 + 3  # the calls' and the witness's


def test_successive_replays_return_tensors_of_their_own(cuda):
    cfg, dec, sched = _decoder(cuda, torch.bfloat16)
    packed = fd.pack_decoder_weights(dec, torch.bfloat16)
    outs = []
    for i in range(4):
        tokens, x = _inputs(cfg, cuda, 64, 100, seed=i)
        outs.append(_call(cfg, sched, dec, tokens, x, 4, "v", packed, torch.bfloat16))
    kept = outs[2].clone()
    outs.append(_call(cfg, sched, dec, *_inputs(cfg, cuda, 64, 100, seed=9), 4, "v", packed,
                      torch.bfloat16))
    torch.cuda.synchronize()
    assert len({o.data_ptr() for o in outs}) == len(outs)
    assert torch.equal(outs[2], kept) and not torch.equal(outs[2], outs[3])


def test_new_weights_or_a_moved_decoder_replan(cuda):
    """A new packed dict, then a cpu -> cuda round trip of the decoder (its
    old memory held, so that its tensors come back at new addresses): each
    first call runs eagerly on the new addresses, the next one captures."""
    dt = torch.bfloat16
    cfg, dec, sched = _decoder(cuda, dt)
    tokens, x = _inputs(cfg, cuda, 32, 250, seed=3)

    def run(packed):
        got = _call(cfg, sched, dec, tokens, x, 4, "v", packed, dt)
        want = _eager(cfg, sched, dec, tokens, x, 4, "v", packed, dt)
        torch.cuda.synchronize()
        assert torch.equal(got, want)

    fd.zero_plan_counts()
    packed = fd.pack_decoder_weights(dec, dt)
    for _ in range(3):
        run(packed)
    assert _routes() == (1, 1, 1)
    packed = fd.pack_decoder_weights(dec, dt)  # the same values at new addresses
    run(packed)
    run(packed)
    assert _routes() == (2, 2, 1)
    held = [t.data for t in (*dec.parameters(), *dec.buffers())]  # no address comes back
    dec.to("cpu").to(cuda)
    run(packed)
    run(packed)
    run(packed)
    assert _routes() == (3, 3, 2) and held


def test_an_in_place_load_state_dict_shows_in_the_next_replay(cuda):
    dt = torch.bfloat16
    cfg, dec, sched = _decoder(cuda, dt)
    packed = fd.pack_decoder_weights(dec, dt)
    tokens, x = _inputs(cfg, cuda, 64, 300, seed=4)
    for _ in range(3):
        before = _call(cfg, sched, dec, tokens, x, 4, "v", packed, dt)
    other = _decoder("cpu", dt, seed=1)[1]
    dec.load_state_dict(other.state_dict())  # copied into the tensors the graph reads
    fd.zero_plan_counts()
    got = _call(cfg, sched, dec, tokens, x, 4, "v", packed, dt)
    want = _eager(cfg, sched, dec, tokens, x, 4, "v", packed, dt)
    torch.cuda.synchronize()
    assert _routes() == (0, 0, 1)
    assert torch.equal(got, want) and not torch.equal(got, before)


def test_a_replay_shows_the_loop_kernels_to_the_profiler(cuda):
    """The benchmark's readers find the loop by kernel name: a replayed
    call's trace holds gemm_wgmma_kernel and ddim_kernel, and the span
    ``prep:graph_replay``."""
    from torch.profiler import ProfilerActivity, profile

    dt = torch.bfloat16
    cfg, dec, sched = _decoder(cuda, dt)
    packed = fd.pack_decoder_weights(dec, dt)
    tokens, x = _inputs(cfg, cuda, 64, 500, seed=5)
    for _ in range(2):
        _call(cfg, sched, dec, tokens, x, 4, "v", packed, dt)
    torch.cuda.synchronize()
    fd.zero_plan_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _call(cfg, sched, dec, tokens, x, 4, "v", packed, dt)
        torch.cuda.synchronize()
    assert _routes() == (0, 0, 1)
    events = list(prof.events())
    device = [e.name for e in events if "cuda" in str(e.device_type).lower()]
    assert any("gemm_wgmma_kernel" in n for n in device), sorted(set(device))[:20]
    assert any("ddim_kernel" in n for n in device), sorted(set(device))[:20]
    assert "prep:graph_replay" in {e.name for e in events}
