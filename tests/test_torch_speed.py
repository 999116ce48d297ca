"""The port's speed utilities on the CPU: ``benchmark``'s statistics and
``fit_device_ms``'s slope on a fake clock (no sleeps), the chain builder,
``TimingContext``, ``profile_trace``, ``memory_stats``, and ``remat_decoder``'s
gradients against the plain decoder's (dropout on, masks from a generator).
"""

import os
import types

import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder
from edge_diffusion_tts_tpu_torch.utils import speed


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def advance_ms(self, ms):
        self.now += ms / 1e3


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(speed, "time", types.SimpleNamespace(perf_counter=c.perf_counter))
    return c


def test_benchmark_statistics(clock):
    durations = iter([9.0] * 2 + [4.0, 1.0, 3.0, 2.0, 5.0])

    def fn(x, scale=1.0):
        clock.advance_ms(next(durations))
        return {"out": (x * scale,)}

    stats = speed.benchmark(fn, torch.ones(3), warmup=2, runs=5, scale=2.0)
    assert set(stats) == {"mean_ms", "median_ms", "min_ms", "max_ms", "std_ms", "runs"}
    np.testing.assert_allclose(
        [stats[k] for k in ("mean_ms", "median_ms", "min_ms", "max_ms", "std_ms", "runs")],
        [3.0, 3.0, 1.0, 5.0, np.std([4, 1, 3, 2, 5], ddof=1), 5.0], rtol=1e-9)


def test_fit_device_ms_slope(clock):
    built = []

    def chain_builder(reps):
        built.append(reps)

        def run():
            clock.advance_ms(5.0 + 0.25 * reps)
            return torch.tensor(1.0)

        return run

    fit = speed.fit_device_ms(chain_builder, reps=(25, 200), runs=3, min_spread_ms=300.0)
    assert set(fit) == {"device_ms", "overhead_ms", "wall_lo_ms", "wall_hi_ms", "reps_hi"}
    np.testing.assert_allclose(fit["device_ms"], 0.25, rtol=1e-9)
    np.testing.assert_allclose(fit["overhead_ms"], 5.0, rtol=1e-9)
    # The long chain grew until the walls differed by >= 300 ms.
    assert built[0] == 25 and fit["wall_hi_ms"] - fit["wall_lo_ms"] >= 300.0
    assert fit["reps_hi"] == built[-1] > 200


def test_scan_chain_builder_sums_dependent_iterations():
    run = speed.scan_chain_builder(lambda i, w: w * i, (torch.tensor(2.0),))(4)
    assert float(run()) == 2.0 * (0 + 1 + 2 + 3)
    # With a carry: each iteration feeds its output to the next.
    run = speed.scan_chain_builder(lambda c, i: (c * 2, c.sum()), carry=torch.ones(2))(3)
    assert float(run()) == 2 + 4 + 8


def test_timing_context_profile_trace_and_memory_stats(tmp_path):
    with speed.TimingContext("t", verbose=False, device="cpu") as t:
        torch.ones(4).sum()
    assert t.elapsed_ms >= 0.0
    with speed.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert len(prof.key_averages()) > 0
    assert speed.memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            speed.TimingContext()
        with pytest.raises(RuntimeError, match="CUDA"):
            speed.memory_stats()


def test_remat_decoder_gradients_equal_the_plain_decoder():
    """Every block recomputed in the backward, its dropout masks drawn again
    from the generator's saved state: the loss and every gradient equal the
    plain decoder's (1e-6; the same ops in the same order), and the
    generator ends where the plain run leaves it."""
    cfg = CFG(hidden=32, layers=2, heads=2, dropout=0.2)
    plain = EdgeDiffusionDecoder(cfg)
    with torch.no_grad():  # the zero-init heads would zero every upstream gradient
        for p in plain.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    remat = speed.remat_decoder(EdgeDiffusionDecoder)(cfg)
    remat.load_state_dict(plain.state_dict())
    assert type(remat).__name__ == "RematEdgeDiffusionDecoder"
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 12, cfg.n_mels).astype(np.float32))
    t = torch.tensor([10, 500])
    sem = torch.from_numpy(rng.randint(0, 64, (2, 6)))
    results = []
    for model in (plain, remat):
        model.train()
        g = torch.Generator().manual_seed(5)
        loss = model(x, t, sem_idx=sem, generator=g).square().mean()
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                                      if p.grad is not None},
                        torch.rand(1, generator=g).item()))
    (l0, g0, r0), (l1, g1, r1) = results
    assert l0 == pytest.approx(l1, abs=1e-6) and r0 == r1
    assert set(g0) == set(g1) and any(n.startswith("layers.1.") for n in g0)
    assert g0["layers.0.attn.qkv.weight"].abs().max() > 0
    for name, grad in g0.items():
        np.testing.assert_allclose(g1[name].numpy(), grad.numpy(), atol=1e-6, err_msg=name)
