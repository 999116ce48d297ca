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
from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
from edge_diffusion_tts_tpu_torch.ops import window_attention as wa
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "B,H,T,d,window,seq_len",
    [(1, 4, 500, 40, 64, None), (2, 4, 200, 40, 64, 150), (1, 2, 300, 32, 16, None),
     (1, 2, 256, 64, 200, None), (1, 1, 130, 16, 0, None), (1, 3, 77, 24, 5, None),
     (1, 4, 4000, 40, 64, None)],
)
def test_banded_kernel_matches_plain(cuda, B, H, T, d, window, seq_len):
    rng = np.random.RandomState(T + d)
    q, k, v = (torch.from_numpy(rng.randn(B, H, T, d).astype(np.float32)).to(cuda)
               for _ in range(3))
    before = wa.banded_attention.launches
    got = wa.banded_attention(q, k, v, window, seq_len=seq_len)
    torch.cuda.synchronize()
    assert wa.banded_attention.launches == before + 1
    want = wa.banded_attention_plain(q, k, v, window, seq_len=seq_len)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_banded_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 1, 8, 72, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        wa.banded_attention(q, q, q, 2)
    q = torch.zeros(1, 1, 8, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        wa.banded_attention(q, q, q, 2)


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
