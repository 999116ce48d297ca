"""Port parity: banded attention vs the JAX Pallas kernel (interpret mode).

On the CPU the port's ``banded_attention`` runs its plain version; it is
held against JAX's ``banded_attention`` (the Pallas kernel, interpreted on
the CPU as tests/test_window_attention.py runs it) to 2e-5.  The CUDA kernel
against the plain version is in test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.ops.window_attention import banded_attention as jband
from edge_diffusion_tts_tpu_torch.layers.attention import local_attention_mask, sdpa
from edge_diffusion_tts_tpu_torch.ops import window_attention as pw


def _qkv(B, H, T, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, T, d).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize(
    "B,H,T,d,window",
    [
        (1, 2, 128, 40, 64),
        (2, 4, 200, 40, 64),
        (1, 1, 300, 32, 16),
        (1, 2, 256, 64, 200),
        (1, 1, 130, 16, 0),    # window 0: each row attends to itself
        (1, 2, 160, 24, 160),  # the band covers the whole sequence
    ],
)
def test_banded_plain_matches_jax_kernel(B, H, T, d, window):
    q, k, v = _qkv(B, H, T, d)
    want = jband(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window)
    before = pw.banded_attention.launches
    got = pw.banded_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window)
    assert pw.banded_attention.launches == before  # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    if window == 0:
        np.testing.assert_allclose(got.numpy(), v, atol=2e-5, rtol=0)


def test_banded_seq_len_bound():
    """``seq_len`` excludes keys j >= seq_len; rows left with no key give 0."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 50, 8, seed=2))
    got = pw.banded_attention(q, k, v, 4, seq_len=30)
    band = local_attention_mask(50, 4)
    mask = (band & (torch.arange(50) < 30)[None, :])[None, None]
    torch.testing.assert_close(got[:, :, :34], sdpa(q, k, v, mask)[:, :, :34],
                               atol=2e-5, rtol=0)
    assert got[:, :, 35:].abs().max() == 0  # rows 35.. reach no key below 30
    with pytest.raises(ValueError, match="shape"):
        pw.banded_attention(q, k[:, :, :10], v, 4)

