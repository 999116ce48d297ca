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


@pytest.mark.parametrize("B,H,T,d,window", [(2, 4, 200, 40, 64), (1, 2, 96, 16, 5)])
def test_banded_strided_views_match_jax_kernel(B, H, T, d, window):
    """q, k, v as views of one [B, T, 3, H, d] buffer (the qkv projection's
    output, as the attention layer hands them over), the result in [B, T,
    H, d] memory; against JAX's kernel on the same values, 2e-5."""
    buf = np.random.RandomState(T + d).randn(B, T, 3, H, d).astype(np.float32)
    qkv = torch.from_numpy(buf).permute(2, 0, 3, 1, 4)  # [3, B, H, T, d] views
    assert not qkv[0].is_contiguous()
    q, k, v = (np.ascontiguousarray(buf[:, :, i].transpose(0, 2, 1, 3)) for i in range(3))
    want = np.asarray(jband(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window))
    got = pw.banded_attention(qkv[0], qkv[1], qkv[2], window, out_layout="bthd")
    assert got.shape == (B, H, T, d)
    assert got.transpose(1, 2).is_contiguous()  # [B, T, H, d] memory
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="out_layout"):
        pw.banded_attention(qkv[0], qkv[1], qkv[2], window, out_layout="tbhd")


def _plan_in(monkeypatch, rows, *shape):
    """band_plan with the tiles narrowed to ``rows`` query rows per block."""
    monkeypatch.setattr(pw, "BAND_ROWS", (rows,))
    return pw.band_plan(*shape)


@pytest.mark.parametrize("window", [0, 5, 64, 200])
@pytest.mark.parametrize("rows", pw.BAND_ROWS)
def test_band_plan_blocks_cover_their_rows_band(monkeypatch, rows, window):
    """A block of the plan walks keys [lo, hi) in chunks of the plan's keys,
    lo = q0 - window and hi = q0 + rows + window clipped to [0, seq_len) (as
    csrc/band_attention.cu sets them): every key its rows attend (|i - j| <=
    window, j < seq_len) lies in a walked chunk, and no chunk lies wholly
    past hi.  The plan's shared bytes fit a block of the H100 (232,448) at
    every head dim."""
    for T, seq_len in ((77, 77), (500, 500), (300, 211), (1000, 1000)):
        plan = _plan_in(monkeypatch, rows, 1, 4, T, 40, window)
        assert plan["rows"] == rows and plan["threads"] == rows // 16 * 32 <= 1024
        keys = plan["keys"]
        for q0 in range(0, T, rows):
            lo, hi = max(0, q0 - window), min(seq_len, q0 + rows + window)
            chunks = -(-(hi - lo) // keys) if lo < hi else 0
            assert (chunks - 1) * keys < hi - lo <= chunks * keys or chunks == 0
            for i in range(q0, min(q0 + rows, T)):
                first, last = max(0, i - window), min(seq_len - 1, i + window)
                if first <= last:
                    assert lo <= first and last < lo + chunks * keys
    for d in range(4, pw.MAX_HEAD_DIM + 1, 4):
        smem = _plan_in(monkeypatch, rows, 2, 4, 4000, d, window)["smem"]
        assert smem == pw.band_smem_bytes(rows, d) <= 232_448


@pytest.mark.parametrize("B,T,rows,blocks", [(1, 4000, 32, 500), (2, 4000, 64, 504),
                                             (1, 500, 32, 64)])
def test_band_plan_at_the_long_form_shapes(B, T, rows, blocks):
    """On 132 SMs, at [B,4,T,40], w=64: the tile with the most blocks that
    still run as one wave, the fastest measured there."""
    plan = pw.band_plan(B, 4, T, 40, 64)
    assert (plan["rows"], plan["blocks"]) == (rows, blocks)
    assert plan["waves"] <= 1
    assert plan["threads"] == rows // 16 * 32


def test_band_plan_refusals_and_the_fallback(monkeypatch):
    """Past one wave for every tile, the fewest waves."""
    plan = pw.band_plan(2, 4, 8000, 40, 64)
    assert plan["waves"] == min(_plan_in(monkeypatch, rows, 2, 4, 8000, 40, 64)["waves"]
                                for rows in pw.BAND_ROWS) > 1
    with pytest.raises(ValueError, match="head dim"):
        pw.band_plan(1, 4, 500, 42, 64)
