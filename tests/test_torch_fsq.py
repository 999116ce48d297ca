"""``FSQ.bound`` against the JAX package's, and ``FSQ.forward`` through it.

JAX's ``FSQ.bound`` is ``jnp.tanh`` at its input's dtype; the port's is
``torch.tanh``.  Bars: float32 within 4 float32 ulps (XLA's CPU tanh is a
rational approximation), bf16 within one bf16 ulp.  ``forward`` bounds
through ``bound`` (a subclass's ``bound`` is what it quantizes), and its
quantized values and indices equal JAX's ``__call__`` on the same input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.models.fsq import FSQ as JFSQ
from edge_diffusion_tts_tpu_torch.models.fsq import FSQ

LEVELS = (4, 4, 3, 3, 2, 2, 2, 2)


def _z(dtype):
    rs = np.random.RandomState(0)
    z = rs.randn(3, 50, len(LEVELS)).astype(np.float32) * 2.0
    z[0, :8, 0] = [0.0, -0.0, 1e-8, -1e-8, 9.0, -9.0, 20.0, -20.0]  # zero, tiny, saturated
    return torch.from_numpy(z).to(dtype), jnp.asarray(z).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_bound_matches_jax(dtype):
    z, jz = _z(dtype)
    got = FSQ(LEVELS).bound(z)
    jb = JFSQ(LEVELS).apply({}, jz, method=JFSQ.bound)
    assert got.dtype == dtype and jb.dtype == jz.dtype
    want = np.asarray(jb, np.float32)
    # ulps at the JAX value's magnitude: 4 of float32's, 1 of bf16's (8 bits)
    ulps = 4 * np.spacing(np.abs(want)) if dtype == torch.float32 \
        else np.spacing(np.abs(want)) * 2.0 ** 16
    assert (np.abs(got.float().numpy() - want) <= ulps).all()
    assert (got.float().abs() <= 1).all()


def test_forward_bounds_through_bound_and_matches_jax():
    z, jz = _z(torch.float32)
    fsq = FSQ(LEVELS)
    z_q, idx = fsq(z)
    jz_q, jidx = JFSQ(LEVELS).apply({}, jz)
    np.testing.assert_allclose(z_q.numpy(), np.asarray(jz_q), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))

    class Clipped(FSQ):
        def bound(self, z):
            return torch.clamp(z, -1.0, 1.0)

    z_c, idx_c = Clipped(LEVELS)(z)
    want = torch.clamp(z, -1.0, 1.0)
    np.testing.assert_array_equal(idx_c.numpy(), fsq.codes_to_indices(fsq.quantize(want)).numpy())
    torch.testing.assert_close(z_c, fsq.quantize(want), rtol=0, atol=1e-6)
