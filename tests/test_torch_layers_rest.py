"""Port parity: the library layers the decoder does not use (LearnedTimeEmb,
LearnedPositionalEmb, ConvBlock) vs the JAX package on bridged weights.

Each JAX module is initialised, every parameter perturbed, carried across
with ``weights.state_dict_from_jax`` (which must fill the port module's
state dict exactly: ``load_state_dict`` is strict) and applied to the same
numpy inputs.  Tolerance 1e-5 (float32 on both sides, different summation
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu import layers as jl
from edge_diffusion_tts_tpu_torch import layers as pl
from edge_diffusion_tts_tpu_torch.weights import state_dict_from_jax

ATOL = 1e-5


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(jmod, pmod, *args, seed=0):
    params = jmod.init(jax.random.PRNGKey(seed), *args)["params"]
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), len(leaves))
    params = jax.tree.unflatten(
        tree, [p + 0.02 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])
    pmod.load_state_dict(state_dict_from_jax(params))
    return (lambda *a: jmod.apply({"params": params}, *a)), pmod.eval()


@pytest.mark.parametrize("dim,hidden", [(32, None), (16, 24)])
def test_learned_time_emb(dim, hidden):
    t = np.array([0, 3, 250, 999], np.int32)
    japply, pmod = _pair(jl.LearnedTimeEmb(dim, hidden), pl.LearnedTimeEmb(dim, hidden),
                         jnp.asarray(t))
    assert set(pmod.state_dict()) == {"net.0.weight", "net.0.bias", "net.3.weight",
                                      "net.3.bias"}
    np.testing.assert_allclose(pmod(torch.from_numpy(t)).detach().numpy(),
                               np.asarray(japply(jnp.asarray(t))), atol=ATOL, rtol=0)


def test_learned_positional_emb():
    x = _rand(2, 7, 32)
    japply, pmod = _pair(jl.LearnedPositionalEmb(10, 32), pl.LearnedPositionalEmb(10, 32),
                         jnp.asarray(x))
    np.testing.assert_allclose(pmod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(japply(jnp.asarray(x))), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="exceed"):
        pmod(torch.zeros(1, 11, 32))


@pytest.mark.parametrize("in_ch,out_ch,k,stride,T", [(16, 32, 3, 1, 20), (32, 6, 5, 2, 21),
                                                     (8, 16, 4, 3, 17)])
def test_conv_block(in_ch, out_ch, k, stride, T):
    x = _rand(2, T, in_ch, seed=1)
    japply, pmod = _pair(jl.ConvBlock(in_ch, out_ch, k, stride),
                         pl.ConvBlock(in_ch, out_ch, k, stride), jnp.asarray(x))
    got = pmod(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(japply(jnp.asarray(x)))
    assert got.shape == want.shape == (2, -(-T // stride), out_ch)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
