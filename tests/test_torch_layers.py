"""Port parity: layers vs the JAX package on bridged weights (hidden 32, heads 2).

Each JAX module is initialised, every parameter perturbed (so zero-init
projections are nontrivial), carried across with
``weights.state_dict_from_jax`` and applied to the same numpy inputs.
Tolerance 1e-5 (float32 on both sides, different summation order).
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
DIM, HEADS = 32, 2


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _perturbed_params(module, *args, seed=0, **kwargs):
    params = module.init(jax.random.PRNGKey(seed), *args, **kwargs)["params"]
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), len(leaves))
    return jax.tree.unflatten(
        tree, [p + 0.02 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)]
    )


def _pair(jmod, pmod, *args, seed=0, **kwargs):
    """Init + perturb the JAX module, bridge into the port module; returns
    (jax apply fn, port module)."""
    params = _perturbed_params(jmod, *args, seed=seed, **kwargs)
    pmod.load_state_dict(state_dict_from_jax(params))
    pmod.eval()
    return (lambda *a, **kw: jmod.apply({"params": params}, *a, **kw)), pmod


def _close(port_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(
        port_out.detach().numpy(), np.asarray(jax_out), atol=atol, rtol=0
    )


def _mask(B, T, lens):
    return np.arange(T)[None, :] < np.asarray(lens)[:, None]


# ---- norms, embeddings, ffn -------------------------------------------------------


def test_rmsnorm():
    x = _rand(2, 5, DIM)
    japply, pmod = _pair(jl.RMSNorm(DIM), pl.RMSNorm(DIM), jnp.asarray(x))
    _close(pmod(torch.from_numpy(x)), japply(jnp.asarray(x)))


def test_adalayernorm():
    x, c = _rand(2, 5, DIM), _rand(2, DIM, seed=1)
    japply, pmod = _pair(jl.AdaLayerNorm(DIM, DIM), pl.AdaLayerNorm(DIM, DIM),
                         jnp.asarray(x), jnp.asarray(c))
    _close(pmod(torch.from_numpy(x), torch.from_numpy(c)),
           japply(jnp.asarray(x), jnp.asarray(c)))


def test_embeddings():
    # Sine arguments reach ~300 and ~1000 rad here, where one float32 ulp of
    # the argument is 3e-5 and 6e-5: the two frameworks' exp/sin round
    # differently by up to that much, so these tables are held to 3e-5.
    t = np.array([0, 1, 17, 999])
    _close(pl.sinusoidal_time_embedding(torch.from_numpy(t), DIM),
           jl.sinusoidal_time_embedding(jnp.asarray(t), DIM), atol=3e-5)
    _close(pl.sinusoidal_position_table(300, DIM), jl.sinusoidal_position_table(300, DIM),
           atol=3e-5)
    x = _rand(2, 9, DIM)
    jpos = jl.SinusoidalPositionalEmb(DIM, max_len=64)
    ppos = pl.SinusoidalPositionalEmb(DIM, max_len=64)
    _close(ppos(torch.from_numpy(x), offset=5),
           jpos.apply({}, jnp.asarray(x), offset=5))
    with pytest.raises(ValueError):
        ppos(torch.from_numpy(x), offset=60)
    for a, b in zip(pl.rope_tables(50, 16), jl.rope_tables(50, 16)):
        _close(a, b)
    q, k = _rand(2, 2, 7, 16), _rand(2, 2, 7, 16, seed=1)
    for a, b in zip(pl.apply_rope(torch.from_numpy(q), torch.from_numpy(k)),
                    jl.apply_rope(jnp.asarray(q), jnp.asarray(k))):
        _close(a, b)


def test_feedforward():
    x = _rand(2, 6, DIM)
    japply, pmod = _pair(jl.FeedForward(DIM, 2, 0.0), pl.FeedForward(DIM, 2, 0.0),
                         jnp.asarray(x))
    _close(pmod(torch.from_numpy(x)), japply(jnp.asarray(x)))


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_separable_conv(stride):
    x = _rand(2, 11, DIM)
    japply, pmod = _pair(jl.DepthwiseSeparableConv(DIM, 16, stride=stride),
                         pl.DepthwiseSeparableConv(DIM, 16, stride=stride), jnp.asarray(x))
    _close(pmod(torch.from_numpy(x)), japply(jnp.asarray(x)))


# ---- attention ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "route",
    ["dense_band", "key_mask", "kernel", "kernel_len_masked", "band_chunk", "full"],
)
def test_efficient_attention(route):
    B, T, window = 2, 20, 3
    x = _rand(B, T, DIM)
    key_mask = _mask(B, T, [20, 13]) if route in ("key_mask", "kernel_len_masked",
                                                  "band_chunk") else None
    jkw = dict(dropout=0.0, window_size=None if route == "full" else window)
    pkw = dict(jkw)
    if route in ("kernel", "kernel_len_masked"):
        jkw.update(use_pallas=True, pallas_min_seq=16)
        pkw.update(use_kernel=True, kernel_min_seq=16)
    if route == "band_chunk":
        jkw["band_q_chunk"] = pkw["band_q_chunk"] = 4
    jm = jl.EfficientAttention(DIM, HEADS, **jkw)
    japply, pmod = _pair(jm, pl.EfficientAttention(DIM, HEADS, **pkw), jnp.asarray(x))
    jmask = None if key_mask is None else jnp.asarray(key_mask)
    pmask = None if key_mask is None else torch.from_numpy(key_mask)
    _close(pmod(torch.from_numpy(x), key_mask=pmask),
           japply(jnp.asarray(x), key_mask=jmask))


def test_cross_attention():
    x, ctx = _rand(2, 9, DIM), _rand(2, 5, DIM, seed=1)
    japply, pmod = _pair(jl.CrossAttention(DIM, heads=HEADS, dropout=0.0),
                         pl.CrossAttention(DIM, heads=HEADS, dropout=0.0),
                         jnp.asarray(x), jnp.asarray(ctx))
    _close(pmod(torch.from_numpy(x), torch.from_numpy(ctx)),
           japply(jnp.asarray(x), jnp.asarray(ctx)))


@pytest.mark.parametrize("mode", ["cross", "cross_masked", "cross_chunked", "self_band"])
def test_mla(mode):
    B, T, S = 2, 20, 7
    x, ctx = _rand(B, T, DIM), _rand(B, S, DIM, seed=1)
    q_chunk = 4 if mode == "cross_chunked" else 0
    window = 3 if mode == "self_band" else None
    kw = dict(heads=HEADS, kv_lora_rank=DIM // 2, dropout=0.0, window_size=window,
              q_chunk=q_chunk)
    context = None if mode == "self_band" else ctx
    jctx = None if context is None else jnp.asarray(context)
    pctx = None if context is None else torch.from_numpy(context)
    key_mask = _mask(B, S, [7, 4]) if mode in ("cross_masked", "cross_chunked") else None
    jmask = None if key_mask is None else jnp.asarray(key_mask)
    pmask = None if key_mask is None else torch.from_numpy(key_mask)
    japply, pmod = _pair(jl.MultiHeadLatentAttention(DIM, **kw),
                         pl.MultiHeadLatentAttention(DIM, **kw),
                         jnp.asarray(x), context=jctx)
    _close(pmod(torch.from_numpy(x), context=pctx, key_mask=pmask),
           japply(jnp.asarray(x), context=jctx, key_mask=jmask))


def test_q_chunked_fallbacks():
    from edge_diffusion_tts_tpu.layers.attention import q_chunked_banded_sdpa as jband
    from edge_diffusion_tts_tpu.layers.attention import q_chunked_sdpa as jchunk

    B, H, T, S, d = 2, 2, 23, 11, 8
    q, k, v = (_rand(B, H, T, d, seed=s) for s in range(3))
    ck, cv = _rand(B, H, S, d, seed=4), _rand(B, H, S, d, seed=5)
    smask, tmask = _mask(B, S, [11, 6]), _mask(B, T, [23, 15])
    t = torch.from_numpy
    _close(pl.q_chunked_sdpa(t(q), t(ck), t(cv), 5, key_mask=t(smask)),
           jchunk(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), 5,
                  key_mask=jnp.asarray(smask)))
    for km in (None, tmask):
        _close(pl.q_chunked_banded_sdpa(t(q), t(k), t(v), 3, 5,
                                        key_mask=None if km is None else t(km)),
               jband(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 3, 5,
                     key_mask=None if km is None else jnp.asarray(km)))
    # Dense SDPA with the same band: the chunked form is the same math.
    band = pl.local_attention_mask(T, 3)[None, None]
    _close(pl.q_chunked_banded_sdpa(t(q), t(k), t(v), 3, 5),
           pl.sdpa(t(q), t(k), t(v), band).numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_transformer_block(masked):
    B, T, S = 2, 18, 9
    x, ctx, cond = _rand(B, T, DIM), _rand(B, S, DIM, seed=1), _rand(B, DIM, seed=2)
    mel_mask = _mask(B, T, [18, 10]) if masked else None
    ctx_mask = _mask(B, S, [9, 5]) if masked else None
    jm = jl.DiffusionTransformerBlock(DIM, DIM, DIM, heads=HEADS, dropout=0.0,
                                      window_size=4)
    pm = pl.DiffusionTransformerBlock(DIM, DIM, heads=HEADS, dropout=0.0, window_size=4)
    japply, pmod = _pair(jm, pm, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(cond))
    j = lambda a: None if a is None else jnp.asarray(a)
    p = lambda a: None if a is None else torch.from_numpy(a)
    _close(pmod(p(x), p(ctx), p(cond), mel_mask=p(mel_mask), ctx_mask=p(ctx_mask)),
           japply(j(x), j(ctx), j(cond), mel_mask=j(mel_mask), ctx_mask=j(ctx_mask)))
