"""Port parity: EdgeDiffusionDecoder forward and the weight bridge.

The JAX decoder is initialised and every parameter perturbed (including the
zero-init head, so outputs are nontrivial), the tree carried across with
``weights.state_dict_from_jax``, and both decoders run on the same numpy
inputs.  Small config at 1e-5; one flagship-shape forward (hidden 160,
4 layers, 4 heads of 40, window 64, T=500, S=250) at 2e-4, the JAX package's
own decoder bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.utils.torch_compat import convert_decoder_state_dict
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.weights import state_dict_from_jax

SMALL = dict(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8)


def _decoders(seed=0, **overrides):
    """(jax decoder, perturbed params, port decoder with those weights)."""
    jcfg = JCFG(**overrides)
    jdec = JDecoder(jcfg)
    params = init_decoder_params(jdec, jax.random.PRNGKey(seed), jcfg)["params"]
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 5), len(leaves))
    params = jax.tree.unflatten(
        tree, [p + 0.02 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)]
    )
    pcfg = PCFG(**overrides)
    pdec = PDecoder(pcfg)
    pdec.load_state_dict(state_dict_from_jax(params, pcfg))
    return jdec, params, pdec.eval()


def _inputs(B, T, S, cfg_kw, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "x": rng.randn(B, T, 80).astype(np.float32),
        "t": rng.randint(0, 1000, size=B),
        "step": rng.randint(0, 20, size=B),  # >= 16 exercises the clamp
        "sem_idx": rng.randint(0, 2304, size=(B, S)),
        "feat": rng.randn(B, S, 128).astype(np.float32),
    }


@pytest.mark.parametrize("cond", ["sem_idx", "sem_features", "masked", "pos_offset",
                                  "depthwise"])
def test_small_decoder_forward(cond):
    overrides = dict(SMALL, use_depthwise=cond == "depthwise")
    jdec, params, pdec = _decoders(**overrides)
    B, T, S = 2, 24, 12
    d = _inputs(B, T, S, overrides)
    jkw, pkw = {}, {}
    if cond == "sem_features":
        jkw["sem_features"] = jnp.asarray(d["feat"])
        pkw["sem_features"] = torch.from_numpy(d["feat"])
    else:
        jkw["sem_idx"] = jnp.asarray(d["sem_idx"])
        pkw["sem_idx"] = torch.from_numpy(d["sem_idx"])
    if cond == "masked":
        sem_mask = np.arange(S)[None] < np.array([[S], [7]])
        mel_mask = np.repeat(sem_mask, 2, axis=1)
        jkw.update(sem_mask=jnp.asarray(sem_mask), mel_mask=jnp.asarray(mel_mask))
        pkw.update(sem_mask=torch.from_numpy(sem_mask), mel_mask=torch.from_numpy(mel_mask))
    if cond == "pos_offset":
        jkw["pos_offset"] = pkw["pos_offset"] = 37
    ref = jdec.apply({"params": params}, jnp.asarray(d["x"]), jnp.asarray(d["t"]),
                     step_idx=jnp.asarray(d["step"]), **jkw)
    with torch.no_grad():
        out = pdec(torch.from_numpy(d["x"]), torch.from_numpy(d["t"]),
                   step_idx=torch.from_numpy(d["step"]), **pkw)
    assert np.abs(np.asarray(ref)).max() > 1e-2  # the head is not trivially zero
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_small_decoder_kernel_route_matches_dense():
    """use_kernel=True sends self-attention through banded_attention (its
    plain version on the CPU); the result equals the dense masked route."""
    _, params, pdec = _decoders(**SMALL)
    kdec = PDecoder(PCFG(**SMALL), use_kernel=True).eval()
    kdec.load_state_dict(pdec.state_dict())
    d = _inputs(1, 40, 20, SMALL)
    args = (torch.from_numpy(d["x"]), torch.from_numpy(d["t"]))
    with torch.no_grad():
        a = pdec(*args, sem_idx=torch.from_numpy(d["sem_idx"]))
        b = kdec(*args, sem_idx=torch.from_numpy(d["sem_idx"]))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_flagship_decoder_forward():
    overrides = dict(dropout=0.0)
    jdec, params, pdec = _decoders(seed=7, **overrides)
    assert (pdec.cfg.hidden, pdec.cfg.layers, pdec.cfg.heads,
            pdec.cfg.attn_window_size) == (160, 4, 4, 64)
    assert sum(p.numel() for p in pdec.parameters()) == 2_270_160
    B, T, S = 1, 500, 250
    d = _inputs(B, T, S, overrides, seed=42)
    t, step = np.array([750]), np.array([1])
    ref = jdec.apply({"params": params}, jnp.asarray(d["x"]), jnp.asarray(t),
                     sem_idx=jnp.asarray(d["sem_idx"]), step_idx=jnp.asarray(step))
    with torch.no_grad():
        out = pdec(torch.from_numpy(d["x"]), torch.from_numpy(t),
                   sem_idx=torch.from_numpy(d["sem_idx"]), step_idx=torch.from_numpy(step))
    assert out.shape == (B, T, 80)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=0)


def test_weight_bridge_round_trip():
    """JAX params -> port state dict -> the JAX package's own reference-key
    converter -> the original params, leaf for leaf."""
    _, params, pdec = _decoders(**SMALL)
    sd = pdec.state_dict()
    assert {"time_emb.1.weight", "time_emb.3.bias", "layers.1.norm1.proj.weight",
            "layers.0.attn.qkv.weight", "layers.0.cross_attn.kv_down_proj.weight",
            "layers.1.ffn.net.0.weight", "layers.1.ffn.net.3.bias",
            "final_norm.weight", "final_norm.bias"} <= set(sd)
    back = convert_decoder_state_dict(sd, num_layers=SMALL["layers"])["params"]
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="layers"):
        state_dict_from_jax(params, PCFG(**dict(SMALL, layers=3)))
