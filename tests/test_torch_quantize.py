"""Port parity: weight-only int8 (utils/quantize.py) against the JAX package's
on the same decoder weights, carried across by ``weights.state_dict_from_jax``.

The rule is written on the port's names; it must select the very tensors
JAX's rule selects on flax paths (mapped through the bridge).  The int8
codes must be equal exactly (transposed for a Dense/Linear weight), the
scales within rtol 1e-7, the dequantized state dict bit-equal to the bridge
of JAX's dequantized tree, and the .npz round trip and the report as JAX's.
"""

import os

import jax
import numpy as np
import pytest

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.utils import quantize as jq
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.utils import quantize as pq
from edge_diffusion_tts_tpu_torch.weights import state_dict_from_jax
from test_torch_orbax_bridge import _jitter

SMALL = dict(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8)


def _decoders(**overrides):
    jcfg = JCFG(**overrides)
    jdec = JDecoder(jcfg)
    params = _jitter(jax.jit(
        lambda: init_decoder_params(jdec, jax.random.PRNGKey(0), jcfg)["params"])(), 5)
    pdec = PDecoder(PCFG(**overrides))
    pdec.load_state_dict(state_dict_from_jax(params))
    return jax.device_get(params), pdec


def _port_name(path: str) -> str:
    """The port state-dict name the bridge gives a flax path."""
    (name,) = state_dict_from_jax(jq._unflatten({path: np.zeros((1, 1), np.float32)}))
    return name


def _bridged(jflat: dict, tag: str) -> dict:
    """JAX's ``tag:`` entries carried across the bridge (float32)."""
    tree = jq._unflatten({k.split(":", 1)[1]: np.asarray(v, np.float32)
                          for k, v in jflat.items() if k.startswith(tag + ":")})
    return {k: v.numpy() for k, v in state_dict_from_jax(tree).items()}


@pytest.mark.parametrize("depthwise", [False, True])
def test_selection_codes_and_scales_equal_jax(depthwise):
    params, pdec = _decoders(**SMALL, use_depthwise=depthwise)
    jflat = jq.quantize_decoder_params(params)
    pflat = pq.quantize_decoder_params(pdec)
    for tag in ("f32", "q8", "sc"):
        want = {_port_name(k.split(":", 1)[1]) for k in jflat if k.startswith(tag + ":")}
        got = {k.split(":", 1)[1] for k in pflat if k.startswith(tag + ":")}
        assert got == want, (tag, sorted(got ^ want))
    assert any("time_emb" in k for k in pflat if k.startswith("f32:"))
    assert "q8:token_emb.weight" in pflat and "q8:layers.1.ffn.net.0.weight" in pflat
    codes = _bridged(jflat, "q8")
    for name, want in codes.items():
        got = pflat[f"q8:{name}"]
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got.astype(np.float32), want, err_msg=name)
    for key, want in jflat.items():
        if key.startswith("sc:"):
            got = pflat["sc:" + _port_name(key[3:])]
            np.testing.assert_allclose(got.ravel(), want, rtol=1e-7, atol=0, err_msg=key)
    # Per output channel for a Linear ([out, in]: a scale per row), per
    # feature for an Embedding ([vocab, feat]: a scale per column).
    assert pflat["sc:layers.0.attn.qkv.weight"].shape == (3 * 32, 1)
    assert pflat["sc:token_emb.weight"].shape == (1, 32)


def test_dequantized_state_dict_equals_jax_and_npz_round_trip(tmp_path):
    params, pdec = _decoders(**SMALL)
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        jq.dequantize_decoder_params(jq.quantize_decoder_params(params))).items()}
    got = pq.dequantize_decoder_params(pq.quantize_decoder_params(pdec))
    assert set(got) == set(want) == set(pdec.state_dict())
    for name, v in want.items():
        np.testing.assert_array_equal(got[name].numpy(), v, err_msg=name)

    final, report = pq.save_quantized(str(tmp_path / "dec.int8"), pdec)
    assert final == str(tmp_path / "dec.int8.npz") and os.path.exists(final)
    _, jreport = jq.save_quantized(str(tmp_path / "jax.int8"), params)
    assert set(report) == set(jreport) == {"f32_bytes", "quantized_bytes", "file_bytes",
                                           "ratio", "kept_f32"}
    for key in ("f32_bytes", "quantized_bytes", "ratio"):
        assert report[key] == jreport[key], key
    assert report["kept_f32"] == sorted(_port_name(p) for p in jreport["kept_f32"])
    assert report["file_bytes"] == os.path.getsize(final)
    loaded = pq.load_quantized(final)
    for name, v in got.items():
        assert loaded[name].dtype == v.dtype
        np.testing.assert_array_equal(loaded[name].numpy(), v.numpy(), err_msg=name)
    fresh = PDecoder(PCFG(**SMALL))
    fresh.load_state_dict(loaded)  # strict: every name, every shape
    with np.load(final) as z:
        assert all(z[k].dtype == np.int8 for k in z.files if k.startswith("q8:"))
