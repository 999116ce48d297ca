"""Port parity: the semantic encoder (FSQ, VQ, HuBERT, the conv frontend's plain
version, SemanticEncoder, the weight bridges) vs the JAX package.

Inputs and weights come from numpy seeds or from the JAX initializers and
are handed to both packages; weights cross with ``weights.py``.  Tolerances:
tokens and indices exact; HuBERT hidden states 1e-5 (float32 summation
order); the frontend against JAX's ``_FeatureExtractor`` atol 2e-4 rtol
1e-3, the JAX fused kernel's own bar (its analytical GroupNorm reads
E[x^2] - mean^2).  Full-width HuBERT stays out of this CPU lane: only the
conv stack runs at full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import SemanticEncoder as JEncoder
from edge_diffusion_tts_tpu.models.fsq import FSQ as JFSQ
from edge_diffusion_tts_tpu.models.fsq import FSQEncoder as JFSQEncoder
from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.models.hubert import HubertEncoder as JHubert
from edge_diffusion_tts_tpu.models.hubert import _FeatureExtractor as JFeatureExtractor
from edge_diffusion_tts_tpu.models.hubert import load_hubert_params_from_torch
from edge_diffusion_tts_tpu.models.vq import VectorQuantizer as JVQ
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.models import FSQ, FSQEncoder, SemanticEncoder, VectorQuantizer
from edge_diffusion_tts_tpu_torch.models.encoder import is_hubert_param
from edge_diffusion_tts_tpu_torch.models.hubert import HubertConfig as PHC
from edge_diffusion_tts_tpu_torch.models.hubert import HubertEncoder as PHubert
from edge_diffusion_tts_tpu_torch.models.hubert import conv_frame_lengths
from edge_diffusion_tts_tpu_torch.models.hubert import FeatureExtractor as PFeatureExtractor
from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
from edge_diffusion_tts_tpu_torch.weights import (
    encoder_state_dict_from_jax,
    hubert_state_dict_from_hf,
    state_dict_from_jax,
)

LEVELS = (4, 4, 3, 3, 2, 2, 2, 2)
KEY = jax.random.PRNGKey(0)


def _jitter(tree, seed):
    """Every leaf + 0.02 N(0, 1), so biases and norm affines are nontrivial."""
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(
        treedef, [p + 0.02 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])


def _port_cfg(hc: JHC) -> PHC:
    return PHC.from_json(hc.to_json())


def _hubert_sd(params):
    """JAX HubertEncoder params -> the port HubertEncoder's state dict."""
    sd = encoder_state_dict_from_jax({"params": {"hubert": params}})
    return {k[len("hubert."):]: v for k, v in sd.items()}


def _wav(shape, seed):
    return (0.2 * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


# ---- FSQ and VQ ----------------------------------------------------------------


def test_fsq_quantize_and_index_maps_match_jax():
    jf, pf = JFSQ(LEVELS), FSQ(LEVELS)
    rng = np.random.RandomState(0)
    z = np.tanh(1.5 * rng.randn(3, 40, 8)).astype(np.float32)
    # Exact half-way points of the 3- and 2-level dims: round half to even.
    z[0, 0, 2:] = [-0.5, 0.5, 0.0, 0.0, 0.0, 0.0]
    z[0, 1, 2:] = [0.5, -0.5, 0.0, -1.0, 1.0, 0.0]
    want = np.asarray(jf.apply({}, jnp.asarray(z), method=JFSQ.quantize))
    got = pf.quantize(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, want)

    zt = torch.from_numpy(z)
    j_zq, j_idx = jf.apply({}, jnp.asarray(z))
    p_zq, p_idx = pf(zt)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(p_zq.numpy(), np.asarray(j_zq), atol=1e-6, rtol=0)

    all_idx = np.arange(pf.codebook_size)
    codes = np.array(jf.apply({}, jnp.asarray(all_idx), method=JFSQ.indices_to_codes))
    np.testing.assert_array_equal(pf.indices_to_codes(torch.from_numpy(all_idx)).numpy(), codes)
    back = pf.codes_to_indices(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(back, all_idx)
    assert pf.codebook_size == 2304 and pf.dim == 8


def test_fsq_encoder_matches_jax():
    jenc = JFSQEncoder(16, LEVELS)
    z = np.random.RandomState(1).randn(2, 30, 16).astype(np.float32)
    params = _jitter(jenc.init(KEY, jnp.asarray(z))["params"], 2)
    penc = FSQEncoder(16, LEVELS)
    penc.load_state_dict(state_dict_from_jax(params))
    want = jenc.apply({"params": params}, jnp.asarray(z))
    with torch.no_grad():
        got = penc(torch.from_numpy(z))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[2].item() == 0.0
        np.testing.assert_allclose(got[3].item(), float(want[3]), rtol=1e-6)
        assert got[4].item() == int(want[4])
        idx = penc.encode(torch.from_numpy(z)).numpy()
        np.testing.assert_array_equal(
            idx, np.asarray(jenc.apply({"params": params}, jnp.asarray(z), method=jenc.encode)))
        dec = penc.decode(torch.from_numpy(idx)).numpy()
    want_dec = jenc.apply({"params": params}, jnp.asarray(idx), method=jenc.decode)
    np.testing.assert_allclose(dec, np.asarray(want_dec), atol=1e-6, rtol=0)


def test_vq_inference_matches_jax():
    jvq = JVQ(8, 32)
    z = np.random.RandomState(3).randn(2, 20, 8).astype(np.float32)
    variables = jvq.init({"params": KEY, "vq": KEY}, jnp.asarray(z))
    pvq = VectorQuantizer(8, 32)
    pvq.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in variables["vq_state"].items()})
    want = jvq.apply(variables, jnp.asarray(z), train=False)
    got = pvq(torch.from_numpy(z))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[3].item(), float(want[3]), rtol=1e-6)
    assert got[2].item() == 0.0 and got[4].item() == int(want[4])
    idx = pvq.encode(torch.from_numpy(z))
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jvq.apply(variables, jnp.asarray(z), method=jvq.encode)))
    np.testing.assert_array_equal(
        pvq.decode(idx).numpy(),
        np.asarray(jvq.apply(variables, jnp.asarray(idx.numpy()), method=jvq.decode)))
    # train=True is the training half now (held against JAX in
    # test_torch_training_losses.py): a finite loss and one EMA update.
    loss = pvq(torch.from_numpy(z), train=True, generator=torch.Generator().manual_seed(0))[2]
    assert torch.isfinite(loss) and loss.item() > 0 and pvq.update_count.item() == 1


# ---- HuBERT -----------------------------------------------------------------------


@pytest.mark.parametrize("name,samples", [("tiny", 1600), ("tiny320", 3200)])
def test_hubert_hidden_states_match_jax(name, samples):
    jcfg = getattr(JHC, name)()
    wav = _wav((2, samples), 4)
    jenc = JHubert(jcfg)
    params = _jitter(jenc.init(KEY, jnp.asarray(wav))["params"], 5)
    want = jenc.apply({"params": params}, jnp.asarray(wav))
    penc = PHubert(_port_cfg(jcfg)).eval()
    penc.load_state_dict(_hubert_sd(params))
    with torch.no_grad():
        got = penc(torch.from_numpy(wav))
        assert len(got) == len(want) == jcfg.num_layers + 1
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0,
                                       err_msg=f"hidden_states[{i}]")
        top = penc.extract_layer(torch.from_numpy(wav), 1)
    np.testing.assert_allclose(top.numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    assert penc.cfg.total_stride == jcfg.total_stride


def test_hubert_masked_batched_lengths_match_jax():
    """Per-row wav_len (as tests/test_hubert.py::test_masked_forward_batched_lengths):
    the port's padded batch equals JAX's, and each row equals its own solo
    exact-length forward on its valid frames (zeros beyond)."""
    jcfg = JHC.tiny()
    lens = (1200, 1600)
    rng = np.random.RandomState(6)
    batch = np.zeros((2, 1600), np.float32)
    for i, L in enumerate(lens):
        batch[i, :L] = rng.randn(L)
    jenc = JHubert(jcfg)
    params = _jitter(jenc.init(KEY, jnp.asarray(batch))["params"], 7)
    want = jenc.apply({"params": params}, jnp.asarray(batch), wav_len=jnp.asarray(lens))
    penc = PHubert(_port_cfg(jcfg)).eval()
    penc.load_state_dict(_hubert_sd(params))
    with torch.no_grad():
        got = penc(torch.from_numpy(batch), wav_len=torch.tensor(lens))
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0,
                                       err_msg=f"hidden_states[{i}]")
        for i, L in enumerate(lens):
            solo = penc(torch.from_numpy(batch[i:i + 1, :L]))[-1]
            n = conv_frame_lengths(penc.cfg, L)[-1]
            np.testing.assert_allclose(got[-1][i:i + 1, :n].numpy(), solo.numpy(),
                                       atol=1e-5, rtol=1e-5)
            assert (got[-1][i, n:] == 0).all()


def test_hubert_config_json_round_trip():
    for cfg in (PHC(), PHC.tiny(), PHC.tiny320()):
        assert PHC.from_json(cfg.to_json()) == cfg
        assert JHC.from_json(cfg.to_json()).to_json() == cfg.to_json()
    assert PHC().total_stride == 320 and PHC.tiny().total_stride == 20


# ---- the conv frontend's plain version ----------------------------------------------


@pytest.fixture(scope="module")
def base_frontend():
    """Full hubert-base conv specs: JAX _FeatureExtractor params and the
    port's packed frontend weights from them."""
    fe = JFeatureExtractor(JHC())
    params = _jitter(fe.init(KEY, jnp.zeros((1, 8000)))["params"], 9)
    pfe = PFeatureExtractor(PHC())
    sd = encoder_state_dict_from_jax({"params": {"hubert": {"feature_extractor": params}}})
    pfe.load_state_dict({k[len("hubert.feature_extractor."):]: v for k, v in sd.items()})
    return fe, params, pfe, ff.pack_frontend_weights(pfe)


@pytest.mark.parametrize("shape,frames", [((2, 8000), 24), ((1, 32000), 99)])
def test_frontend_plain_matches_jax_feature_extractor(base_frontend, shape, frames):
    fe, params, pfe, w = base_frontend
    wav = _wav(shape, shape[1])
    want = np.asarray(fe.apply({"params": params}, jnp.asarray(wav)))
    before = ff.conv_frontend.launches
    got = ff.conv_frontend(torch.from_numpy(wav), w)
    assert ff.conv_frontend.launches == before  # CPU tensors never reach the kernel
    assert got.shape == want.shape == (shape[0], frames, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    with torch.no_grad():  # the module route (exact GroupNorm) agrees as well
        np.testing.assert_allclose(pfe(torch.from_numpy(wav)).numpy(), want,
                                   atol=2e-4, rtol=1e-3)
    assert ff.frame_counts(shape[1])[-1] == frames


@pytest.mark.slow
def test_frontend_plain_matches_jax_pallas_interpret(base_frontend):
    from edge_diffusion_tts_tpu.ops.fused_frontend import fused_conv_frontend

    _, params, _, w = base_frontend
    wav = _wav((2, 8000), 10)
    want = fused_conv_frontend(JHC(), params, jnp.asarray(wav), interpret=True,
                               compute_dtype=jnp.float32)
    got = ff.conv_frontend(torch.from_numpy(wav), w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)


def test_frontend_rejects_other_specs_and_short_audio():
    with pytest.raises(ValueError, match="hubert-base"):
        ff.pack_frontend_weights(PFeatureExtractor(PHC.tiny320()))
    w = ff.pack_frontend_weights(PFeatureExtractor(PHC()))
    assert w["wk3"].shape == (4, 512, 1536) and w["wk2"].shape == (2, 512, 1024)
    with pytest.raises(ValueError, match="no frame"):
        ff.conv_frontend(torch.zeros(1, 399), w)


# ---- SemanticEncoder ---------------------------------------------------------------


def _encoders(use_fsq=True):
    """The config of tests/test_fused_frontend.py::test_fast_encode_matches_encode:
    full conv specs, a 2-layer 64-wide transformer."""
    kw = dict(hidden=32, layers=1, heads=2, dropout=0.0, use_fsq=use_fsq, codebook_size=64)
    jcfg, pcfg = JCFG(**kw), PCFG(**kw)
    hc = JHC(num_layers=2, hidden_size=64, num_heads=2, intermediate_size=128)
    jenc = JEncoder(jcfg, hc)
    wav = _wav((2, 8000), 11)
    variables = jenc.init({"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(5),
                           "vq": jax.random.PRNGKey(6)}, jnp.asarray(wav), train=False)
    variables = dict(variables, params=_jitter(variables["params"], 12))
    penc = SemanticEncoder(pcfg, _port_cfg(hc)).eval()
    penc.load_state_dict(encoder_state_dict_from_jax(variables))
    return jenc, variables, penc, wav


def test_fast_encode_tokens_match_jax_encode():
    jenc, variables, penc, wav = _encoders()
    want = np.asarray(jenc.apply(variables, jnp.asarray(wav), method=jenc.encode))
    before = ff.conv_frontend.launches
    got = ff.fast_encode(penc, torch.from_numpy(wav),
                         ff.pack_frontend_weights(penc.hubert.feature_extractor))
    assert ff.conv_frontend.launches == before
    assert got.shape == want.shape == (2, 24)
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.no_grad():
        np.testing.assert_array_equal(penc.encode(torch.from_numpy(wav)).numpy(), want)
        feats = penc.decode_tokens(got)
    want_feats = jenc.apply(variables, jnp.asarray(want), method=jenc.decode_tokens)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_fsq", [True, False])
def test_semantic_encoder_call_with_wav_len_matches_jax(use_fsq):
    jenc, variables, penc, wav = _encoders(use_fsq)
    wav[1, 6000:] = 0.0
    lens = np.array([8000, 6000])
    want = jenc.apply(variables, jnp.asarray(wav), wav_len=jnp.asarray(lens))
    with torch.no_grad():
        got = penc(torch.from_numpy(wav), wav_len=torch.from_numpy(lens))
        feats = penc.from_features(penc.extract_hubert(torch.from_numpy(wav)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2].item() == float(want[2])
    np.testing.assert_allclose(got[3].item(), float(want[3]), rtol=1e-5)
    assert got[4].item() == int(want[4])
    n = conv_frame_lengths(penc.hubert_cfg, 6000)[-1]
    assert (got[1][1, n:] == 0).all() and (got[0][1, n:] == 0).all()
    want_ff = jenc.apply(variables, jenc.apply(variables, jnp.asarray(wav),
                                               method=jenc.extract_hubert),
                         method=jenc.from_features)
    np.testing.assert_array_equal(feats[1].numpy(), np.asarray(want_ff[1]))


# ---- weight bridges ------------------------------------------------------------------


def test_encoder_bridge_round_trip():
    """JAX encoder params -> port state dict -> the JAX package's own HF-key
    converter -> the original HuBERT params, leaf for leaf."""
    _, variables, penc, _ = _encoders()
    hc = JHC(num_layers=2, hidden_size=64, num_heads=2, intermediate_size=128)
    back = load_hubert_params_from_torch(penc.hubert.state_dict(), hc)["params"]
    orig = variables["params"]["hubert"]
    flat_a = jax.tree_util.tree_flatten_with_path(orig)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    names = list(penc.state_dict())
    assert "hubert.feature_extractor.conv_layers.0.layer_norm.weight" in names
    assert "hubert.encoder.layers.1.feed_forward.output_dense.bias" in names
    assert {n for n in names if not is_hubert_param(n)} == {
        f"{m}.{p}" for m in ("proj_fc1", "proj_ln", "proj_fc2", "vq.proj_down", "vq.proj_up")
        for p in ("weight", "bias")}
    _, vq_vars, vq_enc, _ = _encoders(use_fsq=False)
    np.testing.assert_array_equal(vq_enc.vq.codebook.numpy(),
                                  np.asarray(vq_vars["vq_state"]["vq"]["codebook"]))


@pytest.mark.parametrize("form", ["weight_g", "parametrizations"])
def test_hf_state_dict_loader(form):
    """A synthetic HF ``HubertModel`` state dict (weight-normed positional
    conv, an extra ``masked_spec_embed``) loads into the port, which then
    matches the JAX encoder loaded from the same dict by the JAX package's
    ``load_hubert_params_from_torch``."""
    cfg = PHC.tiny()
    rng = np.random.RandomState(13)
    hf = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.3)
          for k, v in PHubert(cfg).state_dict().items()}
    pos = "encoder.pos_conv_embed.conv"
    del hf[f"{pos}.weight"]
    k = cfg.num_conv_pos_embeddings
    g = torch.from_numpy(rng.rand(1, 1, k).astype(np.float32) + 0.5)
    v = torch.from_numpy(rng.randn(cfg.hidden_size, cfg.hidden_size // 4, k).astype(np.float32))
    if form == "parametrizations":
        hf[f"{pos}.parametrizations.weight.original0"] = g
        hf[f"{pos}.parametrizations.weight.original1"] = v
    else:
        hf[f"{pos}.weight_g"], hf[f"{pos}.weight_v"] = g, v
    hf["masked_spec_embed"] = torch.zeros(cfg.hidden_size)

    penc = PHubert(cfg).eval()
    penc.load_state_dict(hubert_state_dict_from_hf(hf, cfg))
    jcfg = JHC.tiny()
    jparams = load_hubert_params_from_torch(
        {n.replace("parametrizations.weight.original0", "weight_g")
          .replace("parametrizations.weight.original1", "weight_v"): t
         for n, t in hf.items()}, jcfg)
    wav = _wav((1, 1600), 14)
    want = JHubert(jcfg).apply(jparams, jnp.asarray(wav))[-1]
    with torch.no_grad():
        got = penc(torch.from_numpy(wav))[-1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(KeyError, match="lacks"):
        hubert_state_dict_from_hf({n: t for n, t in hf.items() if "layers.1." not in n}, cfg)
