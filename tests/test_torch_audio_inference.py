"""Port parity: EdgeInference.generate_from_audio end to end vs the JAX package.

wav -> SemanticEncoder tokens (the port through ``fast_encode``, i.e. the
conv frontend's plain version on the CPU; JAX through its module path) ->
4-step DDIM over a small decoder.  JAX draws its start noise from
``PRNGKey(k)``; the port is handed the same numbers as ``x_T``.  The
encoder has the full hubert-base conv stack under a 2-layer, 64-wide
transformer (the config of tests/test_fused_frontend.py).  Tolerance 1e-4,
as for generate_mel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.inference import EdgeInference as JInference
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models import SemanticEncoder as JEncoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference as PInference
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.models import HubertConfig as PHC
from edge_diffusion_tts_tpu_torch.models import SemanticEncoder as PEncoder
from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule as PSchedule
from edge_diffusion_tts_tpu_torch.weights import encoder_state_dict_from_jax, state_dict_from_jax

SMALL = dict(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8)
HUBERT = dict(num_layers=2, hidden_size=64, num_heads=2, intermediate_size=128)


def _jitter(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(
        treedef, [p + 0.02 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = JCFG(**SMALL), PCFG(**SMALL)
    jdec = JDecoder(jcfg)
    dparams = _jitter(init_decoder_params(jdec, jax.random.PRNGKey(0), jcfg)["params"], 5)
    pdec = PDecoder(pcfg)
    pdec.load_state_dict(state_dict_from_jax(dparams, pcfg))

    jenc = JEncoder(jcfg, JHC(**HUBERT))
    wav0 = jnp.zeros((1, 8000))
    evars = jenc.init({"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(5),
                       "vq": jax.random.PRNGKey(6)}, wav0, train=False)
    evars = dict(evars, params=_jitter(evars["params"], 12))
    penc = PEncoder(pcfg, PHC(**HUBERT))
    penc.load_state_dict(encoder_state_dict_from_jax(evars))
    dec_apply = lambda p, x, t, **kw: jdec.apply({"params": p}, x, t, **kw)
    enc_apply = lambda v, wav: jenc.apply(v, wav, method=jenc.encode)
    return jcfg, pcfg, dec_apply, dparams, pdec, enc_apply, evars, penc


@pytest.mark.parametrize("prediction,shape", [("eps", (1, 8000)), ("v", (2, 6400)),
                                              ("eps", (6400,))])
def test_generate_from_audio_matches_jax(models, prediction, shape):
    jcfg, pcfg, dec_apply, dparams, pdec, enc_apply, evars, penc = models
    wav = (0.2 * np.random.RandomState(sum(shape)).randn(*shape)).astype(np.float32)
    k = 3
    ref = JInference(jcfg, JSchedule.create(jcfg.diff_steps), dec_apply, dparams,
                     encoder_apply=enc_apply, encoder_params=evars, prediction=prediction)
    want = np.asarray(ref.generate_from_audio(jnp.asarray(wav), num_steps=4,
                                              rng=jax.random.PRNGKey(k)))
    B, T = want.shape[:2]
    x_T = np.array(jax.random.normal(jax.random.PRNGKey(k), (B, T, 80)))

    port = PInference(pcfg, PSchedule.create(pcfg.diff_steps), pdec, prediction=prediction,
                      device="cpu", encoder=penc)
    before = ff.conv_frontend.launches
    got = port.generate_from_audio(wav, num_steps=4, x_T=x_T)
    assert ff.conv_frontend.launches == before  # CPU tensors never reach the kernel
    assert got.shape == want.shape == (B, 2 * ff.frame_counts(shape[-1])[-1], 80)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_generate_from_audio_fused_backend_and_errors(models):
    _, pcfg, _, _, pdec, _, _, penc = models
    wav = (0.2 * np.random.RandomState(1).randn(1, 6400)).astype(np.float32)
    out = {
        backend: PInference(pcfg, PSchedule.create(pcfg.diff_steps), pdec, backend=backend,
                            device="cpu", encoder=penc).generate_from_audio(
            wav, num_steps=2, generator=torch.Generator().manual_seed(3), temperature=0.7)
        for backend in ("eager", "fused")
    }
    torch.testing.assert_close(out["fused"], out["eager"], atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="without an encoder"):
        PInference(pcfg, PSchedule.create(pcfg.diff_steps), pdec,
                   device="cpu").generate_from_audio(wav)
    with pytest.raises(ValueError, match="hubert-base"):  # never rerouted to the modules
        PInference(pcfg, PSchedule.create(pcfg.diff_steps), pdec, device="cpu",
                   encoder=PEncoder(pcfg, PHC.tiny320()))
