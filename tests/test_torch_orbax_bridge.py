"""The orbax -> port recipe end to end: a JAX final model written by the JAX
package's ``save_final_model`` (orbax), read back with ``restore_final_model``,
carried across with ``weights.state_dict_from_jax`` /
``encoder_state_dict_from_jax``, written with ``weights.save_checkpoint`` and
read with ``weights.load_checkpoint``.  The port's ``generate_mel`` (JAX's
start noise injected as ``x_T``) and ``generate_from_audio`` then equal the
JAX package's on its own restored model (1e-4, as for generate_mel; both
sample with DPM-Solver++, which starts at t=950 and is well conditioned).
An FSQ model and a VQ model (its codebook rides in ``vq_state``).

The conversion needs JAX and orbax, so it lives here and in the README, not
in the port package.  ``port_checkpoint_from_jax`` is shared with
tests/test_torch_demo_cli.py.
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
from edge_diffusion_tts_tpu.training.checkpoint import (
    encoder_variables,
    restore_final_model,
    restore_hubert_config,
    save_final_model,
)
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference as PInference
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.models import HubertConfig as PHC
from edge_diffusion_tts_tpu_torch.models import SemanticEncoder as PEncoder
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule as PSchedule
from edge_diffusion_tts_tpu_torch.weights import (
    encoder_state_dict_from_jax,
    load_checkpoint,
    save_checkpoint,
    state_dict_from_jax,
)

SMALL = dict(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8)
# The hubert-base conv stack (the frontend kernel's route) under a small transformer.
HUBERT = dict(num_layers=2, hidden_size=64, num_heads=2, intermediate_size=128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the small calls here are launch-bound, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jitter(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.randn(*np.shape(a))
                        .astype(np.float32), tree)


def write_jax_final_model(path: str, **cfg_kw):
    """A JAX final model (perturbed random weights) saved by the JAX package;
    the inits are jitted (eager, each takes seconds on the CPU)."""
    jcfg = JCFG(**dict(SMALL, **cfg_kw))
    dec, enc = JDecoder(jcfg), JEncoder(jcfg, JHC(**HUBERT))
    dparams = jax.jit(lambda: init_decoder_params(dec, jax.random.PRNGKey(0), jcfg)["params"])()
    evars = jax.jit(lambda: enc.init({"params": jax.random.PRNGKey(4),
                                      "dropout": jax.random.PRNGKey(5),
                                      "vq": jax.random.PRNGKey(6)},
                                     jnp.zeros((1, 8000)), train=False))()
    params = {"encoder": _jitter(evars["params"], 12), "decoder": _jitter(dparams, 5)}
    vq_state = {"encoder": jax.device_get(evars["vq_state"])} if "vq_state" in evars else None
    save_final_model(path, params, jcfg, vq_state=vq_state, hubert_cfg=JHC(**HUBERT))


def port_checkpoint_from_jax(jax_dir: str, port_dir: str) -> None:
    """The recipe: restore the JAX final model, bridge it, save it for the port."""
    params, jcfg = restore_final_model(jax_dir)
    cfg = PCFG.from_json(jcfg.to_json())
    decoder = PDecoder(cfg)
    decoder.load_state_dict(state_dict_from_jax(params["decoder"], cfg))
    encoder = PEncoder(cfg, PHC.from_json(restore_hubert_config(jax_dir).to_json()))
    encoder.load_state_dict(encoder_state_dict_from_jax(encoder_variables(params)))
    save_checkpoint(port_dir, cfg, decoder, encoder)


@pytest.mark.parametrize("use_fsq", [True, False])
def test_orbax_final_model_to_port_checkpoint(tmp_path, use_fsq):
    jdir, pdir = str(tmp_path / "jax_final"), str(tmp_path / "port_final")
    write_jax_final_model(jdir, use_fsq=use_fsq)
    port_checkpoint_from_jax(jdir, pdir)

    params, jcfg = restore_final_model(jdir)
    jdec, jenc = JDecoder(jcfg), JEncoder(jcfg, restore_hubert_config(jdir))
    ref = JInference(jcfg, JSchedule.create(jcfg.diff_steps),
                     lambda p, x, t, **kw: jdec.apply({"params": p}, x, t, **kw),
                     params["decoder"],
                     encoder_apply=lambda v, w: jenc.apply(v, w, method=jenc.encode),
                     encoder_params=encoder_variables(params), prediction="v",
                     sampler="dpmpp")

    cfg, dec_sd, hubert_cfg, enc_sd = load_checkpoint(pdir, with_encoder=True)
    assert cfg.use_fsq == use_fsq and cfg.hidden == 32
    decoder, encoder = PDecoder(cfg), PEncoder(cfg, hubert_cfg)
    decoder.load_state_dict(dec_sd)
    encoder.load_state_dict(enc_sd)
    if not use_fsq:
        np.testing.assert_array_equal(
            enc_sd["vq.codebook"].numpy(),
            np.asarray(params["vq_state"]["encoder"]["vq"]["codebook"]))
    port = PInference(cfg, PSchedule.create(cfg.diff_steps), decoder, prediction="v",
                      sampler="dpmpp", device="cpu", encoder=encoder)

    sem = np.random.RandomState(0).randint(0, cfg.effective_codebook_size(), (2, 30))
    want = np.asarray(ref.generate_mel(jnp.asarray(sem), num_steps=4, rng=jax.random.PRNGKey(3)))
    x_T = np.array(jax.random.normal(jax.random.PRNGKey(3), want.shape))
    got = port.generate_mel(sem, num_steps=4, x_T=x_T).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    wav = (0.2 * np.random.RandomState(1).randn(1, 6400)).astype(np.float32)
    want = np.asarray(ref.generate_from_audio(jnp.asarray(wav), num_steps=4,
                                              rng=jax.random.PRNGKey(4)))
    x_T = np.array(jax.random.normal(jax.random.PRNGKey(4), want.shape))
    assert port.encode_route == "kernel"
    got = port.generate_from_audio(torch.from_numpy(wav), num_steps=4, x_T=x_T).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
