"""Port parity: the fused DDIM/DDPM loops with the depthwise pre-net
(``use_depthwise=True``, the setting of every config under configs/).

The model those configs define is ``h = in_proj(x); h = h + pre_conv(h);
h = pos_emb(h)``, which the JAX package computes on its XLA path
(``EdgeInference(backend="xla")``, ``EdgeDiffusionDecoder.apply``).  JAX's
fused Pallas kernel leaves the pre-net out (ROADMAP Queue C item 1), so the
port's fused loops are held to JAX's XLA path, not to JAX's kernel; the last
test pins that divergence.  On the CPU ``fused_ddim``/``fused_ddpm`` run
their plain versions, in the kernels' order.  Small config: hidden 32, 2
layers, 2 heads, window 8; weights from JAX's ``init_decoder_params`` plus a
0.02 perturbation, bridged by ``weights.state_dict_from_jax``.  Bars: 1e-4
(the JAX kernel's own), the DDPM oracle's rtol 1e-4 atol 1e-3 (its
recurrence grows to O(1e3)), and at the flagship shape the mean |mel
difference| < 5e-4 of tests/test_torch_inference.py (there the first step's
division by sqrt(alpha_bar[999]) turns last-bit differences into isolated
jumps).  The CUDA kernels against these plain versions are in
test_torch_kernels_gpu.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.inference import EdgeInference as JInference
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.ops.fused_denoise import fused_generate_mel as jfused
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference as PInference
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.ops import fused_denoise as pf
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule as PSchedule
from edge_diffusion_tts_tpu_torch.weights import state_dict_from_jax

SMALL = dict(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8,
             use_depthwise=True)
CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")


def _bridge(jcfg, pcfg, init_key, perturb_key):
    jdec = JDecoder(jcfg)
    params = init_decoder_params(jdec, jax.random.PRNGKey(init_key), jcfg)["params"]
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(perturb_key), len(leaves))
    params = jax.tree.unflatten(
        tree, [p + 0.02 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)]
    )
    pdec = PDecoder(pcfg)
    pdec.load_state_dict(state_dict_from_jax(params, pcfg))
    apply = lambda p, x, t, **kw: jdec.apply({"params": p}, x, t, **kw)
    return jdec, apply, params, pdec.eval()


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = JCFG(**SMALL), PCFG(**SMALL)
    jdec, apply, params, pdec = _bridge(jcfg, pcfg, 0, 5)
    assert "pre_conv" in params  # the pre-net is in the model under test
    return jcfg, pcfg, jdec, apply, params, pdec


def _jax_xla(jcfg, apply, params, sem_idx, steps, prediction, key):
    ref = JInference(jcfg, JSchedule.create(jcfg.diff_steps), apply, params,
                     prediction=prediction, backend="xla")
    return np.asarray(ref.generate_mel(jnp.asarray(sem_idx), num_steps=steps,
                                       rng=jax.random.PRNGKey(key)))


@pytest.mark.parametrize("steps,prediction", [(1, "eps"), (4, "eps"), (1, "v"), (4, "v")])
def test_fused_generate_mel_matches_jax_xla(setup, steps, prediction):
    """The port's fused ``generate_mel`` on JAX's own start noise (its
    ``PRNGKey`` draw handed over as ``x_T``) = JAX's XLA path, 1e-4."""
    jcfg, pcfg, _, apply, params, pdec = setup
    B, S, k = 2, 12, 3
    sem_idx = np.random.RandomState(1).randint(0, 2304, size=(B, S))
    want = _jax_xla(jcfg, apply, params, sem_idx, steps, prediction, k)
    x_T = np.asarray(jax.random.normal(jax.random.PRNGKey(k), (B, 2 * S, 80)))
    port = PInference(pcfg, PSchedule.create(pcfg.diff_steps), pdec, prediction=prediction,
                      backend="fused", device="cpu")
    assert set(pf.PRENET_NAMES) <= set(port.fused_weights)
    before = pf.fused_ddim.launches
    got = port.generate_mel(sem_idx, num_steps=steps, x_T=x_T)
    assert pf.fused_ddim.launches == before  # CPU tensors never reach the kernel
    assert got.shape == (B, 2 * S, 80)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("T", [13, 1])
def test_decoder_step_with_prenet_odd_T_matches_jax_apply(setup, T):
    """One decoder forward (``decoder_step_plain``, the kernels' order) at
    B=2 and an odd T (and T=1, where both taps fall outside): the depthwise
    taps stop at each batch row's edges as JAX's SAME conv does, 1e-4."""
    jcfg, pcfg, jdec, _, params, pdec = setup
    B, S, t = 2, 7, 500
    rng = np.random.RandomState(3)
    sem_idx = rng.randint(0, 2304, size=(B, S))
    x = rng.randn(B, T, 80).astype(np.float32)
    want = np.asarray(jdec.apply({"params": params}, jnp.asarray(x), jnp.full((B,), t),
                                 sem_idx=jnp.asarray(sem_idx),
                                 step_idx=jnp.zeros((B,), jnp.int32)))
    with torch.no_grad():
        loop = pf.prepare_loop_inputs(pdec, torch.from_numpy(sem_idx), T, [t])
        got = pf.decoder_step_plain(torch.from_numpy(x), loop["pos"], loop["mods"][0],
                                    loop["ckv"], pf.pack_decoder_weights(pdec),
                                    heads=pcfg.heads, window=pcfg.attn_window_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("T", [13, 1])
def test_prenet_plain_matches_the_module(setup, T):
    """``decoder_prenet_plain`` = the decoder's own prelude (in_proj, then
    ``h + pre_conv(h)``, then the positional rows) on the same h, 1e-5."""
    _, _, _, _, _, pdec = setup
    x = torch.from_numpy(np.random.RandomState(4).randn(2, T, 80).astype(np.float32))
    w = pf.pack_decoder_weights(pdec)
    with torch.no_grad():
        h = pdec.in_proj(x)
        want = pdec.pos_emb(h + pdec.pre_conv(h))
        got = pf.decoder_prenet_plain(h, pdec.pos_emb.table[:T], w)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _flagship():
    with open(os.path.join(CONFIGS, "flagship.json")) as f:
        d = dict(json.load(f), dropout=0.0)
    return JCFG.from_dict(d), PCFG.from_dict(d)


def test_flagship_fused_generate_mel_matches_jax_xla():
    """configs/flagship.json's decoder (pre-net on, v prediction as it
    trains), B=1, S=250 -> T=500, 4 steps: the port's fused output against
    JAX's XLA path, mean |diff| < 5e-4."""
    jcfg, pcfg = _flagship()
    assert jcfg.use_depthwise and pcfg.use_depthwise and pcfg.use_v_prediction
    _, apply, params, pdec = _bridge(jcfg, pcfg, 7, 8)
    sem_idx = np.random.RandomState(42).randint(0, 2304, size=(1, 250))
    want = _jax_xla(jcfg, apply, params, sem_idx, 4, "v", 0)
    x_T = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 500, 80)))
    port = PInference(pcfg, PSchedule.create(pcfg.diff_steps), pdec, prediction="v",
                      backend="fused", device="cpu")
    got = port.generate_mel(sem_idx, num_steps=4, x_T=x_T).numpy()
    assert got.shape == (1, 500, 80)
    assert np.abs(got - want).mean() < 5e-4


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_fused_ddpm_plain_with_prenet_matches_jax_oracle(setup, prediction):
    """``fused_ddpm_plain`` with the pre-net over an 8-step schedule with
    injected noise = ``ddpm_step``'s update driven by JAX's XLA decoder
    apply on the same noise (the oracle of tests/test_torch_ddpm.py, which
    here does not go through JAX's kernel and its missing pre-net)."""
    jcfg, pcfg, jdec, _, params, pdec = setup
    sched = JSchedule.create(8)
    B, S = 2, 12
    rng = np.random.RandomState(11)
    sem_idx = rng.randint(0, 2304, size=(B, S))
    x_T = rng.randn(B, 2 * S, 80).astype(np.float32)
    noise = rng.randn(B, 8, 2 * S, 80).astype(np.float32)
    x = jnp.asarray(x_T)
    for i, t in enumerate(range(sched.T - 1, -1, -1)):
        t_b = jnp.full((B,), t, jnp.int32)
        out = jdec.apply({"params": params}, x, t_b, sem_idx=jnp.asarray(sem_idx),
                         step_idx=jnp.zeros((B,), jnp.int32))
        eps = sched.predict_eps_from_v(x, t_b, out) if prediction == "v" else out
        mean = (x - sched.betas[t] / jnp.sqrt(1.0 - sched.alpha_bar[t]) * eps) / jnp.sqrt(
            sched.alphas[t])
        x = mean + jnp.where(t > 0, jnp.sqrt(sched.posterior_variance[t]), 0.0) * noise[:, i]
    want = np.asarray(x)
    before = pf.fused_ddpm.launches
    got = pf.fused_ddpm_sample(pcfg, PSchedule.create(8), pdec, torch.from_numpy(sem_idx),
                               torch.from_numpy(x_T), prediction=prediction,
                               noise=torch.from_numpy(noise))
    assert pf.fused_ddpm.launches == before
    if prediction == "eps":
        assert np.abs(want).max() > 10.0  # the recurrence has grown: a relative check
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_jax_kernel_leaves_the_prenet_out(setup):
    """ROADMAP Queue C item 1, pinned: on the same weights and noise, JAX's
    fused Pallas kernel (interpret mode) differs from JAX's XLA path by more
    than the 1e-4 bar, because it never applies ``pre_conv``; the port's
    fused output equals the XLA path.  If JAX's kernel gains the pre-net,
    this test fails and the item can close."""
    jcfg, pcfg, _, apply, params, pdec = setup
    B, S, k, steps = 2, 12, 3, 4
    sem_idx = np.random.RandomState(1).randint(0, 2304, size=(B, S))
    xla = _jax_xla(jcfg, apply, params, sem_idx, steps, "eps", k)
    x_T = np.asarray(jax.random.normal(jax.random.PRNGKey(k), (B, 2 * S, 80)))
    jax_kernel = np.asarray(jfused(jcfg, JSchedule.create(jcfg.diff_steps), params,
                                   jnp.asarray(sem_idx), jnp.asarray(x_T), steps, "eps",
                                   interpret=True))
    port = pf.fused_generate_mel(pcfg, PSchedule.create(pcfg.diff_steps), pdec,
                                 torch.from_numpy(sem_idx), torch.from_numpy(x_T), steps,
                                 "eps").numpy()
    assert np.abs(jax_kernel - xla).max() > 1e-2
    np.testing.assert_allclose(port, xla, atol=1e-4, rtol=0)


def test_pack_prenet_refusals():
    """The pre-net's packing: names, shapes and float32 contiguity; a hidden
    width that is not a multiple of 8 and a pre-net kernel size other than 3
    are refused by name."""
    pdec = PDecoder(PCFG(**SMALL))
    w = pf.pack_decoder_weights(pdec)
    assert tuple(w) == pf.WEIGHT_NAMES + pf.PRENET_NAMES
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in w.values())
    torch.testing.assert_close(w["pc_dw"], pdec.pre_conv.depthwise.weight[:, 0, :])
    with pytest.raises(ValueError, match="multiple of 8"):
        pf.pack_decoder_weights(PDecoder(PCFG(**dict(SMALL, hidden=4, heads=1))))
    from edge_diffusion_tts_tpu_torch.layers.conv import DepthwiseSeparableConv

    pdec.pre_conv = DepthwiseSeparableConv(32, 32, kernel_size=5)
    with pytest.raises(ValueError, match="kernel of 3"):
        pf.pack_decoder_weights(pdec)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pf.decoder_prenet(torch.zeros(1, 4, 32), torch.zeros(4, 32), w)


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(CONFIGS) if f.endswith(".json")))
def test_fused_backend_builds_for_every_shipped_config(name):
    """Every config under configs/ (all AdaLN) builds ``EdgeInference(
    backend="fused")``, packs at the config's compute dtype, the pre-net
    exactly when it sets ``use_depthwise``, and answers a short request
    (finite, its shape); one decoder forward through the float32 packing
    (``decoder_step_plain``) = the module's forward on the same perturbed
    weights, 1e-4."""
    with open(os.path.join(CONFIGS, name)) as f:
        cfg = PCFG.from_dict(dict(json.load(f), dropout=0.0))
    assert cfg.use_adaln
    torch.manual_seed(0)
    dec = PDecoder(cfg).eval()
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn_like(p))
    fused = PInference(cfg, PSchedule.create(cfg.diff_steps), dec, backend="fused",
                       device="cpu")
    w = fused.fused_weights
    assert (set(pf.PRENET_NAMES) <= set(w)) == cfg.use_depthwise
    compute = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.compute_dtype]
    packed = pf.pack_decoder_weights(dec, compute)
    assert w.keys() == packed.keys() and all(torch.equal(w[k], packed[k]) for k in w)
    if compute != torch.float32:
        w = pf.pack_decoder_weights(dec)
    rng = np.random.RandomState(2)
    sem_idx = torch.from_numpy(rng.randint(0, cfg.effective_codebook_size(), size=(2, 4)))
    mel = fused.generate_mel(sem_idx, num_steps=2)
    assert mel.shape == (2, 8, cfg.n_mels) and torch.isfinite(mel).all()
    x = torch.from_numpy(rng.randn(2, 8, cfg.n_mels).astype(np.float32))
    with torch.no_grad():
        want = dec(x, torch.full((2,), 700), sem_idx=sem_idx,
                   step_idx=torch.zeros(2, dtype=torch.long))
        loop = pf.prepare_loop_inputs(dec, sem_idx, 8, [700])
        got = pf.decoder_step_plain(x, loop["pos"], loop["mods"][0], loop["ckv"], w,
                                    heads=cfg.heads, window=cfg.attn_window_size)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
