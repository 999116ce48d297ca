"""Port parity: config record and diffusion schedule vs the JAX package.

The schedule tables must be bit-identical; the samplers run a shared stub
model (a fixed linear map of x, t and step) with the same start noise and,
for DDPM, the same per-step draws, and agree to 1e-6.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu import config as jcfg
from edge_diffusion_tts_tpu import schedule as jsched
from edge_diffusion_tts_tpu_torch import config as pcfg
from edge_diffusion_tts_tpu_torch import schedule as psched

CONFIGS = sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.json"))
)


# ---- config -------------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_json_round_trip_matches_jax(path):
    with open(path) as f:
        text = f.read()
    port = pcfg.CFG.from_json(text)
    ref = jcfg.CFG.from_json(text)
    # run_name defaults to the clock: pin it so both records are comparable.
    port.run_name = ref.run_name
    assert port.to_dict() == ref.to_dict()
    again = pcfg.CFG.from_json(port.to_json())
    assert again.to_dict() == port.to_dict()
    assert port.effective_codebook_size() == ref.effective_codebook_size()
    assert port.segment_mel_frames == ref.segment_mel_frames
    assert port.segment_sem_frames == ref.segment_sem_frames


def test_config_fields_and_defaults_match_jax():
    pf = {f.name: f for f in dataclasses.fields(pcfg.CFG)}
    jf = {f.name: f for f in dataclasses.fields(jcfg.CFG)}
    assert list(pf) == list(jf)
    port, ref = pcfg.CFG(run_name="x"), jcfg.CFG(run_name="x")
    assert port.to_dict() == ref.to_dict()
    assert port.effective_codebook_size() == 2304
    assert [p.value for p in pcfg.TrainPhase] == [p.value for p in jcfg.TrainPhase]
    for n in (400, 16000, 32000, 123457):
        assert pcfg.hubert_num_frames(n) == jcfg.hubert_num_frames(n)


# ---- schedule tables ------------------------------------------------------------


@pytest.mark.parametrize("T", [1000, 8])
def test_schedule_tables_bit_identical(T):
    ref = jsched.DiffusionSchedule.create(T)
    port = psched.DiffusionSchedule.create(T)
    for name in psched._TABLES:
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )
    assert port.get_schedule_for_steps(4) == ref.get_schedule_for_steps(4)


def test_schedule_conversions_and_steps():
    ref = jsched.DiffusionSchedule.create(1000)
    port = psched.DiffusionSchedule.create(1000)
    rng = np.random.RandomState(0)
    x = rng.randn(3, 6, 5).astype(np.float32)
    e = rng.randn(3, 6, 5).astype(np.float32)
    t = np.array([999, 500, 3])
    tp = np.array([749, -1, 0])
    jt, pt = jnp.asarray(t, jnp.int32), torch.from_numpy(t)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    je, pe = jnp.asarray(e), torch.from_numpy(e)
    for name in ("predict_x0_from_eps", "predict_x0_from_v", "predict_eps_from_v"):
        np.testing.assert_allclose(
            getattr(port, name)(px, pt, pe).numpy(),
            np.asarray(getattr(ref, name)(jx, jt, je)), atol=1e-6, err_msg=name,
        )
    np.testing.assert_allclose(
        port.get_v_target(px, pe, pt).numpy(), np.asarray(ref.get_v_target(jx, je, jt)),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        port.q_sample(px, pt, pe)[0].numpy(), np.asarray(ref.q_sample(jx, jt, je)[0]),
        atol=1e-6,
    )
    for a, b in zip(
        port.get_ddim_step(px, pt, torch.from_numpy(tp), pe),
        ref.get_ddim_step(jx, jt, jnp.asarray(tp, jnp.int32), je),
    ):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # ddpm_step with an injected draw equals the JAX step's own draw.
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, x.shape))
    np.testing.assert_allclose(
        port.ddpm_step(px, pt, pe, noise=torch.from_numpy(noise)).numpy(),
        np.asarray(ref.ddpm_step(jx, jt, je, key)), atol=1e-6,
    )
    with pytest.raises(ValueError, match="Generator"):
        port.get_ddim_step(px, pt, torch.from_numpy(tp), pe, eta=0.5)


# ---- samplers with a shared stub model --------------------------------------------


def _stub(lib, gain=0.7):
    """out = gain x + 1e-3 t - 0.05 step, identical math in both frameworks."""

    def fn(x, t, step_idx):
        tf = t.astype(jnp.float32) if lib is jnp else t.float()
        sf = step_idx.astype(jnp.float32) if lib is jnp else step_idx.float()
        return gain * x + 1e-3 * tf[:, None, None] - 0.05 * sf[:, None, None]

    return fn


@pytest.fixture(scope="module")
def sched_pair():
    return jsched.DiffusionSchedule.create(1000), psched.DiffusionSchedule.create(1000)


@pytest.mark.parametrize("steps,prediction", [(1, "eps"), (4, "eps"), (4, "v"), (12, "v")])
def test_ddim_sample_matches_jax(sched_pair, steps, prediction):
    ref, port = sched_pair
    x_T = np.random.RandomState(steps).randn(2, 10, 6).astype(np.float32)
    a = psched.ddim_sample(port, _stub(torch), torch.from_numpy(x_T), steps, prediction)
    b = jsched.ddim_sample(ref, _stub(jnp), jnp.asarray(x_T), steps, prediction)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_ddpm_sample_injected_noise_matches_jax(prediction):
    ref, port = jsched.DiffusionSchedule.create(8), psched.DiffusionSchedule.create(8)
    x_T = np.random.RandomState(1).randn(2, 6, 4).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    # The JAX sampler splits its key once per step; draw the same numbers.
    key, draws = rng, []
    for _ in range(ref.T):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.normal(sub, x_T.shape))))
    # gain 1 reads pure noise as pure noise, so the unclamped recurrence
    # stays O(1) and 1e-6 is a float32-rounding bar, not a relative one.
    b = jsched.ddpm_sample(ref, _stub(jnp, 1.0), jnp.asarray(x_T), rng, prediction)
    a = psched.ddpm_sample(port, _stub(torch, 1.0), torch.from_numpy(x_T),
                           prediction=prediction, noise=draws)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_ddpm_sample_generator_is_deterministic():
    port = psched.DiffusionSchedule.create(8)
    x_T = torch.zeros(1, 4, 3)
    run = lambda seed: psched.ddpm_sample(
        port, _stub(torch), x_T, generator=torch.Generator().manual_seed(seed)
    )
    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    assert (run(0) - run(1)).abs().max() > 1e-6


@pytest.mark.parametrize("order", [1, 2, 3])
def test_dpm_solver_pp_matches_jax(sched_pair, order):
    ref, port = sched_pair
    x_T = np.random.RandomState(order).randn(2, 8, 6).astype(np.float32)
    js = jsched.DPMSolverPP(ref, order=order)
    ps = psched.DPMSolverPP(port, order=order)
    assert ps.get_time_steps(5, 950) == js.get_time_steps(5, 950)
    a, ia = ps.sample(_stub(torch), torch.from_numpy(x_T), 5, max_t=950,
                      return_intermediates=True)
    b, ib = js.sample(_stub(jnp), jnp.asarray(x_T), 5, max_t=950,
                      return_intermediates=True)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for u, v in zip(ia, ib):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), atol=1e-6)
