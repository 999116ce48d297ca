"""Port parity: full-schedule DDPM through the fused loop's plain version, and
the Philox4x32-10 generator that draws its noise on the card.

The oracle is the loop of tests/test_fused_denoise.py::test_fused_ddpm_matches_oracle:
the JAX decoder driven t = T-1 .. 0 with step_idx 0 and ddpm_step's update
with injected noise (made with numpy, handed to both packages).  An
untrained decoder's unclamped DDPM recurrence grows to O(1e3), so outputs
are held relatively: rtol 1e-4, atol 1e-3, the JAX kernel's own bar.  The
CUDA kernel against the plain version is in test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.ops import fused_denoise as pf
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule as PSchedule
from edge_diffusion_tts_tpu_torch.weights import state_dict_from_jax

SMALL = dict(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8)


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = JCFG(**SMALL), PCFG(**SMALL)
    jdec = JDecoder(jcfg)
    params = init_decoder_params(jdec, jax.random.PRNGKey(0), jcfg)["params"]
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    params = jax.tree.unflatten(
        tree, [p + 0.02 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)]
    )
    pdec = PDecoder(pcfg)
    pdec.load_state_dict(state_dict_from_jax(params, pcfg))
    return jcfg, pcfg, jdec, params, pdec.eval()


def _inputs(steps, B=2, S=12, seed=11):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 2304, size=(B, S)),
            rng.randn(B, 2 * S, 80).astype(np.float32),
            rng.randn(B, steps, 2 * S, 80).astype(np.float32))


def _jax_oracle(jdec, params, sched, sem_idx, x_T, noise, prediction):
    x = jnp.asarray(x_T)
    B = x.shape[0]
    for i, t in enumerate(range(sched.T - 1, -1, -1)):
        t_b = jnp.full((B,), t, jnp.int32)
        out = jdec.apply({"params": params}, x, t_b, sem_idx=jnp.asarray(sem_idx),
                         step_idx=jnp.zeros((B,), jnp.int32))
        eps = sched.predict_eps_from_v(x, t_b, out) if prediction == "v" else out
        mean = (x - sched.betas[t] / jnp.sqrt(1.0 - sched.alpha_bar[t]) * eps) / jnp.sqrt(
            sched.alphas[t])
        sigma = jnp.where(t > 0, jnp.sqrt(sched.posterior_variance[t]), 0.0)
        x = mean + sigma * noise[:, i]
    return np.asarray(x)


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_fused_ddpm_plain_matches_jax_oracle(setup, prediction):
    jcfg, pcfg, jdec, params, pdec = setup
    sem_idx, x_T, noise = _inputs(8)
    want = _jax_oracle(jdec, params, JSchedule.create(8), sem_idx, x_T, noise, prediction)
    before = pf.fused_ddpm.launches
    got = pf.fused_ddpm_sample(pcfg, PSchedule.create(8), pdec, torch.from_numpy(sem_idx),
                               torch.from_numpy(x_T), prediction=prediction,
                               noise=torch.from_numpy(noise))
    assert pf.fused_ddpm.launches == before  # CPU tensors never reach the kernel
    if prediction == "eps":
        assert np.abs(want).max() > 10.0  # the recurrence has grown: a relative check
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.slow
def test_fused_ddpm_plain_matches_jax_pallas_interpret(setup):
    from edge_diffusion_tts_tpu.ops.fused_denoise import fused_ddpm_sample

    jcfg, pcfg, _, params, pdec = setup
    sem_idx, x_T, noise = _inputs(8, seed=12)
    want = fused_ddpm_sample(jcfg, JSchedule.create(8), params, jnp.asarray(sem_idx),
                             jnp.asarray(x_T), noise=jnp.asarray(noise), interpret=True)
    got = pf.fused_ddpm_sample(pcfg, PSchedule.create(8), pdec, torch.from_numpy(sem_idx),
                               torch.from_numpy(x_T), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


def test_ddpm_coefficients():
    sched = PSchedule.create(1000)
    coef = pf.ddpm_coefficients(sched).numpy()
    assert coef.shape == (1000, 5) and coef.dtype == np.float32
    ab, a, b = (getattr(sched, n).numpy().astype(np.float64)
                for n in ("alpha_bar", "alphas", "betas"))
    np.testing.assert_allclose(coef[0, :4], [np.sqrt(ab[999]), np.sqrt(1 - ab[999]),
                                             1 / np.sqrt(a[999]), b[999] / np.sqrt(1 - ab[999])],
                               rtol=1e-6)
    assert coef[-1, 4] == 0.0 and (coef[:-1, 4] > 0).all()  # no noise at t = 0


# Random123's known-answer vectors for philox4x32_10.
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    got = pf.philox4x32_10(torch.tensor([counter, counter]), key)
    assert got.dtype == torch.int64
    assert got.tolist() == [list(want)] * 2


def test_philox_normals_moments():
    z = pf.philox_normal((1000, 1000), step=7, key=(0x12345678, 0x9ABCDEF0))
    assert z.shape == (1000, 1000) and torch.isfinite(z).all()
    assert abs(z.mean().item()) < 5e-3 and abs(z.std().item() - 1.0) < 5e-3
    other = pf.philox_normal((1000, 1000), step=8, key=(0x12345678, 0x9ABCDEF0))
    assert abs(torch.corrcoef(torch.stack([z.flatten(), other.flatten()]))[0, 1]) < 5e-3


def test_prng_mode_equals_its_draws_injected(setup):
    """The Philox mode is the injected mode fed philox_normal's draws."""
    _, pcfg, _, _, pdec = setup
    sem_idx, x_T, _ = _inputs(4, B=1, S=6)
    key = (31337, 4242)
    noise = torch.stack([pf.philox_normal(x_T.shape, i, key) for i in range(4)], dim=1)
    ts = [3, 2, 1, 0]
    loop = pf.prepare_loop_inputs(pdec, torch.from_numpy(sem_idx), x_T.shape[1], ts,
                                  step_idx=torch.zeros(4, dtype=torch.long))
    args = (torch.from_numpy(x_T), loop["pos"], loop["mods"], loop["ckv"],
            pf.ddpm_coefficients(PSchedule.create(4)), pf.pack_decoder_weights(pdec))
    kw = dict(heads=pcfg.heads, window=pcfg.attn_window_size)
    a = pf.fused_ddpm(*args, **kw, key=key)
    b = pf.fused_ddpm(*args, **kw, noise=noise)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_sample_ddpm_deterministic_per_seed(setup):
    _, pcfg, _, _, pdec = setup
    inf = pf.FusedEdgeInference(pcfg, PSchedule.create(8), pdec, device="cpu")
    sem_idx = np.random.RandomState(2).randint(0, 2304, size=(1, 10))

    def run(seed):
        return inf.sample_ddpm(sem_idx, generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert a.shape == (1, 20, 80) and a.device.type == "cpu" and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert (a - c).abs().max().item() > 1e-3
    v = inf.sample_ddpm(sem_idx, temperature=0.5, prediction="v")
    assert torch.isfinite(v).all()
