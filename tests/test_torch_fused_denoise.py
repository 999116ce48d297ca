"""Port parity: the fused DDIM loop vs the JAX Pallas kernel and the eager path.

On the CPU ``fused_ddim`` runs its plain version; it is held against JAX's
``fused_generate_mel(..., interpret=True)`` (the Pallas kernel in interpret
mode) at hidden 32, 2 layers, 2 heads, window 8, B=2, S=12, and against the
port's own eager ``generate_mel``, to 1e-4 (the JAX kernel's bar).  The CUDA
kernel against the plain version is in test_torch_kernels_gpu.py.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.ops.fused_denoise import fused_generate_mel as jfused
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
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
    return jcfg, pcfg, params, pdec.eval()


def _inputs(B=2, S=12, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 2304, size=(B, S)),
            rng.randn(B, 2 * S, 80).astype(np.float32))


@pytest.mark.parametrize("steps,prediction", [(1, "eps"), (4, "eps"), (2, "v")])
def test_fused_plain_matches_jax_pallas_interpret(setup, steps, prediction):
    jcfg, pcfg, params, pdec = setup
    sem_idx, x_T = _inputs()
    want = jfused(jcfg, JSchedule.create(jcfg.diff_steps), params, sem_idx, x_T, steps,
                  prediction, interpret=True)
    before = pf.fused_ddim.launches
    got = pf.fused_generate_mel(pcfg, PSchedule.create(pcfg.diff_steps), pdec,
                                torch.from_numpy(sem_idx), torch.from_numpy(x_T),
                                steps, prediction)
    assert pf.fused_ddim.launches == before  # CPU tensors never reach the kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_fused_backend_matches_eager(setup, prediction):
    _, pcfg, _, pdec = setup
    sched = PSchedule.create(pcfg.diff_steps)
    sem_idx, x_T = _inputs(B=1, S=16, seed=9)
    out = {
        backend: EdgeInference(pcfg, sched, pdec, prediction=prediction, backend=backend,
                               device="cpu").generate_mel(sem_idx, num_steps=4, x_T=x_T)
        for backend in ("eager", "fused")
    }
    torch.testing.assert_close(out["fused"], out["eager"], atol=1e-4, rtol=0)


def test_fused_facade_and_packing(setup):
    _, pcfg, _, pdec = setup
    inf = pf.FusedEdgeInference(pcfg, PSchedule.create(pcfg.diff_steps), pdec, device="cpu")
    mel = inf.generate_mel(np.zeros((1, 8), np.int64), num_steps=2)
    assert mel.shape == (1, 16, 80) and torch.isfinite(mel).all()
    w = inf.weights
    assert tuple(w) == pf.WEIGHT_NAMES
    assert w["qkv_w"].shape == (2, 96, 32) and w["fc1_w"].shape == (2, 128, 32)
    pw = pf.pack_decoder_weights(PDecoder(PCFG(**dict(SMALL, use_depthwise=True))))
    assert tuple(pw) == pf.WEIGHT_NAMES + pf.PRENET_NAMES
    assert {n: tuple(pw[n].shape) for n in pf.PRENET_NAMES} == {
        "pc_dw": (32, 3), "pc_pw": (32, 32), "pc_pb": (32,), "pc_gs": (32,), "pc_gb": (32,)}
    with pytest.raises(ValueError, match="use_adaln"):
        pf.pack_decoder_weights(PDecoder(PCFG(**dict(SMALL, use_adaln=False))))
    ts, coef = pf.ddim_coefficients(PSchedule.create(1000), 4)
    assert ts == [999, 749, 499, 249] and coef.shape == (4, 4)



# -- the DDIM grid on the device and the loop plans' rule (no CUDA needed) ----------


@pytest.mark.parametrize("steps", range(1, 9))
def test_ddim_grid_is_the_numpy_table_bit_for_bit(steps):
    sched = PSchedule.create(1000)
    ts, coef = pf.ddim_coefficients(sched, steps)
    grid_ts, grid_coef = pf.ddim_grid(sched, steps, "cpu")
    assert grid_ts.dtype == grid_coef.dtype == torch.float32
    assert torch.equal(grid_coef, coef) and grid_ts.tolist() == ts
    assert pf.ddim_grid(sched, steps, "cpu")[1] is grid_coef  # made once, then kept


def test_loop_inputs_from_the_grid_equal_those_from_the_list(setup):
    _, _, _, pdec = setup
    sched = PSchedule.create(1000)
    sem_idx = torch.from_numpy(_inputs()[0])
    ts, _ = pf.ddim_coefficients(sched, 4)
    want = pf.prepare_loop_inputs(pdec, sem_idx, 24, ts)
    got = pf.prepare_loop_inputs(pdec, sem_idx, 24, pf.ddim_grid(sched, 4, "cpu")[0])
    assert all(torch.equal(got[k], want[k]) for k in want)


def _plan(addrs):
    return SimpleNamespace(addrs=addrs)


def test_loop_plans_capture_a_shape_the_second_time_it_is_seen():
    plans = pf.LoopPlans()
    assert plans.route("a", (1, 2)) == "eager"
    assert plans.route("b", (1, 2)) == "eager"  # another shape is its own first sighting
    assert plans.route("a", (1, 2)) == "capture"
    plans.keep("a", _plan((1, 2)))
    assert [plans.route("a", (1, 2)) for _ in range(3)] == ["replay"] * 3
    assert plans.route("b", (1, 2)) == "capture"


def test_loop_plans_drop_a_plan_whose_addresses_moved():
    plans = pf.LoopPlans()
    plans.route("a", (1, 2))
    plans.route("a", (1, 2))
    plans.keep("a", _plan((1, 2)))
    assert plans.route("a", (1, 3)) == "eager" and "a" not in plans.plans
    assert plans.route("a", (1, 2)) == "eager"  # the old addresses are a new sighting
    assert plans.route("a", (1, 2)) == "capture"
    plans.route("c", (5,))
    assert plans.route("c", (6,)) == "eager"  # a sighting at other addresses is no second one
    assert plans.route("c", (6,)) == "capture"


def test_loop_plans_forget_the_least_recently_used_past_their_limit():
    assert pf.PLANS_PER_DECODER == 32 and pf.LoopPlans().limit == 32
    plans = pf.LoopPlans()
    plans.limit = 3
    for key in "abcd":
        assert plans.route(key, ()) == "eager"
    assert list(plans.seen) == ["b", "c", "d"]
    assert plans.route("a", ()) == "eager"  # forgotten: a first sighting again
    assert plans.route("b", ()) == "eager" and list(plans.seen) == ["d", "a", "b"]
    for key in "dab":
        assert plans.route(key, ()) == "capture"
        plans.keep(key, _plan(()))
    assert plans.route("d", ()) == "replay"  # now the most recently used
    plans.route("e", ())
    plans.route("e", ())
    plans.keep("e", _plan(()))
    assert list(plans.plans) == ["b", "d", "e"]


def test_cpu_calls_make_no_plan_and_take_the_plain_loop(setup, monkeypatch):
    _, pcfg, _, pdec = setup
    sched = PSchedule.create(pcfg.diff_steps)
    sem_idx, x_T = (torch.from_numpy(a) for a in _inputs())
    packed = pf.pack_decoder_weights(pdec)
    plain = []
    monkeypatch.setattr(pf, "fused_ddim_plain",
                        lambda *a, **k: plain.append(1) or torch.zeros_like(a[0]))
    pf.zero_plan_counts()
    for _ in range(3):
        pf.fused_generate_mel(pcfg, sched, pdec, sem_idx, x_T, 2, "v", weights=packed)
    assert len(plain) == 3 and pdec not in pf._LOOP_PLANS
    counts = pf.fused_generate_mel
    assert (counts.eager, counts.captures, counts.replays) == (3, 0, 0)
