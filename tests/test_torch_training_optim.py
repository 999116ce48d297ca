"""The port's optimizer and train state against optax and the JAX TrainState.

The schedule, clipped AdamW, MultiSteps accumulation and the distillation
learning-rate swap are held against the JAX package's ``make_optimizer``
(optax) on the same gradients; the teacher's EMA, the frozen HuBERT and
``weights.train_state_from_jax`` are checked on the port's trainer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.training import create_train_state as j_create_train_state
from edge_diffusion_tts_tpu.training import init_models
from edge_diffusion_tts_tpu.training import make_lr_schedule as j_make_lr_schedule
from edge_diffusion_tts_tpu.training import make_optimizer as j_make_optimizer
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.models import HubertConfig as PHC
from edge_diffusion_tts_tpu_torch.models import SemanticEncoder as PEncoder
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule as PSchedule
from edge_diffusion_tts_tpu_torch.training import (
    Trainer,
    TrainState,
    constant_schedule,
    create_train_state,
    make_lr_schedule,
    make_optimizer,
)
from edge_diffusion_tts_tpu_torch.weights import (
    _trainable_from_jax,
    encoder_state_dict_from_jax,
    state_dict_from_jax,
    train_state_from_jax,
)

TINY = dict(hidden=32, layers=1, heads=2, segment_secs=0.1, batch_size=2, diff_steps=50,
            max_timestep=48, dropout=0.0, cfg_dropout=0.0, lr=1e-3, grad_clip=1.0)


@pytest.fixture(scope="module")
def jax_init():
    jcfg = JCFG(**TINY)
    _, _, params, vq_state = init_models(jcfg, jax.random.PRNGKey(0), hubert_cfg=JHC.tiny())
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32)), params)
    return params, vq_state


def _port_modules(params, vq_state, **kw):
    pcfg = PCFG(**dict(TINY, **kw))
    enc, dec = PEncoder(pcfg, PHC.tiny()), PDecoder(pcfg)
    enc_vars = {"params": params["encoder"]}
    if vq_state:
        enc_vars["vq_state"] = vq_state["encoder"]
    enc.load_state_dict(encoder_state_dict_from_jax(enc_vars))
    dec.load_state_dict(state_dict_from_jax(params["decoder"]))
    return pcfg, enc, dec


def _grads(params, seed, scale=3.0):
    """Random gradients big enough that global-norm clipping is active."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        scale * rng.randn(*np.shape(a)).astype(np.float32)), params)


def _hold_params(params, enc, dec, what):
    want = {f"decoder.{k}": v for k, v in state_dict_from_jax(params["decoder"]).items()}
    want.update({f"encoder.{k}": v for k, v in
                 encoder_state_dict_from_jax({"params": params["encoder"]}).items()})
    got = {f"decoder.{k}": v for k, v in dec.state_dict().items()}
    got.update({f"encoder.{k}": v for k, v in enc.state_dict().items()})
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), atol=1e-6, rtol=0,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("total,warmup_frac,lr", [(21, 0.05, 2e-4), (100, 0.05, 2e-4),
                                                  (400, 0.1, 1e-3), (7, 0.5, 3e-4)])
def test_lr_schedule_matches_optax(total, warmup_frac, lr):
    jcfg, pcfg = JCFG(warmup_frac=warmup_frac, lr=lr), PCFG(warmup_frac=warmup_frac, lr=lr)
    want, got = j_make_lr_schedule(jcfg, total), make_lr_schedule(pcfg, total)
    for count in range(total + 6):
        np.testing.assert_allclose(got(count), float(want(jnp.asarray(count, jnp.int32))),
                                   rtol=1e-6, atol=0, err_msg=f"update count {count}")
    assert got(0) == 0.0


@pytest.mark.parametrize("accumulation", [1, 2])
def test_updates_match_optax(jax_init, accumulation):
    """Three optimizer updates (k data steps each) with clipping active; the
    first runs at learning rate 0 in both; then the distillation swap to a
    constant lr keeps the moments, and the next update still agrees."""
    params, vq_state = jax_init
    jcfg = JCFG(**dict(TINY, grad_accumulation=accumulation))
    tx = j_make_optimizer(jcfg, 10)
    opt_state = tx.init(params)
    tx_update = jax.jit(tx.update)
    pcfg, enc, dec = _port_modules(params, vq_state, grad_accumulation=accumulation)
    opt = make_optimizer(pcfg, enc, dec, 10)
    assert not any("hubert" in n for n in opt.params)
    start = {n: p.detach().clone() for n, p in opt.params.items()}
    seed = 10
    for update in range(4):
        if update == 3:  # _enter_distillation: constant lr, same opt_state
            tx = j_make_optimizer(jcfg, 10, learning_rate=optax.constant_schedule(5e-4))
            tx_update = jax.jit(tx.update)
            opt.set_learning_rate(constant_schedule(5e-4))
        for _ in range(accumulation):
            g = _grads(params, seed)
            seed += 1
            norm = float(optax.global_norm(g))
            assert norm > 3 * pcfg.grad_clip
            updates, opt_state = tx_update(g, opt_state, params)
            params = jax.tree.map(lambda p, u: p + u, params, updates)
            opt.update(_trainable_from_jax(g))
        _hold_params(params, enc, dec, f"update {update}")
        if update == 0:
            for n, p in opt.params.items():
                assert torch.equal(p, start[n]), f"{n} moved at learning rate 0"
    assert opt.count == 4 and opt.mini_step == 0


def _port_trainer(params, vq_state, **kw):
    pcfg, enc, dec = _port_modules(params, vq_state, **kw)
    trainer = Trainer(pcfg, enc, dec, PSchedule.create(pcfg.diff_steps), device="cpu")
    state = create_train_state(trainer.encoder, trainer.decoder,
                               make_optimizer(pcfg, trainer.encoder, trainer.decoder, 20))
    return pcfg, trainer, state


def _batch(pcfg, seed):
    wav = np.random.RandomState(seed).randn(pcfg.batch_size, pcfg.segment_len) * 0.1
    return {"wav": wav.astype(np.float32)}


def test_teacher_still_on_accumulation_steps_and_hubert_frozen(jax_init):
    params, vq_state = jax_init
    pcfg, trainer, state = _port_trainer(params, vq_state, grad_accumulation=2)
    hubert = {k: v.clone() for k, v in state.encoder.hubert.state_dict().items()}
    assert all(not p.requires_grad for p in state.encoder.hubert.parameters())
    g = torch.Generator().manual_seed(0)
    diffusion = trainer.make_diffusion_step()
    for i in range(4):  # two updates: the second at a learning rate > 0
        state, _ = diffusion(state, trainer.put_batch(_batch(pcfg, i)), g)
    state.with_teacher()
    step = trainer.make_progressive_step(4)
    moved = []
    for i in range(4):
        before = {k: v.clone() for k, v in state.teacher.state_dict().items()}
        state, metrics = step(state, trainer.put_batch(_batch(pcfg, 10 + i)), g)
        assert torch.isfinite(metrics["loss"])
        same = all(torch.equal(before[k], v) for k, v in state.teacher.state_dict().items())
        moved.append(not same)
    # mini_step after 4 diffusion steps is 0: steps 1 and 3 of the phase only
    # accumulate (decay 1.0, bit-equal), steps 2 and 4 update and EMA.
    assert moved == [False, True, False, True]
    assert state.step == 8 and state.optimizer.count == 4
    for k, v in state.encoder.hubert.state_dict().items():
        assert torch.equal(v, hubert[k]), f"HuBERT {k} changed"


def test_train_state_from_jax_round_trips(jax_init):
    """A JAX state three updates in, with a teacher and accumulated gradients,
    comes across whole; the next update from it agrees with optax's."""
    params, vq_state = jax_init
    jcfg = JCFG(**dict(TINY, grad_accumulation=2))
    tx = j_make_optimizer(jcfg, 10)
    jstate = j_create_train_state(jcfg, params, vq_state, tx)
    p = jstate.params
    opt_state = jstate.opt_state
    tx_update = jax.jit(tx.update)
    for seed in range(7):  # 3 updates + one accumulated mini-step
        updates, opt_state = tx_update(_grads(p, 100 + seed), opt_state, p)
        p = jax.tree.map(lambda a, u: a + u, p, updates)
    jstate = jstate.replace(params=p, opt_state=opt_state, step=jnp.asarray(7, jnp.int32))
    jstate = jstate.with_teacher()
    d = train_state_from_jax(jstate)
    assert d["optimizer"]["count"] == 3 and d["optimizer"]["mini_step"] == 1
    assert d["step"] == 7 and d["teacher"] is not None

    pcfg, trainer, state = _port_trainer(params, vq_state, grad_accumulation=2)
    state.optimizer = make_optimizer(pcfg, state.encoder, state.decoder, 10)
    state.load_state_dict(d)
    back = state.state_dict()
    assert back["step"] == 7 and state.teacher is not None
    for part in ("encoder", "decoder", "teacher"):
        assert set(back[part]) >= set(k for k in d[part] if not k.startswith("hubert."))
        for k, v in d[part].items():
            assert torch.equal(back[part][k], v), f"{part}.{k}"
    for name in ("mu", "nu", "acc"):
        for k, v in d["optimizer"][name].items():
            assert torch.equal(back["optimizer"][name][k], v), f"{name}.{k}"
    # One more mini-step completes an update: port and optax agree.
    g = _grads(p, 200)
    updates, opt_state = tx_update(g, opt_state, p)
    p = jax.tree.map(lambda a, u: a + u, p, updates)
    assert state.optimizer.update(_trainable_from_jax(g))
    _hold_params(p, state.encoder, state.decoder, "update from a JAX state")

    fresh = TrainState(state.encoder, state.decoder,
                       make_optimizer(pcfg, state.encoder, state.decoder, 10))
    with pytest.raises(ValueError, match="names differ|shape"):
        bad = dict(d, optimizer=dict(d["optimizer"], mu={"decoder.nope": torch.zeros(1)}))
        fresh.load_state_dict(bad)
