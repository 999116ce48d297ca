"""The port's training losses against the JAX package's loss closures.

Each phase's loss closure (``Trainer.make_*_loss``) runs in both packages on
the same weights (the JAX init, jittered so no gradient is trivially zero,
carried across by ``weights.py``), the same batch and JAX's own draws
(replayed through the batch keys), at the JAX training tests' tiny shapes
with dropout and cfg dropout 0.  The loss and every metric are held at rtol
1e-4 and every trainable gradient tensor at cosine >= 0.99999 against
``jax.value_and_grad`` of the same closure.  The VQ's training forward and
EMA update (with a dead-code reset forced and JAX's permutation handed in)
are held at 1e-5; dropout is tested on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.models.vq import VectorQuantizer as JVQ
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu.training import Trainer as JTrainer
from edge_diffusion_tts_tpu.training import init_models, make_optimizer
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.layers.ffn import dropout
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.models import HubertConfig as PHC
from edge_diffusion_tts_tpu_torch.models import SemanticEncoder as PEncoder
from edge_diffusion_tts_tpu_torch.models.vq import VectorQuantizer as PVQ
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule as PSchedule
from edge_diffusion_tts_tpu_torch.training import Trainer as PTrainer
from edge_diffusion_tts_tpu_torch.training import create_train_state
from edge_diffusion_tts_tpu_torch.training import make_optimizer as p_make_optimizer
from edge_diffusion_tts_tpu_torch.weights import encoder_state_dict_from_jax, state_dict_from_jax

TINY = dict(hidden=32, layers=1, heads=2, segment_secs=0.1, batch_size=2, grad_accumulation=1,
            diff_steps=50, max_timestep=48, diffusion_epochs=1,
            progressive_epochs_per_halving=1, consistency_epochs=1, dropout=0.0,
            cfg_dropout=0.0)
NUM_STEPS = 4  # the progressive grid
GRID = 40  # the exact consistency grid


def _jitter(tree, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + scale * rng.randn(*np.shape(a))
                                              .astype(np.float32)), tree)


class Pair:
    """One tiny config built in both packages on the same weights."""

    def __init__(self, **kw):
        jcfg, pcfg = JCFG(**TINY, **kw), PCFG(**TINY, **kw)
        encoder, decoder, params, vq_state = init_models(
            jcfg, jax.random.PRNGKey(0), hubert_cfg=JHC.tiny())
        self.params = {"encoder": _jitter(params["encoder"], 1),
                       "decoder": _jitter(params["decoder"], 2)}
        self.teacher = _jitter(self.params["decoder"], 3, scale=0.02)
        self.vq_state = vq_state
        self.jcfg, self.pcfg = jcfg, pcfg
        self.jt = JTrainer(jcfg, encoder, decoder, JSchedule.create(jcfg.diff_steps),
                           make_optimizer(jcfg, 100))
        wav = (np.random.RandomState(4).randn(jcfg.batch_size, jcfg.segment_len)
               .astype(np.float32) * 0.1)
        self.wav = wav
        self.mel_shape = tuple(self.jt._mel_normalized(jnp.asarray(wav)).shape)

    def port_state(self, with_teacher: bool):
        pcfg = self.pcfg
        enc, dec = PEncoder(pcfg, PHC.tiny()), PDecoder(pcfg)
        enc_vars = {"params": self.params["encoder"]}
        if self.vq_state:
            enc_vars["vq_state"] = self.vq_state["encoder"]
        enc.load_state_dict(encoder_state_dict_from_jax(enc_vars))
        dec.load_state_dict(state_dict_from_jax(self.params["decoder"], pcfg))
        trainer = PTrainer(pcfg, enc, dec, PSchedule.create(pcfg.diff_steps), device="cpu")
        state = create_train_state(trainer.encoder, trainer.decoder,
                                   p_make_optimizer(pcfg, trainer.encoder, trainer.decoder, 100))
        if with_teacher:
            state.with_teacher()
            state.teacher.load_state_dict(state_dict_from_jax(self.teacher, pcfg))
        return trainer, state


@pytest.fixture(scope="module")
def fsq():
    return Pair()


@pytest.fixture(scope="module")
def vq():
    return Pair(use_fsq=False)


@pytest.fixture
def pair_of(request):
    """The pair for a quantizer, built on first use."""
    return lambda quantizer: request.getfixturevalue(quantizer)


def _port_grads(state):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().numpy()
            for n, p in state.optimizer.params.items()}


def _jax_grads(grads):
    out = {f"encoder.{k}": v.numpy() for k, v in
           encoder_state_dict_from_jax({"params": grads["encoder"]}).items()
           if not k.startswith("hubert.")}
    out.update({f"decoder.{k}": v.numpy() for k, v in
                state_dict_from_jax(grads["decoder"]).items()})
    return out


def _hold(pair, kind, port_loss, jax_call, batch_np, rng):
    """Run both closures; hold loss, metrics and gradients."""
    (jloss, (jvq, jmetrics)), jgrads = jax_call()
    trainer, state = pair.port_state(with_teacher=kind in ("progressive", "pd_two_step",
                                                           "consistency_exact"))
    state.train()
    batch = trainer.put_batch(batch_np)
    loss, metrics = port_loss(trainer)(state, batch, torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert set(metrics) == set(jmetrics), (set(metrics) ^ set(jmetrics))
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-6,
                                   err_msg=f"{kind} metric {k}")
    got, want = _port_grads(state), _jax_grads(jgrads)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    nonzero = 0
    for name, w in want.items():
        g = got[name]
        nw, ng = np.linalg.norm(w), np.linalg.norm(g)
        if nw < 1e-10:
            assert ng < 1e-8, f"{kind} {name}: JAX's gradient is 0, the port's {ng}"
            continue
        nonzero += 1
        cos = float(np.dot(g.ravel().astype(np.float64), w.ravel()) / (ng * nw))
        assert cos >= 0.99999, f"{kind} {name}: gradient cosine {cos}"
        np.testing.assert_allclose(ng, nw, rtol=1e-3, err_msg=f"{kind} {name} grad norm")
    assert nonzero > len(want) // 2, f"{kind}: only {nonzero} nonzero gradients"
    if jvq:
        sd = state.encoder.state_dict()
        for key, value in jvq["encoder"]["vq"].items():
            np.testing.assert_allclose(sd[f"vq.{key}"].numpy(), np.asarray(value), atol=1e-5,
                                       err_msg=f"vq state {key}")


@pytest.mark.parametrize("kind,prediction,quantizer", [
    ("diffusion", "v", "fsq"), ("diffusion", "eps", "fsq"), ("diffusion", "v", "vq"),
    ("progressive", "v", "fsq"), ("pd_two_step", "v", "fsq"), ("consistency", "v", "fsq"),
    ("consistency_exact", "v", "fsq"),
])
def test_loss_and_gradients_match_jax(pair_of, kind, prediction, quantizer):
    pair = pair_of(quantizer)
    jt, jcfg = pair.jt, pair.jcfg
    jt.cfg.use_v_prediction = pair.pcfg.use_v_prediction = prediction == "v"
    try:
        B = jcfg.batch_size
        rs = np.random.RandomState(11)
        rng = jax.random.PRNGKey(5)
        noise = rs.randn(*pair.mel_shape).astype(np.float32)
        batch = {"wav": pair.wav, "noise": noise}
        args = (pair.params, pair.vq_state)
        if kind == "diffusion":
            batch["t"] = np.array([7, 40], np.int32)
            jloss = jt.make_diffusion_loss()
            port = lambda t: t.make_diffusion_loss()
        elif kind == "progressive":
            batch["step_indices"] = np.array([1, 3], np.int32)
            jloss = jt.make_progressive_loss(NUM_STEPS)
            port = lambda t: t.make_progressive_loss(NUM_STEPS)
            args = (pair.params, pair.teacher, pair.vq_state)
        elif kind == "pd_two_step":
            # JAX draws these from its rng: replay the same draws.
            _, k_i, k_noise, _ = jax.random.split(rng, 4)
            batch["step_indices"] = np.asarray(jax.random.randint(k_i, (B,), 0, NUM_STEPS))
            batch["noise"] = np.asarray(jax.random.normal(k_noise, pair.mel_shape))
            jloss = jt.make_pd_two_step_loss(NUM_STEPS)
            port = lambda t: t.make_pd_two_step_loss(NUM_STEPS)
            args = (pair.params, pair.teacher, pair.vq_state)
        elif kind == "consistency":
            batch["t1"], batch["t2"] = np.array([3, 30], np.int32), np.array([45, 12], np.int32)
            jloss = jt.make_consistency_loss()
            port = lambda t: t.make_consistency_loss()
        else:
            _, k_n, k_noise, _ = jax.random.split(rng, 4)
            batch["n"] = np.asarray(jax.random.randint(k_n, (B,), 0, GRID - 1))
            batch["noise"] = np.asarray(jax.random.normal(k_noise, pair.mel_shape))
            jloss = jt.make_consistency_exact_loss(grid_size=GRID)
            port = lambda t: t.make_consistency_exact_loss(grid_size=GRID)
            args = (pair.params, pair.teacher, pair.vq_state)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "n"}

        def jax_call():
            return jax.value_and_grad(jloss, has_aux=True)(*args, jbatch, rng)

        _hold(pair, kind, port, jax_call, batch, rng)
    finally:
        jt.cfg.use_v_prediction = pair.pcfg.use_v_prediction = True


@pytest.fixture(scope="module")
def vq_case():
    """A JAX VQ one update short of its dead-code reset, its update recorded
    with the permutation it drew."""
    dim, size, every = 8, 48, 5
    z = np.random.RandomState(21).randn(3, 10, dim).astype(np.float32)
    jvq = JVQ(dim, size, commit=0.25, reset_unused_every=every)
    variables = jvq.init({"params": jax.random.PRNGKey(0), "vq": jax.random.PRNGKey(1)},
                         jnp.asarray(z))
    vq_state = dict(variables["vq_state"], update_count=jnp.asarray(every - 1, jnp.int32))
    drawn = []
    real = jax.random.permutation

    def recording(key, x, *a, **k):
        out = real(key, x, *a, **k)
        drawn.append(np.array(out))
        return out

    jax.random.permutation = recording
    try:
        outs, mutated = jvq.apply({"vq_state": vq_state}, jnp.asarray(z), train=True,
                                  mutable=["vq_state"], rngs={"vq": jax.random.PRNGKey(2)})
    finally:
        jax.random.permutation = real
    return dict(z=z, dim=dim, size=size, every=every, vq_state=vq_state, outs=outs,
                new=mutated["vq_state"], perm=drawn[0])


def test_vq_training_forward_and_ema_reset_match_jax(vq_case):
    c = vq_case
    pvq = PVQ(c["dim"], c["size"], commit=0.25, reset_unused_every=c["every"])
    pvq.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in c["vq_state"].items()})
    z = torch.from_numpy(c["z"]).requires_grad_(True)
    z_q, idx, loss, ppl, used = pvq(z, train=True, perm=torch.from_numpy(c["perm"]))
    jz_q, jidx, jloss, jppl, jused = c["outs"]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(z_q.detach().numpy(), np.asarray(jz_q), atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ppl.item(), float(jppl), rtol=1e-5)
    assert used.item() == int(jused)
    new = c["new"]
    dead = np.asarray(new["ema_cluster_size"]) == 1.0
    assert int(new["update_count"]) == c["every"] and dead.any(), "no dead-code reset happened"
    for key in ("codebook", "ema_cluster_size", "ema_w", "update_count"):
        np.testing.assert_allclose(getattr(pvq, key).numpy(), np.asarray(new[key]), atol=1e-5,
                                   err_msg=key)
    # The straight-through output carries the gradient to z; the commitment
    # term adds its own.
    loss.backward()
    assert z.grad is not None and torch.isfinite(z.grad).all()


def test_vq_reset_draws_from_the_generator(vq_case):
    c = vq_case

    quantizers = [PVQ(c["dim"], c["size"], reset_unused_every=c["every"]) for _ in range(3)]
    for pvq in quantizers:
        pvq.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in c["vq_state"].items()})

    def run(pvq, seed):
        pvq(torch.from_numpy(c["z"]), train=True, generator=torch.Generator().manual_seed(seed))
        return pvq.codebook.clone()

    before = torch.get_rng_state()
    a, b, other = (run(q, s) for q, s in zip(quantizers, (3, 3, 4)))
    assert torch.equal(torch.get_rng_state(), before), "the reset read torch's global stream"
    assert torch.equal(a, b) and not torch.equal(a, other)
    with pytest.raises(ValueError, match="Generator"):
        PVQ(c["dim"], c["size"])(torch.from_numpy(c["z"]), train=True)


def test_dropout_is_drawn_from_the_generator():
    x = torch.ones(64, 256)
    g = lambda s: torch.Generator().manual_seed(s)
    torch.manual_seed(0)
    before = torch.get_rng_state()
    a, b, c = (dropout(x, 0.2, True, g(s)) for s in (1, 1, 2))
    assert torch.equal(torch.get_rng_state(), before)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.8) < 0.01 and abs(a.mean().item() - 1.0) < 0.02
    assert set(torch.unique(a).tolist()) <= {0.0, 1.25}
    assert torch.equal(dropout(x, 0.2, False, None), x)
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.2, True, None)


def test_training_forward_reads_no_global_stream():
    """A dropout-0.2 decoder and a use_dropout VQ encoder in training mode:
    one generator seed gives one output, and torch's global stream is
    untouched."""
    cfg = PCFG(**dict(TINY, dropout=0.2, use_fsq=False))
    torch.manual_seed(3)
    dec, enc = PDecoder(cfg).train(), PEncoder(cfg, PHC.tiny(), use_dropout=True).train()
    with torch.no_grad():
        dec.out_proj.weight.normal_(0, 0.1)
    x, t = torch.randn(2, 11, 80), torch.tensor([3, 20])
    wav = torch.randn(2, 1600) * 0.1
    enc_sd = {k: v.clone() for k, v in enc.state_dict().items()}
    before = torch.get_rng_state()

    def run(seed):
        enc.load_state_dict(enc_sd)  # the training forward moves the VQ's EMA buffers
        g = torch.Generator().manual_seed(seed)
        z_q, idx, *_ = enc(wav, train=True, generator=g)
        return dec(x, t, sem_features=z_q, step_idx=torch.zeros_like(t), generator=g)

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(torch.get_rng_state(), before)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        dec(x, t, sem_features=torch.zeros(2, 4, cfg.semantic_dim))
