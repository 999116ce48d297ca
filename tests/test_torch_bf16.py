"""bfloat16 compute in the port against the JAX package's, on the CPU.

The JAX side is built by JAX's own modules at ``dtype=jnp.bfloat16`` (and
jitted, as its training step is), the weights carried across by
``weights.py``; the port runs its modules at ``dtype=torch.bfloat16``.
bf16 rounds at other places in the two frameworks (torch's CPU kernels
round once per fused op, XLA's CPU may keep excess precision), so a bf16
quantity Q is held by the witness rule against JAX's float32 result Q32 on
the same weights, inputs and draws:

- ``|Q_port - Q32| / |Q32| <= 1.5 * |Q_jax - Q32| / |Q32| + 1e-3`` (norms);
- a gradient: ``cos(g_port, g32) >= cos(g_jax, g32) - 0.01`` for every
  parameter whose JAX gradient is nonzero;
- tokens: ``share(tok_port == tok32) >= share(tok_jax == tok32) - 0.02``.

Also here: the frontend's bf16 plain version against a composition of the
JAX kernel's own helpers (its tier-1 oracle: normwise 5e-3 of JAX's bf16
chain, and the witness rule), AdamW on bf16 parameters against optax (the
moments' dtype, and the parameters within one bf16 ulp), ``train()`` at
configs/tpu_large_batch.json cut to a tiny model, the bridge on JAX's bf16
leaves, and the float32 path of every dtype-aware layer equal bit for bit
to its torch base class.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models.decoder import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.models.encoder import SemanticEncoder as JEncoder
from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.ops import fused_frontend as jff
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu.training import Trainer as JTrainer
from edge_diffusion_tts_tpu.training import make_optimizer as j_make_optimizer
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.config import torch_dtype
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.layers import dtypes
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.models import HubertConfig as PHC
from edge_diffusion_tts_tpu_torch.models import SemanticEncoder as PEncoder
from edge_diffusion_tts_tpu_torch.models.hubert import FeatureExtractor
from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule as PSchedule
from edge_diffusion_tts_tpu_torch.training import Trainer as PTrainer
from edge_diffusion_tts_tpu_torch.training import (create_train_state, init_models,
                                                   restore_checkpoint, train)
from edge_diffusion_tts_tpu_torch.training import make_optimizer as p_make_optimizer
from edge_diffusion_tts_tpu_torch.training.checkpoint import restore_final_model
from edge_diffusion_tts_tpu_torch.training.state import Optimizer
from edge_diffusion_tts_tpu_torch.weights import encoder_state_dict_from_jax, state_dict_from_jax

BF16 = torch.bfloat16
TINY = dict(hidden=32, layers=2, heads=2, attn_window_size=8, use_depthwise=True,
            segment_secs=0.1, batch_size=2, grad_accumulation=1, diff_steps=50, max_timestep=48,
            dropout=0.0, cfg_dropout=0.0)
FACTOR, SLACK, COS_SLACK, TOKEN_SLACK = 1.5, 1e-3, 0.01, 0.02  # the witness rule's bars
# The FSQ usage metrics count tokens: a flipped token moves them by a step
# (~1% at the tests' 158 tokens), so they are held as tokens are, with a
# slack of a few tokens: relative error <= JAX's + 0.05.
USAGE_METRICS, USAGE_SLACK = ("perplexity", "used_codes"), 0.05


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def witness(what: str, port, jax_bf16, jax_f32) -> None:
    e_port, e_jax = rel(port, jax_f32), rel(jax_bf16, jax_f32)
    assert e_port <= FACTOR * e_jax + SLACK, (
        f"{what}: port bf16 is {e_port:.3g} from JAX float32, JAX bf16 {e_jax:.3g}")


def cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _jitter(tree, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + scale * rng.randn(*np.shape(a))
                                              .astype(np.float32)), tree)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Pair:
    """One tiny config in both packages on the same jittered weights: the JAX
    modules at float32 and bf16, the port's at the dtype asked for."""

    def __init__(self, **kw):
        self.jcfg, self.pcfg = JCFG(**{**TINY, **kw}), PCFG(**{**TINY, **kw})
        jc = self.jcfg
        enc32, dec32 = JEncoder(jc, JHC.tiny()), JDecoder(jc)
        k_enc, k_dec, k_drop, k_vq = jax.random.split(jax.random.PRNGKey(0), 4)
        wav = jnp.zeros((1, min(jc.segment_len, 4000)), jnp.float32)
        # the encoder reads no decoder option: pairs that differ only there share its init
        enc_key = _config_key(dataclasses.replace(jc, use_adaln=True))
        if enc_key not in _ENCODER_VARS:
            _ENCODER_VARS[enc_key] = jax.jit(lambda: enc32.init(
                {"params": k_enc, "dropout": k_drop, "vq": k_vq}, wav, train=False))()
        enc_vars = _ENCODER_VARS[enc_key]
        dec_params = jax.jit(lambda: init_decoder_params(dec32, k_dec, jc)["params"])()
        self.params = {"encoder": _jitter(dict(enc_vars["params"]), 1),
                       "decoder": _jitter(dec_params, 2)}
        self.teacher = _jitter(self.params["decoder"], 3, scale=0.02)
        self.vq_state = {"encoder": enc_vars["vq_state"]} if "vq_state" in enc_vars else {}
        self.jax = {jnp.float32: (enc32, dec32),
                    jnp.bfloat16: (JEncoder(jc, JHC.tiny(), dtype=jnp.bfloat16),
                                   JDecoder(jc, dtype=jnp.bfloat16))}
        self.jit_decoder = {dt: jax.jit(lambda params, x, t, s, dec=dec: dec.apply(
            {"params": params}, x, t, sem_idx=s, step_idx=jnp.zeros((x.shape[0],), jnp.int32)))
            for dt, (_, dec) in self.jax.items()}

    def port(self, dtype):
        enc, dec = PEncoder(self.pcfg, PHC.tiny(), dtype=dtype), PDecoder(self.pcfg, dtype=dtype)
        enc_vars = {"params": self.params["encoder"]}
        if self.vq_state:
            enc_vars["vq_state"] = self.vq_state["encoder"]
        enc.load_state_dict(encoder_state_dict_from_jax(enc_vars))
        dec.load_state_dict(state_dict_from_jax(self.params["decoder"], self.pcfg))
        return enc.eval(), dec.eval()


_PAIRS, _ENCODER_VARS = {}, {}


def _config_key(jc) -> str:
    return repr(dataclasses.replace(jc, run_name=""))  # its default is the clock's


def pair(**kw) -> Pair:
    key = _config_key(JCFG(**{**TINY, **kw}))  # the same config by any spelling builds once
    if key not in _PAIRS:
        _PAIRS[key] = Pair(**kw)
    return _PAIRS[key]


# -- the decoder and the encoder -------------------------------------------------------


@pytest.mark.parametrize("adaln", [True, False])
@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_decoder_forward_bf16_witness(adaln, prediction):
    """The bf16 decoder's output and the x0 it predicts (eps or v) at two
    timesteps, against JAX's bf16 decoder by the witness rule."""
    p = pair(use_adaln=adaln)
    rs = np.random.RandomState(5)
    B, T, S = 2, 24, 12
    x = rs.randn(B, T, 80).astype(np.float32)
    t = np.array([7, 40], np.int32)
    sem = rs.randint(0, p.pcfg.effective_codebook_size(), (B, S)).astype(np.int32)
    outs = {dt: np.asarray(p.jit_decoder[dt](p.params["decoder"], jnp.asarray(x),
                                             jnp.asarray(t), jnp.asarray(sem)))
            for dt in (jnp.float32, jnp.bfloat16)}
    _, pdec = p.port(BF16)
    with torch.no_grad():
        port = pdec(torch.from_numpy(x), torch.from_numpy(t).long(),
                    sem_idx=torch.from_numpy(sem).long(), step_idx=torch.zeros(B, dtype=torch.long))
    assert port.dtype == torch.float32 and outs[jnp.bfloat16].dtype == np.float32
    witness("decoder output", port.numpy(), outs[jnp.bfloat16], outs[jnp.float32])
    sched = PSchedule.create(p.pcfg.diff_steps)
    tt = torch.from_numpy(t).long()
    to_x0 = sched.predict_x0_from_v if prediction == "v" else sched.predict_x0_from_eps
    x0 = {k: to_x0(torch.from_numpy(x), tt, torch.from_numpy(v)).numpy() for k, v in
          (("port", port.numpy()), ("bf16", outs[jnp.bfloat16]), ("f32", outs[jnp.float32]))}
    witness(f"x0 from {prediction}", x0["port"], x0["bf16"], x0["f32"])


def test_semantic_encoder_bf16_witness():
    """The bf16 encoder (tiny HuBERT on its modules, the wav cast to bf16
    before conv0): the projection before the quantizer by the witness rule,
    the FSQ tokens against the float32 tokens."""
    p = pair()
    wav = (0.1 * np.random.RandomState(6).randn(2, 3200)).astype(np.float32)
    enc_vars = {"params": p.params["encoder"]}
    proj, tok = {}, {}
    def project_and_encode(m, x):  # what JAX's encode computes, with its projection
        z = m._project(m.extract_hubert(x), True)
        return z, m.vq.encode(z)

    for dt in (jnp.float32, jnp.bfloat16):
        enc = p.jax[dt][0]
        proj[dt], tok[dt] = (np.asarray(a) for a in jax.jit(lambda v, w: enc.apply(
            v, w, method=project_and_encode))(enc_vars, jnp.asarray(wav)))
        proj[dt] = proj[dt].astype(np.float32)
    penc, _ = p.port(BF16)
    with torch.no_grad():
        w = torch.from_numpy(wav)
        z = penc._project(penc.extract_hubert(w))
        ptok = penc.encode(w).numpy()
    assert z.dtype == BF16 and proj[jnp.bfloat16].dtype == np.float32
    witness("encoder projection", z.float().numpy(), proj[jnp.bfloat16], proj[jnp.float32])
    share_port = float(np.mean(ptok == tok[jnp.float32]))
    share_jax = float(np.mean(tok[jnp.bfloat16] == tok[jnp.float32]))
    assert share_port >= share_jax - TOKEN_SLACK, (share_port, share_jax)


# -- losses and gradients ---------------------------------------------------------------


def _port_grads(state):
    return {n: (q.grad if q.grad is not None else torch.zeros_like(q)).detach().float().numpy()
            for n, q in state.optimizer.params.items()}


def _jax_grads(grads):
    out = {f"encoder.{k}": v.float().numpy() for k, v in
           encoder_state_dict_from_jax({"params": grads["encoder"]}).items()
           if not k.startswith("hubert.")}
    out.update({f"decoder.{k}": v.float().numpy() for k, v in
                state_dict_from_jax(grads["decoder"]).items()})
    return out


@pytest.mark.parametrize("kind", ["diffusion", "progressive", "consistency"])
def test_losses_and_gradients_bf16_witness(kind):
    """Each phase's loss closure at compute bf16 on JAX's draws (replayed
    through the batch), dropout 0: the loss and every metric by the witness
    rule, every trainable gradient by the cosine bar."""
    p = pair()
    jc = p.jcfg
    rs = np.random.RandomState(11)
    wav = (rs.randn(jc.batch_size, jc.segment_len) * 0.1).astype(np.float32)
    sched = JSchedule.create(jc.diff_steps)
    trainers = {dt: JTrainer(jc, *p.jax[dt], sched, j_make_optimizer(jc, 100))
                for dt in (jnp.float32, jnp.bfloat16)}
    mel_shape = tuple(trainers[jnp.float32]._mel_normalized(jnp.asarray(wav)).shape)
    batch = {"wav": wav, "noise": rs.randn(*mel_shape).astype(np.float32)}
    args = (p.params, p.vq_state)
    if kind == "diffusion":
        batch["t"] = np.array([7, 40], np.int32)
        make = lambda t: t.make_diffusion_loss()  # noqa: E731
    elif kind == "progressive":
        batch["step_indices"] = np.array([1, 3], np.int32)
        make = lambda t: t.make_progressive_loss(4)  # noqa: E731
        args = (p.params, p.teacher, p.vq_state)
    else:
        batch["t1"], batch["t2"] = np.array([3, 30], np.int32), np.array([45, 12], np.int32)
        make = lambda t: t.make_consistency_loss()  # noqa: E731
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    res = {}
    for dt, jt in trainers.items():
        (loss, (_, metrics)), grads = jax.jit(jax.value_and_grad(make(jt), has_aux=True))(
            *args, jbatch, jax.random.PRNGKey(5))
        res[dt] = (float(loss), {k: float(v) for k, v in metrics.items()}, _jax_grads(grads))

    enc, dec = p.port(BF16)
    trainer = PTrainer(p.pcfg, enc, dec, PSchedule.create(p.pcfg.diff_steps), device="cpu")
    assert trainer.encode_route == "modules" and trainer.dtype == BF16
    state = create_train_state(trainer.encoder, trainer.decoder,
                               p_make_optimizer(p.pcfg, trainer.encoder, trainer.decoder, 100))
    if kind == "progressive":
        state.with_teacher()
        state.teacher.load_state_dict(state_dict_from_jax(p.teacher, p.pcfg))
    state.train()
    loss, metrics = make(trainer)(state, trainer.put_batch(batch), torch.Generator())
    loss.backward()
    assert loss.dtype == torch.float32
    (l32, m32, g32), (lbf, mbf, gbf) = res[jnp.float32], res[jnp.bfloat16]
    witness(f"{kind} loss", loss.item(), lbf, l32)
    assert set(metrics) == set(m32)
    for k in m32:
        if k in USAGE_METRICS:
            e_port, e_jax = rel(float(metrics[k]), m32[k]), rel(mbf[k], m32[k])
            assert e_port <= e_jax + USAGE_SLACK, (k, e_port, e_jax)
        else:
            witness(f"{kind} metric {k}", float(metrics[k]), mbf[k], m32[k])
    got = _port_grads(state)
    assert set(got) == set(g32)
    nonzero = 0
    for name, want in g32.items():
        if np.linalg.norm(gbf[name]) < 1e-10 or np.linalg.norm(want) < 1e-10:
            continue
        nonzero += 1
        c_port, c_jax = cosine(got[name], want), cosine(gbf[name], want)
        assert c_port >= c_jax - COS_SLACK, f"{kind} {name}: cos {c_port:.5f}, JAX {c_jax:.5f}"
    assert nonzero > len(g32) // 2, nonzero


# -- bf16 parameters and the optimizer -------------------------------------------------


def test_param_dtype_bf16_init_and_step():
    """The counterpart of the JAX test_param_dtype_bf16: every float
    parameter is bf16 after init and after a diffusion step (whose loss is
    finite); the VQ statistics stay float32 buffers; the moments have the
    dtype optax gives them (the parameters')."""
    cfg = PCFG(**{**TINY, "param_dtype": "bfloat16", "use_fsq": False})
    torch.manual_seed(0)
    enc, dec = init_models(cfg, PHC.tiny())
    assert all(q.dtype == BF16 for m in (enc, dec) for q in m.parameters())
    assert enc.vq.codebook.dtype == torch.float32 and enc.dtype == torch.float32
    trainer = PTrainer(cfg, enc, dec, PSchedule.create(cfg.diff_steps), device="cpu")
    state = create_train_state(trainer.encoder, trainer.decoder,
                               p_make_optimizer(cfg, trainer.encoder, trainer.decoder, 10))
    jtx = optax.adamw(1e-3)
    for name, q in state.optimizer.params.items():
        mu, nu = jtx.init(jnp.zeros(q.shape, jnp.bfloat16))[0][1:]
        assert state.optimizer.mu[name].dtype == BF16 and mu.dtype == jnp.bfloat16
        assert state.optimizer.nu[name].dtype == BF16 and nu.dtype == jnp.bfloat16
    wav = (np.random.RandomState(0).randn(cfg.batch_size, cfg.segment_len) * 0.1)
    for _ in range(2):  # the first update runs at lr 0
        state, metrics = trainer.make_diffusion_step()(state, trainer.put_batch(
            {"wav": wav.astype(np.float32)}), torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["loss"])) and metrics["grad_norm"].dtype == BF16
    assert all(q.dtype == BF16 for m in (enc, dec) for q in m.parameters())


@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_adamw_on_bf16_params_matches_optax(clip):
    """Three updates of clip -> AdamW (warmup-cosine lr) on bf16 parameters
    and bf16 gradients, jitted optax against the port: every parameter and
    moment within one bf16 ulp (2^-7 relative) of optax's, and at least 99%
    of the parameters' elements bit-equal; ``clip`` 0.05 clips every step."""
    cfg = PCFG(**{**TINY, "grad_clip": clip, "lr": 1e-2})
    jcfg = JCFG(**{**TINY, "grad_clip": clip, "lr": 1e-2})
    rs = np.random.RandomState(3)
    shapes = {"decoder": {"a": (64, 32), "b": (32,)}, "encoder": {"proj": {"w": (16, 48)}}}
    jparams = jax.tree.map(lambda s: jnp.asarray(rs.randn(*s), jnp.bfloat16), shapes,
                           is_leaf=lambda s: isinstance(s, tuple))
    tx = j_make_optimizer(jcfg, 20)
    opt_state = tx.init(jparams)

    @jax.jit
    def jax_update(params, grads, opt_state):
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree.map(lambda q, u: q + u.astype(q.dtype), params, updates), opt_state

    names = {"decoder.a": ("decoder", "a"), "decoder.b": ("decoder", "b"),
             "encoder.proj.w": ("encoder", "proj", "w")}

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)

    params = {n: nn.Parameter(tensor(leaf(jparams, path))) for n, path in names.items()}
    opt = Optimizer(params, cfg, 20)
    for step in range(3):
        jgrads = jax.tree.map(lambda a: jnp.asarray(rs.randn(*a.shape) * 0.3, jnp.bfloat16),
                              jparams)
        jparams, opt_state = jax_update(jparams, jgrads, opt_state)
        opt.update({n: tensor(leaf(jgrads, path)) for n, path in names.items()})
    adam = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
            if hasattr(s, "mu")][0]
    equal = total = 0
    for n, path in names.items():
        for got, want in ((params[n].detach(), leaf(jparams, path)),
                          (opt.mu[n], leaf(adam.mu, path)), (opt.nu[n], leaf(adam.nu, path))):
            assert got.dtype == BF16
            g, w = got.float().numpy(), np.asarray(want, np.float32)
            np.testing.assert_array_less(np.abs(g - w), 2.0 ** -7 * np.abs(w) + 1e-30,
                                         err_msg=n)
        g, w = params[n].detach().float().numpy(), np.asarray(leaf(jparams, path), np.float32)
        equal, total = equal + int((g == w).sum()), total + g.size
    assert equal >= 0.99 * total, (equal, total)


def test_bridge_carries_jax_bf16_leaves_bit_for_bit():
    """JAX's parameter tree cast as its ``init_models`` casts it at
    ``param_dtype="bfloat16"``: the bf16 leaves reach the port as bf16
    tensors with the same 16 bits (no float round trip), and load into a
    bf16-parameter port model as they are."""
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if jnp.issubdtype(a.dtype, jnp.floating) else a, pair().params)
    sd = state_dict_from_jax(params["decoder"], PCFG(**TINY))
    assert all(v.dtype == BF16 for v in sd.values())
    kernel = np.asarray(params["decoder"]["in_proj"]["kernel"])
    assert kernel.dtype.name == "bfloat16"
    assert np.array_equal(sd["in_proj.weight"].view(torch.int16).numpy(),
                          np.ascontiguousarray(kernel.T).view(np.int16))
    esd = encoder_state_dict_from_jax({"params": params["encoder"]})
    assert esd["hubert.feature_extractor.conv_layers.0.conv.weight"].dtype == BF16
    pcfg = PCFG(**{**TINY, "param_dtype": "bfloat16"})
    pdec = dtypes.cast_parameters(PDecoder(pcfg), BF16)
    pdec.load_state_dict(sd)
    assert torch.equal(pdec.in_proj.weight.view(torch.int16), sd["in_proj.weight"].view(torch.int16))


# -- the float32 path ----------------------------------------------------------------


def test_float32_layers_are_their_torch_base_classes_bit_for_bit():
    """With float32 everything, each dtype-aware layer (``layers/dtypes.py``)
    computes exactly its torch base class's forward: the decoder (pre-net on,
    AdaLN) and the encoder (tiny HuBERT) give the same bits with every such
    layer turned back into the base class; a float32 dropout mask is the one
    ``torch.full_like`` gave."""
    cfg = PCFG(**TINY)
    torch.manual_seed(0)
    enc, dec = init_models(cfg, PHC.tiny())
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(2, 24, 80).astype(np.float32))
    t = torch.tensor([3, 40])
    sem = torch.from_numpy(rs.randint(0, 100, (2, 12)))
    wav = torch.from_numpy((0.1 * rs.randn(2, 3200)).astype(np.float32))

    def run():
        with torch.no_grad():
            return (dec.eval()(x, t, sem_idx=sem, step_idx=torch.zeros(2, dtype=torch.long)),
                    enc.eval()(wav)[0], enc.encode(wav))

    before = run()
    bases = {dtypes.Linear: nn.Linear, dtypes.Embedding: nn.Embedding, dtypes.Conv1d: nn.Conv1d,
             dtypes.LayerNorm: nn.LayerNorm, dtypes.GroupNorm: nn.GroupNorm}
    turned = 0
    for m in list(enc.modules()) + list(dec.modules()):
        if type(m) in bases:
            m.__class__ = bases[type(m)]
            turned += 1
    assert turned > 20
    for got, want in zip(run(), before):
        assert torch.equal(got, want)
    from edge_diffusion_tts_tpu_torch.layers.ffn import dropout
    h = torch.randn(3, 40)
    got = dropout(h, 0.2, True, torch.Generator().manual_seed(4))
    keep = torch.bernoulli(torch.full_like(h, 0.8), generator=torch.Generator().manual_seed(4))
    assert torch.equal(got, torch.where(keep.bool(), h / 0.8, 0.0))


def test_torch_dtype_helper():
    assert torch_dtype("float32") == torch.float32 and torch_dtype("bfloat16") == BF16
    assert torch_dtype(BF16) == BF16
    for bad in ("float16", "bf16", torch.float16):
        with pytest.raises(ValueError, match="float32"):
            torch_dtype(bad)
    with pytest.raises(ValueError, match="float32"):
        init_models(PCFG(**{**TINY, "compute_dtype": "float16"}), PHC.tiny())


# -- the frontend's bf16 plain version --------------------------------------------------


def _hubert_base_extractor():
    torch.manual_seed(0)
    fe = FeatureExtractor(PHC())
    with torch.no_grad():
        for layer in fe.conv_layers:
            layer.conv.weight.normal_(0, (2.0 / layer.conv.weight[0].numel()) ** 0.5)
    return fe


def _jax_helper_chain(fe, wav1: np.ndarray, dtype) -> np.ndarray:
    """One wav row through JAX's kernel helpers (``_gelu``, ``_conv_k3s2``,
    ``_conv_k2s2``) as ``_frontend_kernel`` composes them at ``dtype``."""
    kernels = [jnp.asarray(layer.conv.weight.detach().numpy().transpose(2, 1, 0))
               for layer in fe.conv_layers]
    n = wav1.shape[0]
    T0 = (n - 10) // 5 + 1
    patches = np.stack([wav1[j: j + 5 * (T0 - 1) + 1: 5] for j in range(10)], -1)
    w32 = ff.pack_frontend_weights(fe)
    scale, shift = ff.groupnorm_fold(torch.from_numpy(wav1[None]), w32["w0"], w32["gamma"],
                                     w32["beta"])

    @jax.jit
    def chain(patches, scale, shift, kernels):
        x = patches @ kernels[0][:, 0, :]
        x = jff._gelu(x * scale + shift).astype(dtype)
        rows = x.shape[0]
        for layer in range(1, 7):
            w = kernels[layer].astype(dtype)
            if layer <= 4:  # k=3: pad to even rows; the last output row is slack
                valid = (rows - 3) // 2 + 1
                if rows % 2:
                    x = jnp.concatenate([x, jnp.zeros((1, x.shape[1]), x.dtype)])
                y = jff._conv_k3s2(x, w, x.shape[0])[:valid]
            else:
                valid = rows // 2
                y = jff._conv_k2s2(x, w, 2 * valid)
            y = jff._gelu(y)
            x = y.astype(dtype) if layer < 6 else y
            rows = valid
        return x

    return np.asarray(chain(jnp.asarray(patches), jnp.asarray(scale.numpy()[0]),
                            jnp.asarray(shift.numpy()[0]), kernels), np.float32)


def test_frontend_plain_bf16_matches_jax_helpers():
    """``conv_frontend_plain(compute_dtype=bf16)`` at the hubert-base stack
    on [2, 8000]: within 5e-3 (normwise) of JAX's helpers composed at bf16,
    and by the witness rule against their float32 composition.  Rounding
    flips between the two (sums in another order) feed the next layer, so an
    elementwise bar would not hold; the float32 plain version equals the
    float32 composition to 1e-5."""
    fe = _hubert_base_extractor()
    wav = (0.2 * np.random.RandomState(1).randn(2, 8000)).astype(np.float32)
    wb = ff.pack_frontend_weights(fe, BF16)
    assert wb["wk3"].dtype == BF16 and wb["w0"].dtype == torch.float32
    got = ff.conv_frontend_plain(torch.from_numpy(wav), wb, compute_dtype=BF16).numpy()
    f32 = ff.conv_frontend_plain(torch.from_numpy(wav), ff.pack_frontend_weights(fe)).numpy()
    want = np.stack([_jax_helper_chain(fe, w, jnp.bfloat16) for w in wav])
    want32 = np.stack([_jax_helper_chain(fe, w, jnp.float32) for w in wav])
    assert got.shape == want.shape == (2, 24, 512) and got.dtype == np.float32
    np.testing.assert_allclose(f32, want32, atol=1e-5)
    assert rel(got, want) <= 5e-3, rel(got, want)
    witness("frontend plain", got, want, want32)
    # the same on the CPU entry point, which takes the plain version
    same = ff.conv_frontend(torch.from_numpy(wav), wb, compute_dtype=BF16).numpy()
    assert np.array_equal(same, got)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ff.conv_frontend(torch.from_numpy(wav), wb, compute_dtype=torch.float16)


@pytest.mark.slow
def test_frontend_plain_bf16_matches_jax_kernel_interpret():
    """Against JAX's ``fused_conv_frontend(..., interpret=True,
    compute_dtype=bf16)`` at [1, 8000] (slow: the Pallas interpreter)."""
    fe = _hubert_base_extractor()
    wav = (0.2 * np.random.RandomState(2).randn(1, 8000)).astype(np.float32)
    fe_params = {f"conv_{i}": {"kernel": jnp.asarray(
        layer.conv.weight.detach().numpy().transpose(2, 1, 0))}
        for i, layer in enumerate(fe.conv_layers)}
    gn = fe.conv_layers[0].layer_norm
    fe_params["group_norm"] = {"scale": jnp.asarray(gn.weight.detach().numpy()),
                               "bias": jnp.asarray(gn.bias.detach().numpy())}
    want = np.asarray(jff.fused_conv_frontend(JHC(), fe_params, jnp.asarray(wav), interpret=True,
                                              compute_dtype=jnp.bfloat16))
    want32 = np.asarray(jff.fused_conv_frontend(JHC(), fe_params, jnp.asarray(wav),
                                                interpret=True, compute_dtype=jnp.float32))
    got = ff.conv_frontend_plain(torch.from_numpy(wav), ff.pack_frontend_weights(fe, BF16),
                                 compute_dtype=BF16).numpy()
    assert rel(got, want) <= 5e-3, rel(got, want)
    witness("frontend plain vs the interpreted kernel", got, want, want32)


# -- train() at configs/tpu_large_batch.json ------------------------------------------


def _large_batch_cfg(tmp, **kw):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "tpu_large_batch.json")) as f:
        d = json.load(f)
    # cut to a tiny model on the CPU: widths, depth, schedule, batch, epochs
    d.update(hidden=32, layers=1, heads=2, segment_secs=0.1, batch_size=2, diff_steps=16,
             max_timestep=14, diffusion_epochs=1, progressive_epochs_per_halving=1,
             consistency_epochs=1, plot_every_steps=0, log_every_steps=1, val_every_steps=0,
             val_batches=1, ckpt_every_steps=3, out_dir=str(tmp / "out"), run_name="run",
             ckpt_path=str(tmp / "out" / "ckpt"))
    d.update(kw)
    return PCFG.from_dict(d)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_train_large_batch_config_bf16(tmp_path, monkeypatch, param_dtype):
    """``train()`` at configs/tpu_large_batch.json (compute bf16) cut to a
    tiny model, batch 2, one epoch per phase: all three phases with finite
    losses, the parameters at ``param_dtype``; the final checkpoint restores
    into a fresh state bit for bit (dtypes too); the final model serves
    through float32 modules."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # it imports TensorFlow
    cfg = _large_batch_cfg(tmp_path, param_dtype=param_dtype)
    assert cfg.compute_dtype == "bfloat16"
    rs = np.random.RandomState(0)
    loader = [{"wav": (0.1 * rs.randn(2, cfg.segment_len)).astype(np.float32)}
              for _ in range(2)]
    tags = []
    state = train(cfg, train_loader=loader, val_loader=loader[:1], hubert_cfg=PHC.tiny(),
                  device="cpu", phase_end_hook=lambda tag, st: tags.append(tag))
    assert tags[0] == "init" and tags[-1] == "consistency" and "diffusion" in tags
    pdt = torch_dtype(param_dtype)
    assert all(q.dtype == pdt for q in state.decoder.parameters())
    assert state.decoder.dtype == BF16 and state.encoder.dtype == BF16
    with open(os.path.join(cfg.get_run_dir(), "metrics.jsonl")) as f:
        losses = [v for line in f for k, v in json.loads(line).items() if k.endswith("loss")]
    assert losses and all(np.isfinite(losses))

    fresh_enc, fresh_dec = init_models(cfg, PHC.tiny())
    fresh = create_train_state(fresh_enc, fresh_dec,
                               p_make_optimizer(cfg, fresh_enc, fresh_dec, 10))
    fresh, _, _ = restore_checkpoint(os.path.join(cfg.get_run_dir(), "checkpoint_final"), fresh)
    for a, b in zip(state.state_dict()["decoder"].values(),
                    fresh.state_dict()["decoder"].values()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for n, m in state.optimizer.mu.items():
        assert m.dtype == pdt and torch.equal(m, fresh.optimizer.mu[n])

    sd, fcfg = restore_final_model(os.path.join(cfg.get_run_dir(), "edge_model_final"))
    assert all(v.dtype == pdt for k, v in sd["decoder"].items() if v.is_floating_point())
    dec = PDecoder(fcfg)  # float32 modules, as JAX's EdgeDiffusionDecoder(cfg) serves
    dec.load_state_dict(sd["decoder"])
    assert all(q.dtype == torch.float32 for q in dec.parameters())
    engine = EdgeInference(fcfg, PSchedule.create(fcfg.diff_steps), dec, prediction="v",
                           device="cpu")
    tokens = torch.from_numpy(rs.randint(0, fcfg.effective_codebook_size(), (1, 10)))
    mel = engine.generate_mel(tokens, num_steps=4)
    assert mel.shape == (1, 20, 80) and torch.isfinite(mel).all()
    state.decoder.eval()
    with torch.no_grad():  # the same weights at bf16 compute: the trained model's own forward
        x = torch.randn(1, 20, 80)
        t = torch.tensor([5])
        a = dec(x, t, sem_idx=tokens, step_idx=torch.zeros(1, dtype=torch.long))
        b = state.decoder(x, t, sem_idx=tokens, step_idx=torch.zeros(1, dtype=torch.long))
    assert rel(b.numpy(), a.numpy()) < 0.05


def test_parallel_training_refuses_bf16(tmp_path):
    cfg = dataclasses.replace(_large_batch_cfg(tmp_path), mesh_shape=[2, 1])
    with pytest.raises(NotImplementedError, match="A6.4"):
        train(cfg, train_loader=[], hubert_cfg=PHC.tiny(), device="cpu")


def test_fused_entry_points_refuse_bf16_compute():
    """The fused DDIM/DDPM entry points take the JAX functions'
    ``compute_dtype``; their bf16 variants are ROADMAP B2.3 and B1.4, so a
    bf16 call raises before anything runs."""
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    cfg = PCFG(**TINY)
    sem, x = torch.zeros(1, 4, dtype=torch.long), torch.zeros(1, 8, 80)
    with pytest.raises(NotImplementedError, match="B2.3"):
        fd.fused_generate_mel(cfg, PSchedule.create(50), None, sem, x, 4, compute_dtype=BF16)
    with pytest.raises(NotImplementedError, match="B1.4"):
        fd.fused_ddpm_sample(cfg, PSchedule.create(50), None, sem, x, compute_dtype=BF16)


def test_banded_attention_bf16_on_the_cpu_computes_in_float32():
    """On the CPU the band route's plain version takes bf16 q, k, v as the
    TPU kernel does: float32 inside, the output rounded to bf16."""
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa

    q, k, v = (torch.randn(1, 2, 40, 8, generator=torch.Generator().manual_seed(i)).to(BF16)
               for i in range(3))
    got = wa.banded_attention(q, k, v, 5)
    want = wa.banded_attention_plain(q.float(), k.float(), v.float(), 5).to(BF16)
    assert got.dtype == BF16 and torch.equal(got, want)


def test_ema_update_in_bf16_matches_jax():
    """``ema_update`` on a bf16 teacher works in bf16 as JAX's does (its
    0.999 rounds to 1.0 in bf16, so the teacher only gains 0.001 x the
    student): bit for bit against ``training.state.ema_update`` on the same
    bf16 trees, jitted and eager."""
    from edge_diffusion_tts_tpu.training.state import ema_update as j_ema
    from edge_diffusion_tts_tpu_torch.training.state import ema_update

    rs = np.random.RandomState(8)
    shapes = {"w": (16, 8), "b": (8,)}
    t_np = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    s_np = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jt = {k: jnp.asarray(v, jnp.bfloat16) for k, v in t_np.items()}
    js = {k: jnp.asarray(v, jnp.bfloat16) for k, v in s_np.items()}

    def module(tree):
        m = nn.Module()
        for k, v in tree.items():
            setattr(m, k, nn.Parameter(torch.from_numpy(v).to(BF16)))
        return m

    teacher, student = module(t_np), module(s_np)
    ema_update(teacher, student, 0.999)
    for want in (j_ema(jt, js, 0.999), jax.jit(lambda a, b: j_ema(a, b, 0.999))(jt, js)):
        for k in shapes:
            got = getattr(teacher, k).detach()
            assert got.dtype == BF16
            assert np.array_equal(got.float().numpy(), np.asarray(want[k], np.float32)), k
