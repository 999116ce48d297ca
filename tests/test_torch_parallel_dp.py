"""The port's data-parallel steps on two gloo ranks (CPU) against its own
big-batch step and against the JAX package's ``make_dp_*_step`` on a
2-device submesh.

One spawned group runs every case, while this process runs JAX's.  The
weights are the JAX init, jittered (as tests/test_torch_training_losses.py
builds them), and for the VQ case, held against the port's big batch only,
the port's init; the batch is 4 rows,
2 per rank, dropout and cfg dropout 0.  Replay keys hand both packages the
same draws: fixed ``t``/``step_indices``/``t1``/``t2``/noise where the JAX
losses read them, and for the two objectives that draw from their key, the
draws JAX makes on each shard (its step key folded with the shard index),
concatenated in shard order.  Bars:

- against the port's single-process step on the whole batch: loss rel 1e-6,
  gradients atol 1e-6, VQ statistics atol 1e-6, and the parameters after
  one AdamW update (a constant rate of 1e-3) atol 1e-6 plus the rate times
  the difference of the two updates' directions.  Adam's first update is
  lr * g / (|g| + 1e-8) (after the clip): where a gradient is near 1e-8,
  the float32 rounding of the split sums (~1e-10) moves it by ~1e-3 of the
  rate, so that term, computed in float64 from the two steps' own
  gradients, is the witness the bar adds for such elements;
- against JAX: loss and metrics rtol 1e-4 (atol 1e-6), every gradient
  tensor at cosine >= 0.99999 and norm rtol 1e-3 (the loss test's bars).
  JAX's gradients are read off its step with ``optax.scale(2**20)`` as the
  optimizer (new - old = 2**20 g).  Under the installed JAX (0.9),
  ``jax.grad`` inside ``shard_map`` of a replicated (``P()``) parameter
  already sums the shards' gradients (the transpose of the implicit
  ``pvary``), and the step's ``pmean`` then leaves that sum: the JAX step's
  gradient, and its ``grad_norm``, are the shard count (2) times the
  big-batch mean that the port's step reduces to.  The norms are held to
  that factor exactly as stated.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models import SemanticEncoder as JEncoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.parallel import make_mesh as jmake_mesh
from edge_diffusion_tts_tpu.parallel import replicate as jreplicate
from edge_diffusion_tts_tpu.parallel import shard_batch as jshard_batch
from edge_diffusion_tts_tpu.parallel.data_parallel import (
    make_dp_consistency_step,
    make_dp_diffusion_step,
    make_dp_progressive_step,
)
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu.training import Trainer as JTrainer
from edge_diffusion_tts_tpu.training import create_train_state as jcreate_train_state
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.models import HubertConfig as PHC
from edge_diffusion_tts_tpu_torch.models import SemanticEncoder as PEncoder
from edge_diffusion_tts_tpu_torch.models.vq import VectorQuantizer
from edge_diffusion_tts_tpu_torch.parallel.launch import spawn
from edge_diffusion_tts_tpu_torch.weights import encoder_state_dict_from_jax, state_dict_from_jax

import test_torch_parallel_ranks as ranks

TINY = dict(hidden=32, layers=1, heads=2, segment_secs=0.1, batch_size=4, grad_accumulation=1,
            diff_steps=50, max_timestep=48, dropout=0.0, cfg_dropout=0.0)
KINDS = ["diffusion", "diffusion_vq", "progressive", "pd_two_step", "consistency",
         "consistency_exact"]
JAX_KINDS = [k for k in KINDS if k != "diffusion_vq"]
SCALE = 2.0 ** 20
N_SHARDS = 2  # the JAX step's gradient is the shards' sum (module docstring)
TEACHER = ("progressive", "pd_two_step", "consistency_exact")


def jax_init_models(jcfg, hubert_cfg):
    """``training.init_models(jcfg, PRNGKey(0), hubert_cfg)`` with its two
    inits jitted (eager, each takes ~10 s on the CPU): (encoder, decoder,
    params, vq_state)."""
    encoder, decoder = JEncoder(jcfg, hubert_cfg), JDecoder(jcfg)
    k_enc, k_dec, k_drop, k_vq = jax.random.split(jax.random.PRNGKey(0), 4)
    wav = jnp.zeros((1, min(jcfg.segment_len, 4000)), jnp.float32)
    enc_vars = jax.jit(lambda: encoder.init({"params": k_enc, "dropout": k_drop, "vq": k_vq},
                                            wav, train=False))()
    dec_params = jax.jit(lambda: init_decoder_params(decoder, k_dec, jcfg)["params"])()
    params = {"encoder": dict(enc_vars["params"]), "decoder": dec_params}
    vq_state = {"encoder": enc_vars["vq_state"]} if "vq_state" in enc_vars else {}
    return encoder, decoder, params, vq_state


def _jitter(tree, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + scale * rng.randn(*np.shape(a))
                                              .astype(np.float32)), tree)


def _jax_model():
    jcfg = JCFG(**TINY)
    encoder, decoder, params, vq_state = jax_init_models(jcfg, JHC.tiny())
    params = {"encoder": _jitter(params["encoder"], 1), "decoder": _jitter(params["decoder"], 2)}
    teacher = _jitter(params["decoder"], 3, scale=0.02)
    weights = {"encoder": encoder_state_dict_from_jax({"params": params["encoder"]}),
               "decoder": state_dict_from_jax(params["decoder"]),
               "teacher": state_dict_from_jax(teacher)}
    jt = JTrainer(jcfg, encoder, decoder, JSchedule.create(jcfg.diff_steps), optax.scale(SCALE))
    return dict(jcfg=jcfg, jt=jt, params=params, vq_state=vq_state, teacher=teacher,
                weights=weights)


def _jax_dp_step(model, kind, jbatch, rng, mesh):
    jt = model["jt"]
    if kind.startswith("diffusion"):
        step = make_dp_diffusion_step(jt, mesh)
    elif kind in ("progressive", "pd_two_step"):
        step = make_dp_progressive_step(jt, mesh, num_steps=4, exact=kind == "pd_two_step")
    else:
        step = make_dp_consistency_step(jt, mesh, exact=kind == "consistency_exact")
    # The step donates its state: hand it fresh copies.
    fresh = lambda tree: jax.tree.map(lambda a: jnp.array(np.asarray(a)), tree)  # noqa: E731
    state = jcreate_train_state(model["jcfg"], fresh(model["params"]), fresh(model["vq_state"]),
                                jt.tx)
    if kind in TEACHER:
        state = state.replace(teacher=fresh(model["teacher"]))
    with mesh:
        new, metrics = step(jreplicate(state, mesh), jshard_batch(jbatch, mesh), rng)
    grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / SCALE,
                         new.params, model["params"])
    out = {f"encoder.{k}": v.numpy() for k, v in
           encoder_state_dict_from_jax({"params": grads["encoder"]}).items()
           if not k.startswith("hubert.")}
    out.update({f"decoder.{k}": v.numpy()
                for k, v in state_dict_from_jax(grads["decoder"]).items()})
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": out}


def _port_vq_weights():
    """A VQ encoder and a decoder (its output head nonzero) from torch's init."""
    cfg = ranks.tiny_cfg(use_fsq=False)
    torch.manual_seed(3)
    enc, dec = PEncoder(cfg, PHC.tiny()), PDecoder(cfg)
    with torch.no_grad():
        dec.out_proj.weight.normal_(0, 0.05)
    return {"encoder": enc.state_dict(), "decoder": dec.state_dict()}


@pytest.fixture(scope="module")
def dp():
    model = _jax_model()
    jcfg = model["jcfg"]
    wav = (np.random.RandomState(4).randn(4, jcfg.segment_len) * 0.1).astype(np.float32)
    mel_shape = tuple(model["jt"]._mel_normalized(jnp.asarray(wav)).shape)
    noise = np.random.RandomState(11).randn(*mel_shape).astype(np.float32)
    rng = jax.random.PRNGKey(5)

    def shard_draws(key_name, hi):
        """JAX's own draws on each of the 2 shards, in shard order."""
        idx, nz = [], []
        for i in range(2):
            _, k_i, k_noise, _ = jax.random.split(jax.random.fold_in(rng, i), 4)
            idx.append(np.asarray(jax.random.randint(k_i, (2,), 0, hi)))
            nz.append(np.asarray(jax.random.normal(k_noise, (2,) + mel_shape[1:])))
        return {key_name: np.concatenate(idx), "noise": np.concatenate(nz)}

    cases, jax_batches = {}, {}
    for kind in KINDS:
        batch = {"wav": wav, "noise": noise}
        if kind.startswith("diffusion"):
            batch["t"] = np.array([7, 40, 3, 22], np.int64)
        elif kind == "progressive":
            batch["step_indices"] = np.array([1, 3, 0, 2], np.int64)
        elif kind == "consistency":
            batch["t1"] = np.array([3, 30, 12, 45], np.int64)
            batch["t2"] = np.array([45, 12, 30, 3], np.int64)
        elif kind == "pd_two_step":
            batch.update(shard_draws("step_indices", 4))
        else:
            batch.update(shard_draws("n", 39))
        drawn = kind in ("pd_two_step", "consistency_exact")
        jax_batches[kind] = {k: jnp.asarray(v) for k, v in batch.items()
                             if k == "wav" or not drawn}
        vq = kind == "diffusion_vq"
        cases[kind] = {"kind": kind, "cfg": {"use_fsq": not vq},
                       "weights": _port_vq_weights() if vq else model["weights"],
                       "batch": batch}

    vq_cases = {}
    for name, (K, B, T, reset) in {"vq_ema": (16, 8, 4, 0), "vq_reset": (64, 8, 2, 1)}.items():
        torch.manual_seed(K)
        vq = VectorQuantizer(4, K, reset_unused_every=reset)
        z = np.random.RandomState(K).randn(B, T, 4).astype(np.float32)
        vq_cases[name] = {"dim": 4, "K": K, "reset": reset, "state": vq.state_dict(), "z": z}

    with ThreadPoolExecutor(1) as pool:  # the ranks run while this process runs JAX
        ranks_done = pool.submit(spawn, ranks.dp_rank, 2, args=(cases, vq_cases), threads=1,
                                 timeout=300)
        mesh = jmake_mesh((2, 1), devices=jax.devices()[:2])
        jax_out = {kind: _jax_dp_step(model, kind, jax_batches[kind], rng, mesh)
                   for kind in JAX_KINDS}
        single = {k: ranks.run_step(ranks.tiny_cfg(**c["cfg"]), c["weights"], c["kind"],
                                    c["batch"]) for k, c in cases.items()}
        results = ranks_done.result()
    return dict(ranks=results, single=single, jax=jax_out, cases=cases, vq_cases=vq_cases)


def _close(a, b, atol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("kind", KINDS)
def test_dp_step_equals_big_batch_step(dp, kind):
    one, got = dp["single"][kind], dp["ranks"][0]["steps"][kind]
    loss, want = got["metrics"]["loss"], one["metrics"]["loss"]
    assert abs(loss - want) <= 1e-6 * abs(want), (loss, want)
    assert set(got["grads"]) == set(one["grads"])
    for n, g in one["grads"].items():
        _close(got["grads"][n], g, 1e-6, f"{kind} grad {n}")
    clip = ranks.tiny_cfg().grad_clip
    u_got = ranks.adam_direction(got["grads"], clip)
    u_one = ranks.adam_direction(one["grads"], clip)
    for n, p in one["params"].items():
        bar = 1e-6 + ranks.LR * np.abs(u_got[n] - u_one[n])
        diff = np.abs(got["params"][n].numpy() - p.numpy())
        assert (diff <= bar).all(), (kind, n, float(diff.max()), float((diff - bar).max()))
    for k, v in one["vq"].items():
        _close(got["vq"][k].float(), v.float(), 1e-6, f"{kind} vq {k}")


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_dp_step_matches_jax(dp, kind):
    got, want = dp["ranks"][0]["steps"][kind], dp["jax"][kind]
    assert set(got["metrics"]) == set(want["metrics"]), set(got["metrics"]) ^ set(want["metrics"])
    for k, v in want["metrics"].items():
        scale = N_SHARDS if k == "grad_norm" else 1
        np.testing.assert_allclose(scale * got["metrics"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{kind} metric {k}")
    assert set(got["grads"]) == set(want["grads"]), sorted(set(got["grads"]) ^ set(want["grads"]))
    nonzero = 0
    for name, w in want["grads"].items():
        g = got["grads"][name].numpy()
        nw, ng = np.linalg.norm(w), np.linalg.norm(g)
        if nw < 1e-10:
            assert N_SHARDS * ng < 1e-8, f"{kind} {name}: JAX's gradient is 0, the port's {ng}"
            continue
        nonzero += 1
        cos = float(np.dot(g.ravel().astype(np.float64), w.ravel()) / (ng * nw))
        assert cos >= 0.99999, f"{kind} {name}: gradient cosine {cos}"
        np.testing.assert_allclose(N_SHARDS * ng, nw, rtol=1e-3,
                                   err_msg=f"{kind} {name} grad norm")
    assert nonzero > len(want["grads"]) // 2


def test_dp_replicas_stay_bit_equal(dp):
    r0, r1 = dp["ranks"]
    for kind in KINDS:
        a, b = r0["steps"][kind], r1["steps"][kind]
        assert a["metrics"] == b["metrics"], kind
        for n in a["params"]:
            assert torch.equal(a["params"][n], b["params"][n]), (kind, n)
        for k in a["vq"]:
            assert torch.equal(a["vq"][k], b["vq"][k]), (kind, k)


def test_host_local_batch_feeds_the_dp_step(dp):
    """Each rank feeding only its own rows is the same step as shard_batch
    of the global batch; the pod mesh over one node is the plain mesh."""
    for r in dp["ranks"]:
        a, b = r["host_local"], r["steps"]["diffusion"]
        assert a["metrics"] == b["metrics"]
        assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
        assert r["pod_mesh"] == {"data": 2, "model": 1}


def test_vq_ema_sharded_matches_big_batch(dp):
    """Counterpart of the JAX test of the same name: the EMA statistics
    summed over the ranks equal the big-batch update (a mean of per-rank
    updates would dilute the counts by the rank count)."""
    vc = dp["vq_cases"]["vq_ema"]
    ref = VectorQuantizer(vc["dim"], vc["K"], reset_unused_every=0)
    ref.load_state_dict(vc["state"])
    ref(torch.as_tensor(vc["z"]), train=True)
    for r in dp["ranks"]:
        for name in ("ema_cluster_size", "ema_w", "codebook"):
            _close(r["vq_ema"][name], ref.state_dict()[name], 1e-6, name)
    B, T = vc["z"].shape[:2]
    assert abs(float(dp["ranks"][0]["vq_ema"]["ema_cluster_size"].sum())
               - (0.99 * vc["K"] + 0.01 * B * T)) < 1e-4


def test_vq_reset_sharded_uses_real_vectors(dp):
    """A sharded dead-code reset installs real batch rows (from either
    rank) and leaves the codebook bit-equal on every rank."""
    vc = dp["vq_cases"]["vq_reset"]
    a, b = (r["vq_reset"] for r in dp["ranks"])
    for k in a:
        assert torch.equal(a[k], b[k]), k
    flat = vc["z"].reshape(-1, vc["dim"])
    cb0 = vc["state"]["codebook"].numpy()
    counts = np.bincount(((flat[:, None] - cb0[None]) ** 2).sum(-1).argmin(1),
                         minlength=vc["K"])
    dead = np.where(counts == 0)[0][: flat.shape[0]]
    assert dead.size > 8
    codebook = a["codebook"].numpy()
    for r in dead[:8]:
        assert np.abs(flat - codebook[r]).max(axis=1).min() < 1e-6, r
