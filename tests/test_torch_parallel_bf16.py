"""bfloat16 compute and parameters through the port's ``parallel/`` on two
gloo ranks (CPU), against the port's single-process bf16 programs and the
JAX package's bf16 parallel steps on a submesh of its virtual CPU devices.

One spawned group of 2 ranks runs every case (``ranks.bf16_rank``) while
this process runs JAX's steps and the single-process references.  Weights:
the JAX init, jittered (as tests/test_torch_parallel_dp.py builds them), at
hidden 32, 2 layers, the tiny HuBERT; 4 rows, dropout 0, JAX's draws
replayed through the batch.  Three dtype cases: float32 ("f32"), compute
bf16 with float32 parameters ("bf16/f32", configs/tpu_large_batch.json's
pair) and compute bf16 with bf16 parameters ("bf16/bf16").

A bf16 quantity Q is held by the witness rule of tests/test_torch_bf16.py
against the float32 result Q32 of the same program on the same weights:
``|Q - Q32| <= 1.5 |Q_ref - Q32| + 1e-3`` (norms), a gradient by
``cos(g, g32) >= cos(g_ref, g32) - 0.01`` for each tensor, tokens by
``share(tok == tok32) >= share(tok_ref == tok32) - 0.02``, where Q_ref is
the port's single-process bf16 result or JAX's bf16 parallel result.  Held
against JAX's, the steps' scalar metrics take the rule on their pool (the
sum of the relative errors of every metric of the steps): one scalar's bf16
error is one draw of where torch and XLA round, and single metrics of
either package land 0.1-1% from float32 in either order.  JAX's
data-parallel gradient and ``grad_norm`` are the shard count (2) times the
mean the port reduces to (ROADMAP Queue C 4), so JAX's are halved, exactly,
before they are compared; JAX's pipeline step has no such factor.  Its
gradients are read off its step with ``optax.scale(2**20)`` (new - old =
2**20 g; at bf16 parameters that difference rounds at 2**-9 of g).

Also: the DP step's gradients equal its two shards' single-process
gradients, their float32 mean rounded to the parameters' dtype, bit for
bit; the 2-rank gradient bucket (a bf16 all-reduce, halved, equals the
float32 bucket rounded back to bf16, and the exact mean, bit for bit); one
all-reduce per DP step at every dtype; the pipeline stage norm equal to
``global_norm`` of the whole model's gradients bit for bit; the dtypes of
the stage, canonical and reloaded decoders; ``train()`` on a mesh and on
pipeline stages at configs/tpu_large_batch.json cut to a tiny model.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models import SemanticEncoder as JEncoder
from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.parallel import make_mesh as jmake_mesh
from edge_diffusion_tts_tpu.parallel import replicate as jreplicate
from edge_diffusion_tts_tpu.parallel import shard_batch as jshard_batch
from edge_diffusion_tts_tpu.parallel.data_parallel import (
    make_dp_consistency_step,
    make_dp_diffusion_step,
    make_dp_progressive_step,
)
from edge_diffusion_tts_tpu.parallel.pipeline_parallel import create_pp_state as jcreate_pp_state
from edge_diffusion_tts_tpu.parallel.pipeline_parallel import (
    make_pp_diffusion_step as jmake_pp_diffusion_step,
)
from edge_diffusion_tts_tpu.parallel.pipeline_parallel import pp_pack_params as jpp_pack_params
from edge_diffusion_tts_tpu.parallel.pipeline_parallel import (
    pp_unpack_params as jpp_unpack_params,
)
from edge_diffusion_tts_tpu.parallel.tensor_parallel import make_tp_encode as jmake_tp_encode
from edge_diffusion_tts_tpu.parallel.tensor_parallel import (
    shard_encoder_params as jshard_encoder_params,
)
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu.training import Trainer as JTrainer
from edge_diffusion_tts_tpu.training import create_train_state as jcreate_train_state
from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder
from edge_diffusion_tts_tpu_torch.parallel import make_dp_generate
from edge_diffusion_tts_tpu_torch.parallel.launch import spawn
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule, ddim_sample
from edge_diffusion_tts_tpu_torch.training.state import global_norm
from edge_diffusion_tts_tpu_torch.weights import (encoder_state_dict_from_jax, load_checkpoint,
                                                  state_dict_from_jax)

import test_torch_parallel_ranks as ranks
from test_torch_parallel_dp import _jitter, jax_init_models

BF16 = torch.bfloat16
TINY = dict(hidden=32, layers=2, heads=2, segment_secs=0.1, batch_size=4, grad_accumulation=1,
            diff_steps=50, max_timestep=48, dropout=0.0, cfg_dropout=0.0)
KINDS = ["diffusion", "progressive", "consistency"]
PDTS = ["float32", "bfloat16"]  # the parameter dtypes at compute bf16
CASES = {"f32": dict(layers=2), **{pdt: dict(layers=2, compute_dtype="bfloat16",
                                             param_dtype=pdt) for pdt in PDTS}}
FACTOR, SLACK, COS_SLACK, TOKEN_SLACK = 1.5, 1e-3, 0.01, 0.02  # the witness rule's bars
SCALE = 2.0 ** 20
USAGE = ("perplexity", "used_codes")  # token counts: a DP step's are its shards' means
N_SHARDS = 2  # JAX's DP gradient is the shards' sum (module docstring)
SEQ = dict(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=4, diff_steps=50,
           max_timestep=48, use_flash_attn=False, max_mel_positions=2048, max_ctx_positions=1024)
SEQ_T, SEQ_STEPS = 128, 4
TRAIN_STEPS_PER_EPOCH = 2


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def witness(what: str, q, q_ref, q32) -> None:
    e, e_ref = rel(q, q32), rel(q_ref, q32)
    assert e <= FACTOR * e_ref + SLACK, f"{what}: {e:.3g} from float32, the reference {e_ref:.3g}"


def witness_pooled(what: str, triples) -> None:
    """The witness rule over several scalars ``(q, q_ref, q32)`` at once: the
    sum of their relative errors against 1.5 times the reference's sum plus
    1e-3 each.  One scalar's bf16 error is one draw of the rounding; the
    rule is held on the pool, as the token share of the kernel-route
    witness is (tests/test_torch_kernels_gpu.py)."""
    e = sum(rel(q, q32) for q, _, q32 in triples)
    e_ref = sum(rel(r, q32) for _, r, q32 in triples)
    assert e <= FACTOR * e_ref + SLACK * len(triples), (
        f"{what}: {e:.3g} from float32 over {len(triples)} scalars, the reference {e_ref:.3g}")


def cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def hold_grads(what: str, got: dict, ref: dict, g32: dict) -> None:
    """Every gradient by the cosine bar, against float32's; most nonzero."""
    assert set(got) == set(g32), sorted(set(got) ^ set(g32))
    nonzero = 0
    for n, want in g32.items():
        w, r = np.asarray(want, np.float64), np.asarray(ref[n], np.float64)
        if np.linalg.norm(w) < 1e-10 or np.linalg.norm(r) < 1e-10:
            continue
        nonzero += 1
        c, c_ref = cosine(got[n], w), cosine(r, w)
        assert c >= c_ref - COS_SLACK, f"{what} {n}: cos {c:.5f}, the reference {c_ref:.5f}"
    assert nonzero > len(g32) // 2, nonzero


def _f64(tree: dict) -> dict:
    return {n: t.double().numpy() if torch.is_tensor(t) else np.asarray(t, np.float64)
            for n, t in tree.items()}


def _flat(params: dict) -> np.ndarray:
    return np.concatenate([t.double().numpy().ravel() for _, t in sorted(params.items())])


# -- JAX's side ---------------------------------------------------------------------------


def _fresh(tree, dtype=None):
    """A copy the donating JAX steps may consume; floats cast to ``dtype``."""
    def leaf(a):
        a = jnp.array(np.asarray(a))
        return a.astype(dtype) if dtype is not None and jnp.issubdtype(a.dtype, jnp.floating) \
            else a
    return jax.tree.map(leaf, tree)


def _jax_grads(new, old, scale=SCALE) -> dict:
    """(new - old) / scale of a parameter tree, under the port's names
    (the frozen HuBERT left out)."""
    g = jax.tree.map(lambda a, b: (np.asarray(a, np.float32) - np.asarray(b, np.float32))
                     / scale, new, old)
    out = {f"encoder.{k}": v.numpy() for k, v in
           encoder_state_dict_from_jax({"params": g["encoder"]}).items()
           if not k.startswith("hubert.")}
    out.update({f"decoder.{k}": v.numpy() for k, v in state_dict_from_jax(g["decoder"]).items()})
    return out


def _jax_dp(model, kind, pdt, batch, mesh) -> dict:
    jt = model["jt16"]
    step = {"diffusion": lambda: make_dp_diffusion_step(jt, mesh),
            "progressive": lambda: make_dp_progressive_step(jt, mesh, num_steps=4),
            "consistency": lambda: make_dp_consistency_step(jt, mesh)}[kind]()
    dt = jnp.dtype(pdt)
    state = jcreate_train_state(model["jcfg"], _fresh(model["params"], dt), {}, jt.tx)
    if kind == "progressive":
        state = state.replace(teacher=_fresh(model["teacher"], dt))
    old = _fresh(model["params"], dt)
    with mesh:
        new, metrics = step(jreplicate(state, mesh), jshard_batch(batch, mesh), model["rng"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _jax_grads(new.params, old)}


def _jax_pp(model, pdt, batch) -> dict:
    jt = model["jt16"]
    pipe = JMesh(np.array(jax.devices()[:2]), ("pipe",))
    dt = jnp.dtype(pdt)
    state = jcreate_pp_state(model["jcfg"], _fresh(model["params"], dt), {}, jt.tx, pipe)
    old = jpp_pack_params(_fresh(model["params"], dt))
    with pipe:
        new, metrics = jmake_pp_diffusion_step(jt, pipe, 2)(state, batch, model["rng"])
    grads = _jax_grads(jpp_unpack_params(jax.tree.map(np.asarray, new.params)),
                       jpp_unpack_params(old))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads}


def _jax_tp(model, pdt, wav) -> np.ndarray:
    mesh = jmake_mesh((1, 2), devices=jax.devices()[:2])
    enc = model["jt16"].encoder
    params = _fresh(model["params"]["encoder"], jnp.dtype(pdt))
    with mesh:
        return np.asarray(jmake_tp_encode(enc, mesh)(jshard_encoder_params(params, mesh), wav))


# -- the fixture ------------------------------------------------------------------------


def _large_batch_cfg(tmp, name: str, **kw) -> dict:
    """configs/tpu_large_batch.json cut to a tiny model (widths, depth 2,
    schedule, batch 2, one epoch per phase), its dtypes as shipped unless
    ``kw`` sets them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "tpu_large_batch.json")) as f:
        d = json.load(f)
    d.update(hidden=32, layers=2, heads=2, segment_secs=0.1, batch_size=2, diff_steps=16,
             max_timestep=14, diffusion_epochs=1, progressive_epochs_per_halving=1,
             consistency_epochs=1, plot_every_steps=0, log_every_steps=1, val_every_steps=0,
             val_batches=1, ckpt_every_steps=3, out_dir=str(tmp / name), run_name="run",
             ckpt_path=str(tmp / name / "ckpt"))
    d.update(kw)
    return d


@pytest.fixture(scope="module")
def par(tmp_path_factory):
    jcfg = JCFG(**TINY)
    _, _, params, _ = jax_init_models(jcfg, JHC.tiny())
    params = {"encoder": _jitter(params["encoder"], 1), "decoder": _jitter(params["decoder"], 2)}
    teacher = _jitter(params["decoder"], 3, scale=0.02)
    jt16 = JTrainer(jcfg, JEncoder(jcfg, JHC.tiny(), dtype=jnp.bfloat16),
                    JDecoder(jcfg, dtype=jnp.bfloat16), JSchedule.create(jcfg.diff_steps),
                    optax.scale(SCALE))
    model = dict(jcfg=jcfg, jt16=jt16, params=params, teacher=teacher,
                 rng=jax.random.PRNGKey(5))
    weights = {"encoder": encoder_state_dict_from_jax({"params": params["encoder"]}),
               "decoder": state_dict_from_jax(params["decoder"]),
               "teacher": state_dict_from_jax(teacher)}

    rs = np.random.RandomState(4)
    wav = (rs.randn(4, jcfg.segment_len) * 0.1).astype(np.float32)
    mel_shape = tuple(jt16._mel_normalized(jnp.asarray(wav)).shape)
    base = {"wav": wav, "noise": rs.randn(*mel_shape).astype(np.float32)}
    batches = {"diffusion": dict(base, t=np.array([7, 40, 3, 22])),
               "progressive": dict(base, step_indices=np.array([1, 3, 0, 2])),
               "consistency": dict(base, t1=np.array([3, 30, 12, 45]),
                                   t2=np.array([45, 12, 30, 3]))}
    # the 2-rank bucket: bf16 values over 40 binades, signs mixed, per rank
    g = torch.Generator().manual_seed(8)
    bucket = [(torch.randn(8192, generator=g)
               * torch.exp2(torch.randint(-20, 20, (8192,), generator=g).float())).to(BF16)
              for _ in range(2)]
    bucket[1][:64] = -bucket[0][:64]  # exact cancellation
    bucket[1][64:128] = bucket[0][64:128]  # ties of the halving
    tp_wav = (np.random.RandomState(3).randn(2, 3200) * 0.1).astype(np.float32)

    seq_cfg = CFG(**SEQ)
    torch.manual_seed(6)
    seq_dec = EdgeDiffusionDecoder(seq_cfg)
    with torch.no_grad():  # a nonzero head, so the sampler moves
        seq_dec.out_proj.weight.normal_(0, 0.05)
    srs = np.random.RandomState(7)
    seq = {"cfg": SEQ, "decoder": seq_dec.state_dict(), "steps": SEQ_STEPS,
           "sem": srs.randint(0, seq_cfg.effective_codebook_size(), (1, SEQ_T // 2)),
           "x_T": srs.randn(1, SEQ_T, 80).astype(np.float32)}

    tmp = tmp_path_factory.mktemp("train")
    seg = CFG.from_dict(_large_batch_cfg(tmp, "x")).segment_len
    lrs = np.random.RandomState(0)
    loader = [{"wav": (0.1 * lrs.randn(2, seg)).astype(np.float32)}
              for _ in range(TRAIN_STEPS_PER_EPOCH)]
    train_cfgs = {(layout, pdt): _large_batch_cfg(tmp, f"{layout}-{pdt}", param_dtype=pdt, **kw)
                  for layout, kw in (("mesh", dict(mesh_shape=[2, 1])),
                                     ("pipe", dict(pipeline_stages=2)))
                  for pdt in PDTS}

    spec = dict(cases=CASES, weights=weights, batches=batches, bucket=bucket,
                tp={"wav": tp_wav}, seq=seq, train=train_cfgs, loader=loader)
    # The ranks run while this process runs JAX's steps, four at a time (XLA
    # compiles outside the GIL).
    with ThreadPoolExecutor(5) as pool:
        ranks_done = pool.submit(spawn, ranks.bf16_rank, 2, args=(spec,), threads=1,
                                 timeout=400)
        mesh = jmake_mesh((2, 1), devices=jax.devices()[:2])
        jbatches = {k: {n: jnp.asarray(v) for n, v in b.items()} for k, b in batches.items()}
        jobs = {("dp", (pdt, kind)): (_jax_dp, model, kind, pdt, jbatches[kind], mesh)
                for pdt in PDTS for kind in KINDS}
        jobs.update({("pp", pdt): (_jax_pp, model, pdt, jbatches["diffusion"]) for pdt in PDTS})
        jobs.update({("tp", pdt): (_jax_tp, model, pdt, tp_wav) for pdt in PDTS})
        done = {key: pool.submit(*job) for key, job in jobs.items()}
        single = {(case, kind): ranks.run_step(ranks.tiny_cfg(**kw), weights, kind, batches[kind])
                  for case, kw in CASES.items() for kind in KINDS}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # the ranks' one thread: the same sums in the same order
        shards = {(case, kind): [ranks.run_step(ranks.tiny_cfg(**kw), weights, kind,
                                                {k: v[2 * r:2 * r + 2]
                                                 for k, v in batches[kind].items()})["grads"]
                                 for r in range(2)]
                  for case, kw in CASES.items() for kind in KINDS}
        torch.set_num_threads(threads)
        encode = {}
        with torch.no_grad():
            for case, kw in CASES.items():
                enc, _ = ranks.build_models(ranks.tiny_cfg(**kw), weights)
                encode[case] = enc.eval().encode(torch.as_tensor(tp_wav))
        jax_out = {"dp": {}, "pp": {}, "tp": {}}
        for (part, key), fut in done.items():
            jax_out[part][key] = fut.result()
        results = ranks_done.result()
    return dict(ranks=results, jax=jax_out, single=single, shards=shards, encode=encode,
                seq=seq, train=train_cfgs, bucket=bucket)


# -- data parallel ------------------------------------------------------------------------


def _hold_step(what, got, ref, q32):
    """Loss, grad_norm, gradients and the parameters after the update."""
    witness(f"{what} loss", got["metrics"]["loss"], ref["metrics"]["loss"],
            q32["metrics"]["loss"])
    if "grad_norm" in ref["metrics"]:  # the single phase-2/3 steps report none
        witness(f"{what} grad_norm", got["metrics"]["grad_norm"], ref["metrics"]["grad_norm"],
                q32["metrics"]["grad_norm"])
    hold_grads(what, _f64(got["grads"]), _f64(ref["grads"]), _f64(q32["grads"]))
    if "params" in got:
        witness(f"{what} parameters after the update", _flat(got["params"]),
                _flat(ref["params"]), _flat(q32["params"]))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pdt", PDTS)
def test_dp_bf16_step_witness_vs_big_batch(par, pdt, kind):
    """The DP step at compute bf16 against the single-process big-batch bf16
    step, float32's big-batch step as Q32; its gradients at the parameters'
    dtype."""
    got = par["ranks"][0]["steps"][(pdt, kind)]
    _hold_step(f"DP {pdt} {kind}", got, par["single"][(pdt, kind)], par["single"][("f32", kind)])
    want = torch.float32 if pdt == "float32" else BF16
    assert all(g.dtype == want for g in got["grads"].values())
    assert all(p.dtype == want for p in got["params"].values())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pdt", PDTS)
def test_dp_bf16_step_matches_jax(par, pdt, kind):
    """Against JAX's ``make_dp_*_step`` at the same dtypes on 2 CPU devices:
    the gradients (JAX's halved) by the cosine bar, the port's float32 DP
    step as Q32."""
    got, want = par["ranks"][0]["steps"][(pdt, kind)], par["jax"]["dp"][(pdt, kind)]
    q32 = par["ranks"][0]["steps"][("f32", kind)]
    assert set(got["metrics"]) == set(want["metrics"])
    jax_grads = {n: g / N_SHARDS for n, g in want["grads"].items()}
    hold_grads(f"DP {pdt} {kind} vs JAX", _f64(got["grads"]), jax_grads, _f64(q32["grads"]))


@pytest.mark.parametrize("pdt", PDTS)
def test_dp_bf16_metrics_match_jax(par, pdt):
    """The three DP steps' loss, every metric but the token-usage counts and
    ``grad_norm`` (JAX's halved) against JAX's by the witness rule held on
    their pool, the port's float32 DP steps as Q32."""
    triples = []
    for kind in KINDS:
        got, want = par["ranks"][0]["steps"][(pdt, kind)], par["jax"]["dp"][(pdt, kind)]
        q32 = par["ranks"][0]["steps"][("f32", kind)]
        for k, v in want["metrics"].items():
            if k not in USAGE:
                scale = N_SHARDS if k == "grad_norm" else 1
                triples.append((got["metrics"][k], v / scale, q32["metrics"][k]))
    assert len(triples) == 17
    witness_pooled(f"DP {pdt} metrics vs JAX", triples)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(CASES))
def test_dp_gradients_are_the_shards_mean(par, case, kind):
    """The gradients a DP step hands the optimizer are, bit for bit, each
    rank's rows stepped alone in this process, their float32 mean rounded
    to the parameters' dtype: the bucket adds nothing but that mean."""
    got = par["ranks"][0]["steps"][(case, kind)]["grads"]
    shards = par["shards"][(case, kind)]
    assert set(got) == set(shards[0])
    for n, g in got.items():
        want = ((shards[0][n].float() + shards[1][n].float()) / 2).to(g.dtype)
        assert torch.equal(g, want), (case, kind, n)


def test_dp_bf16_replicas_stay_bit_equal(par):
    r0, r1 = par["ranks"]
    assert set(r0["steps"]) == {(c, k) for c in CASES for k in KINDS}
    for key, a in r0["steps"].items():
        b = r1["steps"][key]
        assert a["metrics"] == b["metrics"], key
        for n in a["params"]:
            assert a["params"][n].dtype == b["params"][n].dtype
            assert torch.equal(a["params"][n], b["params"][n]), (key, n)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_makes_one_allreduce(par, case):
    """One all-reduce per DP step at every dtype: the float32 bucket."""
    assert [r["allreduces"][case] for r in par["ranks"]] == [1, 1]


def test_two_rank_bucket_equals_a_bf16_allreduce(par):
    """Two ranks' bf16 values: gloo's bf16 all-reduce halved, the float32
    bucket halved and rounded back to bf16, and the exact mean rounded to
    bf16 are the same bits."""
    a, b = par["bucket"]
    exact = ((a.double() + b.double()) / 2).float().to(BF16)  # float32 holds it exactly
    for r in par["ranks"]:
        bf16, f32 = r["bucket"]["bf16"], r["bucket"]["float32"]
        assert bf16.dtype == f32.dtype == BF16
        assert torch.equal(bf16.view(torch.int16), f32.view(torch.int16))
        assert torch.equal(f32.view(torch.int16), exact.view(torch.int16))


# -- pipeline parallel ----------------------------------------------------------------


def _pp_grads(res) -> dict:
    grads = {}
    for r in res:
        grads.update(r)
    return grads


@pytest.mark.parametrize("pdt", PDTS)
def test_pp_bf16_step_witness_vs_single(par, pdt):
    """Two stages x 2 microbatches against the single-process bf16 step."""
    r0, r1 = (r["pp"][pdt] for r in par["ranks"])
    assert r0["metrics"] == r1["metrics"]
    got = {"metrics": r0["metrics"], "grads": _pp_grads([r0["grads"], r1["grads"]])}
    _hold_step(f"PP {pdt}", got, par["single"][(pdt, "diffusion")],
               par["single"][("f32", "diffusion")])


@pytest.mark.parametrize("pdt", PDTS)
def test_pp_stage_norm_is_the_global_norm(par, pdt):
    """The clip's norm of a stage (``grad_norm``) is ``global_norm`` of the
    whole model's gradients in the single-device order: at bf16 parameters
    bit for bit (the running bf16 sum over every stage's tensors), at
    float32 to float32 rounding (the stages' float32 partial sums)."""
    r0, r1 = (r["pp"][pdt] for r in par["ranks"])
    grads = _pp_grads([r0["grads"], r1["grads"]])
    order = list(par["single"][(pdt, "diffusion")]["grads"])
    assert set(order) == set(grads)
    want = global_norm([grads[n] for n in order])
    if pdt == "float32":  # float32 squares, summed per stage, as before: rounding apart
        np.testing.assert_allclose(r0["metrics"]["grad_norm"], float(want), rtol=1e-6)
    else:
        assert want.dtype == BF16 and r0["metrics"]["grad_norm"] == float(want)


@pytest.mark.parametrize("pdt", PDTS)
def test_pp_bf16_step_matches_jax(par, pdt):
    """Against JAX's ``make_pp_diffusion_step`` (``make_pp_trainer``) at the
    same dtypes, 2 stages x 2 microbatches: the metrics but the token-usage
    counts by the pooled witness rule, the gradients by the cosine bar, the
    port's float32 single step as Q32 (JAX's pipeline gradient has no shard
    factor)."""
    r0, r1 = (r["pp"][pdt] for r in par["ranks"])
    want = par["jax"]["pp"][pdt]
    q32 = par["single"][("f32", "diffusion")]
    witness_pooled(f"PP {pdt} metrics vs JAX", [
        (r0["metrics"][k], v, q32["metrics"][k]) for k, v in want["metrics"].items()
        if k not in USAGE])
    hold_grads(f"PP {pdt} vs JAX", _f64(_pp_grads([r0["grads"], r1["grads"]])),
               want["grads"], _f64(q32["grads"]))


@pytest.mark.parametrize("pdt", PDTS)
def test_pp_decoders_and_checkpoints_keep_dtypes(par, pdt):
    """The stage decoder, the canonical decoder and a stage state reloaded
    from the packed checkpoint compute at bf16 and store the source's
    parameter dtype; the packed stack and the moments have it too."""
    for r in par["ranks"]:
        res = r["pp"][pdt]
        want = ("torch.bfloat16", [f"torch.{pdt}"])
        assert res["dtypes"] == {"source": want, "stage": want, "canonical": want,
                                 "reloaded": want}
        assert {str(d) for d in res["packed"].values()} == {f"torch.{pdt}"}
        assert res["mu"] == [f"torch.{pdt}"] and res["reloaded"]
    a, b = (r["pp"][pdt]["canonical"] for r in par["ranks"])
    assert {int(n.split(".")[1]) for n in a if n.startswith("layers.")} == {0, 1}
    for n in a:  # every stage returns the whole decoder
        assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["data2-pipe1", "data1-pipe2"])
def test_dp_x_pp_bf16_step_witness(par, shape):
    """DP x PP at bf16 parameters on (data, pipe) meshes of the two ranks
    against the single-process bf16 step."""
    outs = [r["dppp"][shape] for r in par["ranks"]]
    assert outs[0]["metrics"] == outs[1]["metrics"]
    got = {"metrics": outs[0]["metrics"], "grads": _pp_grads([o["grads"] for o in outs])}
    _hold_step(f"DP x PP {shape}", got, par["single"][("bfloat16", "diffusion")],
               par["single"][("f32", "diffusion")])


# -- tensor and sequence parallel --------------------------------------------------------


@pytest.mark.parametrize("pdt", PDTS)
def test_tp_encode_bf16(par, pdt):
    """The TP encode of a bf16 encoder: its rebuilt modules compute at bf16,
    its shards keep the parameter dtype; tokens equal to the single-device
    bf16 encode on the same (modules) route, and within the token-share
    bar of JAX's bf16 TP encode against the float32 tokens."""
    tok32 = par["encode"]["f32"].numpy()
    single = par["encode"][pdt].numpy()
    for r in par["ranks"]:
        res = r["tp"][pdt]
        assert res["local"][0] == "torch.bfloat16" and res["params"] == [f"torch.{pdt}"]
        assert res["features"].dtype == BF16
        np.testing.assert_array_equal(res["tokens"].numpy(), single)
    share = float(np.mean(par["ranks"][0]["tp"][pdt]["tokens"].numpy() == tok32))
    share_jax = float(np.mean(par["jax"]["tp"][pdt] == tok32))
    assert share >= share_jax - TOKEN_SLACK, (share, share_jax)


def _seq_single(par, dtype):
    seq = par["seq"]
    cfg = CFG(**seq["cfg"])
    dec = EdgeDiffusionDecoder(cfg, dtype=dtype)
    dec.load_state_dict(seq["decoder"])
    dec.eval()
    sem = torch.as_tensor(seq["sem"])
    with torch.no_grad():
        return {p: ddim_sample(DiffusionSchedule.create(cfg.diff_steps),
                               lambda x, t, si: dec(x, t, sem_idx=sem, step_idx=si),
                               torch.as_tensor(seq["x_T"]), seq["steps"], prediction=p)
                for p in ("eps", "v")}


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_seq_parallel_bf16_decoder(par, prediction):
    """Sequence-parallel DDIM of a bf16-compute decoder over two ranks
    against the single-device bf16 call, float32's as Q32; the replica is
    used at its dtype."""
    ref, q32 = _seq_single(par, BF16)[prediction], _seq_single(par, torch.float32)[prediction]
    for r in par["ranks"]:
        assert r["seq"]["dtype"] == ("torch.bfloat16", ["torch.float32"])
        got = r["seq"][prediction]
        assert got.shape == ref.shape and torch.isfinite(got).all()
        witness(f"sequence parallel {prediction}", got.numpy(), ref.numpy(), q32.numpy())


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_dp_generate_bf16_decoder(masked):
    """``make_dp_generate`` over ["cpu", "cpu"] of an engine on a bf16-compute
    decoder (the eager backend, unmasked, or the masked module loop): the
    rows against the unsharded call's by the witness rule, the float32
    engine as Q32."""
    cfg = CFG(hidden=32, layers=1, heads=2, diff_steps=50, dropout=0.0)
    torch.manual_seed(0)
    dec32 = EdgeDiffusionDecoder(cfg)
    with torch.no_grad():
        dec32.out_proj.weight.normal_(0, 0.05)
    dec16 = EdgeDiffusionDecoder(cfg, dtype=BF16)
    dec16.load_state_dict(dec32.state_dict())
    engines = {dt: EdgeInference(cfg, DiffusionSchedule.create(50), d.eval(), device="cpu")
               for dt, d in ((BF16, dec16), (torch.float32, dec32))}
    sem = torch.as_tensor(np.random.RandomState(1).randint(0, 100, (4, 12)))
    kw = {}
    if masked:
        mask = torch.ones(sem.shape, dtype=torch.bool)
        mask[1, 7:], mask[2, 3:] = False, False
        kw["sem_mask"] = mask
    gen = make_dp_generate(engines[BF16], ["cpu", "cpu"], masked=masked)
    got = gen(sem, num_steps=4, generator=torch.Generator().manual_seed(3), **kw)
    want = engines[BF16].generate_mel(sem, 4, generator=torch.Generator().manual_seed(3), **kw)
    want32 = engines[torch.float32].generate_mel(sem, 4, generator=torch.Generator().manual_seed(3),
                                                 **kw)
    assert got.shape == want.shape == (4, 24, 80) and torch.isfinite(got).all()
    witness("make_dp_generate", got.numpy(), want.numpy(), want32.numpy())


# -- train() ---------------------------------------------------------------------------------


TRAIN_CASES = [(layout, pdt) for layout in ("mesh", "pipe") for pdt in PDTS]


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_train_parallel_bf16_phases_and_replicas(par, case):
    """``train()`` at configs/tpu_large_batch.json (compute bf16) cut to a
    tiny model, on mesh [2, 1] or 2 pipeline stages: every phase runs on
    both ranks at the config's dtypes, and the final parameters are equal
    bit for bit (the replicated ones, for the pipeline)."""
    r0, r1 = (r["train"][case] for r in par["ranks"])
    assert r0["tags"] == r1["tags"]
    assert [t for t, _ in r0["tags"]] == ["init", "diffusion", "prog8", "prog4", "consistency"]
    assert r0["step"] == r1["step"] == 4 * TRAIN_STEPS_PER_EPOCH
    want = ("torch.bfloat16", [f"torch.{case[1]}"])
    assert r0["dtypes"] == r1["dtypes"] == want and r0["encoder"] == want
    shared = set(r0["params"]) & set(r1["params"])
    if case[0] == "mesh":
        assert shared == set(r0["params"])
    else:
        shared = {n for n in shared if not n.startswith("decoder.layers.")}
    for n in shared:
        assert torch.equal(r0["params"][n], r1["params"][n]), n
        assert torch.isfinite(r0["params"][n].float()).all(), n


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_train_parallel_bf16_final_model_and_resume(par, case):
    """The final model is saved at ``param_dtype`` (canonical for the
    pipeline: every block); resume from the last periodic checkpoint (step
    6, the last step of halving 4) skips the diffusion phase and halving 8,
    and reruns halving 4 and the consistency epoch."""
    dt = torch.float32 if case[1] == "float32" else BF16
    r0, r1 = (r["train"][case] for r in par["ranks"])
    _, dec_state, _, _ = load_checkpoint(os.path.join(r0["run_dir"], "edge_model_final"))
    assert {v.dtype for v in dec_state.values() if v.is_floating_point()} == {dt}
    assert {int(k.split(".")[1]) for k in dec_state if k.startswith("layers.")} == {0, 1}
    for r in (r0, r1):
        assert all(p.dtype == dt for p in r["params"].values())
        assert r["resumed_tags"] == ["prog4", "consistency"]
        assert r["resumed_step"] == 6 + 2 * TRAIN_STEPS_PER_EPOCH
