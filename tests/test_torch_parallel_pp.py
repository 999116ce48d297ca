"""Pipeline parallelism on gloo ranks (CPU): the packed layout, the
pipelined backbone against the sequential decoder, the pipeline steps
against the single-process steps, DP x PP, and the weight bridge's packed
JAX trees.

Two spawned groups: two stages (the backbone at 1/2/4 microbatches and
masked, then a diffusion, a two-step distillation and a consistency step)
and four ranks (the 4-stage backbone, then one DP x PP step on a (data 2,
pipe 2) mesh).  Bars, float32 rounding of microbatched sums:

- backbone output and every gradient (the inputs' and the blocks', for the
  loss ``sum(h * w)``) atol 1e-5 rtol 1e-4 against ``decoder.backbone``
  under autograd on the whole batch;
- steps, dropout 0: loss rel 1e-6, gradients atol 1e-6, parameters after
  one AdamW update atol 1e-6 plus the rate times the difference of the
  updates' directions (test_torch_parallel_dp explains the witness);
  ``grad_norm`` (the clip's norm summed over the stages) rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.parallel import make_mesh as jmake_mesh
from edge_diffusion_tts_tpu.parallel import replicate as jreplicate
from edge_diffusion_tts_tpu.parallel.pipeline_parallel import create_pp_state as jcreate_pp_state
from edge_diffusion_tts_tpu.parallel.pipeline_parallel import pp_pack_params as jpp_pack_params
from edge_diffusion_tts_tpu.training import create_train_state as jcreate_train_state
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, HubertConfig, SemanticEncoder
from edge_diffusion_tts_tpu_torch.parallel import pp_pack_params, pp_unpack_params
from edge_diffusion_tts_tpu_torch.parallel.launch import spawn
from edge_diffusion_tts_tpu_torch.parallel.pipeline_parallel import pp_unpack_decoder
from edge_diffusion_tts_tpu_torch.training import TrainState, make_optimizer
from edge_diffusion_tts_tpu_torch.weights import state_dict_from_jax, train_state_from_jax

import test_torch_parallel_ranks as ranks
from test_torch_parallel_dp import jax_init_models

BB_CFG = dict(hidden=32, layers=4, heads=2, dropout=0.0, attn_window_size=4)
BB_CASES = [(1, False), (2, False), (4, False), (2, True)]
STEP_CASES = {"diffusion": 2, "pd_two_step": 4, "consistency": 1}


def _weights(cfg, seed):
    torch.manual_seed(seed)
    enc, dec = SemanticEncoder(cfg, HubertConfig.tiny()), EdgeDiffusionDecoder(cfg)
    with torch.no_grad():  # a nonzero output head, so every block has a gradient
        dec.out_proj.weight.normal_(0, 0.05)
    return {"encoder": enc.state_dict(), "decoder": dec.state_dict(),
            "teacher": {k: v + 0.01 * torch.randn_like(v) for k, v in dec.state_dict().items()}}


def _batch(cfg, tr, kind):
    rs = np.random.RandomState(4)
    wav = (rs.randn(4, cfg.segment_len) * 0.1).astype(np.float32)
    mel = tr._mel_normalized(torch.from_numpy(wav))
    b = {"wav": wav, "noise": rs.randn(*mel.shape).astype(np.float32)}
    if kind == "diffusion":
        b["t"] = np.array([7, 40, 3, 22])
    elif kind == "pd_two_step":
        b["step_indices"] = np.array([1, 3, 0, 2])
    else:
        b["t1"], b["t2"] = np.array([3, 30, 12, 45]), np.array([45, 12, 30, 3])
    return b


def _backbone_inputs(cfg):
    rs = np.random.RandomState(7)
    B, T, S, H = 4, 16, 8, cfg.hidden
    mel_mask = np.ones((B, T), bool)
    ctx_mask = np.ones((B, S), bool)
    mel_mask[1, 11:], mel_mask[3, 5:] = False, False
    ctx_mask[1, 6:], ctx_mask[2, 3:] = False, False
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    return {"h0": f(B, T, H), "ctx": f(B, S, H), "cond": f(B, H), "w": f(B, T, H),
            "mel_mask": mel_mask, "ctx_mask": ctx_mask}


def _sequential(cfg_kw, dec_state, inputs, masked):
    dec = EdgeDiffusionDecoder(ranks.CFG(**cfg_kw))
    dec.load_state_dict(dec_state)
    dec.eval()
    h0, ctx, cond = (torch.as_tensor(inputs[n]).clone().requires_grad_()
                     for n in ("h0", "ctx", "cond"))
    masks = dict(mel_mask=torch.as_tensor(inputs["mel_mask"]),
                 ctx_mask=torch.as_tensor(inputs["ctx_mask"])) if masked else {}
    h = dec.backbone(h0, ctx, cond, **masks)
    (h * torch.as_tensor(inputs["w"])).sum().backward()
    blocks = {n: p.grad for n, p in dec.named_parameters() if n.startswith("layers.")}
    return h.detach(), [h0.grad, ctx.grad, cond.grad], blocks


@pytest.fixture(scope="module")
def pp():
    bb_cfg = ranks.CFG(**BB_CFG)
    torch.manual_seed(3)
    dec = EdgeDiffusionDecoder(bb_cfg)
    inputs = _backbone_inputs(bb_cfg)
    backbone = {"cfg_kw": BB_CFG, "dec_state": dec.state_dict(), "inputs": inputs,
                "cases": BB_CASES}
    cfg = ranks.tiny_cfg(layers=2)
    weights = _weights(cfg, 5)
    tr, _ = ranks.build_state(cfg, weights)
    steps = {k: {"kind": k, "cfg": {"layers": 2}, "weights": weights, "microbatches": m,
                 "batch": _batch(cfg, tr, k)} for k, m in STEP_CASES.items()}
    two = spawn(ranks.pp2_rank, 2, args=(backbone, steps), threads=1, timeout=300)
    dppp = {"cfg": {"layers": 2}, "weights": weights, "batch": _batch(cfg, tr, "diffusion")}
    four = spawn(ranks.pp4_rank, 4, args=(backbone, dppp), threads=1, timeout=300)
    single = {k: ranks.run_step(cfg, weights, k, c["batch"]) for k, c in steps.items()}
    seq = {c: _sequential(BB_CFG, backbone["dec_state"], inputs, c[1]) for c in BB_CASES}
    return dict(two=two, four=four, single=single, seq=seq, cfg=cfg)


def test_pp_pack_unpack_round_trip():
    cfg = ranks.tiny_cfg(layers=4)
    enc, dec = SemanticEncoder(cfg, HubertConfig.tiny()), EdgeDiffusionDecoder(cfg)
    params = {"encoder": enc.state_dict(), "decoder": dec.state_dict()}
    packed = pp_pack_params(params)
    stack = packed["decoder"]["pp_stack"]
    assert stack["attn.qkv.weight"].shape[0] == 4
    assert not any(k.startswith("layers.") for k in packed["decoder"]["pp_rest"])
    back = pp_unpack_params(packed)
    assert set(back["decoder"]) == set(params["decoder"])
    for k, v in params["decoder"].items():
        assert torch.equal(back["decoder"][k], v), k
    assert back["encoder"] is params["encoder"]


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("case", BB_CASES, ids=lambda c: f"mb{c[0]}{'-masked' if c[1] else ''}")
def test_pp_backbone_matches_sequential(pp, stages, case):
    res = (pp["two"] if stages == 2 else pp["four"])
    h, g_in, blocks = pp["seq"][case]
    got_blocks = {}
    for r in res:
        out = r["backbone"][case]
        np.testing.assert_allclose(out["h"], h, atol=1e-5, rtol=1e-4)
        for a, b, n in zip(out["inputs"], g_in, ("h0", "ctx", "cond")):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, err_msg=f"grad {n}")
        got_blocks.update(out["blocks"])
    assert set(got_blocks) == set(blocks)
    for n, g in blocks.items():
        np.testing.assert_allclose(got_blocks[n], g, atol=1e-5, rtol=1e-4, err_msg=n)


def _hold_step(got_metrics, got_grads, one, packed, cfg, what):
    loss, want = got_metrics["loss"], one["metrics"]["loss"]
    assert abs(loss - want) <= 1e-6 * abs(want), (what, loss, want)
    if "grad_norm" in one["metrics"]:
        np.testing.assert_allclose(got_metrics["grad_norm"], one["metrics"]["grad_norm"],
                                   rtol=1e-6)
    assert set(got_grads) == set(one["grads"]), set(got_grads) ^ set(one["grads"])
    for n, g in one["grads"].items():
        np.testing.assert_allclose(got_grads[n], g, atol=1e-6, rtol=0, err_msg=f"{what} {n}")
    if packed is None:
        return
    params = {f"decoder.{k}": v for k, v in pp_unpack_decoder(packed["decoder"]).items()}
    params.update({f"encoder.{k}": v for k, v in packed["encoder"].items()})
    u_got = ranks.adam_direction(got_grads, cfg.grad_clip)
    u_one = ranks.adam_direction(one["grads"], cfg.grad_clip)
    for n, p in one["params"].items():
        bar = 1e-6 + ranks.LR * np.abs(u_got[n] - u_one[n])
        diff = np.abs(params[n].numpy() - p.numpy())
        assert (diff <= bar).all(), (what, n, float(diff.max()))


@pytest.mark.parametrize("kind", list(STEP_CASES))
def test_pp_step_equals_single_step(pp, kind):
    r0, r1 = (r["steps"][kind] for r in pp["two"])
    assert r0["metrics"] == r1["metrics"]
    grads = {**r0["grads"], **r1["grads"]}
    for n in set(r0["grads"]) & set(r1["grads"]):  # the replicated part: equal on both
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
    _hold_step(r0["metrics"], grads, pp["single"][kind], r0["state"], pp["cfg"], kind)


def test_pp_checkpoint_layout_is_packed_and_reloads(pp):
    for kind in STEP_CASES:
        a, b = (r["steps"][kind] for r in pp["two"])
        assert a["reloaded"] and b["reloaded"], kind
        dec = a["state"]["decoder"]
        assert set(dec) == {"pp_stack", "pp_rest"}
        assert dec["pp_stack"]["attn.qkv.weight"].shape[0] == 2
        assert any(k.startswith("decoder.pp_stack.") for k in a["state"]["optimizer"]["mu"])
        for k, v in dec["pp_stack"].items():  # every stage returns the whole model
            assert torch.equal(v, b["state"]["decoder"]["pp_stack"][k]), k


def test_dp_x_pp_step_equals_single_step(pp):
    """A (data 2, pipe 2) mesh: each data row pipelines its 2 rows."""
    outs = [r["dppp"] for r in pp["four"]]
    grads = {}
    for o in outs:
        assert o["metrics"] == outs[0]["metrics"]
        grads.update(o["grads"])
    _hold_step(outs[0]["metrics"], grads, pp["single"]["diffusion"], None, pp["cfg"], "dppp")


def test_weight_bridge_takes_jax_pipeline_and_dp_states():
    """A JAX pipeline run's packed decoder tree and its train state (packed
    params and moments), and a data-parallel run's replicated state, come
    across as the canonical port layout, and load into a port TrainState."""
    jcfg = JCFG(hidden=32, layers=2, heads=2, segment_secs=0.1, batch_size=2,
                grad_accumulation=1, diff_steps=50, max_timestep=48)
    encoder, decoder, params, vq_state = jax_init_models(jcfg, JHC.tiny())
    canonical = state_dict_from_jax(params["decoder"])
    packed = jpp_pack_params(params)
    from_packed = state_dict_from_jax(packed["decoder"])
    assert set(from_packed) == set(canonical)
    for k, v in canonical.items():
        assert torch.equal(from_packed[k], v), k
    tx = optax.adam(1e-3)
    pipe = JMesh(np.array(jax.devices()[:2]), ("pipe",))
    pp_state = jcreate_pp_state(jcfg, params, vq_state, tx, pipe)
    pp_state = pp_state.replace(opt_state=jax.tree.map(
        lambda a: a + 0.5 if jnp.issubdtype(a.dtype, jnp.floating) else a, pp_state.opt_state))
    dp_state = jreplicate(jcreate_train_state(jcfg, params, vq_state, tx),
                          jmake_mesh((2, 1), devices=jax.devices()[:2]))
    pcfg = ranks.CFG(hidden=32, layers=2, heads=2, segment_secs=0.1, batch_size=2,
                     grad_accumulation=1, diff_steps=50, max_timestep=48)
    for st in (pp_state, dp_state):
        d = train_state_from_jax(st)
        assert set(d["decoder"]) == set(canonical)
        for k, v in canonical.items():
            assert torch.equal(d["decoder"][k], v), k
        enc, dec = SemanticEncoder(pcfg, HubertConfig.tiny()), EdgeDiffusionDecoder(pcfg)
        state = TrainState(enc, dec, make_optimizer(pcfg, enc, dec, 10))
        state.load_state_dict(d)
        again = state.state_dict()
        for k, v in d["optimizer"]["mu"].items():
            assert torch.equal(again["optimizer"]["mu"][k], v), k
        want = 0.5 if st is pp_state else 0.0
        assert float(d["optimizer"]["mu"]["decoder.layers.1.attn.qkv.weight"].max()) == want
