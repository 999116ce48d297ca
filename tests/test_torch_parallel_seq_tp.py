"""Sequence-parallel long-form generation and the tensor-parallel HuBERT
encode on gloo ranks (CPU), against the port's single-device programs and
the JAX package's sharded ones on a submesh of its virtual CPU devices.

Sequence parallel, over 2 and 4 ranks, on the JAX test's decoder (2 layers,
window 4, T = 128 frames): the port's ``ddim_sample`` at atol 1e-5 for eps
and at 2e-3 for v (the bar JAX's own test gives v: the v -> eps -> x0 round
trip divides by sqrt(alpha_bar) ~1e-2 late in the grid, amplifying the
rounding of the sliced windows); JAX's ``make_seq_parallel_generate`` on the
same weights and x_T at 1e-4 (eps); a length that does not divide raises.

Tensor parallel, a (data 1, model 2) mesh on the tiny HuBERT (4 heads, FFN
64): layer features against the single encode's at 1e-5, tokens equal to
the single encode's and to JAX's ``make_tp_encode``; the placement rules
equal JAX's ``hubert_param_spec`` for every HuBERT tensor.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.parallel import make_mesh as jmake_mesh
from edge_diffusion_tts_tpu.parallel.sequence_parallel import (
    make_seq_parallel_generate as jmake_seq_parallel_generate,
)
from edge_diffusion_tts_tpu.parallel.tensor_parallel import hubert_param_spec as jhubert_spec
from edge_diffusion_tts_tpu.parallel.tensor_parallel import make_tp_encode as jmake_tp_encode
from edge_diffusion_tts_tpu.parallel.tensor_parallel import (
    shard_encoder_params as jshard_encoder_params,
)
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.models import HubertConfig, SemanticEncoder
from edge_diffusion_tts_tpu_torch.parallel.launch import spawn
from edge_diffusion_tts_tpu_torch.parallel.sequence_parallel import seq_margin
from edge_diffusion_tts_tpu_torch.parallel.tensor_parallel import TPEncode, hubert_param_spec
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule as PSchedule
from edge_diffusion_tts_tpu_torch.schedule import ddim_sample
from edge_diffusion_tts_tpu_torch.weights import encoder_state_dict_from_jax, state_dict_from_jax

import test_torch_parallel_ranks as ranks
from test_torch_parallel_dp import jax_init_models

SEQ = dict(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=4, diff_steps=50,
           max_timestep=48, use_flash_attn=False, max_mel_positions=2048, max_ctx_positions=1024)
T = 128
STEPS = 4
BARS = {"eps": 1e-5, "v": 2e-3}


@pytest.fixture(scope="module")
def seq():
    jcfg, pcfg = JCFG(**SEQ), PCFG(**SEQ)
    assert T // 4 >= 2 * seq_margin(pcfg)
    jdec = JDecoder(jcfg)
    params = jax.jit(lambda k: init_decoder_params(jdec, k, jcfg)["params"])(
        jax.random.PRNGKey(0))
    sem = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, T // 2), 0,
                                      jcfg.effective_codebook_size()))
    x_T = np.array(jax.random.normal(jax.random.PRNGKey(2), (1, T, jcfg.n_mels)))
    dec_state = state_dict_from_jax(params, pcfg)
    dec = PDecoder(pcfg)
    dec.load_state_dict(dec_state)
    dec.eval()
    schedule = PSchedule.create(pcfg.diff_steps)
    sem_t, x_t = torch.as_tensor(sem), torch.as_tensor(x_T)
    with torch.no_grad():
        ref = {p: ddim_sample(schedule, lambda x, t, si: dec(x, t, sem_idx=sem_t, step_idx=si),
                              x_t, STEPS, prediction=p) for p in BARS}
    out = {"ref": ref, "ranks": {}, "jax": {}}
    for n in (2, 4):
        out["ranks"][n] = spawn(ranks.seq_rank, n, args=(SEQ, dec_state, sem, x_T, STEPS),
                                threads=1, timeout=240)
        mesh = jmake_mesh((n, 1), devices=jax.devices()[:n])
        out["jax"][n] = np.asarray(jmake_seq_parallel_generate(
            jcfg, jdec, JSchedule.create(jcfg.diff_steps), mesh, num_steps=STEPS,
            prediction="eps")(params, sem, x_T))
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_seq_parallel_matches_ddim_sample(seq, n, prediction):
    for r in seq["ranks"][n]:
        np.testing.assert_allclose(r[prediction].numpy(), seq["ref"][prediction].numpy(),
                                   atol=BARS[prediction], rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_seq_parallel_matches_jax(seq, n):
    np.testing.assert_allclose(seq["ranks"][n][0]["eps"].numpy(), seq["jax"][n], atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_seq_parallel_remainder_raises(seq, n):
    for r in seq["ranks"][n]:
        assert r["remainder"] is not None and "divide" in r["remainder"]


@pytest.fixture(scope="module")
def tp():
    jcfg = JCFG(hidden=32, layers=1, heads=2, use_fsq=True)
    encoder, _, params, _ = jax_init_models(jcfg, JHC.tiny())
    pcfg = PCFG(hidden=32, layers=1, heads=2, use_fsq=True)
    enc_state = encoder_state_dict_from_jax({"params": params["encoder"]})
    enc = SemanticEncoder(pcfg, HubertConfig.tiny())
    enc.load_state_dict(enc_state)
    enc.eval()
    wav = (np.random.RandomState(3).randn(2, 3200) * 0.1).astype(np.float32)
    with torch.no_grad():
        w = torch.as_tensor(wav)
        single = {"tokens": enc.encode(w), "features": enc.extract_hubert(w)}
    res = spawn(ranks.tp_rank, 2, args=(dataclasses.asdict(pcfg), enc_state, wav), threads=1,
                timeout=240)
    mesh = jmake_mesh((1, 2), devices=jax.devices()[:2])
    with mesh:
        jtokens = np.asarray(jmake_tp_encode(encoder, mesh)(
            jshard_encoder_params(params["encoder"], mesh), wav))
    return dict(single=single, ranks=res, jax=jtokens, params=params, enc=enc)


def test_tp_encode_matches_single_and_jax(tp):
    for r in tp["ranks"]:
        np.testing.assert_allclose(r["features"].numpy(), tp["single"]["features"].numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(r["tokens"].numpy(), tp["single"]["tokens"].numpy())
        np.testing.assert_array_equal(r["tokens"].numpy(), tp["jax"])


def test_tp_shards_hold_their_slices(tp):
    hc = HubertConfig.tiny()
    H, F = hc.hidden_size, hc.intermediate_size
    shapes = tp["ranks"][0]["shapes"]
    layer = "hubert.encoder.layers.0."
    assert shapes[layer + "attention.q_proj.weight"] == (H // 2, H)
    assert shapes[layer + "attention.q_proj.bias"] == (H // 2,)
    assert shapes[layer + "attention.out_proj.weight"] == (H, H // 2)
    assert shapes[layer + "attention.out_proj.bias"] == (H,)
    assert shapes[layer + "feed_forward.intermediate_dense.weight"] == (F // 2, H)
    assert shapes[layer + "feed_forward.output_dense.weight"] == (H, F // 2)
    full = {k: tuple(v.shape) for k, v in tp["enc"].state_dict().items()}
    assert all(shapes[k] == full[k] for k in full if "hubert" not in k)


def test_hubert_param_spec_follows_jax_rules(tp):
    """Every HuBERT tensor's placement equals JAX's, dims in the port's
    layout (a JAX kernel is [in, out], a port weight [out, in])."""
    leaves = jax.tree_util.tree_flatten_with_path(tp["params"]["encoder"]["hubert"])[0]
    split = 0
    for path, leaf in leaves:
        keys = [getattr(k, "key", str(k)) for k in path]
        want = tuple(jhubert_spec(path))
        if keys[-1] == "kernel" and np.ndim(leaf) == 2:
            want = tuple(reversed(want))
        name = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
        got = hubert_param_spec(".".join(keys[:-1] + [name]))
        assert got == want, (keys, got, want)
        split += any(want)
    # Per layer: q/k/v and intermediate kernels and biases, two row-parallel kernels.
    assert split == 10 * JHC.tiny().num_layers


def test_tp_encode_refuses_an_indivisible_model_axis():
    hc = dataclasses.replace(HubertConfig.tiny(), num_heads=3)
    fake_mesh = types.SimpleNamespace(axis=lambda name: types.SimpleNamespace(size=2, index=0))
    enc = types.SimpleNamespace(hubert_cfg=hc)
    with pytest.raises(ValueError, match="must divide"):
        TPEncode(enc, fake_mesh)
