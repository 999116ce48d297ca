"""w2v-BERT 2.0 in the port's encoder slot, on the CPU: the filterbank
(``ops/fbank.py``) against transformers' ``SeamlessM4TFeatureExtractor``,
the port's ``W2vBertEncoder`` against transformers' ``Wav2Vec2BertModel`` on
the same state dict, the benchmark's plain reference
(``benchmark/reference/w2v_bert.py``) against both, ``wav_len`` against each
row alone, the relative-key plain route against an emulation of the card
kernel's tiling, the four faults the benchmark's cell must catch, the
encoder named by ``hubert_id``, checkpoints, and the callers that reach the
encoder's insides (``cli precompute``, tensor-parallel encode, ``train()``).

All at a tiny size (width 64, 2-3 layers of 4 heads, FFN 128) with the
published conv kernel (31), clamp window (-64 .. 8) and filterbank."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import w2v_bert as rw
from benchmark.reference.precision import Ops
from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.models import (EdgeDiffusionDecoder, SemanticEncoder,
                                                 W2vBertConfig, W2vBertEncoder,
                                                 hubert_config_for)
from edge_diffusion_tts_tpu_torch.models import w2v_bert as wb
from edge_diffusion_tts_tpu_torch.models.hubert import HubertConfig, encoder_config_from_json
from edge_diffusion_tts_tpu_torch.ops.fbank import fbank, stacked_count
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
from edge_diffusion_tts_tpu_torch.weights import w2v_bert_state_dict_from_hf

transformers = pytest.importorskip("transformers")

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128)


def rel_gap(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def hf_model():
    torch.manual_seed(0)
    m = transformers.Wav2Vec2BertModel(transformers.Wav2Vec2BertConfig(**TINY)).eval()
    with torch.no_grad():  # norms, biases and tables off their init values
        for p in m.parameters():
            p.add_(0.1 * torch.randn_like(p))
        for layer in m.encoder.layers:
            layer.self_attn.distance_embedding.weight.normal_()
    return m


@pytest.fixture(scope="module")
def port(hf_model):
    enc = W2vBertEncoder(W2vBertConfig.tiny())
    enc.load_state_dict(w2v_bert_state_dict_from_hf(hf_model.state_dict(), W2vBertConfig.tiny()))
    return enc.eval()


@pytest.fixture(scope="module")
def wav():
    # 2 s and a row of speech-like tone that ends at 1.3 s: 99 positions, offsets
    # past both ends of the clamp window
    g = torch.Generator().manual_seed(1)
    t = torch.arange(32000) / 16000
    w = 0.1 * torch.randn(2, 32000, generator=g)
    w[1] = 0.3 * torch.sin(2 * np.pi * 180 * t) * (t < 1.3) + 0.1 * w[1]
    return w


@pytest.fixture(scope="module")
def extractor():
    return transformers.SeamlessM4TFeatureExtractor()


def hf_features(extractor, rows):
    return extractor([r.numpy() for r in rows], sampling_rate=16000, return_tensors="pt")


# The filterbank's bar against transformers' on features of unit variance: its
# FFT runs in float64, ours in float32, whose rounding is relative to a frame's
# largest bin; the bins that DC removal and pre-emphasis leave near 0 Hz lie
# some 1e-6 of the largest below it in the tone row, and reach 5e-4 there.
FBANK_BAR = 1e-3


def test_the_fbank_is_the_feature_extractors(extractor, wav):
    """Normalized, stacked features within ``FBANK_BAR`` of transformers';
    the reference's DFT-by-product within the same."""
    want = hf_features(extractor, wav)["input_features"]
    got = fbank(wav)
    assert got.shape == want.shape == (2, 99, 160)
    assert float((got - want).abs().max()) <= FBANK_BAR
    ref = rw.features(wav, dataclasses.asdict(W2vBertConfig.tiny()), Ops())
    assert float((ref - want).abs().max()) <= FBANK_BAR
    assert stacked_count(32000) == 99 and stacked_count(16000) == 49


def test_the_fbank_with_wav_len_is_each_row_alone(extractor, wav):
    """Each row normalized over its own frames; an odd last frame of a row
    dropped as the extractor's stacking drops it; padded positions zero."""
    lens = torch.tensor([32000, 21000])
    got = fbank(wav, wav_len=lens)
    for i, n in enumerate(lens.tolist()):
        one = hf_features(extractor, wav[i:i + 1, :n])
        S = int(one["attention_mask"].sum())
        assert S == stacked_count(n)
        assert float((got[i, :S] - one["input_features"][0, :S]).abs().max()) <= FBANK_BAR
        assert torch.all(got[i, S:] == 0)


def test_the_port_is_transformers(hf_model, port, extractor, wav):
    """Every hidden state 0 .. L within 1e-5 relative of transformers' on
    the extractor's features (the same equations, float32 in both), and
    within 1e-4 from the wav (the filterbank's float32 gap above)."""
    inp = hf_features(extractor, wav)["input_features"]
    with torch.no_grad():
        want = hf_model(inp, output_hidden_states=True).hidden_states
        injected = port(wav, conv_feats=inp)
        got = port(wav)
    assert len(want) == len(got) == 3
    for L in range(3):
        assert rel_gap(injected[L], want[L]) <= 1e-5, L
        assert rel_gap(got[L], want[L]) <= 1e-4, L
    with torch.no_grad():
        assert torch.equal(port.extract_layer(wav, 1), got[1])


def test_the_reference_is_transformers(hf_model, extractor, wav):
    P = {"hubert." + k: v for k, v in hf_model.state_dict().items()}
    h = dataclasses.asdict(W2vBertConfig.tiny())
    inp = hf_features(extractor, wav)["input_features"]
    with torch.no_grad():
        want = hf_model(inp, output_hidden_states=True).hidden_states
    for L in range(3):
        assert rel_gap(rw.layer(P, h, None, Ops(), L, feats=inp), want[L]) <= 1e-5, L
        assert rel_gap(rw.layer(P, h, wav, Ops(), L), want[L]) <= 1e-4, L


def test_wav_len_is_each_row_alone(hf_model, port, extractor, wav):
    """A zero-padded batch with ``wav_len``: each row's positions equal
    transformers' on that row alone under its attention mask (1e-4: the
    filterbank's gap), padded positions zero in every hidden state."""
    lens = torch.tensor([32000, 21000])
    batch = wav * (torch.arange(32000)[None, :] < lens[:, None])
    with torch.no_grad():
        got = port(batch, wav_len=lens)
    for i, n in enumerate(lens.tolist()):
        one = hf_features(extractor, wav[i:i + 1, :n])
        S = int(one["attention_mask"].sum())
        with torch.no_grad():
            want = hf_model(one["input_features"], attention_mask=one["attention_mask"],
                            output_hidden_states=True).hidden_states
        for L in range(3):
            assert rel_gap(got[L][i, :S], want[L][0, :S]) <= 1e-4, (i, L)
            assert torch.all(got[L][i, S:] == 0)


def kernel_emulation(y, E, left):
    """``relkey_attention16_kernel``'s computation on the CPU: per 64-row
    block and 16-row warp, Q E^T over the table's rows padded to 80; each
    16-key step either adds the table's first or last column to every
    score of the warp's rows (the step lies wholly outside the window) or
    reads each score's own column; logits in log2 units, P normalised,
    then rounded to y's dtype before P V."""
    B, S, width = y.shape
    H, dh = width // 3, 64
    heads, right = H // dh, E.shape[0] - 1 - left
    q, k, v = (y[..., n * H:(n + 1) * H].reshape(B, S, heads, dh).transpose(1, 2).float()
               for n in range(3))
    Ep = torch.zeros(80, dh)
    Ep[:E.shape[0]] = E.float()
    qe = q @ Ep.t()  # [B, heads, S, 80]
    z = torch.empty(B, heads, S, S)
    for r0 in range(0, S, 16):
        rows = torch.arange(r0, min(r0 + 16, S))
        for j0 in range(0, S, 16):
            keys = torch.arange(j0, min(j0 + 16, S))
            qk = q[:, :, rows] @ k[:, :, keys].transpose(-1, -2)
            if j0 + 15 - r0 <= -left:
                term = qe[:, :, rows, :1]
            elif j0 - r0 - 15 >= right:
                term = qe[:, :, rows, E.shape[0] - 1:E.shape[0]]
            else:
                d = torch.clamp(keys[None, :] - rows[:, None], -left, right) + left
                term = torch.gather(qe[:, :, rows], -1, d.expand(B, heads, -1, -1))
            z[:, :, rows[:, None], keys[None, :]] = (qk + term) * (0.125 * 1.4426950408889634)
    p = torch.exp2(z - z.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(y.dtype).float()
    return (p @ v).transpose(1, 2).reshape(B, S, H).to(y.dtype)


@pytest.mark.parametrize("S", [40, 97, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_route_is_the_kernels_tiling(S, dtype):
    """The plain route against the kernel's tiling emulated on the CPU, at
    lengths inside the window, across it and far past it: 1e-5 relative at
    float32 (summation order), 2^-7 of the largest output at bf16 (one
    rounding of P and of the output)."""
    g = torch.Generator().manual_seed(S)
    y = torch.randn(2, S, 3 * 128, generator=g).to(dtype)
    E = torch.randn(73, 64, generator=g).to(dtype)
    want = wb.relkey_attention(y, E, 64).float()
    got = kernel_emulation(y, E, 64).float()
    if dtype == torch.float32:
        assert rel_gap(got, want) <= 1e-5
    else:
        assert float((got - want).abs().max()) <= 2 ** -7 * float(want.abs().max())
    assert not wb.relkey_kernel_serves(y, None, 64, 73)  # the CPU takes the plain route


@pytest.mark.parametrize("fault", ["relkey_dropped", "window_reversed", "conv_not_causal",
                                   "no_preemphasis"])
def test_each_fault_fails_the_comparison(fault, hf_model, port, extractor, wav, monkeypatch):
    """The port with the benchmark cell's faults planted is far from
    transformers: the last hidden state at least 1e-2 relative off, a
    hundred times the unbroken port's gap."""
    from benchmark.tests.test_bench_conformer import break_path

    break_path(fault, monkeypatch)
    inp = hf_features(extractor, wav)["input_features"]
    with torch.no_grad():
        want = hf_model(inp, output_hidden_states=True).hidden_states[-1]
        got = port(wav)[-1]
    assert rel_gap(got, want) > 1e-2, fault


def test_hubert_id_names_w2v_bert():
    hc = hubert_config_for("facebook/w2v-bert-2.0")
    assert hc == W2vBertConfig()
    assert (hc.hidden_size, hc.num_layers, hc.num_heads, hc.intermediate_size) == (1024, 24, 16,
                                                                                   4096)
    assert (hc.conv_depthwise_kernel_size, hc.left_max_position_embeddings,
            hc.right_max_position_embeddings, hc.feature_projection_input_dim) == (31, 64, 8, 160)
    assert hc.total_stride == 320 and hc.num_frames(160000) == 499
    assert encoder_config_from_json(hc.to_json()) == hc
    assert encoder_config_from_json(HubertConfig.wavlm_large().to_json()) == \
        HubertConfig.wavlm_large()
    with pytest.raises(ValueError):
        W2vBertConfig(num_mel_bins=64)  # 2 x 64 frames do not fill the 160-wide projection


def test_the_semantic_encoder_builds_to_its_layer_only(hf_model):
    """``hubert_layer`` 1 of a 2-layer w2v-BERT builds one layer; an HF state
    dict loads less its second layer and ``masked_spec_embed``."""
    cfg = CFG(hidden=32, layers=1, heads=2, hubert_id="facebook/w2v-bert-2.0", hubert_layer=1)
    enc = SemanticEncoder(cfg, W2vBertConfig.tiny())
    assert len(enc.hubert.encoder.layers) == 1
    sd = w2v_bert_state_dict_from_hf(hf_model.state_dict(), W2vBertConfig.tiny(), 1)
    assert "encoder.layers.0.self_attn.distance_embedding.weight" in sd
    assert not any(k.startswith("encoder.layers.1.") for k in sd)
    assert "masked_spec_embed" not in sd
    enc.hubert.load_state_dict(sd)  # strict: every name and shape
    with pytest.raises(KeyError, match="w2v-BERT"):
        w2v_bert_state_dict_from_hf({}, W2vBertConfig.tiny())


def tiny_engine(seed=0):
    cfg = CFG(hidden=32, layers=1, heads=2, hubert_id="facebook/w2v-bert-2.0", hubert_layer=2)
    torch.manual_seed(seed)
    enc = SemanticEncoder(cfg, W2vBertConfig.tiny())
    return cfg, enc, EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps),
                                   EdgeDiffusionDecoder(cfg), backend="fused", device="cpu",
                                   encoder=enc)


def test_generate_from_audio_runs_the_conformer():
    cfg, enc, engine = tiny_engine()
    wav = 0.1 * torch.randn(2, 16000, generator=torch.Generator().manual_seed(4))
    mel = engine.generate_from_audio(wav, 2)
    assert mel.shape == (2, 2 * 49, cfg.n_mels) and torch.isfinite(mel).all()
    z_q, idx, *_ = enc(wav, wav_len=torch.tensor([16000, 9000]))
    n = stacked_count(9000)
    assert torch.all(idx[1, n:] == 0) and torch.all(z_q[1, n:] == 0)


def test_a_checkpoint_keeps_the_architecture(tmp_path):
    from edge_diffusion_tts_tpu_torch.training.checkpoint import restore_hubert_config
    from edge_diffusion_tts_tpu_torch.weights import load_checkpoint, save_checkpoint

    cfg, enc, engine = tiny_engine(1)
    save_checkpoint(str(tmp_path), cfg, engine.decoder, enc)
    cfg2, _, hc, enc_sd = load_checkpoint(str(tmp_path), with_encoder=True)
    assert hc == W2vBertConfig.tiny() and restore_hubert_config(str(tmp_path)) == hc
    again = SemanticEncoder(cfg2, hc)
    again.load_state_dict(enc_sd)


def test_tensor_parallel_encode_refuses_a_conformer():
    import types

    from edge_diffusion_tts_tpu_torch.parallel.tensor_parallel import TPEncode

    fake_mesh = types.SimpleNamespace(axis=lambda name: types.SimpleNamespace(size=2, index=0))
    with pytest.raises(ValueError, match="w2v-BERT"):
        TPEncode(types.SimpleNamespace(hubert_cfg=W2vBertConfig.tiny()), fake_mesh)


def test_precompute_runs_the_conformer(tmp_path, monkeypatch):
    """``cli precompute`` builds the encoder ``CFG().hubert_id`` names through
    ``speech_encoder`` and writes its layer's features (a tiny w2v-BERT in
    w2v-BERT 2.0's place)."""
    from edge_diffusion_tts_tpu_torch import cli, config, data
    from edge_diffusion_tts_tpu_torch.models import hubert

    monkeypatch.setattr(config, "CFG", lambda: CFG(hubert_id="facebook/w2v-bert-2.0",
                                                   hubert_layer=2))
    monkeypatch.setitem(hubert.HUBERT_IDS, "facebook/w2v-bert-2.0", W2vBertConfig.tiny)
    seen = []

    def fake_precompute(root, apply, limit=None):
        seen.append(apply(0.1 * np.random.RandomState(0).randn(1, 16000).astype(np.float32)))

    monkeypatch.setattr(data, "precompute_hubert_features", fake_precompute)
    cli._precompute(type("A", (), {"root": str(tmp_path), "limit": 1})(), "cpu")
    assert seen[0].shape == (1, 49, 64)


def test_train_runs_a_step_with_the_conformer_frozen(tmp_path, monkeypatch):
    """``train()`` builds the encoder ``cfg.hubert_id`` names (a tiny
    w2v-BERT in w2v-BERT 2.0's place) and runs its steps with it frozen."""
    import importlib

    from test_torch_training_driver import _corpus, tiny_cfg

    train_mod = importlib.import_module("edge_diffusion_tts_tpu_torch.training.train")
    monkeypatch.setattr(train_mod, "hubert_config_for", lambda hubert_id: W2vBertConfig.tiny())
    _corpus(str(tmp_path / "LJSpeech-1.1"))
    cfg = tiny_cfg(tmp_path, hubert_id="facebook/w2v-bert-2.0", hubert_layer=2,
                   progressive_epochs_per_halving=0, consistency_epochs=0, ckpt_every_steps=0,
                   val_every_steps=0, num_workers=0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = train_mod.train(cfg, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert isinstance(state.encoder.hubert_cfg, W2vBertConfig) and state.step > 0
    frozen = [k for k in state.encoder.state_dict() if k.startswith("hubert.")]
    assert "hubert.encoder.layers.1.self_attn.distance_embedding.weight" in frozen
    assert not any("hubert" in k.split(".") for k in state.optimizer.params)


def test_the_encoder_opens_fbank_then_its_layers_inside_encode():
    """``prep:fbank`` around the filterbank, then ``prep:encoder_layers``
    around the Conformer layers (the reader both encoders share), once a
    call, both inside ``prep:encode``."""
    from test_torch_spans import W2V_BERT_SPANS, _ancestors, _named, _profiled

    _, _, engine = tiny_engine(2)
    wav = 0.1 * torch.randn(2, 8000, generator=torch.Generator().manual_seed(6))
    events = _profiled(lambda: engine.generate_from_audio(wav, 2))
    spans = _named(events, W2V_BERT_SPANS + ("prep:encoder_layers",))
    assert [e.name for e in spans] == ["prep:fbank", "prep:encoder_layers"]
    assert all("prep:encode" in _ancestors(e) for e in spans)
    assert spans[0].time_range.end <= spans[1].time_range.start
