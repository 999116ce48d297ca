"""WavLM-Large in the port's encoder slot, on the CPU: the benchmark's plain
reference (``benchmark/reference/wavlm.py``) against transformers'
``WavLMModel``, the port's ``HubertEncoder`` at a WavLM configuration
against both, its bf16 plain route, the packed GEMM the card's kernel
reads (``Attention.packed_input``) against the four projections,
``wav_len`` masking, ``wavlm_state_dict_from_hf``, the encoder named by
``hubert_id``, ``train()`` with a tiny WavLM frozen in it, and the conv
stack's plain version in the frontend kernels' LayerNorm mode with the
routes that take it.

All at a tiny size (width 32-128, 2-3 layers) with the published bucket
numbers (320 buckets, distance 800), stable (pre-LN) layers and a
LayerNorm after every conv."""

import dataclasses

import pytest
import torch

from benchmark.reference import wavlm as rw
from benchmark.reference.precision import Ops
from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference, fast_encode
from edge_diffusion_tts_tpu_torch.models import (EdgeDiffusionDecoder, HubertConfig,
                                                 SemanticEncoder, hubert_config_for)
from edge_diffusion_tts_tpu_torch.models.hubert import (HubertEncoder, relative_buckets,
                                                        relpos_kernel_serves)
from edge_diffusion_tts_tpu_torch.models.hubert import FeatureExtractor
from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
from edge_diffusion_tts_tpu_torch.ops.fused_frontend import kernel_serves
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
from edge_diffusion_tts_tpu_torch.weights import wavlm_state_dict_from_hf

TINY = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
            hidden_size=32, num_layers=3, num_heads=2, intermediate_size=64,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
WAVLM = dict(feat_extract_norm="layer", do_stable_layer_norm=True, num_buckets=320,
             max_bucket_distance=800)


def tiny_wavlm(**kw) -> HubertConfig:
    return HubertConfig(**dict(TINY, **WAVLM, **kw))


def as_dict(hc: HubertConfig) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(hc).items()}


def seeded(hc: HubertConfig, seed: int = 0, dtype=torch.float32) -> HubertEncoder:
    """A HubertEncoder with every parameter drawn (norms and gates off their
    init values, so that each path computes something)."""
    torch.manual_seed(seed)
    enc = HubertEncoder(hc, dtype)
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(0.1 * torch.randn_like(p))
    enc.pack_frontend()
    return enc.eval()


def reference_params(enc: HubertEncoder) -> dict:
    return {"hubert." + k: v.detach().float() for k, v in enc.state_dict().items()}


def rel_gap(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hc = transformers.WavLMConfig(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=2, intermediate_size=64,
        conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, do_stable_layer_norm=True,
        feat_extract_norm="layer", num_buckets=320, max_bucket_distance=800, conv_bias=False)
    m = transformers.WavLMModel(hc).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn_like(p))
    return m


@pytest.fixture(scope="module")
def wav():
    # 2,000 samples: 199 frames, offsets to 198, past the buckets' exact range
    g = torch.Generator().manual_seed(1)
    return torch.randn(2, 4000, generator=g)


def test_the_reference_is_transformers_wavlm(hf_model, wav):
    """Every hidden state, 0 to the last (the final LayerNorm's), within
    1e-5 relative: float32 in both, the same equations in another order."""
    sd = wavlm_state_dict_from_hf(hf_model.state_dict(), tiny_wavlm())
    P = {"hubert." + k: v for k, v in sd.items()}
    with torch.no_grad():
        want = hf_model(wav, output_hidden_states=True).hidden_states
    assert len(want) == 4
    for L in range(4):
        got = rw.layer(P, as_dict(tiny_wavlm()), wav, Ops(), L)
        assert rel_gap(got, want[L]) <= 1e-5, L


def test_the_state_dict_loads_and_the_port_is_transformers_wavlm(hf_model, wav):
    sd = wavlm_state_dict_from_hf(hf_model.state_dict(), tiny_wavlm())
    assert "encoder.layers.0.attention.rel_attn_embed.weight" in sd
    assert "encoder.layers.1.attention.rel_attn_embed.weight" not in sd
    enc = HubertEncoder(tiny_wavlm())
    enc.load_state_dict(sd)  # strict: every name and shape
    with torch.no_grad():
        got = enc.eval()(wav)
        want = hf_model(wav, output_hidden_states=True).hidden_states
    for L in range(4):
        assert rel_gap(got[L], want[L]) <= 1e-5, L
    with pytest.raises(KeyError, match="WavLM"):
        wavlm_state_dict_from_hf({k: v for k, v in hf_model.state_dict().items()
                                  if "gru_rel_pos_const" not in k}, tiny_wavlm())


def test_buckets_are_transformers(hf_model):
    att = hf_model.encoder.layers[0].attention
    offsets = torch.arange(-1500, 1501)
    assert torch.equal(relative_buckets(offsets, 320, 800), att._relative_positions_bucket(offsets))
    assert torch.equal(rw.bucket(offsets, 320, 800), att._relative_positions_bucket(offsets))


def test_port_float32_is_the_reference(wav):
    """At float32 the port and the reference compute the same equations; the
    gap is summation order (the port's q k^T and bias add against the
    reference's, its fused LayerNorms): 1e-5 relative on every hidden
    state, the tolerance the HuBERT port is held to."""
    hc = tiny_wavlm(hidden_size=64, num_heads=4, intermediate_size=128)
    enc = seeded(hc, 3)
    P = reference_params(enc)
    with torch.no_grad():
        got = enc(wav)
    for L in range(hc.num_layers + 1):
        assert rel_gap(got[L], rw.layer(P, as_dict(hc), wav, Ops(), L)) <= 1e-5, L
    # hidden_states[i] is the stream after i layers: no final LayerNorm but after the last
    assert got[1].std() > 1.2 * got[-1].std() or rel_gap(got[-1], got[1]) > 0.1
    with torch.no_grad():
        assert torch.equal(enc.extract_layer(wav, 2), got[2])


def test_port_bf16_plain_route(wav):
    """bf16 compute (products' operands and the stream at bf16, logits,
    bias, softmax and norms' statistics in float32): within 3e-2 relative
    of the float32 reference on every hidden state, about eight bf16
    roundings (2^-8 each) through three layers; the float32 port is 1e-5."""
    hc = tiny_wavlm(hidden_size=64, num_heads=4, intermediate_size=128)
    enc32 = seeded(hc, 4)
    enc16 = HubertEncoder(hc, torch.bfloat16).eval()
    enc16.load_state_dict(enc32.state_dict())
    P = reference_params(enc32)
    with torch.no_grad():
        got = enc16(wav)
    for L in range(hc.num_layers + 1):
        assert got[L].dtype == torch.bfloat16
        gap = rel_gap(got[L], rw.layer(P, as_dict(hc), wav, Ops(), L))
        assert 1e-4 < gap <= 3e-2, (L, gap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_packed_gemm_is_the_projections(dtype):
    """``packed_input``, the one GEMM the gated attention reads on either
    route: q, k, v and each head's 8 gate projections (the gate's weight
    block-diagonal over the heads) as the four Linears give them, to a
    rounding of the compute dtype (the sums in another order)."""
    hc = tiny_wavlm(hidden_size=128, num_heads=2)  # head dim 64, the kernel's
    enc = seeded(hc, 5, dtype)
    att = enc.encoder.layers[1].attention
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 97, 128, generator=g).to(dtype)
    with torch.no_grad():
        y = att.packed_input(x)
        want = torch.cat([att.q_proj(x), att.k_proj(x), att.v_proj(x),
                          att.gru_rel_pos_linear(x.reshape(3, 97, 2, 64)).reshape(3, 97, 16)], -1)
    assert y.dtype == dtype and y.shape == (3, 97, 3 * 128 + 16)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), want.float(), atol=tol * float(want.abs().max()),
                               rtol=0)
    rel = enc.encoder.rel_values(97, "cpu")
    assert rel.shape == (2, 2 * 97 - 1) and rel.dtype == torch.float32
    assert not relpos_kernel_serves(x, None, 64)  # the CPU takes the plain route


def test_wav_len_makes_a_padded_batch_exact():
    """A LayerNorm conv stack and the gated attention under a key mask: the
    frames of a zero-padded row equal its unpadded forward's."""
    hc = tiny_wavlm()
    enc = seeded(hc, 6)
    g = torch.Generator().manual_seed(3)
    short, full = torch.randn(1, 2500, generator=g), torch.randn(1, 4000, generator=g)
    batch = torch.cat([torch.nn.functional.pad(short, (0, 1500)), full])
    with torch.no_grad():
        padded = enc(batch, wav_len=torch.tensor([2500, 4000]))
        alone = enc(short)
    n = alone[0].shape[1]
    for L in range(hc.num_layers + 1):
        torch.testing.assert_close(padded[L][0, :n], alone[L][0], atol=2e-5, rtol=1e-5)
        assert torch.all(padded[L][0, n:] == 0)


def test_hubert_id_names_the_encoder():
    assert hubert_config_for("facebook/hubert-base-ls960") == HubertConfig()
    wl = hubert_config_for("microsoft/wavlm-large")
    assert wl == HubertConfig.wavlm_large()
    assert (wl.hidden_size, wl.num_layers, wl.num_heads, wl.intermediate_size) == (1024, 24, 16,
                                                                                   4096)
    assert (wl.feat_extract_norm, wl.do_stable_layer_norm, wl.num_buckets,
            wl.max_bucket_distance) == ("layer", True, 320, 800)
    with pytest.raises(ValueError, match="hubert_id"):
        hubert_config_for("facebook/hubert-large-ll60k")
    # hubert-base's file keeps the fields the JAX package reads; WavLM's round-trips
    assert "num_buckets" not in HubertConfig().to_json()
    assert HubertConfig.from_json(wl.to_json()) == wl


def test_a_layernorm_stack_takes_the_modules():
    assert kernel_serves(HubertConfig(), torch.float32)
    assert not kernel_serves(HubertConfig.wavlm_large(), torch.float32)
    cfg = CFG(hidden=32, layers=1, heads=2, hubert_id="microsoft/wavlm-large")
    torch.manual_seed(0)
    enc = SemanticEncoder(cfg, tiny_wavlm(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                                          conv_stride=(5, 2, 2, 2, 2, 2, 2)))
    engine = EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), EdgeDiffusionDecoder(cfg),
                           backend="fused", device="cpu", encoder=enc)
    assert not engine.encoder.hubert.frontend_kernel
    assert not any("frontend" in n for n, _ in engine.encoder.named_buffers())
    wav = torch.randn(2, 6400, generator=torch.Generator().manual_seed(4))
    mel = engine.generate_from_audio(wav, 2)
    assert mel.shape == (2, 2 * 19, cfg.n_mels) and torch.isfinite(mel).all()


def test_train_follows_hubert_id(tmp_path, monkeypatch):
    """``train()`` builds the encoder ``cfg.hubert_id`` names (a tiny WavLM
    in WavLM-Large's place here) and runs its steps with it frozen."""
    import importlib

    from test_torch_training_driver import _corpus, tiny_cfg

    train_mod = importlib.import_module("edge_diffusion_tts_tpu_torch.training.train")

    asked = []

    def tiny_for(hubert_id):
        asked.append(hubert_id)
        assert hubert_config_for(hubert_id).num_buckets  # the WavLM id
        return tiny_wavlm(conv_dim=(16,) * 5, conv_kernel=(10, 4, 4, 2, 2),
                          conv_stride=(5, 4, 4, 2, 2))

    monkeypatch.setattr(train_mod, "hubert_config_for", tiny_for)
    _corpus(str(tmp_path / "LJSpeech-1.1"))
    cfg = tiny_cfg(tmp_path, hubert_id="microsoft/wavlm-large", hubert_layer=2,
                   progressive_epochs_per_halving=0, consistency_epochs=0, ckpt_every_steps=0,
                   val_every_steps=0, num_workers=0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = train_mod.train(cfg, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert asked == ["microsoft/wavlm-large"]
    hc = state.encoder.hubert_cfg
    assert hc.do_stable_layer_norm and hc.num_buckets == 320
    assert state.step > 0
    frozen = {k: v for k, v in state.encoder.state_dict().items() if k.startswith("hubert.")}
    assert "hubert.encoder.layers.0.attention.rel_attn_embed.weight" in frozen
    assert not any(k.startswith("encoder.hubert.") or "hubert" in k.split(".")
                   for k in state.optimizer.params)


# -- the conv stack in the frontend kernels' LayerNorm mode ----------------------------------

BASE_CONVS = dict(conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2))


def layernorm_stack(width: int, dtype=torch.float32) -> FeatureExtractor:
    """WavLM's conv stack (hubert-base's kernels and strides, a LayerNorm
    after every conv) at ``width``, with each norm's gamma and beta drawn."""
    torch.manual_seed(width)
    fe = FeatureExtractor(tiny_wavlm(conv_dim=(width,) * 7, **BASE_CONVS), dtype)
    with torch.no_grad():
        for layer in fe.conv_layers:
            layer.conv.weight.normal_(0, (2.0 / layer.conv.weight[0].numel()) ** 0.5)
            layer.layer_norm.weight.add_(0.1 * torch.randn(width))
            layer.layer_norm.bias.add_(0.1 * torch.randn(width))
    return fe.eval()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("width", [16, 512])
def test_layernorm_plain_is_the_feature_extractor(width, masked):
    """``conv_frontend_plain`` over packed LayerNorm weights ([7, C] norms):
    the float32 ``FeatureExtractor`` to 1e-5 relative, the per-layer plain
    version chained bit for bit; at bf16, in the kernel's rounding order (one
    bf16 rounding a layer, after the GELU), within 2e-2 of the bf16 modules
    and no farther from float32 than they are (they round the wav, w0, each
    conv's output and each norm's).  ``wav_len``: a zero-padded row's frames
    inside its true length are its exact-length call's (1e-5: the CPU's
    convolutions sum in an order that follows the length)."""
    fe = layernorm_stack(width)
    w = ff.pack_frontend_weights(fe)
    assert ff.layer_norm_mode(w) and w["gamma"].shape == w["beta"].shape == (7, width)
    wav = torch.randn(2, 6000, generator=torch.Generator().manual_seed(width))
    wav_len = torch.tensor([6000, 3700]) if masked else None
    if masked:
        wav[1, 3700:] = 0.0
    with torch.no_grad():
        want = fe(wav, wav_len=wav_len)
        got = ff.conv_frontend_plain(wav, w, wav_len=wav_len)
        assert rel_gap(got, want) <= 1e-5
        x = wav
        for layer in range(ff.LAYERS):
            x = ff.conv_frontend_layer_plain(x, layer, w)
        assert torch.equal(x, got)
        fe16 = FeatureExtractor(fe.cfg, torch.bfloat16).eval()
        fe16.load_state_dict(fe.state_dict())
        modules = fe16(wav, wav_len=wav_len).float()
        wb = ff.pack_frontend_weights(fe16, torch.bfloat16)
        low = ff.conv_frontend_plain(wav, wb, wav_len=wav_len, compute_dtype=torch.bfloat16)
        assert low.dtype == torch.float32 and wb["wk3"].dtype == torch.bfloat16
        assert rel_gap(low, modules) <= 2e-2
        assert 0 < rel_gap(low, want) <= rel_gap(modules, want)
        if masked:
            n = ff.frame_counts(3700)[-1]
            alone = ff.conv_frontend_plain(wav[1:, :3700], w)
            assert rel_gap(got[1:, :n], alone) <= 1e-5


def test_kernel_serves_a_layernorm_stack_at_bf16():
    """The frontend kernel takes WavLM's stack at bf16 compute (its LayerNorm
    mode), not at float32; hubert-base's GroupNorm stack at either; a
    LayerNorm stack only at the mode's widths (multiples of 256, to 1024)."""
    bf16 = torch.bfloat16
    assert kernel_serves(HubertConfig.wavlm_large(), bf16)
    assert not kernel_serves(HubertConfig.wavlm_large(), torch.float32)
    with pytest.raises(TypeError):  # no default dtype to fall back to
        kernel_serves(HubertConfig.wavlm_large())
    assert kernel_serves(HubertConfig(), torch.float32) and kernel_serves(HubertConfig(), bf16)
    for width, takes in ((128, False), (256, True), (1024, True), (2048, False)):
        hc = tiny_wavlm(conv_dim=(width,) * 7, **BASE_CONVS)
        assert kernel_serves(hc, bf16) == takes, width
    assert not kernel_serves(tiny_wavlm(), bf16)  # not hubert-base's kernels
    ff.check_base_specs(HubertConfig.wavlm_large())
    with pytest.raises(ValueError, match="hubert-base stack"):
        ff.check_base_specs(tiny_wavlm())


def test_edge_inference_takes_the_kernel_route_at_bf16():
    """A WavLM-shaped encoder built at bf16 (WavLM's conv stack at width
    256) takes the kernel route, with the frontend weights packed at bf16
    and the seven norms [7, C]; the tokens ``EdgeInference`` encodes are
    ``encode`` over ``conv_frontend`` at bf16 (on the CPU the plain
    version).  A float32 encoder of hubert-base's stack keeps the float32
    packing of ``pack_frontend_weights``."""
    cfg = CFG(hidden=32, layers=1, heads=2, hubert_id="microsoft/wavlm-large",
              compute_dtype="bfloat16")
    torch.manual_seed(0)
    enc = SemanticEncoder(cfg, tiny_wavlm(conv_dim=(256,) * 7, **BASE_CONVS),
                          dtype=torch.bfloat16)
    sched = DiffusionSchedule.create(cfg.diff_steps)
    engine = EdgeInference(cfg, sched, EdgeDiffusionDecoder(cfg, dtype=torch.bfloat16),
                           backend="fused", device="cpu", encoder=enc)
    w = engine.encoder.hubert.packed_frontend()
    assert engine.encoder.hubert.frontend_kernel
    assert w["wk3"].dtype == w["wk2"].dtype == torch.bfloat16 and w["gamma"].shape == (7, 256)
    wav = 0.3 * torch.randn(2, 6400, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = enc.encode(wav, conv_feats=ff.conv_frontend_plain(wav, w,
                                                                 compute_dtype=torch.bfloat16))
    assert torch.equal(fast_encode(enc, wav), want)
    mel = engine.generate_from_audio(wav, 2)
    assert mel.shape == (2, 2 * want.shape[1], cfg.n_mels) and torch.isfinite(mel).all()

    base = SemanticEncoder(CFG(hidden=32, layers=1, heads=2),
                           HubertConfig(conv_dim=(128,) * 7, **{k: TINY[k] for k in TINY
                                                                if "conv_dim" != k and
                                                                not k.startswith("conv_")}))
    flagship = EdgeInference(CFG(hidden=32, layers=1, heads=2), sched,
                             EdgeDiffusionDecoder(CFG(hidden=32, layers=1, heads=2)),
                             device="cpu", encoder=base)
    packed = ff.pack_frontend_weights(base.hubert.feature_extractor)
    held = flagship.encoder.hubert.packed_frontend()
    assert flagship.encoder.hubert.frontend_kernel and set(held) == set(packed)
    assert all(torch.equal(held[k], v) and v.dtype == torch.float32 for k, v in packed.items())
    assert packed["gamma"].shape == (128,)
