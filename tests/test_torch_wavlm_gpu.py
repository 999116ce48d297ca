"""WavLM's gated relative-position attention kernel (csrc/relpos_attention16.cuh),
the frontend kernels' LayerNorm mode (csrc/conv_frontend.cu) and the WavLM
encoder's bf16 route on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device;
like ``test_torch_kernels_gpu.py`` this file imports neither JAX nor the JAX
package, so run it on the card as

    python -m pytest --noconftest -m gpu tests/test_torch_wavlm_gpu.py
"""

import pytest
import torch

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.models import (EdgeDiffusionDecoder, HubertConfig,
                                                 SemanticEncoder)
from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
from edge_diffusion_tts_tpu_torch.ops.fused_denoise import fused_generate_mel
from edge_diffusion_tts_tpu_torch.models.hubert import gated_attention as relpos_attention_plain
from edge_diffusion_tts_tpu_torch.ops.relpos_attention import relpos_attention16
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def packed_inputs(B, S, heads, device, seed=0):
    """A layer's packed GEMM output at WavLM-Large's scales (q, k, v of unit
    variance, gate projections of std 1), the offset vector (std 0.25, the
    benchmark's table) and the gate constants."""
    g = torch.Generator(device=device).manual_seed(seed + S)
    y = torch.randn(B, S, heads * (3 * 64 + 8), generator=g, device=device).to(torch.bfloat16)
    rel = 0.25 * torch.randn(heads, 2 * S - 1, generator=g, device=device)
    const = 0.25 * torch.randn(heads, generator=g, device=device)
    return y, rel, const


@pytest.mark.parametrize("S", [100, 347, 500])
def test_kernel_matches_the_plain_route_at_the_published_widths(cuda, S):
    """B = 32, 16 heads of 64: every output within 2^-7 of the plain route
    (float32 logits and softmax, P rounded to bf16, o rounded to bf16: one
    bf16 rounding of the output and of P, in another summation order) and
    within 1% normwise; two calls bit-equal; no [B, heads, S, S] tensor
    allocated."""
    y, rel, const = packed_inputs(32, S, 16, cuda)
    want = relpos_attention_plain(y, rel, const).float()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = relpos_attention16(y, rel, const)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= got.numel() * 2 + (1 << 20)
    assert got.dtype == torch.bfloat16 and got.shape == (32, S, 1024)
    err = (got.float() - want).abs()
    assert float(err.max()) <= 2 ** -7 * max(1.0, float(want.abs().max())), float(err.max())
    assert float(err.norm() / want.norm()) <= 1e-2
    assert torch.equal(relpos_attention16(y, rel, const), got)


def test_kernel_sees_the_bias_and_the_gates(cuda):
    """Dropping the bias or holding the gates at 1 moves the output far past
    the kernel's own error."""
    y, rel, const = packed_inputs(4, 200, 16, cuda, seed=1)
    got = relpos_attention16(y, rel, const).float()
    no_bias = relpos_attention_plain(y, torch.zeros_like(rel), const).float()
    gp_one = y.clone()
    gp_one[..., 3 * 1024:] = 20.0  # sigmoids at 1: gate = c_h + 1
    at_one = relpos_attention16(gp_one, rel, torch.zeros_like(const)).float()
    assert float((got - no_bias).norm() / got.norm()) > 0.05
    assert float((got - at_one).norm() / got.norm()) > 0.05
    want_one = relpos_attention_plain(gp_one, rel, torch.zeros_like(const)).float()
    assert float((at_one - want_one).norm() / want_one.norm()) <= 1e-2


def test_kernel_refuses_what_it_does_not_take(cuda):
    y, rel, const = packed_inputs(2, 64, 16, cuda)
    with pytest.raises(ValueError):
        relpos_attention16(y.float(), rel, const)
    with pytest.raises(ValueError):
        relpos_attention16(y[..., :-8].contiguous(), rel, const)
    with pytest.raises(ValueError):
        relpos_attention16(y, rel[:, :-1], const)


def wavlm_encoder(cfg, layers, device):
    hc = HubertConfig.wavlm_large()
    torch.manual_seed(0)
    with torch.device(device):
        enc = SemanticEncoder(cfg, hc, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(0.02 * torch.randn_like(p))
    enc.hubert.pack_frontend()
    return enc.eval()


def test_one_launch_per_layer_per_call(cuda):
    """WavLM-Large to layer 21 at bf16: 21 kernel launches an encode, none
    on a masked call (the plain route), whose first two layers agree with
    the kernel route's within 2e-2 (bf16 roundings of the stream in two
    summation orders)."""
    cfg = CFG(hubert_id="microsoft/wavlm-large", hubert_layer=21, compute_dtype="bfloat16")
    enc = wavlm_encoder(cfg, 21, cuda)
    wav = 0.1 * torch.randn(2, 48000, device=cuda)
    fd.zero_kernel_launches()
    with torch.no_grad():
        h = enc.extract_hubert(wav)
    torch.cuda.synchronize()
    assert fd.kernel_launches("relpos_attention16") == 21 and torch.isfinite(h.float()).all()
    full = torch.full((2,), 48000, device=cuda)
    with torch.no_grad():
        kern = enc.hubert.extract_layer(wav, 2)
        plain = enc.hubert.extract_layer(wav, 2, wav_len=full)  # a key mask: the plain route
    assert fd.kernel_launches("relpos_attention16") == 23
    gap = float((kern.float() - plain.float()).norm() / plain.float().norm())
    assert gap <= 2e-2, gap


def test_edge_inference_at_bf16_is_encode_then_the_bf16_loop(cuda):
    """``EdgeInference(backend="fused")`` at a bf16 configuration: the tokens
    of the encoder's route (the conv stack on the frontend kernels' LayerNorm
    mode) and the mel of ``fused_generate_mel`` at bf16, bit for bit."""
    cfg = CFG(hubert_id="microsoft/wavlm-large", hubert_layer=21, compute_dtype="bfloat16",
              use_v_prediction=True, use_depthwise=True)
    enc = wavlm_encoder(cfg, 21, cuda)
    torch.manual_seed(1)
    with torch.device(cuda):
        dec = EdgeDiffusionDecoder(cfg, dtype=torch.bfloat16).eval()
    sched = DiffusionSchedule.create(cfg.diff_steps, cfg.beta_start, cfg.beta_end)
    engine = EdgeInference(cfg, sched, dec, prediction="v", backend="fused", device=cuda,
                           encoder=enc)
    w = engine.encoder.hubert.packed_frontend()
    assert engine.encoder.hubert.frontend_kernel
    assert w["wk3"].dtype == torch.bfloat16
    assert w["gamma"].shape == (7, 512)
    wav = 0.1 * torch.randn(4, 40000, device=cuda)
    with torch.no_grad():
        tokens = enc.encode(wav, conv_feats=ff.conv_frontend(wav, w, compute_dtype=torch.bfloat16))
    x = torch.randn(4, 2 * tokens.shape[1], cfg.n_mels, device=cuda)
    got = engine.generate_from_audio(wav, 4, x_T=x)
    with torch.no_grad():
        want = fused_generate_mel(cfg, sched.to(cuda), dec, tokens, x, 4, "v",
                                  compute_dtype=torch.bfloat16)
    assert torch.equal(got, want)


# -- the frontend kernels' LayerNorm mode --------------------------------------------------


def layernorm_extractor(device):
    """WavLM-Large's conv stack at bf16 with seeded weights: the convs at
    He scale, each LayerNorm's gamma and beta moved off 1 and 0."""
    torch.manual_seed(0)
    from edge_diffusion_tts_tpu_torch.models.hubert import FeatureExtractor

    fe = FeatureExtractor(HubertConfig.wavlm_large(), dtype=torch.bfloat16)
    with torch.no_grad():
        for layer in fe.conv_layers:
            layer.conv.weight.normal_(0, (2.0 / layer.conv.weight[0].numel()) ** 0.5)
            layer.layer_norm.weight.add_(0.1 * torch.randn(512))
            layer.layer_norm.bias.add_(0.1 * torch.randn(512))
    return fe.to(device).eval()


def bf16_close(got, want, normwise=4e-3):
    """Within one bf16 rounding flip of each element (summation orders
    differ) and ``normwise`` over all."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    assert float(err.max()) <= 2 ** -7 * max(1.0, float(want.abs().max())), float(err.max())
    assert float(err.norm() / want.norm()) <= normwise, float(err.norm() / want.norm())


# conv1-6 on each bf16 tile: the two wgmma tiles (clusters of 2 and 4 blocks)
# and the mma.sync tile with one and with four K splits
LN_ROUTES = [dict(tile=1), dict(tile=2), dict(tile=0, splits=1), dict(tile=0, splits=4)]


@pytest.mark.parametrize("seconds", [2, 7, 10])
def test_layernorm_mode_layers_match_the_plain_version(cuda, seconds):
    """Each layer of the LayerNorm mode at B = 32 against
    ``conv_frontend_layer_plain`` on the same input (the plain chain's), in
    every tile; conv0 on its kernel."""
    fe = layernorm_extractor(cuda)
    w = ff.pack_frontend_weights(fe, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(seconds)
    x = 0.1 * torch.randn(32, 16000 * seconds, generator=g, device=cuda)
    with torch.no_grad():
        for layer in range(ff.LAYERS):
            want = ff.conv_frontend_layer_plain(x, layer, w, compute_dtype=torch.bfloat16)
            for route in [{}] if layer == 0 else LN_ROUTES:
                got = ff.conv_frontend_layer(x, layer, w, compute_dtype=torch.bfloat16, **route)
                torch.cuda.synchronize()
                assert got.dtype == want.dtype and got.shape == want.shape, (layer, route)
                bf16_close(got, want)
            x = want


def test_layernorm_mode_repeats_and_counts_seven_launches(cuda):
    """A call of the LayerNorm mode at [32, 112000] (the 7 s bucket): the
    plain chain's features within bf16 rounding (normwise 1e-2: rounding
    flips feed the next layer), two calls bit for bit, seven layer launches
    each, and none in a GroupNorm call; the library's workspace is the
    plan's (``frontend_workspace(..., layer_norm=True)``)."""
    fe = layernorm_extractor(cuda)
    w = ff.pack_frontend_weights(fe, torch.bfloat16)
    wav = 0.1 * torch.randn(32, 112000, generator=torch.Generator(device=cuda).manual_seed(1),
                            device=cuda)
    with torch.no_grad():
        before = ff.ln_launches()
        got = ff.conv_frontend(wav, w, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert ff.ln_launches() - before == 7
        assert torch.equal(ff.conv_frontend(wav, w, compute_dtype=torch.bfloat16), got)
        assert ff.ln_launches() - before == 14
        want = ff.conv_frontend_plain(wav, w, compute_dtype=torch.bfloat16)
    err = float((got - want).norm() / want.norm())
    assert got.shape == (32, 349, 512) and got.dtype == torch.float32 and err <= 1e-2, err
    for B, n in ((32, 112000), (32, 32000), (1, 80000), (2, 8000)):
        plan = ff.frontend_plan(B, n, dtype=torch.bfloat16)
        assert ff._lib().edt_conv_frontend_ln_workspace(B, n, 512, ff._splits(plan),
                                                       ff._tiles(plan)) == \
            4 * ff.frontend_workspace(B, plan, torch.bfloat16, layer_norm=True)
    from edge_diffusion_tts_tpu_torch.models.hubert import FeatureExtractor

    torch.manual_seed(0)
    base = FeatureExtractor(HubertConfig()).to(cuda).eval()
    before = ff.ln_launches()
    with torch.no_grad():
        ff.conv_frontend(wav[:2], ff.pack_frontend_weights(base, torch.bfloat16),
                         compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert ff.ln_launches() == before


def test_kernel_route_tokens_against_the_modules_route(cuda):
    """Layer 21 of WavLM-Large at bf16 on [4, 48000]: the kernel route's
    hidden state and tokens against the float32 modules (the reference
    here), no farther than the bf16 modules route's."""
    cfg = CFG(hubert_id="microsoft/wavlm-large", hubert_layer=21, compute_dtype="bfloat16")
    enc = wavlm_encoder(cfg, 21, cuda).to(cuda)  # the FSQ's basis is made on the CPU
    ref = SemanticEncoder(cfg, HubertConfig.wavlm_large())
    ref.load_state_dict(enc.state_dict())
    ref = ref.to(cuda).eval()
    w = ff.pack_frontend_weights(enc.hubert.feature_extractor, torch.bfloat16)
    wav = 0.1 * torch.randn(4, 48000, generator=torch.Generator(device=cuda).manual_seed(2),
                            device=cuda)
    with torch.no_grad():
        feats = ff.conv_frontend(wav, w, compute_dtype=torch.bfloat16)
        kernel = enc.extract_hubert(wav, conv_feats=feats).float()
        assert torch.equal(enc.extract_hubert(wav).float(), kernel)  # the encoder's own route
        conv = [e.hubert.feature_extractor(wav) for e in (enc, ref)]
        modules = enc.extract_hubert(wav, conv_feats=conv[0]).float()
        want = ref.extract_hubert(wav, conv_feats=conv[1]).float()
        tokens = [ff.fast_encode(enc, wav), enc.encode(wav, conv_feats=conv[0]),
                  ref.encode(wav, conv_feats=conv[1])]
    gap_kernel = float((kernel - want).norm() / want.norm())
    gap_modules = float((modules - want).norm() / want.norm())
    assert gap_kernel <= 1.1 * gap_modules, (gap_kernel, gap_modules)
    agree = [float((t == tokens[2]).float().mean()) for t in tokens[:2]]
    assert agree[0] >= agree[1] - 0.02, agree
