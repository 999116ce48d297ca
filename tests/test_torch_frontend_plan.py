"""The conv frontend's launch plan and its per-layer plain version, on the CPU.

``frontend_plan`` is what the host hands the kernel (tile, split-K factor,
blocks per layer), so its invariants are checked here without a card: frames
per layer, split-K over whole channel chunks, the workspace, and how the
grids fill an H100's 132 SMs.  ``conv_frontend_layer_plain`` is the plain
version of the per-layer hook: chained, it is ``conv_frontend_plain``
(bit for bit); each layer is the port's ``FeatureExtractor.conv_layers[i]``
(1e-5, or atol 2e-4 rtol 1e-3 for conv0 whose GroupNorm is folded
analytically) and the chain is JAX's ``_FeatureExtractor`` (atol 2e-4 rtol
1e-3, the JAX fused kernel's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.models.hubert import _FeatureExtractor as JFeatureExtractor
from edge_diffusion_tts_tpu_torch.models.hubert import FeatureExtractor, HubertConfig
from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
from edge_diffusion_tts_tpu_torch.weights import encoder_state_dict_from_jax

SHAPES = [(1, 80000), (4, 32000), (2, 8000), (3, 4321)]


def _wav(B, n):
    return torch.from_numpy((0.2 * np.random.RandomState(B + n).randn(B, n)).astype(np.float32))


def _fold(wav, w):
    return ff.groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"])


@pytest.fixture(scope="module")
def extractor():
    torch.manual_seed(0)
    fe = FeatureExtractor(HubertConfig()).eval()
    with torch.no_grad():  # a nontrivial GroupNorm affine
        fe.conv_layers[0].layer_norm.weight.add_(0.1 * torch.randn(512))
        fe.conv_layers[0].layer_norm.bias.add_(0.1 * torch.randn(512))
    return fe, ff.pack_frontend_weights(fe)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B,n", SHAPES)
def test_plan_covers_every_layer(B, n, sms):
    plan = ff.frontend_plan(B, n, sms=sms)
    frames = ff.frame_counts(n)
    assert [p["M"] for p in plan] == frames and [p["layer"] for p in plan] == list(range(7))
    assert [p["K"] for p in plan] == [10] + [k * 512 for k in ff.BASE_KERNELS[1:]]
    chunks = 512 // ff.CHUNK
    for p in plan:
        bm, bn = p["tile"]
        assert p["N"] == 512 and 512 % bn == 0
        tiles = B * -(-p["M"] // bm) * (512 // bn)
        assert p["blocks"] == tiles * p["splits"]
        S = p["splits"]
        if p["layer"] == 0:
            assert S == 1 and p["tile"] == (ff.CONV0_ROWS, 512)
            continue
        # Split s takes chunks [s*Q//S, (s+1)*Q//S): together every chunk once.
        spans = [range(s * chunks // S, (s + 1) * chunks // S) for s in range(S)]
        assert all(len(r) >= 1 for r in spans)
        assert [q for r in spans for q in r] == list(range(chunks))
        # One wave, and no further split would still fit in it.
        assert S == 1 or tiles * S <= sms
        assert tiles >= sms or S == chunks or tiles * (S + 1) > sms


@pytest.mark.parametrize("B,n", SHAPES)
def test_workspace_covers_the_plan(B, n):
    plan = ff.frontend_plan(B, n)
    work = ff.frontend_workspace(B, plan)
    f0, f1 = plan[0]["M"], plan[1]["M"]
    # Layer i writes the buffer of layer i - 2 (conv0's or conv1's, the last
    # layer writes the output); split layers' partials follow both.
    for p in plan[2:]:
        assert p["M"] <= (f0 if p["layer"] % 2 == 0 else f1)
    partials = [p["splits"] * B * p["M"] * 512 for p in plan if p["splits"] > 1]
    assert work == B * 512 * (f0 + f1) + max(partials or [0])


def test_plan_fills_the_card_at_5_seconds():
    """wav [1, 80000] on 132 SMs: conv0 and conv1 launch >= 132 blocks; every
    layer that would not fill the card alone runs split-K as one wave of
    128 blocks (4 SMs idle)."""
    plan = ff.frontend_plan(1, 80000)
    assert [p["blocks"] for p in plan] == [1000, 252, 128, 128, 128, 128, 128]
    assert [p["splits"] for p in plan] == [1, 1, 1, 2, 4, 8, 16]


@pytest.mark.parametrize("B,n", [(2, 8000), (3, 4321)])
def test_plain_layers_chain_to_the_plain_frontend(extractor, B, n):
    _, w = extractor
    wav = _wav(B, n)
    x = wav
    for i in range(7):
        x = ff.conv_frontend_layer_plain(x, i, w, *(_fold(wav, w) if i == 0 else ()))
        assert x.shape == (B, ff.frame_counts(n)[i], 512) and x.is_contiguous()
    assert torch.equal(x, ff.conv_frontend_plain(wav, w))


@pytest.mark.parametrize("layer", range(7))
def test_plain_layer_matches_the_module_layer(extractor, layer):
    fe, w = extractor
    wav = _wav(2, 8000)
    conv = fe.conv_layers[layer]
    with torch.no_grad():
        x = wav[:, None, :]
        for i in range(layer):  # the module route's input to this layer
            x = fe.conv_layers[i].conv(x)
            x = F.gelu(fe.conv_layers[0].layer_norm(x) if i == 0 else x)
        want = conv.conv(x)
        want = F.gelu(conv.layer_norm(want) if layer == 0 else want).transpose(1, 2)
    x_in = wav if layer == 0 else x.transpose(1, 2).contiguous()
    got = ff.conv_frontend_layer_plain(x_in, layer, w, *(_fold(wav, w) if layer == 0 else ()))
    tol = dict(atol=2e-4, rtol=1e-3) if layer == 0 else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got, want, **tol)


def test_plain_layers_match_jax_feature_extractor():
    fe = JFeatureExtractor(JHC())
    params = fe.init(jax.random.PRNGKey(3), jnp.zeros((1, 8000)))["params"]
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(4), len(leaves))
    params = jax.tree.unflatten(
        treedef, [p + 0.02 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])
    pfe = FeatureExtractor(HubertConfig())
    sd = encoder_state_dict_from_jax({"params": {"hubert": {"feature_extractor": params}}})
    pfe.load_state_dict({k[len("hubert.feature_extractor."):]: v for k, v in sd.items()})
    w = ff.pack_frontend_weights(pfe)
    wav = _wav(1, 8000)
    want = np.asarray(fe.apply({"params": params}, jnp.asarray(wav.numpy())))
    x = wav
    for i in range(7):
        x = ff.conv_frontend_layer_plain(x, i, w, *(_fold(wav, w) if i == 0 else ()))
    assert x.shape == want.shape == (1, 24, 512)
    np.testing.assert_allclose(x.numpy(), want, atol=2e-4, rtol=1e-3)


def test_layer_hook_takes_cuda_tensors_only(extractor):
    _, w = extractor
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ff.conv_frontend_layer(torch.zeros(1, 100, 512), 1, w)
