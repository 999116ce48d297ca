"""The positional-conv kernel (csrc/pos_conv.cu) on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device;
like ``test_torch_kernels_gpu.py`` this file imports neither JAX nor the JAX
package, so run it on the card as

    python -m pytest --noconftest -m gpu tests/test_torch_pos_conv_gpu.py
"""

import pytest
import torch
import torch.nn.functional as F

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.models import (EdgeDiffusionDecoder, HubertConfig,
                                                 SemanticEncoder)
from edge_diffusion_tts_tpu_torch.models.hubert import PositionalConvEmbedding
from edge_diffusion_tts_tpu_torch.ops import pos_conv as pc
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

pytestmark = pytest.mark.gpu
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _conv(hc: HubertConfig, device, seed: int = 0) -> PositionalConvEmbedding:
    torch.manual_seed(seed)
    return PositionalConvEmbedding(hc).to(device).eval()


def _float64(module: PositionalConvEmbedding, h: torch.Tensor) -> torch.Tensor:
    """h + the module's conv, GELU and trim, all in float64."""
    conv = module.conv
    y = F.conv1d(h.double().transpose(1, 2), conv.weight.double(), conv.bias.double(),
                 padding=pc.TAPS // 2, groups=conv.groups)[:, :, :-1]
    return h.double() + F.gelu(y).transpose(1, 2)


@pytest.mark.parametrize("hc", [HubertConfig(), HubertConfig.wavlm_large()],
                         ids=["hubert-base", "wavlm-large"])
@pytest.mark.parametrize("B, S", [(32, 99), (32, 347), (32, 499), (1, 1), (1, 63), (1, 130),
                                  (1, 257)])
def test_kernel_against_a_float64_conv(cuda, hc, B, S):
    """The kernel's largest error from the float64 conv is no more than twice
    cuDNN's float32 conv's (TF32 off) on the same inputs: both sum the 6,144
    (8,192) products of an output in float32 in another order, so each one's
    error is a sum of float32 roundings of the same size; twice leaves room
    for the orders, and a TF32 product (2^-11 relative) would exceed it
    about a thousandfold.  Two calls give the same bits."""
    module = _conv(hc, cuda)
    w = pc.pack_pos_conv_weights(module.conv.weight)
    h = torch.randn(B, S, hc.hidden_size, generator=torch.Generator(device=cuda).manual_seed(S),
                    device=cuda)
    with torch.no_grad():
        got = pc.positional_conv(h, w, module.conv.bias)
        library = h + module(h)
        want = _float64(module, h)
        assert torch.equal(pc.positional_conv(h, w, module.conv.bias), got)
    err = (got.double() - want).abs().max().item()
    err_library = (library.double() - want).abs().max().item()
    assert err <= 2 * err_library, (err, err_library)


def test_geometry_is_the_hosts(cuda):
    for cpg in pc.WIDTHS:
        g = pc.geometry(cpg)
        assert (g["taps"], g["rows"], g["rt"]) == (pc.TAPS, pc.ROWS, pc.RT)
        assert g["taps_a_stage"] * g["rt"] == pc.TAPS and g["blocks_per_sm"] >= 2, g


def test_refusals(cuda):
    module = _conv(HubertConfig(), cuda)
    w = pc.pack_pos_conv_weights(module.conv.weight)
    h = torch.randn(2, 40, 768, device=cuda)
    bias = module.conv.bias.detach()
    with pytest.raises(RuntimeError, match="no backward"):
        pc.positional_conv(h, w, module.conv.bias)
    with pytest.raises(RuntimeError, match="no backward"):
        pc.positional_conv(h.clone().requires_grad_(), w, bias)
    with pytest.raises(ValueError):
        pc.positional_conv(h[:, :, :767].contiguous(), w, bias)
    with pytest.raises(ValueError):
        pc.positional_conv(h.transpose(0, 1), w, bias)
    with pytest.raises(ValueError):
        pc.positional_conv(h.to(BF16), w, bias)
    small = _conv(HubertConfig(hidden_size=64, num_conv_pos_embedding_groups=4), cuda)
    with pytest.raises(ValueError):  # 16 channels a group: no kernel
        pc.positional_conv(torch.randn(1, 9, 64, device=cuda),
                           pc.pack_pos_conv_weights(small.conv.weight), small.conv.bias.detach())


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
def test_one_launch_per_generate_from_audio_at_float32(cuda, dtype):
    """HuBERT-base in ``EdgeInference.generate_from_audio``: one kernel
    launch a call at float32, where its layer-9 features stay within 1e-3 of
    the module route's (cuDNN's conv), and none at bf16."""
    bf16 = dtype == BF16
    cfg = CFG(dropout=0.0, compute_dtype="bfloat16" if bf16 else "float32")
    torch.manual_seed(0)
    with torch.device(cuda):
        enc = SemanticEncoder(cfg, HubertConfig(), dtype=dtype).eval()
        dec = EdgeDiffusionDecoder(cfg, dtype=dtype).eval()
    enc.hubert.pack_frontend()
    assert enc.hubert.pos_conv_kernel is not bf16
    engine = EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), dec, backend="fused",
                           device=cuda, encoder=enc)
    wav = 0.1 * torch.randn(2, 48000, device=cuda)
    engine.generate_from_audio(wav, 4)
    torch.cuda.synchronize()
    before = pc.launches()
    mel = engine.generate_from_audio(wav, 4)
    torch.cuda.synchronize()
    assert pc.launches() - before == (0 if bf16 else 1) and torch.isfinite(mel).all()
    if not bf16:
        with torch.no_grad():
            routed = enc.extract_hubert(wav)
            enc.hubert.pos_conv_kernel = False
            modules = enc.extract_hubert(wav)
        assert (routed - modules).abs().max().item() <= 1e-3
