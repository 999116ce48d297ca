"""The positional-conv kernel's route and plain version on the CPU
(``ops/pos_conv.py``; the kernel itself is held to a float64 conv on the
card in ``test_torch_pos_conv_gpu.py``).

The encoder takes the kernel for a float32 positional conv of 128 taps
with 48 or 64 channels a group (HuBERT-base, WavLM-Large), and the module
anywhere else; on the CPU the route runs the plain version, which is the
module and its residual add bit for bit; the packed weight is a
non-persistent buffer that ``load_state_dict`` and ``pack_frontend`` pack
again in place; no gradient flows through the route.
"""

import pytest
import torch

from edge_diffusion_tts_tpu_torch.models.hubert import (HubertConfig, HubertEncoder,
                                                        PositionalConvEmbedding)
from edge_diffusion_tts_tpu_torch.ops import pos_conv as pc

BF16 = torch.bfloat16
# A small encoder whose positional conv the kernel takes: 2 groups of 48.
SERVED = HubertConfig(conv_dim=(32,) * 7, hidden_size=96, num_layers=1, num_heads=2,
                      intermediate_size=64, num_conv_pos_embedding_groups=2)


@pytest.mark.parametrize("hc, dtype, serves", [
    (HubertConfig(), torch.float32, True),
    (HubertConfig.wavlm_large(), torch.float32, True),
    (HubertConfig(), BF16, False),
    (HubertConfig.wavlm_large(), BF16, False),
    (HubertConfig.tiny(), torch.float32, False),
    (HubertConfig.tiny320(), torch.float32, False),
    (SERVED, torch.float32, True),
], ids=["base-f32", "wavlm-f32", "base-bf16", "wavlm-bf16", "tiny", "tiny320", "small-48"])
def test_route_rule(hc, dtype, serves):
    assert pc.kernel_serves(hc, dtype) is serves


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_the_encoder_decides_the_route_once(dtype):
    enc = HubertEncoder(SERVED, dtype)
    assert enc.pos_conv_kernel is (dtype == torch.float32)
    assert hasattr(enc, "pos_conv_w") is enc.pos_conv_kernel
    assert "pos_conv_w" not in enc.state_dict()
    tiny = HubertEncoder(HubertConfig.tiny())
    assert not tiny.pos_conv_kernel and not hasattr(tiny, "pos_conv_w")


@pytest.mark.parametrize("B, S", [(1, 99), (1, 100), (3, 1), (3, 130)])
def test_plain_version_is_the_module_bit_for_bit(B, S):
    hc = HubertConfig()
    torch.manual_seed(0)
    module = PositionalConvEmbedding(hc)
    h = torch.randn(B, S, hc.hidden_size, generator=torch.Generator().manual_seed(S))
    w = pc.pack_pos_conv_weights(module.conv.weight)
    with torch.no_grad():
        want = h + module(h)
        got = pc.positional_conv(h, w, module.conv.bias)
    assert torch.equal(pc.positional_conv_plain(h, w, module.conv.bias.detach()), want)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cpg", [48, 64])
def test_packed_layout_round_trips(cpg):
    g = torch.Generator().manual_seed(cpg)
    weight = torch.randn(3 * cpg, cpg, pc.TAPS, generator=g)
    w = pc.pack_pos_conv_weights(weight)
    assert tuple(w.shape) == (3, pc.RT, cpg // 4, pc.TAPS // pc.RT, cpg, 4) and w.is_contiguous()
    assert torch.equal(pc.unpack_pos_conv_weights(w), weight)
    idx = torch.randint(0, 10 ** 6, (50, 6), generator=g)
    for gi, j0, k, u, o, e in (idx % torch.tensor(w.shape)).tolist():
        assert w[gi, j0, k, u, o, e] == weight[gi * cpg + o, 4 * k + e, j0 + pc.RT * u]


def _drawn(enc: HubertEncoder, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in enc.state_dict().items()}


def test_load_state_dict_and_pack_frontend_repack_in_place():
    enc = HubertEncoder(SERVED)
    held = enc.pos_conv_w
    ptr = held.data_ptr()
    sd = _drawn(enc, 1)
    enc.load_state_dict(sd)
    conv = enc.encoder.pos_conv_embed.conv
    assert enc.pos_conv_w is held and held.data_ptr() == ptr
    assert torch.equal(held, pc.pack_pos_conv_weights(sd["encoder.pos_conv_embed.conv.weight"]))
    with torch.no_grad():
        conv.weight.mul_(-0.5)
    assert not torch.equal(held, pc.pack_pos_conv_weights(conv.weight))
    enc.pack_frontend()
    assert enc.pos_conv_w is held and torch.equal(held, pc.pack_pos_conv_weights(conv.weight))


def test_encoder_route_is_the_module_route():
    """On the CPU the encoder's route gives the module's hidden states bit
    for bit, with and without a zero-padded batch's ``wav_len``."""
    enc = HubertEncoder(SERVED).eval()
    enc.load_state_dict(_drawn(enc, 2))
    wav = 0.3 * torch.randn(2, 4000, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        routed = [enc(wav), enc(wav, wav_len=[4000, 2500])]
        enc.pos_conv_kernel = False
        modules = [enc(wav), enc(wav, wav_len=[4000, 2500])]
    for got, want in zip(routed, modules):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_no_gradient_flows_through_the_route():
    torch.manual_seed(0)
    module = PositionalConvEmbedding(HubertConfig())
    w = pc.pack_pos_conv_weights(module.conv.weight)
    h = torch.randn(1, 20, 768)
    with pytest.raises(RuntimeError, match="no backward"):
        pc.positional_conv(h, w, module.conv.bias)  # the bias is a parameter
    with pytest.raises(RuntimeError, match="no backward"):
        pc.positional_conv(h.requires_grad_(), w, module.conv.bias.detach())
    with torch.no_grad():
        pc.positional_conv(h, w, module.conv.bias)
    enc = HubertEncoder(SERVED)
    with pytest.raises(RuntimeError, match="no backward"):
        enc(torch.randn(1, 4000))
    frozen = HubertEncoder(SERVED).requires_grad_(False)
    frozen(torch.randn(1, 4000))  # nothing requires a gradient: the route runs
