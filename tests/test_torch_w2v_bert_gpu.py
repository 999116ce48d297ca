"""w2v-BERT's relative-key attention kernel (csrc/relpos_attention16.cuh's
``relkey_attention16_kernel``) and the w2v-BERT encoder's bf16 route on the
card.

Every test here carries the ``gpu`` marker and skips without a CUDA device;
like ``test_torch_kernels_gpu.py`` this file imports neither JAX nor the JAX
package, so run it on the card as

    python -m pytest --noconftest -m gpu tests/test_torch_w2v_bert_gpu.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.models import (EdgeDiffusionDecoder, SemanticEncoder,
                                                 W2vBertConfig)
from edge_diffusion_tts_tpu_torch.models.w2v_bert import relkey_attention
from edge_diffusion_tts_tpu_torch.ops.relpos_attention import (relkey_attention16,
                                                               relkey_launches)
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEFT, ROWS = 64, 73  # the published clamp window: offsets -64 .. 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def packed_inputs(B, S, heads, device, seed=0, e_std=1.0):
    """A layer's packed q, k, v (unit variance, bf16) and a distance table of
    std ``e_std`` (the benchmark draws it at 1)."""
    g = torch.Generator(device=device).manual_seed(seed + S)
    y = torch.randn(B, S, 3 * heads * 64, generator=g, device=device).to(torch.bfloat16)
    E = (e_std * torch.randn(ROWS, 64, generator=g, device=device)).to(torch.bfloat16)
    return y, E


@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("S", [99, 346, 499])
def test_kernel_matches_the_plain_route_at_the_published_widths(cuda, S, B):
    """16 heads of 64: every output within 2^-7 of the plain route's largest
    (float32 logits and softmax, P rounded to bf16, o rounded to bf16: one
    bf16 rounding of the output and of P, in another summation order) and
    within 1% normwise; two calls bit-equal; no [B, heads, S, S] tensor
    allocated."""
    y, E = packed_inputs(B, S, 16, cuda)
    want = relkey_attention(y, E, LEFT).float()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = relkey_attention16(y, E, LEFT)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= got.numel() * 2 + (1 << 20)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, 1024)
    err = (got.float() - want).abs()
    assert float(err.max()) <= 2 ** -7 * max(1.0, float(want.abs().max())), float(err.max())
    assert float(err.norm() / want.norm()) <= 1e-2
    assert torch.equal(relkey_attention16(y, E, LEFT), got)


@pytest.mark.parametrize("S", [20, 64, 65, 200])
def test_kernel_at_short_and_ragged_lengths(cuda, S):
    """Lengths below the clamp window, at a tile's edge and past it: the
    same bars as above, at B = 2."""
    y, E = packed_inputs(2, S, 16, cuda, seed=3)
    want = relkey_attention(y, E, LEFT).float()
    got = relkey_attention16(y, E, LEFT).float()
    assert float((got - want).abs().max()) <= 2 ** -7 * max(1.0, float(want.abs().max()))
    assert float((got - want).norm() / want.norm()) <= 1e-2


def test_kernel_sees_the_position_term_and_its_window(cuda):
    """Dropping the position term or reversing the clamp window ([-8, 64])
    moves the output far past the kernel's own error."""
    y, E = packed_inputs(4, 200, 16, cuda, seed=1)
    got = relkey_attention16(y, E, LEFT).float()
    dropped = relkey_attention(y, torch.zeros_like(E), LEFT).float()
    reversed_ = relkey_attention(y, E.flip(0), ROWS - 1 - LEFT).float()
    assert float((got - dropped).norm() / got.norm()) > 0.05
    assert float((got - reversed_).norm() / got.norm()) > 0.05


def test_kernel_refuses_what_it_does_not_take(cuda):
    y, E = packed_inputs(2, 64, 16, cuda)
    with pytest.raises(ValueError):
        relkey_attention16(y.float(), E, LEFT)
    with pytest.raises(ValueError):
        relkey_attention16(y[..., :-64].contiguous(), E, LEFT)
    with pytest.raises(ValueError):
        relkey_attention16(y, torch.zeros(81, 64, device=cuda, dtype=torch.bfloat16), LEFT)
    with pytest.raises(ValueError):
        relkey_attention16(y, E, ROWS)


def w2v_bert_encoder(cfg, device):
    torch.manual_seed(0)
    with torch.device(device):
        enc = SemanticEncoder(cfg, W2vBertConfig(), dtype=torch.bfloat16)
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(0.02 * torch.randn_like(p))
    return enc.eval()


def test_seventeen_launches_a_call_and_the_masked_route(cuda):
    """w2v-BERT 2.0 to layer 17 at bf16: 17 layers built, 17 kernel launches
    an encode (``relkey_launches()``), none on a masked call (the plain
    route), whose first two layers agree with the kernel route's within
    2e-2 (bf16 roundings of the stream in two summation orders)."""
    cfg = CFG(hubert_id="facebook/w2v-bert-2.0", hubert_layer=17, compute_dtype="bfloat16")
    enc = w2v_bert_encoder(cfg, cuda)
    assert len(enc.hubert.encoder.layers) == 17
    wav = 0.1 * torch.randn(2, 48000, device=cuda)
    n0 = relkey_launches()
    with torch.no_grad():
        h = enc.extract_hubert(wav)
    torch.cuda.synchronize()
    assert relkey_launches() - n0 == 17 and torch.isfinite(h.float()).all()
    assert h.shape == (2, 149, 1024)
    full = torch.full((2,), 48000, device=cuda)
    with torch.no_grad():
        kern = enc.hubert.extract_layer(wav, 2)
        plain = enc.hubert.extract_layer(wav, 2, wav_len=full)  # a key mask: the plain route
    assert relkey_launches() - n0 == 19
    gap = float((kern.float() - plain.float()).norm() / plain.float().norm())
    assert gap <= 2e-2, gap


def test_generate_from_audio_launches_the_kernel_once_a_layer(cuda):
    """``EdgeInference(backend="fused").generate_from_audio`` at a bf16
    configuration naming w2v-BERT 2.0: 17 launches a call, a finite mel of
    two frames a token."""
    cfg = CFG(hubert_id="facebook/w2v-bert-2.0", hubert_layer=17, compute_dtype="bfloat16",
              use_v_prediction=True, use_depthwise=True)
    enc = w2v_bert_encoder(cfg, cuda)
    torch.manual_seed(1)
    with torch.device(cuda):
        dec = EdgeDiffusionDecoder(cfg, dtype=torch.bfloat16).eval()
    sched = DiffusionSchedule.create(cfg.diff_steps, cfg.beta_start, cfg.beta_end)
    engine = EdgeInference(cfg, sched, dec, prediction="v", backend="fused", device=cuda,
                           encoder=enc)
    wav = 0.1 * torch.randn(4, 40000, device=cuda)
    n0 = relkey_launches()
    mel = engine.generate_from_audio(wav, 4)
    torch.cuda.synchronize()
    assert relkey_launches() - n0 == 17
    assert mel.shape == (4, 2 * 124, cfg.n_mels) and torch.isfinite(mel).all()


def test_fbank_on_the_card_is_the_cpus(cuda):
    """The filterbank at float32 on the card against the same on the CPU,
    within 1e-3 of features of unit variance: cuFFT and the mel product (TF32
    off) in other summation orders, float32 FFT rounding relative to a
    frame's largest bin (2.2e-4 measured on an H100)."""
    from edge_diffusion_tts_tpu_torch.ops.fbank import fbank

    g = torch.Generator().manual_seed(5)
    wav = 0.1 * torch.randn(3, 35000, generator=g)
    lens = torch.tensor([35000, 20000, 9000])
    want = fbank(wav, wav_len=lens)
    got = fbank(wav.to(cuda), wav_len=lens.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-3


def test_kernel_bits_runs_every_case_twice_alike(cuda, tmp_path):
    """``tools/kernel_bits.py`` twice in fresh processes: every case
    fingerprints the same (the kernels are deterministic), both relative-
    position modes' cases among them.  Against an older checkout it is run
    as its note says (``--compare``)."""
    outs = []
    for i in range(2):
        path = tmp_path / f"bits{i}.json"
        r = subprocess.run([sys.executable, "tools/kernel_bits.py", str(path)], cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-3000:]
        outs.append(json.loads(path.read_text()))
    assert outs[0] == outs[1]
    assert any(k.startswith("relkey ") for k in outs[0])
    assert any(k.startswith("relpos ") for k in outs[0])

