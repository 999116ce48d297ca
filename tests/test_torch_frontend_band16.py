"""The arithmetic of the bf16 frontend's wgmma route and of the bf16 band
kernel, held against the JAX package on the CPU, and their host side.

The CUDA kernels (csrc/conv_wgmma.cuh, csrc/band16.cuh) run only on the
card, where tests/test_torch_kernels_gpu.py holds them against their plain
versions.  Here:

* a float32 torch emulation of a conv layer as the TPU kernel writes it,
  even @ W0 + odd @ W1 (+ shift(even) @ W2), bf16 operands and float32
  sums, chained with GELU and a bf16 round per layer, against JAX's
  ``fused_conv_frontend(..., compute_dtype=bfloat16, interpret=True)`` at a
  short wav, within ``chip_smoke.py`` phase 6b's bars (1e-2 normwise, and the
  witness rule against JAX's float32 kernel);
* a torch emulation of the band kernel's products, P split as P_hi +
  P_lo with P_hi = bf16(P), P_lo = bf16(P - P_hi) and both against bf16 V,
  against JAX's ``banded_attention`` in interpret mode on bf16 inputs,
  within the card test's bar (2e-5 + one bf16 ulp of the output), and the
  P-rounded mutant (bf16(P) alone, the decoder step's attention16.cuh)
  shown outside it on the same inputs;
* the host side with the kernels' libraries refused: the bf16 plan and its
  tile rule, the workspace, the band plan's bf16 geometry, the refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.ops import fused_frontend as jff
from edge_diffusion_tts_tpu.ops.window_attention import banded_attention as j_band
from edge_diffusion_tts_tpu_torch.models.hubert import FeatureExtractor, HubertConfig
from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
from edge_diffusion_tts_tpu_torch.ops import window_attention as wa

BF16 = torch.bfloat16


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- the frontend ------------------------------------------------------------------


def parity_layer(x: torch.Tensor, W: torch.Tensor, taps: int) -> torch.Tensor:
    """A stride-2 conv of ``taps`` taps over x [B, Tin, C] with the packed W
    [C, taps * C], as the TPU kernel's ``_conv_k3s2`` / ``_conv_k2s2`` write
    it: x's even and odd frames times the taps' weights, bf16 operands
    (their products exact in float32), float32 sums; [B, M, C] float32."""
    C, M = x.shape[-1], (x.shape[1] - taps) // 2 + 1
    xb, w = x.to(BF16).float(), W.to(BF16).float().reshape(C, taps, C)
    even, odd = xb[:, 0::2], xb[:, 1::2]
    y = even[:, :M] @ w[:, 0].T + odd[:, :M] @ w[:, 1].T
    if taps == 3:
        y = y + even[:, 1:M + 1] @ w[:, 2].T
    return y


def emulate_frontend(wav: torch.Tensor, w: dict) -> torch.Tensor:
    """conv0 as the bf16 kernel computes it (float32, rounded to bf16),
    then ``parity_layer`` with GELU in float32 and a bf16 round per layer,
    conv6 left float32."""
    fold = ff.groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"])
    x = ff.conv_frontend_layer_plain(wav, 0, w, *fold, compute_dtype=BF16)
    for layer in range(1, ff.LAYERS):
        y = F.gelu(parity_layer(x, ff.layer_weight(w, layer), ff.BASE_KERNELS[layer]))
        x = y.to(BF16) if layer < ff.LAYERS - 1 else y
    return x


@pytest.fixture(scope="module")
def extractor():
    torch.manual_seed(5)
    fe = FeatureExtractor(HubertConfig()).eval()
    params = {f"conv_{i}": {"kernel": jnp.asarray(layer.conv.weight.detach().numpy()
                                                  .transpose(2, 1, 0))}
              for i, layer in enumerate(fe.conv_layers)}
    gn = fe.conv_layers[0].layer_norm
    params["group_norm"] = {"scale": jnp.asarray(gn.weight.detach().numpy()),
                            "bias": jnp.asarray(gn.bias.detach().numpy())}
    return fe, params


@pytest.mark.parametrize("samples", [4000, 4321])
def test_parity_split_frontend_matches_jax_kernel(extractor, samples):
    """The emulation at [1, samples] (an even and an odd conv0 frame count)
    against JAX's interpreted kernel at bf16: within 1e-2 normwise, and by
    the witness rule against its float32 run; the port's plain version
    stands beside it within the same bar."""
    fe, params = extractor
    wav = (0.2 * np.random.RandomState(samples).randn(1, samples)).astype(np.float32)
    want = np.asarray(jff.fused_conv_frontend(JHC(), params, jnp.asarray(wav), interpret=True,
                                              compute_dtype=jnp.bfloat16))
    want32 = np.asarray(jff.fused_conv_frontend(JHC(), params, jnp.asarray(wav), interpret=True,
                                                compute_dtype=jnp.float32))
    w = ff.pack_frontend_weights(fe, BF16)
    got = emulate_frontend(torch.from_numpy(wav), w).numpy()
    assert got.shape == want.shape == (1, ff.frame_counts(samples)[-1], 512)
    e_k, e_j = rel(got, want32), rel(want, want32)
    print(f"[{samples}] emulation vs JAX bf16 {rel(got, want):.4g}; from JAX float32: emulation "
          f"{e_k:.4g}, JAX bf16 {e_j:.4g}")
    assert rel(got, want) <= 1e-2
    assert e_k <= 1.5 * e_j + 1e-3, (e_k, e_j)
    plain = ff.conv_frontend_plain(torch.from_numpy(wav), w, compute_dtype=BF16).numpy()
    assert rel(got, plain) <= 1e-2


def test_parity_split_layer_is_the_plain_layer_up_to_sum_order():
    """Per layer, on the same bf16 input: the even/odd decomposition and
    ``F.conv1d`` over the same bf16 values differ only in the order of
    float32 sums (1e-6 normwise before the round), at odd and even Tin."""
    torch.manual_seed(1)
    for taps, Tin in ((3, 101), (3, 100), (2, 51), (2, 50)):
        x = torch.randn(2, Tin, 64).to(BF16)
        W = (0.1 * torch.randn(64, taps * 64)).to(BF16)
        got = parity_layer(x, W, taps)
        want = F.conv1d(x.float().transpose(1, 2), W.float().reshape(64, taps, 64).permute(0, 2, 1),
                        stride=2).transpose(1, 2)
        assert got.shape == want.shape
        assert rel(got.numpy(), want.numpy()) <= 1e-6


# -- the band kernel ------------------------------------------------------------------


def emulate_band(q, k, v, window: int, p_mode: str = "split") -> torch.Tensor:
    """The bf16 band kernel's arithmetic in float32 on bf16 q, k, v [B, H,
    T, d]: S = q k^T d^-0.5, the band's softmax with P = exp(S - max) over
    the row's sum; P V with P as P_hi + P_lo (``p_mode`` "split", the
    kernel) or as bf16(P) alone ("rounded", the mutant); out in bf16."""
    T, d = q.shape[-2:]
    i = torch.arange(T)
    mask = (i[None, :] - i[:, None]).abs() <= window
    s = ((q.float() @ k.float().transpose(-1, -2)) * d ** -0.5).masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.to(BF16).float()
    o = hi @ v.float()
    if p_mode == "split":
        o = o + (p - hi).to(BF16).float() @ v.float()
    return (o / p.sum(-1, keepdim=True)).to(BF16)


def band_inputs(case: str, T: int, d: int, seed: int):
    """bf16 q, k, v [1, 2, T, d]: "randn" (the card tests' inputs), or
    "flat", where rounding P shows: q small (every weight near the row's
    max, none a power of two) and V of magnitude 8 with alternating sign
    (an output much smaller than V, so its ulp is)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(1, 2, T, d).astype(np.float32) for _ in range(3))
    if case == "flat":
        q *= 0.1
        v = 8.0 * np.where(np.arange(T) % 2, -1.0, 1.0)[:, None] * (1 + 0.05 * v)
    return [torch.from_numpy(t.astype(np.float32)).to(BF16) for t in (q, k, v)]


def bf16_band_over(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    """|got - want| less the card test's bar, 2e-5 + one bf16 ulp of the
    larger of the two (``_bf16_band_close``): > 0 where the bar is broken."""
    g = got.float().numpy()
    m = np.maximum(np.abs(g), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
    return np.abs(g - want) - (2e-5 + ulp)


BAND_CASES = [("randn", 300, 40, 64), ("randn", 200, 16, 5), ("randn", 96, 32, 0),
              ("flat", 300, 40, 64), ("flat", 256, 64, 100)]


@pytest.fixture(scope="module")
def band_jax():
    cache = {}

    def get(case, T, d, window):
        key = (case, T, d, window)
        if key not in cache:
            q, k, v = band_inputs(case, T, d, T + d)
            cache[key] = np.asarray(j_band(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                             for t in (q, k, v)), window, interpret=True),
                                    np.float32)
        return cache[key]

    return get


@pytest.mark.parametrize("case,T,d,window", BAND_CASES)
def test_split_p_band_matches_jax_kernel(band_jax, case, T, d, window):
    q, k, v = band_inputs(case, T, d, T + d)
    over = bf16_band_over(emulate_band(q, k, v, window), band_jax(case, T, d, window))
    assert over.max() <= 0, f"{case}: over the bar by {over.max():.3g}"


@pytest.mark.parametrize("case,T,d,window", [c for c in BAND_CASES if c[0] == "flat"])
def test_p_rounded_band_is_outside_the_bar(band_jax, case, T, d, window):
    """The mutant that rounds P to bf16 breaks the bar on the inputs where
    the split-P emulation keeps it (the test above)."""
    q, k, v = band_inputs(case, T, d, T + d)
    over = bf16_band_over(emulate_band(q, k, v, window, "rounded"), band_jax(case, T, d, window))
    assert (over > 0).mean() > 0.01, f"{case}: {(over > 0).mean():.3g} of elements over the bar"


# -- the host side, with the libraries refused ----------------------------------------


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if anything reaches for a kernel library."""
    def refuse():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(ff, "_lib", refuse)
    monkeypatch.setattr(wa, "_lib", refuse)


# (B, samples) -> each conv1-6 layer's tile index on a 132-SM card
PLAN_TILES = {(256, 32000): [1, 1, 1, 1, 1, 1], (1, 80000): [1, 2, 2, 0, 0, 0],
              (4, 32000): [1, 2, 2, 2, 0, 0], (2, 32000): [2, 2, 0, 0, 0, 0],
              (1, 8000): [0, 0, 0, 0, 0, 0]}


@pytest.mark.parametrize("B,samples", list(PLAN_TILES))
def test_bf16_plan_tiles_splits_and_workspace(no_library, B, samples):
    plan = ff.frontend_plan(B, samples, sms=132, dtype=BF16)
    assert [p["tile_index"] for p in plan[1:]] == PLAN_TILES[(B, samples)]
    frames = ff.frame_counts(samples)
    assert plan[0]["tile"] == (ff.CONV0_ROWS_BF16, 512)
    chunks = -(-frames[0] // ff.CONV0_ROWS_BF16)
    assert plan[0]["blocks"] == B * min(chunks, -(-ff.CONV0_BLOCKS_BF16 // B))
    for p in plan[1:]:
        t = ff.FRONTEND_BF16_TILES[p["tile_index"]]
        tiles = B * -(-p["M"] // t["rows"]) * (512 // t["cols"])
        assert p["tile"] == (t["rows"], t["cols"]) and p["M"] == frames[p["layer"]]
        if t["kernel"] == "wgmma":  # a persistent grid, no split-K
            assert p["splits"] == 1 and p["blocks"] == min(tiles, 132)
            assert tiles >= t["fill"] * 132
        else:
            assert p["blocks"] == tiles * p["splits"]
            assert p["blocks"] <= 132 or p["splits"] == 1
            assert 1 <= p["splits"] <= 512 // ff.CHUNK_BF16
    partials = max([p["splits"] * p["M"] for p in plan[1:] if p["splits"] > 1] or [0])
    assert ff.frontend_workspace(B, plan, BF16) == \
        B * 512 * (frames[0] + frames[1]) // 2 + B * 512 * partials


def test_frontend_tile_rule(no_library):
    """The 256-channel wgmma tile where its tiles fill 0.9 of a wave, else
    the 128-channel one where they fill 0.45, else the mma.sync tile; a
    width that 256 does not divide skips the wider tile."""
    assert ff.frontend_tile(256, 3199) == 1
    assert ff.frontend_tile(256, 99) == 1    # 512 tiles: 3.9 waves
    assert ff.frontend_tile(1, 7999) == 1    # 126 tiles of 256 fill 0.95 of 132
    assert ff.frontend_tile(1, 3999) == 2    # 64 of 256 do not; 128 of 128 do
    assert ff.frontend_tile(1, 1999) == 2    # 64 of 128: 0.48 of a wave
    assert ff.frontend_tile(1, 999) == 0     # 32: split-K on mma.sync
    assert ff.frontend_tile(256, 99, C=384) == 2
    assert ff.frontend_tile(1, 7999, sms=114) == 1
    assert ff.frontend_tile(1, 7999, sms=300) == 2
    assert ff.frontend_tile(1, 7999, sms=1000) == 0


def test_float32_plan_is_unchanged(no_library):
    for B, samples in ((1, 80000), (256, 32000), (3, 4321)):
        plan = ff.frontend_plan(B, samples)
        assert all("tile_index" not in p for p in plan)
        assert [p["tile"] for p in plan] == [(ff.CONV0_ROWS, 512)] + [ff.TILE] * 6


def test_layer_tile_refusals(no_library):
    """``conv_frontend_layer``'s tile argument is checked before any launch:
    a bf16 conv1-6 index in range, splits only in the mma.sync tile; the
    hook refuses CPU tensors before it reaches the library."""
    lt = ff._layer_tile
    assert lt(None, None, True, 1, 256, 3199, 512, 132) == 1
    assert lt(None, 4, True, 1, 256, 3199, 512, 132) == 0  # splits given: the mma.sync tile
    assert lt(None, None, False, 1, 256, 3199, 512, 132) == 0
    assert lt(2, None, True, 3, 1, 10, 512, 132) == 2
    assert lt(None, None, True, 4, 1, 999, 512, 132) == 0
    with pytest.raises(ValueError, match="bf16 variant"):
        lt(1, None, False, 1, 1, 100, 512, 132)
    with pytest.raises(ValueError, match="bf16 variant"):
        lt(1, None, True, 0, 1, 100, 512, 132)
    with pytest.raises(ValueError, match="tile must be"):
        lt(3, None, True, 1, 1, 100, 512, 132)
    with pytest.raises(ValueError, match="multiple of 256"):
        lt(1, None, True, 1, 1, 100, 384, 132)
    w = {"w0": torch.zeros(512, 10), "wk3": torch.zeros(4, 512, 1536, dtype=BF16),
         "wk2": torch.zeros(2, 512, 1024, dtype=BF16)}
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ff.conv_frontend_layer(torch.zeros(1, 100, 512, dtype=BF16), 1, w, compute_dtype=BF16,
                               tile=1)


@pytest.mark.parametrize("d", range(4, wa.MAX_HEAD_DIM + 1, 4))
def test_band_plan_bf16_geometry(no_library, d):
    """The bf16 kernel's plan: 64-key chunks in a ring of 3, Q and the ring
    in bf16 rows of d padded to 16 plus 8 (an odd number of 16-byte
    units), no P tile; float32's plan as before."""
    for rows in wa.BAND_ROWS:
        r = -(-d // 16) * 16 + 8
        assert r // 8 % 2 == 1
        assert wa.band_smem_bytes(rows, d, BF16) == 2 * r * (rows + 2 * 3 * 64)
        r32 = -(-d // 8) * 8 + 4
        assert wa.band_smem_bytes(rows, d) == 4 * (rows * r32 + 2 * 3 * 32 * r32) + 4 * rows * 40
    plan = wa.band_plan(1, 4, 4000, d, 64, dtype=BF16)
    assert (plan["keys"], plan["stages"]) == (wa.BAND_KEYS_BF16, wa.BAND_STAGES_BF16) == (64, 3)
    assert plan["smem"] == wa.band_smem_bytes(plan["rows"], d, BF16)
    assert plan["threads"] == plan["rows"] // 16 * 32
    assert wa.band_plan(1, 4, 4000, d, 64)["keys"] == wa.BAND_KEYS == 32
