"""The host side of the bf16 decoder step's kernels (csrc/gemm_wgmma.cuh,
csrc/attention16.cuh), on the CPU: the hooks' arguments are checked before
any library is built or any card is needed."""

import pytest
import torch

from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

BF16 = torch.bfloat16


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if anything reaches for the kernels' library."""
    def refuse():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(fd, "_lib", refuse)


@pytest.mark.parametrize("compute_dtype,tile", [(torch.float32, 0), (BF16, -1)])
def test_decoder_gemm_tile_is_a_bf16_index(no_library, compute_dtype, tile):
    a, w = torch.zeros(8, 16), torch.zeros(4, 16, dtype=compute_dtype)
    with pytest.raises(ValueError, match="tile"):
        fd.decoder_gemm(a, w, compute_dtype=compute_dtype, tile=tile)


def test_decoder_gemm_with_a_tile_still_refuses_cpu_tensors(no_library):
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fd.decoder_gemm(torch.zeros(8, 16), torch.zeros(4, 16, dtype=BF16), compute_dtype=BF16,
                        tile=4)


def test_kernel_kinds_and_rules_are_checked_before_the_library(no_library):
    assert set(fd.KERNEL_KINDS) == {"gemm_wgmma", "gemm16", "attention16", "relpos_attention16"}
    with pytest.raises(ValueError, match="kind"):
        fd.kernel_launches("gemm32")
    with pytest.raises(ValueError, match="rule"):
        fd.decoder_gemm16_tile(500, 160, rule="fastest")


@pytest.mark.parametrize("fma", [False, True])
def test_step_attention_refuses_cpu_tensors(no_library, fma):
    q = torch.zeros(1, 2, 16, 40, dtype=BF16)
    with pytest.raises(ValueError, match="CUDA"):
        fd.step_attention(q, q, q, 4, compute_dtype=BF16, fma=fma)


@pytest.mark.parametrize("tile,compute_dtype,fma", [("diagonal", BF16, False),
                                                    ("rows", torch.float32, False),
                                                    ("keys", BF16, True)])
def test_step_attention_refuses_a_tile_before_the_library(no_library, tile, compute_dtype,
                                                          fma):
    q = torch.zeros(1, 2, 16, 40, dtype=compute_dtype)
    with pytest.raises(ValueError, match="tile"):
        fd.step_attention(q, q, q, 4, compute_dtype=compute_dtype, fma=fma, tile=tile)


class _TileLibrary:
    """The two tile exports of the kernels' library, as fixed numbers."""

    @staticmethod
    def edt_attention16_tile_launches(out):
        out[0], out[1] = 3, 5
        return 2

    @staticmethod
    def edt_attention16_pick_tile(batch, heads, tq):
        return int(100 * batch * heads * ((tq + 63) // 64) >= 75 * 132)


def test_attention16_tile_counts_and_rule_by_name(monkeypatch):
    monkeypatch.setattr(fd, "_lib", _TileLibrary)
    assert set(fd.ATTENTION16_TILES) == {"keys", "rows"}
    assert fd.attention16_tile_launches() == {"keys": 3, "rows": 5}
    assert fd.attention16_tile(1, 4, 500) == "keys"
    assert fd.attention16_tile(64, 4, 1000) == "rows"
