"""The operation and byte counts against values derived by hand at tiny shapes."""

from __future__ import annotations

import pytest

from benchmark.counts import decoder, frontend, hubert, least_s, peaks

TINY = dict(hidden=8, n_mels=4, layers=1, heads=2, ffn_mult=2, attn_window_size=1,
            use_depthwise=False)


def test_band_pairs_by_hand():
    # T = 4, window 1: rows see 2, 3, 3, 2 keys
    assert decoder.band_pairs(4, 1) == 10
    assert decoder.band_pairs(3, 5) == 9
    assert decoder.band_pairs(1, 64) == 1


def test_decoder_forward_products_by_hand():
    # H 8, M 4, F 16, L 1, heads 2 (dh 4); B 1, T 4, S 2.
    # per row: in+out 4*4*8 = 128; qkv 2*8*24 = 384; proj, cq, co 6*64 = 384;
    # fc1 4*8*16 = 512; fc2 2*16*8 = 256 -> 1664; x T = 6656.
    # attention: 2 heads * 4 * dh 4 * (10 band pairs + 4*2 cross) = 576.
    assert decoder.forward_products(TINY, 1, 4, 2) == 6656 + 576
    pre = dict(TINY, use_depthwise=True)
    assert decoder.forward_products(pre, 1, 4, 2) == 6656 + 576 + 4 * 2 * 64
    assert decoder.forward_f32(pre, 2, 4) == 2 * 4 * 16 * 8
    assert decoder.forward_f32(TINY, 2, 4) == 0


def test_context_and_loop_bytes_by_hand():
    # kv_down 8 -> 4: 2*8*4 = 64; kv_up 4 -> 16: 2*4*16 = 128; per position 192
    assert decoder.context_products(TINY, 2, 3) == 2 * 3 * 192
    # products' weights: in 32 + qkv 192 + proj/cq/co 192 + fc1 256 + fc2 128 + out 32 = 832
    # float32 vectors: in_b 8, n2w 8, proj_b 8, fc1_b 32, fc2_b 8, fn 16, out_b 4 = 84
    # tables: pos T*H = 32, mods steps*L*4*H = 64, coef 8; ckv L*B*S*2H = 32 elements
    # x_T in, x0 out: 2 * 4 * B*T*M = 128 bytes
    f32 = 4 * (84 + 32 + 64 + 8)
    assert decoder.loop_bytes(TINY, 1, 4, 2, 2, 4) == 832 * 4 + f32 + 32 * 4 + 128
    assert decoder.loop_bytes(TINY, 1, 4, 2, 2, 2) == 832 * 2 + f32 + 32 * 2 + 128
    n = decoder.loop(TINY, 1, 4, 2, 2, "bfloat16")
    assert n["products"] == 2 * (6656 + 576) and n["f32"] == 0


def test_frontend_counts_by_hand():
    # 400 samples: frames 79, 39, 19, 9, 4, 2, 1
    assert frontend.frames(400) == [79, 39, 19, 9, 4, 2, 1]
    n = frontend.conv_stack(1, 400, C=4)
    assert n["conv0"] == 2 * 79 * 4 * 10
    assert n["rest"] == 2 * 4 * 4 * (3 * (39 + 19 + 9 + 4) + 2 * (2 + 1))
    weights = 4 * 10 * 4 + 16 * (3 * 4 + 2 * 2) * 4 + 2 * 4 * 4
    assert n["bytes"] == 4 * 400 + weights + 4 * 1 * 4
    assert frontend.conv_stack(1, 400, C=4, compute="bfloat16")["bytes"] == \
        4 * 400 + 4 * 10 * 4 + 16 * 16 * 2 + 2 * 4 * 4 + 16


def test_hubert_products_by_hand():
    h = dict(hidden_size=4, intermediate_size=8, conv_dim=[2], num_conv_pos_embeddings=2,
             num_conv_pos_embedding_groups=2, num_layers=3)
    cfg = dict(hubert_layer=1, semantic_dim=2, fsq_levels=[2, 2])
    # per frame: proj 2*2*4 = 16; pos conv 2*4*2*2 = 32; one layer: 8*16 + 4*4*8 + 4*S*4
    # with S = 3: 128 + 128 + 48 = 304; projection 2*4*2 + 2*2*2 + 4*2*2 = 40
    assert hubert.encoder_products(h, cfg, 1, 3) == 3 * (16 + 32 + 304 + 40)


def test_least_time_takes_the_largest_of_its_three_bounds():
    p = peaks()
    f32, bf16, bw = p["flops_per_s"]["float32"], p["flops_per_s"]["bfloat16"], p["hbm_bytes_per_s"]
    assert least_s(1e12, "bfloat16", 0) == pytest.approx(1e12 / bf16)
    assert least_s(1e12, "bfloat16", 0, f32=1e12) == pytest.approx(1e12 / f32)
    assert least_s(0, "float32", 1e12) == pytest.approx(1e12 / bw)
    assert (f32, bf16, bw) == (67e12, 989e12, 3.35e12)
