"""The w2v-BERT 2.0 cell in whole CPU runs at a small size (the harness's look
for a chip skipped, the port on its plain paths): correct as built, and not
correct under its own limits where the timed path drops the relative-key
term, reverses its clamp window, pads the conv module's depthwise conv on
both sides or leaves the filterbank's pre-emphasis out; its control and the
reference's weights."""

from __future__ import annotations

import pytest

from benchmark.harness.runner import run_cell

from .test_bench_faults import MIX, SEED, TINY

CELL = "synth-audio-conformer-bf16.w2v-bert-2.0-bf16"
# w2v-BERT's filterbank, clamp window and conv kernel at width 64 and 3 of its
# layers (the extraction at layer 2); float32 at this size, as the WavLM
# cell's CPU runs: bf16's rounding of a few short rows is not what the
# limits were set on, and the faults are the same
HUB = {"hidden_size": 64, "num_layers": 3, "num_heads": 4, "intermediate_size": 128,
       "conv_depthwise_kernel_size": 31, "left_max_position_embeddings": 64,
       "right_max_position_embeddings": 8, "feature_projection_input_dim": 160,
       "layer_norm_eps": 1e-5, "num_mel_bins": 80, "stride": 2}
SIZES = {"config": dict(TINY, hubert=HUB, hubert_layer=2, compute_dtype="float32"),
         "traffic": dict(MIX, rows=2)}
FAULTS = ["relkey_dropped", "window_reversed", "conv_not_causal", "no_preemphasis"]


def run() -> dict:
    return run_cell(CELL, SEED, 0.5, False, "cpu", overrides=SIZES)


def test_an_unbroken_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def break_path(fault: str, monkeypatch) -> None:
    """Break the timed path's encoder as ``fault`` says."""
    import torch
    import torch.nn.functional as F

    from edge_diffusion_tts_tpu_torch.models import w2v_bert as wb
    from edge_diffusion_tts_tpu_torch.ops import relpos_attention as ra

    if fault in ("relkey_dropped", "window_reversed"):  # on either route: the plain or the kernel
        def table(E, left):
            if fault == "relkey_dropped":  # no position term reaches a logit
                return torch.zeros_like(E), left
            return E.flip(0), E.shape[0] - 1 - left  # offsets -8 .. 64

        plain, kernel = wb.relkey_attention, ra.relkey_attention16
        monkeypatch.setattr(wb, "relkey_attention", lambda y, E, left, key_mask=None:
                            plain(y, *table(E, left), key_mask))
        monkeypatch.setattr(ra, "relkey_attention16", lambda y, E, left:
                            kernel(y, *table(E, left)))
    elif fault == "conv_not_causal":  # the depthwise conv padded 15 and 15
        def forward(self, x, frame_mask=None):
            h = F.glu(self.pointwise_conv1(self.layer_norm(x)), dim=-1)
            k = self.depthwise_conv.kernel_size[0]
            h = self.depthwise_conv(F.pad(h.transpose(1, 2), (k // 2, k // 2))).transpose(1, 2)
            return self.pointwise_conv2(F.silu(self.depthwise_layer_norm(h)))

        monkeypatch.setattr(wb.ConvModule, "forward", forward)
    else:
        from edge_diffusion_tts_tpu_torch.ops import fbank

        monkeypatch.setattr(fbank, "PREEMPHASIS", 0.0)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_encoder_is_not_correct(fault, monkeypatch):
    break_path(fault, monkeypatch)
    r = run()
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


def test_the_reference_reads_what_the_extraction_runs():
    from benchmark.reference import w2v_bert as rw

    shapes = rw.w2v_bert_shapes(HUB, 2)
    assert shapes["hubert.encoder.layers.1.self_attn.distance_embedding.weight"] == (73, 16)
    assert shapes["hubert.encoder.layers.1.conv_module.depthwise_conv.weight"] == (64, 1, 31)
    assert not any(k.startswith("hubert.encoder.layers.2.") for k in shapes)
    assert rw.positions(16000) == 49 and rw.positions(160000) == 499


def test_the_control_is_not_correct_at_a_small_size():
    """The reference with fp8 operands (below the configuration's bf16) in
    the program's place, held to the cell's limits."""
    from .test_bench_control import SEEDS, control_run

    from benchmark.harness import compare

    for seed in SEEDS:
        run = control_run(CELL, seed, "cpu", sized=False)
        run.config.update(SIZES["config"])
        run.traffic.update(SIZES["traffic"])
        checks = compare.judge(run.driver.control(run, run.lower), run.limits_of)
        assert not all(c["ok"] for c in checks.values()), checks
