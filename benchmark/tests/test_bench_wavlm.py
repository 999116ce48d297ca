"""The WavLM-Large cell in whole CPU runs at a small size (the harness's look
for a chip skipped, the port on its plain paths): correct as built, and not
correct under its own limits where the timed path drops the gated
relative-position bias or holds every gate at 1; its control and the
reference's weights."""

from __future__ import annotations

import pytest

from benchmark.harness.runner import run_cell

from .test_bench_faults import MIX, SEED, TINY

CELL = "synth-audio-bf16.wavlm-large-bf16"
# WavLM's conv stack, norms and buckets at width 64 and 3 of its layers (the
# extraction at layer 2); float32 at this size, as the training cell's runs:
# bf16's rounding of a few short rows is not what the limits were set on,
# and the faults are the same
HUB = {"conv_dim": [128] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
       "conv_stride": [5, 2, 2, 2, 2, 2, 2], "hidden_size": 64, "num_layers": 3, "num_heads": 2,
       "intermediate_size": 128, "num_conv_pos_embeddings": 16,
       "num_conv_pos_embedding_groups": 4, "layer_norm_eps": 1e-5, "feat_extract_norm": "layer",
       "do_stable_layer_norm": True, "num_buckets": 320,
       "max_bucket_distance": 800}
SIZES = {"config": dict(TINY, hubert=HUB, hubert_layer=2, compute_dtype="float32"),
         "traffic": dict(MIX, rows=2)}


def run() -> dict:
    return run_cell(CELL, SEED, 0.5, False, "cpu", overrides=SIZES)


def test_an_unbroken_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("fault", ["bias_dropped", "gates_at_one"])
def test_a_broken_relative_position_path_is_not_correct(fault, monkeypatch):
    import torch

    from edge_diffusion_tts_tpu_torch.models import hubert

    if fault == "bias_dropped":  # the offset vector zeroed: no bias reaches a logit
        inner = hubert.TransformerEncoder.rel_values
        monkeypatch.setattr(hubert.TransformerEncoder, "rel_values",
                            lambda self, S, device: torch.zeros_like(inner(self, S, device)))
    else:
        monkeypatch.setattr(hubert, "relpos_gate",
                            lambda gp, const: torch.ones(gp.shape[:-1], device=gp.device))
    r = run()
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


def test_the_reference_reads_what_the_extraction_runs():
    from benchmark.reference import wavlm as rw

    shapes = rw.wavlm_shapes(HUB, 2)
    assert "hubert.encoder.layers.1.attention.gru_rel_pos_const" in shapes
    assert not any(k.startswith("hubert.encoder.layers.2.") for k in shapes)
    assert "hubert.encoder.layer_norm.weight" not in shapes
    assert "hubert.encoder.layer_norm.weight" in rw.wavlm_shapes(HUB, 3)


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
