"""The controls of ``correct`` come out as not correct: the reference, computed
in the precision below the configuration's (TF32 for float32, fp8 for
bfloat16), put in the program's place and held to the cell's own limits.

On the CPU at sizes a test run holds; marked ``gpu``, at the cell's own size
on the card (``python -m pytest -m gpu benchmark/tests``), where the same
readings set the limits (``python3 -m benchmark.calibrate``)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.calibrate import LOWER
from benchmark.harness import compare
from benchmark.harness.manifest import Manifest

from .test_bench_faults import SIZES

SEEDS = (2**31 + 501, 2**31 + 502, 2**31 + 503)


def control_run(cell: str, seed: int, device: str, sized: bool) -> SimpleNamespace:
    m = Manifest()
    w = m.cell(cell)
    config, traffic = m.config(w["config"]), m.traffic(w["traffic"])
    if sized:
        config.update(SIZES[cell].get("config", {}))
        traffic.update(SIZES[cell].get("traffic", {}))
    return SimpleNamespace(config=config, traffic=traffic, seed=seed, device=device, limits={},
                           driver=m.driver(traffic["driver"]), limits_of=m.limits(cell),
                           lower=LOWER[m.config(w["config"])["compute_dtype"]])


def fails(cell: str, seed: int, device: str, sized: bool) -> dict:
    run = control_run(cell, seed, device, sized)
    checks = compare.judge(run.driver.control(run, run.lower), run.limits_of)
    assert not all(c["ok"] for c in checks.values()), checks
    return checks


@pytest.mark.parametrize("cell", ["synth-tokens.flagship", "synth-tokens.large-batch-bf16",
                                  "synth-audio.flagship", "train.large-batch-bf16"])
def test_the_control_is_not_correct_at_a_small_size(cell):
    # the training cell runs float32 at this size (test_bench_faults.SIZES); its
    # control is the configuration's: fp8 below bfloat16
    for seed in SEEDS:
        fails(cell, seed, "cpu", sized=True)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["synth-tokens.flagship", "synth-tokens.large-batch-bf16",
                                  "synth-audio.flagship", "train.large-batch-bf16"])
def test_the_control_is_not_correct_at_the_cells_size_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's own size")
    for seed in SEEDS:
        fails(cell, seed, "cuda", sized=False)
