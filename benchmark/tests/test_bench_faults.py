"""Whole runs on the CPU (the harness's look for a chip skipped, the port on
its plain paths, small sizes) with the timed path broken underneath: each
fault a cell can have comes out as not correct under the cell's own limits,
where the same run unbroken comes out correct."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import traffic
from benchmark.harness.manifest import Manifest
from benchmark.harness.runner import run_cell

TINY = {"hidden": 32, "layers": 1, "heads": 2, "attn_window_size": 8}
HUB = {"conv_dim": [128] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
       "conv_stride": [5, 2, 2, 2, 2, 2, 2], "hidden_size": 32, "num_layers": 2, "num_heads": 2,
       "intermediate_size": 64, "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4}
# utterances of 0.3-1.0 s in two buckets (0.5 s and 1 s), a block of 4 calls
MIX = {"durations": {"min_s": 0.3, "mean_s": 0.7, "max_s": 1.0}, "bucket_s": [0.5, 1.0],
       "block": 4}
SIZES = {
    "synth-tokens.flagship": {"config": TINY, "traffic": dict(MIX, rows=4)},
    "synth-tokens.large-batch-bf16": {"config": TINY, "traffic": dict(MIX, rows=4)},
    "synth-audio.flagship": {"config": dict(TINY, hubert=HUB), "traffic": dict(MIX, rows=2)},
    # float32 at this size: bf16's rounding does not average out over four
    # rows of 0.4 s as it does over 256 rows of 2 s; the faults are the same
    "train.large-batch-bf16": {"config": dict(TINY, hubert=HUB, batch_size=4,
                                              segment_len=6400, compute_dtype="float32")},
}
SEED = 2**31 + 77


def run(cell: str, seconds: float = 0.5, traffic: dict = None) -> dict:
    sizes = dict(SIZES[cell], traffic=dict(SIZES[cell].get("traffic", {}), **(traffic or {})))
    return run_cell(cell, SEED, seconds, False, "cpu", overrides=sizes)


def loop_fault(monkeypatch, kind: str):
    """Break the fused DDIM loop (what every synthesis entry launches)."""
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    inner = fd.fused_ddim

    def broken(x_T, pos, mods, ckv, coef, w, **kw):
        if kind == "step_unchanged":  # the last step returns its state unchanged
            return inner(x_T, pos, mods[:-1], ckv, coef[:-1], w, **kw)
        out = inner(x_T, pos, mods, ckv, coef, w, **kw)
        if kind == "half_batch":  # half the rows never computed: others' answers instead
            half = out.shape[0] // 2
            out[half:] = out[:out.shape[0] - half]
        elif kind == "answer_altered":  # one mel frame of one row altered
            out[0, out.shape[1] // 2] += 0.5
        return out

    monkeypatch.setattr(fd, "fused_ddim", broken)


SYNTH = ["synth-tokens.flagship", "synth-tokens.large-batch-bf16", "synth-audio.flagship"]


@pytest.mark.parametrize("cell", SYNTH + ["train.large-batch-bf16"])
def test_an_unbroken_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell", SYNTH)
def test_the_window_runs_on_to_every_checked_call(cell):
    r = run(cell, seconds=0.0)
    last = max(traffic.checked(dict(Manifest().traffic(cell.split(".")[0]),
                                    **SIZES[cell]["traffic"]), SEED))
    assert r["correct"], r["checks"]
    assert r["attempted"] == last + 1


@pytest.mark.parametrize("cell", SYNTH)
def test_a_checked_call_never_made_is_not_correct(cell):
    # the plan ends after its first call: the other checked calls are never made
    r = run(cell, traffic={"plan_calls": 1})
    assert r["attempted"] == 1
    assert not r["correct"] and r["failed"] > 0, r["checks"]
    assert all(c["value"] == float("inf") for c in r["checks"].values()), r["checks"]


@pytest.mark.parametrize("kind", ["step_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", SYNTH)
def test_a_broken_loop_is_not_correct(cell, kind, monkeypatch):
    loop_fault(monkeypatch, kind)
    r = run(cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


def test_an_altered_token_is_not_correct(monkeypatch):
    from edge_diffusion_tts_tpu_torch import inference

    inner = inference.fast_encode

    def broken(*a, **k):
        tokens = inner(*a, **k).clone()
        tokens[0, tokens.shape[1] // 2] = (tokens[0, tokens.shape[1] // 2] + 1) % 2304
        return tokens

    monkeypatch.setattr(inference, "fast_encode", broken)
    r = run("synth-audio.flagship")
    assert not r["correct"] and r["checks"]["token_margin"]["value"] > \
        r["checks"]["token_margin"]["limit"], r["checks"]


@pytest.mark.parametrize("kind", ["step_unchanged", "half_batch", "answer_altered"])
def test_a_broken_training_step_is_not_correct(kind, monkeypatch):
    from edge_diffusion_tts_tpu_torch.training import state as st, steps

    if kind == "step_unchanged":  # the optimizer leaves the parameters as they were
        monkeypatch.setattr(st.Optimizer, "update", lambda self, grads: True)
    elif kind == "half_batch":  # the loss's mean over the first half of the rows alone
        inner = steps.Trainer.make_diffusion_loss

        def half(self, *a, **k):
            loss_fn = inner(self, *a, **k)
            return lambda state, batch, g: loss_fn(
                state, {n: v[:v.shape[0] // 2] for n, v in batch.items()}, g)

        monkeypatch.setattr(steps.Trainer, "make_diffusion_loss", half)
    else:  # one leaf's gradient lost where it is produced
        inner = st.Optimizer.update

        def lose_one(self, grads):
            first = next(iter(grads))
            return inner(self, dict(grads, **{first: torch.zeros_like(grads[first])}))

        monkeypatch.setattr(st.Optimizer, "update", lose_one)
    r = run("train.large-batch-bf16")
    assert not r["correct"], r["checks"]
