"""``train()`` under a process group on the CPU: ``mesh_shape [2, 1]``
(data parallel) and ``pipeline_stages 2``, each on two gloo ranks, on a
tiny synthetic in-memory corpus (6 training batches of 2 wavs, one
validation batch): all three phases (one epoch each, one halving), then
``resume="auto"`` from the last periodic checkpoint (in the consistency
phase).  Checked: rank 0 alone writes checkpoints; the
final parameters are equal on every rank (the replicated ones, for the
pipeline); resume skips the completed phases and reruns the consistency
epoch; a pipeline run's checkpoints carry the packed layout and its final
model is canonical.
"""

import os

import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu_torch.parallel.launch import spawn
from edge_diffusion_tts_tpu_torch.training import restore_checkpoint
from edge_diffusion_tts_tpu_torch.weights import load_checkpoint

import test_torch_parallel_ranks as ranks

STEPS_PER_EPOCH = 6


def _batches(n, seed, samples):
    """``n`` batches of 2 synthetic wavs (sines plus noise) of ``samples``."""
    rng = np.random.RandomState(seed)
    t = np.arange(samples) / 16000
    out = []
    for i in range(n):
        f = 100 + 40 * rng.rand(2, 1)
        wav = 0.3 * np.sin(2 * np.pi * f * t) + 0.02 * rng.randn(2, samples)
        out.append({"wav": wav.astype(np.float32)})
    return out


def _cfg(tmp, **kw):
    d = dict(hidden=32, layers=2, heads=2, segment_secs=0.1, batch_size=2, grad_accumulation=2,
             diff_steps=8, max_timestep=6, diffusion_epochs=1, progressive_epochs_per_halving=1,
             consistency_epochs=1, dropout=0.1, cfg_dropout=0.1, plot_every_steps=0,
             log_every_steps=1, val_every_steps=3, val_batches=1, ckpt_every_steps=3,
             out_dir=str(tmp / "out"), run_name="run", seed=3)
    d.update(kw)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, kw in {"dp": dict(mesh_shape=[2, 1]), "pp": dict(pipeline_stages=2)}.items():
        cfg_kw = _cfg(tmp_path_factory.mktemp(name), **kw)
        samples = ranks.CFG(**cfg_kw).segment_len
        out[name] = spawn(ranks.train_rank, 2, args=(
            cfg_kw, _batches(STEPS_PER_EPOCH, 0, samples), _batches(1, 1, samples)),
            threads=1, timeout=300)
    return out


@pytest.mark.parametrize("name", ["dp", "pp"])
def test_rank0_alone_writes_checkpoints(runs, name):
    r0, r1 = runs[name]
    assert r1["writes"] == []
    assert {"checkpoint_latest", "best_diffusion", "checkpoint_phase1", "checkpoint_phase2",
            "checkpoint_final"} <= {w.removesuffix(".tmp") for w in r0["writes"]}
    run_dir = r0["run_dir"]
    for ckpt in ("checkpoint_phase1", "checkpoint_phase2", "checkpoint_final"):
        assert os.path.isfile(os.path.join(run_dir, ckpt, "state.pt"))


@pytest.mark.parametrize("name", ["dp", "pp"])
def test_phases_run_and_final_params_agree(runs, name):
    r0, r1 = runs[name]
    assert r0["tags"] == r1["tags"]
    assert [t for t, _ in r0["tags"]] == ["init", "diffusion", "prog4", "consistency"]
    assert r0["step"] == r1["step"] > 0
    shared = set(r0["params"]) & set(r1["params"])
    if name == "dp":
        assert shared == set(r0["params"])
    else:  # each stage holds its own block
        assert {n for n in r0["params"] if n.startswith("decoder.layers.")} != set()
    for n in shared - ({n for n in shared if n.startswith("decoder.layers.")}
                       if name == "pp" else set()):
        assert torch.equal(r0["params"][n], r1["params"][n]), n
        assert torch.isfinite(r0["params"][n]).all(), n


@pytest.mark.parametrize("name", ["dp", "pp"])
def test_resume_skips_completed_phases(runs, name):
    r0, r1 = runs[name]
    assert r0["step"] == 3 * STEPS_PER_EPOCH
    for r in runs[name]:
        assert r["resumed_step"] == r["step"] + STEPS_PER_EPOCH
    for n in set(r0["resumed_params"]) & set(r1["resumed_params"]):
        if name == "dp" or not n.startswith("decoder.layers."):
            assert torch.equal(r0["resumed_params"][n], r1["resumed_params"][n]), n


def test_pipeline_checkpoints_are_packed_and_final_model_canonical(runs):
    run_dir = runs["pp"][0]["run_dir"]
    d, cfg, meta = restore_checkpoint(os.path.join(run_dir, "checkpoint_final"))
    assert meta["phase_complete"] == "consistency"
    assert set(d["decoder"]) == {"pp_stack", "pp_rest"}
    assert d["decoder"]["pp_stack"]["attn.qkv.weight"].shape[0] == cfg.layers == 2
    cfg, dec_state, _, _ = load_checkpoint(os.path.join(run_dir, "edge_model_final"))
    assert {int(k.split(".")[1]) for k in dec_state if k.startswith("layers.")} == {0, 1}
    r0, r1 = runs["pp"]  # the resumed run wrote the final model last
    for stage, r in enumerate((r0, r1)):  # stage s holds block s
        for n, p in r["resumed_params"].items():
            if n.startswith("decoder.layers.0."):
                key = n[len("decoder."):].replace("layers.0.", f"layers.{stage}.", 1)
                assert torch.equal(dec_state[key], p), key
