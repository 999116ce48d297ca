"""The command line's multi-rank training, on the CPU: two gloo ranks, each
running ``cli.main(["train", "--mesh", "2,1", ...])`` (and ``--pipeline 2``)
with torchrun's environment set, so that ``cli`` brings the process group
up through ``parallel.init_multihost``.  The final decoder it writes must
equal, bit for bit, the one ``train()`` writes on the same mesh from the
same config and corpus (a synthetic LJSpeech-layout corpus, a tiny decoder
and ``HubertConfig.tiny()``).

This file imports no JAX: the spawned ranks import it by name.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.parallel.launch import free_port, spawn
from edge_diffusion_tts_tpu_torch.weights import load_checkpoint

N_UTT = 12  # 11 training utterances and 1 validation utterance at val_frac 0.05


def _corpus(root: str) -> str:
    os.makedirs(os.path.join(root, "wavs"))
    rng = np.random.RandomState(1)
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        for i in range(N_UTT):
            n = int(22050 * (0.09 + 0.06 * rng.rand()))
            t = np.arange(n) / 22050
            w = 0.3 * np.sin(2 * np.pi * (110 + 9 * i) * t) + 0.02 * rng.randn(n)
            wavfile.write(os.path.join(root, "wavs", f"LJ{i:03d}.wav"), 22050,
                          (w * 32767).astype(np.int16))
            f.write(f"LJ{i:03d}|t|t\n")
    return root


def _cfg(tmp, tag: str) -> CFG:
    return CFG(hidden=32, layers=2, heads=2, segment_secs=0.1, batch_size=2, grad_accumulation=1,
               diff_steps=8, max_timestep=6, diffusion_epochs=1, progressive_epochs_per_halving=1,
               consistency_epochs=1, dropout=0.1, cfg_dropout=0.1, plot_every_steps=0,
               log_every_steps=1, val_every_steps=100, val_batches=1, ckpt_every_steps=100,
               num_workers=0, out_dir=os.path.join(str(tmp), tag), run_name="run", seed=5,
               ljspeech_dir=os.path.join(str(tmp), "LJSpeech-1.1"), data_root=str(tmp))


def cli_rank(rank: int, port: int, argv: list, train_cfg: dict) -> dict:
    """Tear down the spawner's group, set torchrun's environment, and train
    through ``cli.main``; then ``train()`` on the group the CLI brought up."""
    import importlib

    import torch.distributed as dist

    from edge_diffusion_tts_tpu_torch import cli
    from edge_diffusion_tts_tpu_torch.models import HubertConfig

    train_mod = importlib.import_module("edge_diffusion_tts_tpu_torch.training.train")
    torch.set_num_threads(1)
    dist.destroy_process_group()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")
    # Both runs take train()'s default HuBERT: the tiny stack here.
    train_mod.hubert_config_for = lambda hubert_id: HubertConfig.tiny()
    # The metric writer's TensorBoard mirror (best-effort, not under test)
    # would import TensorFlow where it is installed: ~10 s.
    sys.modules["torch.utils.tensorboard"] = None
    cli.main(argv)
    group = (dist.is_initialized(), dist.get_world_size(), dist.get_rank(), dist.get_backend())
    state = train_mod.train(CFG.from_dict(train_cfg), device="cpu")
    return {"group": group, "step": state.step,
            "params": {n: p.detach().clone() for n, p in state.optimizer.params.items()}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_multirank")
    _corpus(os.path.join(str(tmp), "LJSpeech-1.1"))
    return tmp


@pytest.mark.parametrize("flags,key", [(["--mesh", "2,1"], dict(mesh_shape=[2, 1])),
                                       (["--pipeline", "2"], dict(pipeline_stages=2))],
                         ids=["mesh", "pipeline"])
def test_cli_multirank_train_equals_train(corpus, flags, key):
    tag = flags[0].strip("-")
    cli_cfg = _cfg(corpus, f"{tag}_cli").to_dict()
    train_cfg = dict(_cfg(corpus, f"{tag}_train").to_dict(), **key)
    path = cli_cfg["out_dir"] + ".json"
    with open(path, "w") as f:
        json.dump(cli_cfg, f)
    argv = ["train", "--config", path, "--device", "cpu", *flags]
    r0, r1 = spawn(cli_rank, 2, args=(free_port(), argv, train_cfg), threads=1, timeout=120)
    assert r0["group"] == (True, 2, 0, "gloo") and r1["group"] == (True, 2, 1, "gloo")
    assert r0["step"] == r1["step"] > 0
    cli_final = load_checkpoint(os.path.join(cli_cfg["out_dir"], "run", "edge_model_final"))
    want = load_checkpoint(os.path.join(train_cfg["out_dir"], "run", "edge_model_final"))
    paths = ("out_dir", "ckpt_path")
    assert ({k: v for k, v in cli_final[0].to_dict().items() if k not in paths}
            == {k: v for k, v in want[0].to_dict().items() if k not in paths})
    assert cli_final[1].keys() == want[1].keys()
    for n, p in want[1].items():
        assert torch.equal(cli_final[1][n], p), n
        assert torch.isfinite(p).all(), n
    if tag == "mesh":  # data parallel: every rank holds the whole decoder
        for n, p in r0["params"].items():
            assert torch.equal(r1["params"][n], p), n
