"""The port's command line on the TFLite export, and the final-model readers.

- ``edge-tts-torch export CKPT --format tflite`` (with ``--t-frames``,
  ``--s-tokens`` and ``--quantize dynamic``) writes the bytes
  ``export_tflite`` writes for the checkpoint's decoder (``--quantize
  int8``: test_torch_tflite_int8.py), and ``--format stablehlo`` still
  exits naming ``--format pt2``.
- ``training.checkpoint.restore_final_model`` returns the state dicts a
  final model holds and its cfg; ``restore_hubert_config`` its HuBERT
  architecture, and ``HubertConfig()`` when ``hubert.json`` is absent.
"""

import os
import types

import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu_torch import cli
from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, HubertConfig, SemanticEncoder
from edge_diffusion_tts_tpu_torch.training import (
    restore_final_model, restore_hubert_config, save_final_model,
)
from edge_diffusion_tts_tpu_torch.utils import tflite_surgery as ts
from edge_diffusion_tts_tpu_torch.utils.export import export_tflite
from edge_diffusion_tts_tpu_torch.weights import save_checkpoint

SMALL = dict(hidden=32, layers=1, heads=2, dropout=0.0, attn_window_size=8,
             use_depthwise=True)
TINY_HUBERT = dict(num_layers=1, hidden_size=32, num_heads=2, intermediate_size=64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    torch.manual_seed(3)
    cfg = CFG(**SMALL)
    dec = EdgeDiffusionDecoder(cfg).eval()
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn_like(p))
    path = str(tmp_path_factory.mktemp("tflite_cli") / "ckpt")
    save_checkpoint(path, cfg, dec)
    return dict(path=path, cfg=cfg, dec=dec)


@pytest.mark.parametrize("flags,shape,mode", [
    ([], (1, 200, 100), ""),
    (["--t-frames", "24", "--s-tokens", "12", "--quantize", "dynamic"], (1, 24, 12), "dynamic"),
], ids=["float", "dynamic"])
def test_cli_export_tflite_writes_export_tflites_bytes(ckpt, tmp_path, flags, shape, mode):
    out = str(tmp_path / "cli.tflite")
    cli.main(["export", ckpt["path"], "--format", "tflite", "--out", out, "--device", "cpu"]
             + flags)
    want = str(tmp_path / "api.tflite")
    export_tflite(ckpt["cfg"], ckpt["dec"], want, *shape, quantize=mode)
    with open(out, "rb") as a, open(want, "rb") as b:
        got = a.read()
        assert got == b.read()
    sg = ts.read_model(got).subgraphs[0]
    assert [tuple(sg.tensors[i].shape) for i in sg.inputs] == [
        (1, shape[1], 80), (1,), (1, shape[2]), (1,)]
    assert any(t.type == ts.INT8 for t in sg.tensors) == (mode == "dynamic")


@pytest.mark.parametrize("argv,match", [
    (["--format", "stablehlo"], "--format pt2"),
    (["--format", "pt2", "--quantize", "dynamic"], "--format weight-int8"),
], ids=["stablehlo", "quantize_without_tflite"])
def test_cli_export_refusals(ckpt, tmp_path, argv, match):
    out = str(tmp_path / "never.tflite")
    with pytest.raises(SystemExit, match=match):
        cli.main(["export", ckpt["path"], "--out", out, "--device", "cpu"] + argv)
    assert not os.path.exists(out)


def test_restore_final_model_and_hubert_config(tmp_path):
    torch.manual_seed(4)
    cfg = CFG(**SMALL)
    hubert_cfg = HubertConfig(**TINY_HUBERT)
    dec, enc = EdgeDiffusionDecoder(cfg), SemanticEncoder(cfg, hubert_cfg)
    path = str(tmp_path / "edge_model_final")
    # save_final_model reads the train state's two modules only.
    save_final_model(path, types.SimpleNamespace(decoder=dec, encoder=enc), cfg)
    state, got_cfg = restore_final_model(path)
    assert got_cfg.to_dict() == cfg.to_dict()
    assert set(state) == {"decoder", "encoder"}
    for name, module in (("decoder", dec), ("encoder", enc)):
        want = module.state_dict()
        assert set(state[name]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(state[name][k].numpy(), v.numpy())
    assert restore_hubert_config(path) == hubert_cfg
    os.remove(os.path.join(path, "hubert.json"))
    assert restore_hubert_config(path) == HubertConfig()


def test_restore_final_model_without_an_encoder(ckpt):
    state, cfg = restore_final_model(ckpt["path"])
    assert set(state) == {"decoder"} and cfg.use_depthwise
    assert restore_hubert_config(ckpt["path"]) == HubertConfig()
