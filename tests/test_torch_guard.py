"""Guards of the port: it imports no JAX, and its entry points never fall back
to the CPU on their own."""

import ast
import os

import jax  # noqa: F401  (imported like the other port tests; unused here)
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder
from edge_diffusion_tts_tpu_torch.ops.fused_denoise import FusedEdgeInference
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

ROOT = os.path.join(os.path.dirname(__file__), "..")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "edge_diffusion_tts_tpu")


def _port_files():
    pkg = os.path.join(ROOT, "edge_diffusion_tts_tpu_torch")
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py", "port_profile.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10
    bad = [
        (os.path.relpath(f, ROOT), m)
        for f in files
        for m in _imported_modules(f)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"the port imports JAX or the JAX package: {bad}"


def test_entry_points_need_a_card_unless_told_cpu():
    cfg = CFG(hidden=32, layers=1, heads=2, dropout=0.0)
    dec = EdgeDiffusionDecoder(cfg)
    sched = DiffusionSchedule.create(1000)
    if torch.cuda.is_available():
        assert EdgeInference(cfg, sched, dec).device.type == "cuda"
        assert FusedEdgeInference(cfg, sched, dec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            EdgeInference(cfg, sched, dec)
        with pytest.raises(RuntimeError, match="CUDA"):
            FusedEdgeInference(cfg, sched, dec, device=None)
    mel = EdgeInference(cfg, sched, dec, device="cpu").generate_mel(
        np.zeros((1, 4), np.int64), num_steps=1)
    assert mel.device.type == "cpu" and mel.shape == (1, 8, 80)


def test_wrappers_refuse_other_devices():
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa

    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wa.banded_attention(q, q, q, 2)


def test_audio_and_ddpm_entry_points_need_a_card_unless_told_cpu():
    from edge_diffusion_tts_tpu_torch.models import HubertConfig, SemanticEncoder

    cfg = CFG(hidden=32, layers=1, heads=2, dropout=0.0)
    dec = EdgeDiffusionDecoder(cfg)
    # The hubert-base conv stack (the frontend kernel's) under a small transformer.
    enc = SemanticEncoder(cfg, HubertConfig(num_layers=1, hidden_size=32, num_heads=2,
                                            intermediate_size=64))
    sched = DiffusionSchedule.create(4)
    if torch.cuda.is_available():
        assert EdgeInference(cfg, sched, dec, encoder=enc).encoder is not None
        assert FusedEdgeInference(cfg, sched, dec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            EdgeInference(cfg, sched, dec, encoder=enc)
        with pytest.raises(RuntimeError, match="CUDA"):
            FusedEdgeInference(cfg, sched, dec).sample_ddpm(np.zeros((1, 4), np.int64))
    engine = EdgeInference(cfg, sched, dec, device="cpu", encoder=enc)
    assert next(engine.encoder.parameters()).device.type == "cpu"
    mel = FusedEdgeInference(cfg, sched, dec, device="cpu").sample_ddpm(
        np.zeros((1, 4), np.int64))
    assert mel.device.type == "cpu" and mel.shape == (1, 8, 80)


def test_new_wrappers_refuse_other_devices():
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff

    with pytest.raises(ValueError, match="CPU or CUDA"):
        ff.conv_frontend(torch.zeros(1, 800, device="meta"), {})
    x = torch.zeros(1, 4, 80, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fd.fused_ddpm(x, None, None, None, None, {}, heads=1, window=1)


def test_trainer_and_train_need_a_card_unless_told_cpu(tmp_path):
    from edge_diffusion_tts_tpu_torch.models import HubertConfig, SemanticEncoder
    from edge_diffusion_tts_tpu_torch.training import Trainer, train

    cfg = CFG(hidden=32, layers=1, heads=2, dropout=0.0, segment_secs=0.1, diff_steps=8,
              out_dir=str(tmp_path / "out"), data_root=str(tmp_path))
    enc, dec = SemanticEncoder(cfg, HubertConfig.tiny()), EdgeDiffusionDecoder(cfg)
    sched = DiffusionSchedule.create(cfg.diff_steps)
    if torch.cuda.is_available():
        assert Trainer(cfg, enc, dec, sched).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, enc, dec, sched)
        with pytest.raises(RuntimeError, match="CUDA"):
            train(cfg, train_loader=[{"wav": np.zeros((2, cfg.segment_len), np.float32)}],
                  hubert_cfg=HubertConfig.tiny())
    trainer = Trainer(cfg, enc, dec, sched, device="cpu")
    assert trainer.device.type == "cpu" and not trainer.encoder.hubert.frontend_kernel
    assert next(trainer.decoder.parameters()).device.type == "cpu"
