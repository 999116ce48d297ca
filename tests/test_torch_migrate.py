"""Port parity: reference-checkpoint migration (utils/torch_compat.py and the
CLI's ``migrate``) against the JAX package's converter.

Synthetic reference checkpoints in the three layouts the reference saves
(v1 with VQ, v1 with FSQ, v2), each with the plain and the fast encoder
projection, go through both converters; the port's state dicts must equal
``state_dict_from_jax`` / ``encoder_state_dict_from_jax`` of JAX's result
exactly, with and without HuBERT weights (an HF-layout state dict read by
each package's own loader).  Also: the ``use_depthwise`` sanitizing, a file
that needs pickled code refused, and ``migrate`` without ``--hubert-id``
writing no HuBERT weights, which ``generate`` then refuses.
"""

import dataclasses
import os
import types

import jax  # noqa: F401  (JAX on the CPU, as in the other port tests)
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.models.hubert import HubertConfig as JHC
from edge_diffusion_tts_tpu.models.hubert import load_hubert_params_from_torch
from edge_diffusion_tts_tpu.utils import torch_compat as jtc
from edge_diffusion_tts_tpu_torch import cli
from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, HubertConfig, HubertEncoder
from edge_diffusion_tts_tpu_torch.utils import torch_compat as ptc
from edge_diffusion_tts_tpu_torch.weights import (
    encoder_state_dict_from_jax,
    hubert_state_dict_from_hf,
    load_checkpoint,
    state_dict_from_jax,
)

LAYERS, HIDDEN, D = 2, 32, 16
FSQ_LEVELS = [4, 4, 3]


def _rand(rng, *shape):
    return torch.from_numpy((0.1 * rng.randn(*shape)).astype(np.float32))


def reference_checkpoint(layout: str, fast: bool, hubert_hidden: int = 32, seed: int = 0):
    """A reference-layout checkpoint dict: the decoder by the port's (= the
    reference's) names, the projection as a Sequential, the quantizer as
    the layout keeps it."""
    rng = np.random.RandomState(seed)
    cfg = CFG(hidden=HIDDEN, layers=LAYERS, heads=2, semantic_dim=D, fsq_levels=FSQ_LEVELS,
              codebook_size=24, use_fsq=layout != "v1-vq", use_depthwise=True)
    dec = EdgeDiffusionDecoder(dataclasses.replace(cfg, use_depthwise=False))
    decoder = {k: _rand(rng, *v.shape) for k, v in dec.state_dict().items()}
    last = "4" if fast else "3"
    proj = {"0.weight": _rand(rng, D, hubert_hidden), "0.bias": _rand(rng, D),
            "2.weight": _rand(rng, D), "2.bias": _rand(rng, D),
            f"{last}.weight": _rand(rng, D, D), f"{last}.bias": _rand(rng, D)}
    fsq = {"proj_down.weight": _rand(rng, len(FSQ_LEVELS), D),
           "proj_down.bias": _rand(rng, len(FSQ_LEVELS)),
           "proj_up.weight": _rand(rng, D, len(FSQ_LEVELS)), "proj_up.bias": _rand(rng, D)}
    vq = {"codebook.weight": _rand(rng, 24, D), "ema_cluster_size": _rand(rng, 24).abs(),
          "ema_w": _rand(rng, 24, D), "update_count": torch.tensor(7)}
    ckpt = {"encoder_proj": proj, "decoder": decoder}
    if layout == "v2":
        ckpt.update(encoder_fsq=fsq, epoch=3, val_cos=0.5)
    else:
        ckpt.update(encoder_vq=vq if layout == "v1-vq" else fsq, cfg=cfg.to_dict())
    return ckpt


def _hf_hubert(seed=3):
    rng = np.random.RandomState(seed)
    return {k: _rand(rng, *v.shape) for k, v in HubertEncoder(HubertConfig.tiny()).state_dict()
            .items()}


@pytest.mark.parametrize("with_hubert", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("layout", ["v1-vq", "v1-fsq", "v2"])
def test_conversion_equals_jax_through_the_bridge(layout, fast, with_hubert):
    ckpt = reference_checkpoint(layout, fast)
    hf = _hf_hubert() if with_hubert else None
    jparams, jvq, jcfg = jtc.convert_reference_checkpoint(
        ckpt, num_layers=LAYERS,
        hubert_params=None if hf is None else load_hubert_params_from_torch(
            {k: v.numpy() for k, v in hf.items()}, JHC.tiny()))
    dec, enc, cfg = ptc.convert_reference_checkpoint(
        ckpt, num_layers=LAYERS,
        hubert_state=None if hf is None else hubert_state_dict_from_hf(hf, HubertConfig.tiny()))

    want_dec = state_dict_from_jax(jparams["decoder"])
    assert set(dec) == set(want_dec) == set(ckpt["decoder"])
    for k, v in want_dec.items():
        assert torch.equal(dec[k], v), k
    variables = {"params": jparams["encoder"]}
    if jvq:
        variables["vq_state"] = jvq["encoder"]
    want_enc = encoder_state_dict_from_jax(variables)
    assert set(enc) == set(want_enc)
    assert any(k.startswith("hubert.") for k in enc) == with_hubert
    for k, v in want_enc.items():
        assert enc[k].dtype == v.dtype and torch.equal(enc[k], v), k
    if layout == "v1-vq":
        assert enc["vq.update_count"].dtype == torch.int32 and int(enc["vq.update_count"]) == 7
    # The reference declares use_depthwise=True and consumes it nowhere.
    assert cfg == jcfg
    assert cfg is None if layout == "v2" else cfg["use_depthwise"] is False


def test_pickled_code_is_refused(tmp_path):
    path = str(tmp_path / "pickled.pt")
    torch.save({"decoder": {}, "cfg": types.SimpleNamespace(hidden=32)}, path)
    with pytest.raises(ValueError, match="pickled code"):
        ptc.load_reference_checkpoint(path)
    ok = str(tmp_path / "ok.pt")
    torch.save(reference_checkpoint("v2", fast=True), ok)
    assert set(ptc.load_reference_checkpoint(ok)) >= {"encoder_proj", "encoder_fsq", "decoder"}


def test_migrate_without_hubert_writes_none_and_generate_refuses(tmp_path, capsys):
    pt = str(tmp_path / "edge_model_final.pt")
    ckpt = reference_checkpoint("v1-fsq", fast=False, hubert_hidden=768)
    torch.save(ckpt, pt)
    out = str(tmp_path / "migrated")
    cli.main(["migrate", pt, out])
    assert "no --hubert-id" in capsys.readouterr().out
    enc = torch.load(os.path.join(out, "encoder.pt"), weights_only=True)
    assert enc and not any(k.startswith("hubert.") for k in enc)
    cfg, dec, _, _ = load_checkpoint(out)
    assert cfg.use_depthwise is False and cfg.layers == LAYERS
    for k, v in ckpt["decoder"].items():
        assert torch.equal(dec[k], v), k
    with pytest.raises(ValueError, match="--hubert-id"):
        load_checkpoint(out, with_encoder=True)
    wav = str(tmp_path / "in.wav")
    from scipy.io import wavfile

    wavfile.write(wav, 16000, np.zeros(3200, np.int16))
    with pytest.raises(SystemExit, match="--hubert-id"):
        cli.main(["generate", out, "--wav", wav, "--device", "cpu",
                  "--out", str(tmp_path / "g.wav")])
