"""Training checkpoints (counterpart of ``edge_diffusion_tts_tpu/training/checkpoint.py``).

A checkpoint is a directory: ``state.pt`` (``TrainState.state_dict()`` by
``torch.save``: the modules' state dicts with the VQ buffers, the teacher,
the optimizer's moments and counts, the step), ``cfg.json``, ``hubert.json``
and ``meta.json`` (phase, halving, step ...).  Everything is read back with
``torch.load(weights_only=True)``: tensors, numbers and strings, no pickled
code.  The JAX package's behaviours are kept:

- a save is atomic: it is written to ``<path>.tmp``, then ``<path>`` is
  renamed to ``<path>.stale`` and the tmp to ``<path>``;
  ``resolve_checkpoint_dir`` finds the ``.stale`` sibling after a crash
  between the two renames;
- ``dedup_frozen=True`` writes the frozen HuBERT (~380 MB) once, to a
  ``frozen_hubert/`` sibling, and leaves it out of the state; restore puts it
  back.  Phase-end and final checkpoints stay self-contained;
- restore fits the teacher's arity to the checkpoint's (a checkpoint saved
  in a distillation phase has one);
- ``save_final_model`` writes the inference artifact in the layout
  ``weights.load_checkpoint`` and ``serving.run_server`` read;
  ``restore_final_model`` and ``restore_hubert_config`` read it back as the
  JAX package's functions of those names do.  The JAX package's
  ``encoder_variables`` (flax's ``{"params", "vq_state"}`` split) has no
  counterpart: the VQ codebook and its statistics ride in the encoder's
  state dict.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import torch

from .. import weights
from ..config import CFG
from ..models.hubert import HubertConfig, encoder_config_from_json, hubert_config_for
from .state import TrainState

_STATE_FILE = "state.pt"
_CFG_FILE = "cfg.json"
_HUBERT_FILE = "hubert.json"
_META_FILE = "meta.json"
_TMP_SUFFIX = ".tmp"
_STALE_SUFFIX = ".stale"
_FROZEN_DIR = "frozen_hubert"
_FROZEN_FILE = "hubert.pt"
_FROZEN_KEY = "frozen_external"
_HUBERT_PREFIX = "hubert."


def resolve_checkpoint_dir(path: str) -> Optional[str]:
    """The directory holding a complete checkpoint at ``path``: ``path``
    itself, else its ``.stale`` sibling, else None (a partly written
    ``.tmp`` is never returned)."""
    path = os.path.abspath(path)
    for candidate in (path, path + _STALE_SUFFIX):
        if os.path.isfile(os.path.join(candidate, _STATE_FILE)):
            return candidate
    return None


def frozen_hubert_host(state: TrainState) -> Dict[str, torch.Tensor]:
    """The frozen HuBERT's tensors on the host, under the encoder's names."""
    return {k: v.detach().cpu() for k, v in state.encoder.state_dict().items()
            if k.startswith(_HUBERT_PREFIX)}


def _write_json(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


def save_checkpoint(path: str, state: TrainState, cfg: CFG, meta: Optional[dict] = None,
                    frozen_host: Optional[Dict[str, torch.Tensor]] = None,
                    hubert_cfg: Optional[HubertConfig] = None,
                    dedup_frozen: bool = False, write: bool = True) -> None:
    """Save the full train state + cfg (+ free-form meta) at ``path``.

    ``frozen_host`` is ``frozen_hubert_host(state)`` fetched once by the
    caller: it is written in place of a fresh device fetch of bit-identical
    frozen weights.  ``dedup_frozen`` writes it once to the ``frozen_hubert/``
    sibling and records that in the meta.  ``write=False`` builds the state
    and writes nothing: a pipeline stage's ``state_dict`` is collective, so
    every rank builds it and one writes it."""
    path = os.path.abspath(path)
    d = state.state_dict(with_hubert=False)
    if not write:
        return
    meta = dict(meta or {})
    frozen = frozen_host if frozen_host is not None else frozen_hubert_host(state)
    if dedup_frozen:
        shared = os.path.join(os.path.dirname(path), _FROZEN_DIR)
        if not os.path.isfile(os.path.join(shared, _FROZEN_FILE)):
            os.makedirs(shared, exist_ok=True)
            tmp_file = os.path.join(shared, _FROZEN_FILE + _TMP_SUFFIX)
            torch.save(frozen, tmp_file)
            os.replace(tmp_file, os.path.join(shared, _FROZEN_FILE))
        meta[_FROZEN_KEY] = _FROZEN_DIR
    else:
        d["encoder"] = {**frozen, **d["encoder"]}
    tmp, stale = path + _TMP_SUFFIX, path + _STALE_SUFFIX
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(d, os.path.join(tmp, _STATE_FILE))
    _write_json(os.path.join(tmp, _CFG_FILE), cfg.to_json())
    if hubert_cfg is not None:
        _write_json(os.path.join(tmp, _HUBERT_FILE), hubert_cfg.to_json())
    _write_json(os.path.join(tmp, _META_FILE), json.dumps(meta))
    shutil.rmtree(stale, ignore_errors=True)
    if os.path.isdir(path):
        os.rename(path, stale)
    os.rename(tmp, path)
    shutil.rmtree(stale, ignore_errors=True)


def restore_checkpoint(path: str, state: Optional[TrainState] = None
                       ) -> Tuple[object, CFG, dict]:
    """``(state, cfg, meta)``.  With ``state`` the checkpoint is loaded into
    it (``TrainState.load_state_dict``: the teacher's arity follows the
    checkpoint; tensors that do not fit raise ValueError); without, the raw
    dict of CPU tensors comes back in its place."""
    path = resolve_checkpoint_dir(path) or os.path.abspath(path)
    meta = {}
    meta_path = os.path.join(path, _META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    d = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu", weights_only=True)
    frozen_rel = meta.get(_FROZEN_KEY)
    if frozen_rel:
        frozen = torch.load(os.path.join(os.path.dirname(path), frozen_rel, _FROZEN_FILE),
                            map_location="cpu", weights_only=True)
        d["encoder"] = {**frozen, **d["encoder"]}
    with open(os.path.join(path, _CFG_FILE)) as f:
        cfg = CFG.from_json(f.read())
    if state is None:
        return d, cfg, meta
    state.load_state_dict(d)
    return state, cfg, meta


def save_final_model(path: str, state: TrainState, cfg: CFG) -> None:
    """The inference artifact (``edge_model_final``): ``cfg.json``,
    ``decoder.pt``, ``hubert.json`` and ``encoder.pt`` (the VQ codebook and
    statistics ride in the encoder's state dict), as
    ``weights.save_checkpoint`` writes them."""
    weights.save_checkpoint(path, cfg, state.decoder, state.encoder)


def restore_final_model(path: str) -> Tuple[Dict[str, Dict[str, torch.Tensor]], CFG]:
    """``({"decoder": state dict, "encoder": state dict}, cfg)`` of a final
    model (``"encoder"`` only when the artifact holds one), CPU tensors."""
    path = os.path.abspath(path)
    cfg, dec, _, _ = weights.load_checkpoint(path)
    state = {"decoder": dec}
    enc_path = os.path.join(path, weights.CKPT_FILES["encoder"])
    if os.path.exists(enc_path):
        state["encoder"] = torch.load(enc_path, map_location="cpu", weights_only=True)
    return state, cfg


def restore_hubert_config(path: str) -> HubertConfig:
    """The HuBERT architecture a checkpoint's encoder was built for, from its
    ``hubert.json``; for an artifact without the file (one that predates it,
    or a reference-migrated one, always full size) the encoder its
    ``cfg.json``'s ``hubert_id`` names, or hubert-base without either."""
    path = resolve_checkpoint_dir(path) or os.path.abspath(path)
    p = os.path.join(path, _HUBERT_FILE)
    if os.path.exists(p):
        with open(p) as f:
            return encoder_config_from_json(f.read())
    p = os.path.join(path, _CFG_FILE)
    if os.path.exists(p):
        with open(p) as f:
            return hubert_config_for(CFG.from_json(f.read()).hubert_id)
    return HubertConfig()
