"""Carry JAX (flax) parameter trees and HF HuBERT state dicts across to the
port's state dicts.

``state_dict_from_jax(params, cfg)`` takes the JAX decoder's param tree as
``init_decoder_params(...)["params"]`` gives it (numpy or jax arrays) and
returns the port's ``state_dict``: dense ``kernel`` [in, out] becomes
``weight`` [out, in], conv ``kernel`` [k, in/g, out] becomes [out, in/g, k],
``embedding`` and LayerNorm/GroupNorm ``scale`` become ``weight``, and module
names follow the reference state-dict keys (``time_emb.1``, ``ffn.net.0``,
``layers.{i}`` ...).  The same walk converts any sub-tree (one layer, one
block) to the matching port module's state dict.  Leaves come across as
float32, except bf16 ones (a tree cast to ``param_dtype="bfloat16"``), which
numpy holds as ``ml_dtypes.bfloat16``: their 16 bits are carried over as
they are into bf16 tensors, with no float round trip.

``encoder_state_dict_from_jax(variables)`` does the same for the JAX
``SemanticEncoder``'s variables (``params``, and for VQ every ``vq_state``
buffer: codebook, EMA statistics, update count); HuBERT's modules take the
names of transformers' ``HubertModel`` (``conv_{i}`` ->
``feature_extractor.conv_layers.{i}.conv``, ``layer_{i}`` ->
``encoder.layers.{i}`` ...).  ``train_state_from_jax(state)`` carries a
whole JAX ``TrainState`` (params, VQ state, teacher, step, Adam's moments
and count, the accumulated gradients) into ``training.TrainState``'s
``state_dict`` layout; the train state of a data-parallel run is an ordinary
one, and a pipeline run's packed decoder, teacher and moments are unpacked.
``hubert_state_dict_from_hf(sd, cfg)`` takes an HF ``HubertModel`` state
dict (the inverse of the JAX package's ``load_hubert_params_from_torch``)
and materializes the positional conv's weight norm.

``save_checkpoint`` / ``load_checkpoint`` write and read the port's own
checkpoint, the directory ``serving.run_server`` serves: ``cfg.json``
(``CFG.to_json``), ``decoder.pt`` (the decoder's state dict by
``torch.save``) and, with an encoder, ``hubert.json`` and ``encoder.pt``.
They are read with ``torch.load(weights_only=True)``: tensors only, no
pickled code.
"""

from __future__ import annotations

import os
import re
from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import CFG
from .models.hubert import HubertConfig, HubertEncoder

_MODULE_NAMES = {
    "time_fc1": "time_emb.1",
    "time_fc2": "time_emb.3",
    "fc1": "net.0",
    "fc2": "net.3",
}
_LAYER = re.compile(r"layers_(\d+)$")


def _module_name(name: str) -> str:
    m = _LAYER.match(name)
    if m:
        return f"layers.{m.group(1)}"
    return _MODULE_NAMES.get(name, name)


def _index_tree(node, i: int):
    if isinstance(node, Mapping):
        return {k: _index_tree(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _unpack_pp(tree):
    """A pipeline run's packed decoder tree (``{"pp_stack": [L, ...] tree,
    "pp_rest": ...}``, JAX ``pp_pack_decoder``) -> the canonical one with
    ``layers_{i}``; any other tree unchanged."""
    if not (isinstance(tree, Mapping) and "pp_stack" in tree):
        return tree
    stack = tree["pp_stack"]
    leaf = stack
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    out = dict(tree["pp_rest"])
    for i in range(np.shape(leaf)[0]):
        out[f"layers_{i}"] = _index_tree(stack, i)
    return out


def _leaf_array(leaf) -> np.ndarray:
    """A flax leaf as numpy: bf16 as it is, anything else as float32."""
    arr = np.asarray(leaf)
    return arr if arr.dtype.name == "bfloat16" else np.array(leaf, dtype=np.float32)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; ``torch.from_numpy`` refuses ``ml_dtypes.bfloat16``,
    so a bf16 array's bits go across as int16 and are viewed as bf16."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax tree -> {dotted port name: float32 (or bf16) tensor}, leaves converted;
    optax's masked-out leaves (``MaskedNode``) are skipped; a pipeline
    run's packed decoder tree is unpacked first."""
    sd: Dict[str, torch.Tensor] = {}
    params = _unpack_pp(params)

    def walk(node: Mapping, path: list) -> None:
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + [_module_name(name)])
                continue
            if type(child).__name__ == "MaskedNode":
                continue
            arr = _leaf_array(child)
            if name == "kernel":
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
                name = "weight"
            elif name in ("embedding", "scale"):
                name = "weight"
            sd[".".join(path + [name])] = _tensor(arr)

    walk(params, [])
    return sd


def state_dict_from_jax(params: Mapping, cfg: Optional[CFG] = None) -> Dict[str, torch.Tensor]:
    """flax param tree -> port state dict (CPU tensors: float32, bf16 where
    the tree's leaves are bf16).

    With ``cfg``, the tree must hold exactly ``cfg.layers`` decoder blocks.
    """
    if set(params) == {"params"}:
        params = params["params"]
    sd = _flatten(params)
    if cfg is not None:
        found = {int(k.split(".")[1]) for k in sd if k.startswith("layers.")}
        if found != set(range(cfg.layers)):
            raise ValueError(f"param tree holds layers {sorted(found)}, "
                             f"cfg.layers is {cfg.layers}")
    return sd


# JAX HubertEncoder module paths -> HF HubertModel names (first match wins).
_HUBERT_RENAMES = [
    (re.compile(p), r) for p, r in (
        (r"^feature_extractor\.conv_(\d+)\.", r"feature_extractor.conv_layers.\1.conv."),
        (r"^feature_extractor\.group_norm\.", "feature_extractor.conv_layers.0.layer_norm."),
        (r"^fp_layer_norm\.", "feature_projection.layer_norm."),
        (r"^fp_projection\.", "feature_projection.projection."),
        (r"^pos_conv_embed\.", "encoder.pos_conv_embed."),
        (r"^encoder_layer_norm\.", "encoder.layer_norm."),
        (r"^layer_(\d+)\.(q_proj|k_proj|v_proj|out_proj)\.", r"encoder.layers.\1.attention.\2."),
        (r"^layer_(\d+)\.(intermediate_dense|output_dense)\.",
         r"encoder.layers.\1.feed_forward.\2."),
        (r"^layer_(\d+)\.", r"encoder.layers.\1."),
    )
]


def _hubert_name(name: str) -> str:
    for pattern, repl in _HUBERT_RENAMES:
        if pattern.match(name):
            return pattern.sub(repl, name, count=1)
    return name


def encoder_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``SemanticEncoder`` variables -> the port ``SemanticEncoder``'s
    state dict (CPU tensors).  ``variables`` holds ``params`` and, for a VQ
    encoder, ``vq_state``: the codebook, ``ema_cluster_size``, ``ema_w``
    (float32) and ``update_count`` (int32) all come across."""
    sd = {}
    for name, t in _flatten(variables["params"]).items():
        if name.startswith("hubert."):
            name = "hubert." + _hubert_name(name[len("hubert."):])
        sd[name] = t
    vq_state = variables.get("vq_state")
    if vq_state:
        for key, value in vq_state["vq"].items():
            dtype = np.int32 if key == "update_count" else np.float32
            sd[f"vq.{key}"] = torch.from_numpy(np.array(value, dtype=dtype))
    return sd


def _trainable_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """{"encoder": ..., "decoder": ...} param-shaped tree (params, a gradient,
    an Adam moment) -> the optimizer's names ("encoder.<name>",
    "decoder.<name>"), the frozen HuBERT left out."""
    out = {f"encoder.{k}": v
           for k, v in encoder_state_dict_from_jax({"params": tree["encoder"]}).items()
           if not k.startswith("hubert.")}
    out.update({f"decoder.{k}": v for k, v in _flatten(tree["decoder"]).items()})
    return out


def _find_states(node, kinds: tuple, found: dict) -> dict:
    """Walk optax's nested state tuples; collect the first state of each
    class name in ``kinds``."""
    name = type(node).__name__
    if name in kinds and name not in found:
        found[name] = node
    if isinstance(node, Mapping):
        children = node.values()
    elif isinstance(node, tuple):
        children = node
    else:
        return found
    for child in children:
        _find_states(child, kinds, found)
    return found


def train_state_from_jax(state) -> dict:
    """A JAX ``training.TrainState`` -> ``training.TrainState.state_dict()``
    of the port (CPU tensors), so a port trainer can take over mid-run.

    The optimizer state is read out of optax's chain: ``ScaleByAdamState``
    (mu, nu, count) and, under gradient accumulation, ``MultiStepsState``
    (mini_step, acc_grads).  Adam's count is the number of inner updates
    made, which the schedule's count equals."""
    opt = state.opt_state
    found = _find_states(opt, ("MultiStepsState", "ScaleByAdamState", "ScaleByScheduleState"),
                         {})
    adam = found["ScaleByAdamState"]
    count = int(np.asarray(adam.count))
    if "ScaleByScheduleState" in found and int(np.asarray(
            found["ScaleByScheduleState"].count)) != count:
        raise ValueError("optax's schedule and Adam counts differ; the port keeps one count")
    multi = found.get("MultiStepsState")
    optimizer = {
        "mu": _trainable_from_jax(adam.mu), "nu": _trainable_from_jax(adam.nu),
        "acc": None if multi is None else _trainable_from_jax(multi.acc_grads),
        "count": count, "mini_step": 0 if multi is None else int(np.asarray(multi.mini_step)),
    }
    enc_vars = {"params": state.params["encoder"]}
    if state.vq_state:
        enc_vars["vq_state"] = state.vq_state["encoder"]
    return {
        "step": int(np.asarray(state.step)),
        "encoder": encoder_state_dict_from_jax(enc_vars),
        "decoder": _flatten(state.params["decoder"]),
        "teacher": None if state.teacher is None else _flatten(state.teacher),
        "optimizer": optimizer,
    }


_POS_CONV = "encoder.pos_conv_embed.conv"


def hubert_state_dict_from_hf(state_dict: Mapping, cfg: HubertConfig) -> Dict[str, torch.Tensor]:
    """transformers ``HubertModel.state_dict()`` -> the port ``HubertEncoder``'s.

    The positional conv's weight norm (dim=2: one norm per kernel tap over
    the other two dims) is materialized from ``weight_g``/``weight_v`` or
    from torch's ``parametrizations.weight.original0/1``; a plain
    ``weight`` is taken as is.  Keys the port has no use for (such as
    ``masked_spec_embed``) are dropped; a missing one raises KeyError.
    """
    sd = {k: torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                                        dtype=np.float32))
          for k, v in state_dict.items()}
    if f"{_POS_CONV}.weight" not in sd:
        if f"{_POS_CONV}.weight_g" in sd:
            g, v = sd[f"{_POS_CONV}.weight_g"], sd[f"{_POS_CONV}.weight_v"]
        else:
            g = sd[f"{_POS_CONV}.parametrizations.weight.original0"]
            v = sd[f"{_POS_CONV}.parametrizations.weight.original1"]
        sd[f"{_POS_CONV}.weight"] = g * v / v.square().sum((0, 1), keepdim=True).sqrt()
    with torch.device("meta"):
        wanted = list(HubertEncoder(cfg).state_dict())
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"HF HuBERT state dict lacks {missing[:5]} ({len(missing)} keys)")
    return {k: sd[k].contiguous() for k in wanted}


CKPT_FILES = {"cfg": "cfg.json", "decoder": "decoder.pt", "hubert": "hubert.json",
              "encoder": "encoder.pt"}


def save_checkpoint(path: str, cfg: CFG, decoder, encoder=None, hubert: bool = True) -> None:
    """Write a port checkpoint directory: ``cfg.json`` and ``decoder.pt``,
    and for a ``SemanticEncoder`` also ``hubert.json`` and ``encoder.pt``.
    ``hubert=False`` leaves the frozen HuBERT's weights out of ``encoder.pt``
    (a reference checkpoint migrated without pretrained HuBERT weights);
    ``load_checkpoint`` refuses such an encoder."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, CKPT_FILES["cfg"]), "w") as f:
        f.write(cfg.to_json())
    torch.save({k: v.detach().cpu() for k, v in decoder.state_dict().items()},
               os.path.join(path, CKPT_FILES["decoder"]))
    if encoder is not None:
        with open(os.path.join(path, CKPT_FILES["hubert"]), "w") as f:
            f.write(encoder.hubert_cfg.to_json())
        torch.save({k: v.detach().cpu() for k, v in encoder.state_dict().items()
                    if hubert or not k.startswith("hubert.")},
                   os.path.join(path, CKPT_FILES["encoder"]))


def load_checkpoint(path: str, with_encoder: bool = False
                    ) -> Tuple[CFG, Dict[str, torch.Tensor], Optional[HubertConfig],
                               Optional[Dict[str, torch.Tensor]]]:
    """Read a port checkpoint directory: ``(cfg, decoder_state, hubert_cfg,
    encoder_state)``, the last two None unless ``with_encoder`` (which
    raises FileNotFoundError when the checkpoint has no encoder, and
    ValueError when its encoder has no HuBERT weights)."""
    with open(os.path.join(path, CKPT_FILES["cfg"])) as f:
        cfg = CFG.from_json(f.read())
    dec = torch.load(os.path.join(path, CKPT_FILES["decoder"]), map_location="cpu",
                     weights_only=True)
    if not with_encoder:
        return cfg, dec, None, None
    with open(os.path.join(path, CKPT_FILES["hubert"])) as f:
        hubert_cfg = HubertConfig.from_json(f.read())
    enc = torch.load(os.path.join(path, CKPT_FILES["encoder"]), map_location="cpu",
                     weights_only=True)
    if not any(k.startswith("hubert.") for k in enc):
        raise ValueError(
            f"{path} holds no HuBERT weights (a reference checkpoint migrated without "
            "--hubert-id): migrate it again with --hubert-id to run the encoder")
    return cfg, dec, hubert_cfg, enc
