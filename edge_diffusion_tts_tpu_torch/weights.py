"""Carry JAX (flax) parameter trees and HF HuBERT state dicts across to the
port's state dicts.

``state_dict_from_jax(params, cfg)`` takes the JAX decoder's param tree as
``init_decoder_params(...)["params"]`` gives it (numpy or jax arrays) and
returns the port's ``state_dict``: dense ``kernel`` [in, out] becomes
``weight`` [out, in], conv ``kernel`` [k, in/g, out] becomes [out, in/g, k],
``embedding`` and LayerNorm/GroupNorm ``scale`` become ``weight``, and module
names follow the reference state-dict keys (``time_emb.1``, ``ffn.net.0``,
``layers.{i}`` ...).  The same walk converts any sub-tree (one layer, one
block) to the matching port module's state dict.

``encoder_state_dict_from_jax(variables)`` does the same for the JAX
``SemanticEncoder``'s variables (``params``, and for VQ the codebook in
``vq_state``); HuBERT's modules take the names of transformers'
``HubertModel`` (``conv_{i}`` -> ``feature_extractor.conv_layers.{i}.conv``,
``layer_{i}`` -> ``encoder.layers.{i}`` ...).
``hubert_state_dict_from_hf(sd, cfg)`` takes an HF ``HubertModel`` state
dict (the inverse of the JAX package's ``load_hubert_params_from_torch``)
and materializes the positional conv's weight norm.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Optional

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


def _flatten(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax tree -> {dotted port name: float32 tensor}, leaves converted."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: list) -> None:
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + [_module_name(name)])
                continue
            arr = np.array(child, dtype=np.float32)
            if name == "kernel":
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
                name = "weight"
            elif name in ("embedding", "scale"):
                name = "weight"
            sd[".".join(path + [name])] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, [])
    return sd


def state_dict_from_jax(params: Mapping, cfg: Optional[CFG] = None) -> Dict[str, torch.Tensor]:
    """flax param tree -> port state dict (float32 CPU tensors).

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
    state dict (float32 CPU tensors).  ``variables`` holds ``params`` and,
    for a VQ encoder, ``vq_state`` (only its codebook is carried: the EMA
    statistics are training state)."""
    sd = {}
    for name, t in _flatten(variables["params"]).items():
        if name.startswith("hubert."):
            name = "hubert." + _hubert_name(name[len("hubert."):])
        sd[name] = t
    vq_state = variables.get("vq_state")
    if vq_state:
        sd["vq.codebook"] = torch.from_numpy(
            np.array(vq_state["vq"]["codebook"], dtype=np.float32))
    return sd


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
