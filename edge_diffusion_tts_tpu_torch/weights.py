"""Carry JAX (flax) parameter trees across to the port's state dicts.

``state_dict_from_jax(params, cfg)`` takes the JAX decoder's param tree as
``init_decoder_params(...)["params"]`` gives it (numpy or jax arrays) and
returns the port's ``state_dict``: dense ``kernel`` [in, out] becomes
``weight`` [out, in], conv ``kernel`` [k, in/g, out] becomes [out, in/g, k],
``embedding`` and LayerNorm/GroupNorm ``scale`` become ``weight``, and module
names follow the reference state-dict keys (``time_emb.1``, ``ffn.net.0``,
``layers.{i}`` ...).  The same walk converts any sub-tree (one layer, one
block) to the matching port module's state dict.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch

from .config import CFG

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


def state_dict_from_jax(params: Mapping, cfg: Optional[CFG] = None) -> Dict[str, torch.Tensor]:
    """flax param tree -> port state dict (float32 CPU tensors).

    With ``cfg``, the tree must hold exactly ``cfg.layers`` decoder blocks.
    """
    if set(params) == {"params"}:
        params = params["params"]
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
    if cfg is not None:
        found = {int(k.split(".")[1]) for k in sd if k.startswith("layers.")}
        if found != set(range(cfg.layers)):
            raise ValueError(f"param tree holds layers {sorted(found)}, "
                             f"cfg.layers is {cfg.layers}")
    return sd
