"""Weight-only int8 quantization of the decoder (counterpart of
``edge_diffusion_tts_tpu/utils/quantize.py``).

Symmetric int8, one float32 scale per output channel, on the port decoder's
state dict; the numerically sensitive tensors stay float32:

  - ``out_proj`` (the output head, and the cross-attention's output);
  - the AdaLN modulation projections (``norm1``/``norm3`` ``proj``) and
    every other tensor under a ``norm`` name;
  - the timestep MLP (``time_emb``: the JAX package's ``time_fc1``/
    ``time_fc2``) and the stage embedding (``step_emb``);
  - every tensor that is not 2-D (biases, norm weights, convolutions).

This is the JAX package's rule written on the port's names, and it selects
the same tensors.  The channel axis follows the module: a ``Linear`` weight
is [out, in], so its scale runs over the rows (one per output channel); an
``Embedding`` is [vocab, features], so, as in the JAX package, one scale per
feature.  ``w ~= int8 * scale`` with the scale kept in the broadcast shape
([out, 1] or [1, features]), so the artifact describes itself.  The codes
equal the JAX package's (transposed for a ``Linear``): both divide in
float32 and round half to even.

The artifact is a flat ``.npz`` (no pickle): ``q8:<name>`` (int8),
``sc:<name>`` (the float32 scale), ``f32:<name>`` (kept tensors), with the
decoder's state-dict names.  ``load_quantized`` returns a float32 state
dict for ``decoder.load_state_dict``.  Numpy only.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

# Name substrings that keep a tensor float32 (matched lowercase).
SENSITIVE = ("out_proj", "time_emb", "step_emb", "norm")


def _is_sensitive(name: str) -> bool:
    n = name.lower()
    return any(s in n for s in SENSITIVE)


def _host_state(decoder) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in decoder.state_dict().items()}


def _channel_axis(decoder) -> Dict[str, int]:
    """The reduced axis of each 2-D weight: 1 for a ``Linear`` ([out, in]:
    a scale per output row), 0 for an ``Embedding`` ([vocab, features]: a
    scale per feature column)."""
    from torch import nn

    axes = {}
    for prefix, module in decoder.named_modules():
        name = f"{prefix}.weight" if prefix else "weight"
        if isinstance(module, nn.Linear):
            axes[name] = 1
        elif isinstance(module, nn.Embedding):
            axes[name] = 0
    return axes


def quantize_decoder_params(decoder) -> Dict[str, np.ndarray]:
    """A decoder module -> flat dict of int8 weights, their scales and the
    kept float32 tensors (keys ``q8:``/``sc:``/``f32:`` + state-dict name)."""
    axes = _channel_axis(decoder)
    out: Dict[str, np.ndarray] = {}
    for name, w in _host_state(decoder).items():
        if (w.ndim != 2 or _is_sensitive(name) or not np.issubdtype(w.dtype, np.floating)):
            out[f"f32:{name}"] = w.astype(np.float32)
            continue
        if name not in axes:
            raise ValueError(f"{name}: a 2-D tensor of neither a Linear nor an Embedding")
        amax = np.max(np.abs(w), axis=axes[name], keepdims=True)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        out[f"q8:{name}"] = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        out[f"sc:{name}"] = scale
    return out


def dequantize_decoder_params(qflat: Dict[str, np.ndarray]):
    """Inverse of ``quantize_decoder_params``: flat dict -> float32 state dict
    (CPU tensors, the decoder's names)."""
    import torch

    sd = {}
    for key, v in qflat.items():
        tag, name = key.split(":", 1)
        if tag == "f32":
            sd[name] = np.asarray(v, np.float32)
        elif tag == "q8":
            sd[name] = v.astype(np.float32) * np.asarray(qflat[f"sc:{name}"], np.float32)
        elif tag != "sc":
            raise ValueError(f"unknown tag in quantized artifact: {key}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def quantized_nbytes(qflat: Dict[str, np.ndarray]) -> int:
    return sum(np.asarray(v).nbytes for v in qflat.values())


def params_nbytes(decoder) -> int:
    return sum(v.nbytes for v in _host_state(decoder).values())


def save_quantized(path: str, decoder) -> Tuple[str, dict]:
    """Quantize + write a flat .npz; returns (path, size report)."""
    q = quantize_decoder_params(decoder)
    final = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(final)), exist_ok=True)
    np.savez(final, **q)
    f32 = params_nbytes(decoder)
    report = {
        "f32_bytes": f32,
        "quantized_bytes": quantized_nbytes(q),
        "file_bytes": os.path.getsize(final),
        "ratio": round(f32 / max(quantized_nbytes(q), 1), 3),
        "kept_f32": sorted(
            k.split(":", 1)[1] for k in q if k.startswith("f32:") and q[k].ndim == 2
        ),
    }
    return final, report


def load_quantized(path: str):
    """Load a .npz written by ``save_quantized`` -> float32 state dict."""
    with np.load(path) as z:
        return dequantize_decoder_params({k: z[k] for k in z.files})
