"""Model export for edge deployment: the decoder as a ``torch.export`` program
(counterpart of ``edge_diffusion_tts_tpu/utils/export.py``).

``export_for_edge`` writes the decoder's denoise forward, inputs (x_t
[B, T, n_mels] float32, t [B] int64, sem_idx [B, S] int64, step_idx [B]
int64) -> prediction [B, T, n_mels] float32, as a ``.pt2`` file
(``torch.export.save``); ``load_exported`` reads it back as a callable
module on a device.  The ``.pt2`` takes the place of both of the JAX
package's artifacts, StableHLO and TFLite.

The program is traced from a CPU copy of the eval-mode decoder on its plain
routes (no banded-attention kernel, no query chunking: the same function,
and no branch on a symbolic length).  With ``dynamic=True`` the batch, mel
length and context length are symbolic, the lengths bounded by the
positional tables (``cfg.max_mel_positions``, ``cfg.max_ctx_positions``): a
longer input is refused when the program is called.  ``dynamic=False``
fixes (1, 200, 100), as the JAX package's static export does.

A ``.pt2`` is read by the torch release that wrote it.

Not ported: ``export_tflite``, ``load_tflite``, ``synthetic_representative_
batches`` and ``utils/tflite_surgery.py``.  They need jax2tf and a
TensorFlow interpreter, and the card's machine has no TensorFlow.  The
selective weight-only int8 artifact is ``utils/quantize.py``'s.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..config import CFG, resolve_device

STATIC_SHAPE = (1, 200, 100)  # (batch, mel frames, context tokens) of a static export


class _DenoiseForward(nn.Module):
    def __init__(self, decoder):
        super().__init__()
        self.decoder = decoder

    def forward(self, x_t, t, sem_idx, step_idx):
        return self.decoder(x_t, t, sem_idx=sem_idx, step_idx=step_idx)


def _plain_cpu_copy(cfg: CFG, decoder):
    """The decoder's weights in an eval-mode CPU decoder on its plain routes."""
    from ..models import EdgeDiffusionDecoder

    plain_cfg = CFG.from_dict(dict(cfg.to_dict(), band_q_chunk=0, cross_q_chunk=0))
    plain = EdgeDiffusionDecoder(plain_cfg, use_kernel=False)
    plain.load_state_dict({k: v.detach().cpu() for k, v in decoder.state_dict().items()})
    return plain.eval()


def export_for_edge(cfg: CFG, decoder, out_path: str, dynamic: bool = True) -> str:
    """Serialize the decoder's denoise forward as a ``.pt2``; returns the path."""
    from torch.export import Dim

    module = _DenoiseForward(_plain_cpu_copy(cfg, decoder))
    if dynamic:
        b = Dim("b", min=1, max=1024)
        t = Dim("t", min=1, max=cfg.max_mel_positions)
        s = Dim("s", min=1, max=cfg.max_ctx_positions)
        # Example sizes above 1: torch.export specializes a size-1 example.
        B, T, S = 2, min(200, cfg.max_mel_positions), min(100, cfg.max_ctx_positions)
        shapes = {"x_t": {0: b, 1: t}, "t": {0: b}, "sem_idx": {0: b, 1: s},
                  "step_idx": {0: b}}
    else:
        B, T, S = STATIC_SHAPE
        shapes = None
    args = (torch.zeros(B, T, cfg.n_mels), torch.zeros(B, dtype=torch.long),
            torch.zeros(B, S, dtype=torch.long), torch.zeros(B, dtype=torch.long))
    with torch.no_grad():
        program = torch.export.export(module, args, dynamic_shapes=shapes)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    print(f"Exported decoder ({os.path.getsize(out_path) / 1e6:.2f} MB .pt2) -> {out_path}")
    return out_path


def load_exported(path: str, device=None):
    """An exported decoder as a callable module ``(x_t, t, sem_idx, step_idx)
    -> prediction`` on ``device`` (the card unless told otherwise)."""
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    program = torch.export.load(path)
    if device.type != "cpu":
        program = move_to_device_pass(program, device)
    return program.module()
