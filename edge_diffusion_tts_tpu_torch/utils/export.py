"""Model export for edge deployment (counterpart of
``edge_diffusion_tts_tpu/utils/export.py``): the decoder as a ``torch.export``
program and as a TFLite flatbuffer.

``export_for_edge`` writes the decoder's denoise forward, inputs (x_t
[B, T, n_mels] float32, t [B] int64, sem_idx [B, S] int64, step_idx [B]
int64) -> prediction [B, T, n_mels] float32, as a ``.pt2`` file
(``torch.export.save``); ``load_exported`` reads it back as a callable
module on a device.  The ``.pt2`` takes the place of the JAX package's
StableHLO artifact.

The program is traced from a CPU copy of the eval-mode decoder on its plain
routes (no banded-attention kernel, no query chunking: the same function,
and no branch on a symbolic length).  With ``dynamic=True`` the batch, mel
length and context length are symbolic, the lengths bounded by the
positional tables (``cfg.max_mel_positions``, ``cfg.max_ctx_positions``): a
longer input is refused when the program is called.  ``dynamic=False``
fixes (1, 200, 100), as the JAX package's static export does.

A ``.pt2`` is read by the torch release that wrote it.

``export_tflite`` writes the same forward at one static shape as a TFLite
flatbuffer with the JAX package's signature (x_t float32, t, sem_idx and
step_idx int32, bound by name), which a stock ``tf.lite.Interpreter`` runs
on an edge CPU.  The port writes it itself: ``utils/tflite_lower.py`` lowers
the static program to TFLite builtins and ``utils/tflite_surgery.py`` writes
the flatbuffer, so neither TensorFlow nor JAX is needed to export.
``load_tflite`` runs an artifact and needs TensorFlow; it is imported there
only.
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


TFLITE_MODES = ("", "weight_int8", "dynamic")


def export_tflite(
    cfg: CFG,
    decoder,
    out_path: str,
    batch: int = 1,
    t_frames: int = 200,
    s_tokens: int = 100,
    quantize: str = "",
    representative_batches=None,
) -> str:
    """Serialize the decoder forward as a TFLite flatbuffer; returns the path.

    Inputs (x_t [B,T,n_mels] float32, t [B] int32, sem_idx [B,S] int32,
    step_idx [B] int32) -> prediction [B,T,n_mels] float32.  TFLite shapes
    are static: export one flatbuffer per deployment shape.  The positional
    tables go in sliced to T and S.

    ``quantize``:
      - "": the float32 graph;
      - "weight_int8": the shipping edge mode.  The graph of the
        dequantized weights of ``utils/quantize.py`` (the sensitive tensors
        stay float32) is exported, then ``rewrite_weights_int8`` stores
        every int8 weight the graph uses as int8 + DEQUANTIZE, as the JAX
        package does after its converter.  The outputs are those of the
        dequantized decoder; a used weight left float32 raises;
      - "dynamic": the TFLite converter's dynamic-range pass
        (``tflite_surgery.quantize_dynamic_range``): int8 weights and float
        activations, every large FULLY_CONNECTED/CONV_2D weight included,
        the sensitive ones too; kept for comparison, not shipping;
      - "int8": the calibrated full-integer mode is not ported and raises
        NotImplementedError.  ``representative_batches`` belongs to it.
    """
    from .tflite_lower import lower_decoder
    from .tflite_surgery import quantize_dynamic_range, rewrite_weights_int8, write_model

    if quantize == "int8":
        raise NotImplementedError(
            "export_tflite(quantize='int8'), the calibrated full-integer mode, is not ported: "
            "the JAX package's own artifact in that mode aborts a stock interpreter at invoke "
            "(QUANT_r05.json, tflite_full_int8_mode_status); the supported quantized mode is "
            "'weight_int8'")
    if quantize not in TFLITE_MODES:
        raise ValueError(f"quantize must be '', 'dynamic', 'int8' or 'weight_int8', "
                         f"got {quantize!r}")
    qflat = None
    if quantize == "weight_int8":
        from ..models import EdgeDiffusionDecoder
        from .quantize import dequantize_decoder_params, quantize_decoder_params

        qflat = quantize_decoder_params(decoder)
        decoder = EdgeDiffusionDecoder(cfg, use_kernel=False)
        decoder.load_state_dict(dequantize_decoder_params(qflat))
    model, used = lower_decoder(cfg, decoder, batch, t_frames, s_tokens)
    if quantize == "dynamic":
        quantize_dynamic_range(model)
    blob = write_model(model)
    if qflat is not None:
        blob, report = rewrite_weights_int8(blob, qflat)
        left = sorted(set(report["unmatched"]) & set(used))
        if left:
            raise RuntimeError(f"weight_int8: used weights left float32: {left}")
        print(f"weight_int8: {len(report['matched'])} weights int8, "
              f"not in the graph: {report['unmatched']}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(blob)
    print(f"Exported decoder ({len(blob) / 1e6:.2f} MB TFLite) -> {out_path}")
    return out_path


def synthetic_representative_batches(
    cfg: CFG, batch: int, t_frames: int, s_tokens: int, n: int = 16, seed: int = 0
):
    """Calibration batches matched to the denoise-loop input distribution
    (the JAX package's draws): x_t unit-gaussian, timesteps uniform over the
    schedule, sem_idx uniform over the effective codebook, step_idx i % 4."""
    import numpy as np

    rs = np.random.RandomState(seed)
    codes = cfg.effective_codebook_size()
    out = []
    for i in range(n):
        out.append(
            (
                rs.randn(batch, t_frames, cfg.n_mels).astype(np.float32),
                rs.randint(0, cfg.diff_steps, (batch,)).astype(np.int32),
                rs.randint(0, codes, (batch, s_tokens)).astype(np.int32),
                np.full((batch,), i % 4, np.int32),
            )
        )
    return out


def load_tflite(path: str):
    """Load a TFLite decoder; returns ``run(x_t, t, sem_idx, step_idx)``.

    ``tf.lite.Interpreter`` with the inputs bound BY NAME: ``t`` and
    ``step_idx`` share shape and dtype, so a positional binding could swap
    them silently.  Names like ``serving_default_x_t:0`` are accepted; a name
    that matches two inputs, or inputs that match none, raise ValueError.
    Needs TensorFlow (an ImportError without it); nothing stands in for it.
    """
    import numpy as np
    import tensorflow as tf

    interp = tf.lite.Interpreter(model_path=path)
    interp.allocate_tensors()
    inputs = interp.get_input_details()
    output = interp.get_output_details()[0]

    def _bind(names):
        by_name = {}
        for detail in inputs:
            base = detail["name"].split(":")[0]
            for want in names:
                if base == want or base.endswith("_" + want):
                    if want in by_name:
                        raise ValueError(
                            f"ambiguous tflite input names: {want!r} matches both "
                            f"{by_name[want]['name']!r} and {detail['name']!r}")
                    by_name[want] = detail
                    break
        if len(by_name) == len(names):
            return [by_name[k] for k in names]
        raise ValueError(
            "tflite input names unrecognizable - cannot bind by name "
            f"(wanted {names}, got {[d['name'] for d in inputs]}); re-export with "
            "export_tflite")

    names = ("x_t", "t", "sem_idx", "step_idx")

    def run(x_t, t, sem_idx, step_idx):
        vals = [np.asarray(x_t, np.float32), np.asarray(t, np.int32),
                np.asarray(sem_idx, np.int32), np.asarray(step_idx, np.int32)]
        for detail, val in zip(_bind(names), vals):
            interp.set_tensor(detail["index"], val)
        interp.invoke()
        return interp.get_tensor(output["index"])

    return run
