"""PyTorch/CUDA port of the Edge Diffusion TTS framework for the NVIDIA H100.

The JAX package ``edge_diffusion_tts_tpu`` is the reference; this package
imports nothing of it (nor JAX).  Module names match their JAX counterparts:

  config     CFG dataclass, device resolution
  schedule   cosine diffusion tables, DDIM/DDPM steps, DPM-Solver++
  layers     attention (windowed/MLA/cross), AdaLN, SwiGLU, embeddings (fixed
             and learned), convs
  models     EdgeDiffusionDecoder; SemanticEncoder (HuBERT, FSQ, VQ)
  ops        hand-written CUDA kernels (csrc/) with their plain versions;
             the DSP (mel, resample, Griffin-Lim vocoder)
  utils      mel normalization, metric logging, divergence guards, plots,
             timing and profiling (speed), the decoder's .pt2 and TFLite
             exports (the flatbuffer written without TensorFlow),
             weight-only int8 (quantize), reference checkpoints (torch_compat)
  data       LJSpeech reading, collation, the threaded loader, native
             ingest, precomputed HuBERT features
  training   train state + optax-exact AdamW, the three phase steps, the
             driver (train, train_v2), checkpoints
  inference  few-step EdgeInference (eager and fused backends, audio in)
  pipeline   long-form chunked generation (LongFormPipeline, ChunkStream)
  serving    micro-batched TCP server and its clients
  weights    JAX param trees, train states and HF HuBERT state dicts ->
             the port's; the port's own inference checkpoints
  demo       one sample from a checkpoint: generate, denormalize, vocode
  bench      4-step mel generation latency on the card
  cli        the command line (edge-tts-torch): train, bench, precompute,
             generate, longform, export, serve, migrate

Not ported: the calibrated full-integer TFLite mode (``export_tflite(
quantize="int8")``), whose JAX artifact aborts a stock interpreter at invoke.
"""

from .config import CFG, TrainPhase, hubert_num_frames, resolve_device, set_seed

__version__ = "0.1.0"


def __getattr__(name):  # the JAX package's lazy top-level API
    if name in ("DiffusionSchedule", "DPMSolverPP", "ddim_sample", "ddpm_sample"):
        from . import schedule

        return getattr(schedule, name)
    if name in ("SemanticEncoder", "EdgeDiffusionDecoder", "VectorQuantizer",
                "FSQ", "FSQEncoder", "HubertEncoder"):
        from . import models

        return getattr(models, name)
    if name == "EdgeInference":
        from .inference import EdgeInference

        return EdgeInference
    if name == "LongFormPipeline":
        from .pipeline import LongFormPipeline

        return LongFormPipeline
    if name in ("MicroBatcher", "serve_tcp", "request_tts"):
        from . import serving

        return getattr(serving, name)
    if name in ("Trainer", "ConsistencyTrainer", "train", "train_v2"):
        from . import training

        # ConsistencyTrainer: the JAX package's alias of Trainer, which holds
        # the EMA teacher and the progressive and consistency losses.
        return training.Trainer if name == "ConsistencyTrainer" else getattr(training, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# The JAX package's names; resolve_device stands for its get_device.
__all__ = [
    "CFG",
    "TrainPhase",
    "resolve_device",
    "set_seed",
    "DiffusionSchedule",
    "SemanticEncoder",
    "EdgeDiffusionDecoder",
    "VectorQuantizer",
    "EdgeInference",
    "MicroBatcher",
    "ConsistencyTrainer",
    "LongFormPipeline",
    "Trainer",
    "__version__",
    "hubert_num_frames",
]
