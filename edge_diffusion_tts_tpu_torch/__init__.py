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
             timing and profiling (speed), the decoder's .pt2 export,
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

Not ported: the JAX package's TFLite export and utils/tflite_surgery.py
(they need jax2tf and TensorFlow).
"""

from .config import CFG, TrainPhase, hubert_num_frames

__version__ = "0.1.0"

__all__ = ["CFG", "TrainPhase", "hubert_num_frames"]
