"""PyTorch/CUDA port of the Edge Diffusion TTS framework for the NVIDIA H100.

The JAX package ``edge_diffusion_tts_tpu`` is the reference; this package
imports nothing of it (nor JAX).  Module names match their JAX counterparts:

  config     CFG dataclass, device resolution
  schedule   cosine diffusion tables, DDIM/DDPM steps, DPM-Solver++
  layers     attention (windowed/MLA/cross), AdaLN, SwiGLU, embeddings, convs
  models     EdgeDiffusionDecoder; SemanticEncoder (HuBERT, FSQ, VQ)
  ops        hand-written CUDA kernels (csrc/) with their plain versions
  inference  few-step EdgeInference (eager and fused backends, audio in)
  weights    JAX param trees and HF HuBERT state dicts -> port state dicts
"""

from .config import CFG, TrainPhase, hubert_num_frames

__version__ = "0.1.0"

__all__ = ["CFG", "TrainPhase", "hubert_num_frames"]
