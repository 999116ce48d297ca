"""Configuration for the PyTorch/CUDA port of Edge Diffusion TTS.

Field for field the same record as ``edge_diffusion_tts_tpu/config.py`` (same
names, defaults, derived properties and JSON layout), so one JSON file
configures either package.  The port keeps its own copy: it imports nothing
of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional


class TrainPhase(Enum):
    """Training phases of the 3-stage recipe."""

    DIFFUSION = "diffusion"
    PROGRESSIVE = "progressive"
    CONSISTENCY = "consistency"


def set_seed(seed: int, device=None):
    """Seed python's, numpy's and torch's global generators (module
    initialization draws from torch's) and return a fresh ``torch.Generator``
    on ``device`` seeded with ``seed``: the one stream every training draw
    comes from, where the JAX package returns a PRNG key."""
    import random

    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


DTYPES = ("float32", "bfloat16")  # the compute_dtype / param_dtype values the port takes


def torch_dtype(name):
    """``CFG.compute_dtype`` / ``param_dtype`` ("float32" or "bfloat16", or
    that torch dtype itself) -> the torch dtype; anything else raises."""
    import torch

    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if isinstance(name, torch.dtype) and name in table.values():
        return name
    if isinstance(name, str) and name in table:
        return table[name]
    raise ValueError(f"the port computes and stores parameters in one of {DTYPES}, not {name!r}")


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means the CUDA card, and raises when there is none: the port's
    entry points never fall back to the CPU unless the caller asks for it.
    """
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclass
class CFG:
    """Main configuration record (see the JAX package's CFG for field notes)."""

    # ===== SYSTEM =====
    seed: int = 42
    device: str = "auto"
    out_dir: str = "run_edge_diffusion"
    run_name: str = field(default_factory=lambda: time.strftime("run_%Y%m%d_%H%M%S"))

    # ===== DATA =====
    data_root: str = "./data"
    ljspeech_dir: str = "./data/LJSpeech-1.1"
    sample_rate: int = 16000
    orig_sr: int = 22050
    segment_secs: float = 2.0
    segment_len: int = 32000  # derived in __post_init__
    num_workers: int = 1
    pin_memory: bool = False

    # ===== MEL SPECTROGRAM =====
    n_fft: int = 1024
    hop_length: int = 160
    win_length: int = 1024
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float = 8000.0

    # ===== HUBERT + VQ/FSQ =====
    hubert_id: str = "facebook/hubert-base-ls960"
    hubert_layer: int = 9
    semantic_dim: int = 128
    codebook_size: int = 512
    vq_commit: float = 1.0
    use_fsq: bool = True
    fsq_levels: List[int] = field(default_factory=lambda: [4, 4, 3, 3, 2, 2, 2, 2])

    # ===== EDGE-OPTIMIZED MODEL =====
    hidden: int = 160
    layers: int = 4
    heads: int = 4
    ffn_mult: int = 2
    use_depthwise: bool = False
    # Route windowed self-attention through the banded-attention kernel
    # (ops/window_attention.py) once the mel length reaches
    # pallas_min_seq_len.  The field names are shared with the JAX package so
    # one JSON file serves both; the threshold has not been re-measured on
    # the GPU.
    use_flash_attn: bool = True
    pallas_min_seq_len: int = 3000
    cross_q_chunk: int = 512
    band_q_chunk: int = 0
    use_adaln: bool = True
    dropout: float = 0.2
    attn_window_size: int = 64
    max_mel_positions: int = 1000
    max_ctx_positions: int = 512

    # ===== DIFFUSION SCHEDULE =====
    diff_steps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 2e-2
    use_v_prediction: bool = True
    max_timestep: int = 950

    # ===== TRAINING PHASE =====
    phase: TrainPhase = TrainPhase.DIFFUSION

    diffusion_epochs: int = 50
    progressive_epochs_per_halving: int = 5
    progressive_target_steps: int = 4
    progressive_exact: bool = False
    consistency_epochs: int = 10
    consistency_weight: float = 1.0
    token_align_weight: float = 0.1
    consistency_exact: bool = False

    # ===== TRAINING =====
    batch_size: int = 4
    grad_accumulation: int = 8
    lr: float = 2e-4
    lr_consistency: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    cfg_dropout: float = 0.1
    warmup_frac: float = 0.05
    steps_per_dispatch: int = 1

    # ===== PARALLELISM =====
    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    mesh_shape: Optional[List[int]] = None
    mesh_axis_names: List[str] = field(default_factory=lambda: ["data", "model"])
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0

    best_min_delta: float = 0.0
    validate_every_epochs: int = 1

    # ===== LOGGING / EVAL =====
    log_every_steps: int = 50
    val_every_steps: int = 200
    plot_every_steps: int = 100
    val_batches: int = 4
    ckpt_every_steps: int = 500

    # ===== INFERENCE =====
    inference_steps: int = 4

    # ===== CHECKPOINT =====
    ckpt_path: str = ""

    def __post_init__(self):
        # Segment length floored to the HuBERT hop (320 samples @16 kHz).
        self.segment_len = int(self.sample_rate * self.segment_secs)
        lcm = 320
        self.segment_len = (self.segment_len // lcm) * lcm
        if not self.ckpt_path:
            self.ckpt_path = os.path.join(self.out_dir, "checkpoint_latest")

    # -- derived sizes ---------------------------------------------------------

    @property
    def segment_mel_frames(self) -> int:
        """Mel frames produced by a segment (center-pad formula)."""
        return self.segment_len // self.hop_length + 1

    @property
    def segment_sem_frames(self) -> int:
        """Semantic (HuBERT) frames produced by a segment (hop 320, no pad)."""
        return hubert_num_frames(self.segment_len)

    @property
    def fsq_codebook_size(self) -> int:
        n = 1
        for l in self.fsq_levels:
            n *= l
        return n

    def effective_codebook_size(self) -> int:
        """Codebook size actually produced by the configured quantizer."""
        return self.fsq_codebook_size if self.use_fsq else self.codebook_size

    # -- environment ----------------------------------------------------------------

    def setup_environment(self, device=None):
        """Seed the generators and create the output dirs; returns the step
        generator on ``device`` (``set_seed``)."""
        os.makedirs(self.data_root, exist_ok=True)
        os.makedirs(self.out_dir, exist_ok=True)
        return set_seed(self.seed, device)

    def print_config(self, device=None):
        print("=" * 60)
        print("   EDGE-OPTIMIZED DIFFUSION TTS (PyTorch/CUDA)")
        print("=" * 60)
        print(f"Device: {resolve_device(device) if self.device == 'auto' else self.device}")
        print(f"Segment: {self.segment_len} samples "
              f"({self.segment_len / self.sample_rate:.2f}s)")
        print(f"Model hidden: {self.hidden} (edge-optimized)")
        print(f"Target inference steps: {self.inference_steps}")
        print("=" * 60)

    def get_run_dir(self) -> str:
        return os.path.join(self.out_dir, self.run_name)

    # -- serialization -------------------------------------------------------------

    @classmethod
    def from_dict(cls, d: dict) -> "CFG":
        """Build a CFG from a dict, ignoring unknown keys."""
        d = dict(d)
        if "phase" in d and isinstance(d["phase"], str):
            d["phase"] = TrainPhase(d["phase"])
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_dict(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, TrainPhase):
                v = v.value
            d[f.name] = v
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "CFG":
        return cls.from_dict(json.loads(s))


def hubert_num_frames(num_samples: int) -> int:
    """Number of frames HuBERT-base emits for a waveform of given length.

    Conv strides [5,2,2,2,2,2,2] with kernels [10,3,3,3,3,2,2], no padding:
    an effective hop of 320 samples with a receptive field of 400.
    """
    n = num_samples
    for k, s in zip([10, 3, 3, 3, 3, 2, 2], [5, 2, 2, 2, 2, 2, 2]):
        n = (n - k) // s + 1
    return n
