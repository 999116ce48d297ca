"""Data pipeline: LJSpeech reading, collation, loading, precomputed features
(counterpart of ``edge_diffusion_tts_tpu/data``, numpy and threads as there)."""

from .collate import Collate, crop_or_pad, resample_np
from .dataset import LJSpeechDataset, ensure_ljspeech, load_wav
from .loader import DataLoader
from .native import NativeCollate, native_available, read_wav_native
from .precomputed import (
    CollatePrecomputed,
    LJSpeechPrecomputedDataset,
    precompute_hubert_features,
)

__all__ = [
    "Collate",
    "CollatePrecomputed",
    "DataLoader",
    "LJSpeechDataset",
    "LJSpeechPrecomputedDataset",
    "NativeCollate",
    "crop_or_pad",
    "native_available",
    "read_wav_native",
    "ensure_ljspeech",
    "load_wav",
    "precompute_hubert_features",
    "resample_np",
]
