"""LJSpeech dataset reader with the deterministic split (counterpart of
``edge_diffusion_tts_tpu/data/dataset.py``, the same code).

metadata.csv ids, a 5%% validation split drawn from a seed-1234 permutation,
an optional max_samples subsample with seed 42, wavs read with
scipy.io.wavfile (PCM and float formats), stereo -> mono by the mean.  It
never downloads: a missing corpus raises with instructions.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def ensure_ljspeech(root: str) -> str:
    """Verify the LJSpeech-1.1 layout exists; raise with instructions if not."""
    meta = os.path.join(root, "metadata.csv")
    wavs = os.path.join(root, "wavs")
    if not (os.path.isfile(meta) and os.path.isdir(wavs)):
        raise FileNotFoundError(
            f"LJSpeech not found at {root}. Download and extract:\n"
            "  wget https://data.keithito.com/data/speech/LJSpeech-1.1.tar.bz2\n"
            f"  tar -xjf LJSpeech-1.1.tar.bz2 -C {os.path.dirname(root) or '.'}"
        )
    return root


def resolve_ljspeech_dir(ljspeech_dir: str, data_root: str) -> str:
    """An existing ``cfg.ljspeech_dir`` wins; otherwise derive the dataset
    location from ``cfg.data_root`` (``<data_root>/LJSpeech-1.1``), raising
    with download instructions when absent."""
    if os.path.isdir(ljspeech_dir):
        return ljspeech_dir
    return ensure_ljspeech(os.path.join(data_root, "LJSpeech-1.1"))


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:  # stereo -> mono mean
        wav = wav.mean(axis=1)
    return wav, int(sr)


class LJSpeechDataset:
    """Iterable/indexable LJSpeech split.

    ``split`` is "train" or "val"; the val split is the first ``val_frac`` of
    a seed-1234 permutation of all ids, as in the JAX package, so train/val
    membership matches it utterance for utterance.
    """

    def __init__(
        self,
        root: str,
        split: str = "train",
        max_samples: Optional[int] = None,
        val_frac: float = 0.05,
    ):
        self.root = ensure_ljspeech(root)
        with open(os.path.join(root, "metadata.csv"), encoding="utf-8") as f:
            ids = [line.split("|", 1)[0] for line in f if line.strip()]

        perm = np.random.RandomState(1234).permutation(len(ids))
        # No max(1, ...): int(len * val_frac) exactly, and val_frac=0.0 means
        # an empty val split (precompute_hubert_features covers every
        # utterance through it).
        n_val = int(len(ids) * val_frac)
        if split == "val":
            keep = perm[:n_val]
        else:
            keep = perm[n_val:]
        self.ids: List[str] = [ids[i] for i in sorted(keep)]

        if max_samples is not None and max_samples < len(self.ids):
            sub = np.random.RandomState(42).choice(
                len(self.ids), size=max_samples, replace=False
            )
            self.ids = [self.ids[i] for i in sorted(sub)]

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        path = os.path.join(self.root, "wavs", self.ids[i] + ".wav")
        return load_wav(path)
