"""Precomputed-HuBERT-feature dataset and its producer (counterpart of
``edge_diffusion_tts_tpu/data/precomputed.py``).

Per-utterance cached HuBERT features let training skip the frozen 95M-param
forward.  ``precompute_hubert_features`` runs a torch callable (HuBERT to the
wanted layer) once per utterance and saves ``.npy``.  Cropping keeps
waveform and feature spans aligned through the 320-sample HuBERT hop.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..config import CFG, hubert_num_frames
from .collate import resample_np
from .dataset import LJSpeechDataset

HUBERT_HOP = 320
FEATURES_DIRNAME = "hubert_features"


class LJSpeechPrecomputedDataset(LJSpeechDataset):
    """LJSpeech items as (wav_16k, hubert_features) pairs.

    Features are read from ``<root>/hubert_features/<id>.npy`` ([S, 768]
    float32 or float16).  Raises with the producer command if missing.
    """

    def __init__(self, root: str, split: str = "train", **kw):
        super().__init__(root, split, **kw)
        self.feat_dir = os.path.join(root, FEATURES_DIRNAME)
        if not os.path.isdir(self.feat_dir):
            raise FileNotFoundError(
                f"{self.feat_dir} not found. Produce it with "
                "edge_diffusion_tts_tpu_torch.data.precompute_hubert_features"
            )

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        wav, sr = super().__getitem__(i)
        if sr != 16000:
            wav = resample_np(wav, sr, 16000)
        feats = np.load(os.path.join(self.feat_dir, self.ids[i] + ".npy"))
        return wav, feats.astype(np.float32)


class CollatePrecomputed:
    """Crop wav + the matching HuBERT-feature span, pad to batch max.

    The crop start is floored to the HuBERT hop so feature frames align
    exactly with the waveform window.
    """

    def __init__(self, cfg: CFG, deterministic: bool = False, seed: int = 0):
        self.cfg = cfg
        self.deterministic = deterministic
        self.rng = np.random.default_rng(seed)

    def __call__(self, batch: Sequence[Tuple[np.ndarray, np.ndarray]]) -> dict:
        cfg = self.cfg
        seg = cfg.segment_len
        n_frames = hubert_num_frames(seg)
        wav_out = np.zeros((len(batch), seg), dtype=np.float32)
        feat_out = np.zeros((len(batch), n_frames, batch[0][1].shape[-1]), np.float32)
        for i, (wav, feats) in enumerate(batch):
            n = wav.shape[0]
            if n > seg and not self.deterministic:
                start = int(self.rng.integers(0, (n - seg) // HUBERT_HOP + 1))
                start *= HUBERT_HOP
            else:
                start = 0
            w = wav[start : start + seg]
            wav_out[i, : w.shape[0]] = np.clip(w, -1.0, 1.0)
            f0 = start // HUBERT_HOP
            f = feats[f0 : f0 + n_frames]
            feat_out[i, : f.shape[0]] = f
        return {"wav": wav_out, "hubert_features": feat_out}


def precompute_hubert_features(
    root: str,
    hubert_apply,
    dtype=np.float16,
    limit: Optional[int] = None,
):
    """Run HuBERT over every LJSpeech utterance and cache layer features.

    ``hubert_apply(wav)`` takes a float32 numpy [1, T] at 16 kHz and returns
    [1, S, hidden] (a tensor or an array), already at the wanted hidden
    layer, for example the encoder's ``extract_hubert`` on the card under
    ``torch.no_grad()``.  Utterances are processed one at a time (lengths
    vary); each is saved as ``<id>.npy`` in ``dtype``.
    """
    ds = LJSpeechDataset(root, split="train", val_frac=0.0)
    out_dir = os.path.join(root, FEATURES_DIRNAME)
    os.makedirs(out_dir, exist_ok=True)
    ids = ds.ids[:limit] if limit else ds.ids
    for n, uid in enumerate(ids):
        out_path = os.path.join(out_dir, uid + ".npy")
        if os.path.exists(out_path):
            continue
        wav, sr = ds[n]  # ids is a prefix of ds.ids: loop index == ds index
        if sr != 16000:
            wav = resample_np(wav, sr, 16000)
        feats = hubert_apply(wav[None, :])
        if hasattr(feats, "detach"):
            feats = feats.detach().cpu().numpy()
        feats = np.asarray(feats)[0]
        np.save(out_path, feats.astype(dtype))
        if (n + 1) % 100 == 0:
            print(f"precompute_hubert: {n + 1}/{len(ids)}")
    return out_dir
