"""Demo / sample generation: checkpoint -> few-step mel -> waveform
(counterpart of ``edge_diffusion_tts_tpu/demo.py``).

Load a port checkpoint (``weights.load_checkpoint`` with its encoder),
encode a reference utterance to semantic tokens, generate the mel in N
steps with ``EdgeInference`` (the eager backend, the JAX demo's default; the
hubert-base encoder takes the conv-frontend kernel), denormalize it with the
reference utterance's own mel statistics, and vocode it with the inverse
mel scale and Griffin-Lim.  ``oracle`` runs the wav -> mel -> Griffin-Lim
-> wav round trip instead, which isolates the vocoder's error from the
model's.

Randomness: every draw (the sampling noise, then the Griffin-Lim start
phase) comes from one ``torch.Generator`` seeded with ``seed``, so the same
seed gives another waveform than the JAX package's.

The optional post-filter uses ``noisereduce`` where it is installed, else a
spectral-floor gate (the 20th percentile of each frequency's magnitude over
time, by linear interpolation as ``jnp.percentile`` takes it).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .config import CFG, resolve_device
from .models import HubertConfig
from .ops.mel import MelFrontend, inverse_mel_scale
from .ops.vocoder import griffin_lim
from .utils.audio import denormalize_mel, normalize_mel


def _mel_frontend(cfg: CFG, device) -> MelFrontend:
    return MelFrontend(
        sample_rate=cfg.sample_rate, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        win_length=cfg.win_length, n_mels=cfg.n_mels, f_min=cfg.f_min, f_max=cfg.f_max,
    ).to(device)


def vocode_mel(
    cfg: CFG,
    mel_log: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_iter: int = 100,
    angle: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Log-mel [B, T, n_mels] -> waveform [B, (T-1)*hop] via the inverse mel
    scale + Griffin-Lim, on the mel's device.  The start phase is ``angle``
    where given, else drawn from ``generator``."""
    fe = _mel_frontend(cfg, mel_log.device)
    spec = inverse_mel_scale(torch.exp(mel_log), fe.fbank_pinv)
    wav = griffin_lim(spec, generator, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                      win_length=cfg.win_length, n_iter=n_iter, angle=angle)
    return wav.cpu().numpy()


def denoise_post_filter(wav: np.ndarray, sample_rate: int) -> np.ndarray:
    """noisereduce when installed, else a mild spectral floor gate."""
    try:
        import noisereduce
    except ImportError:
        noisereduce = None
    if noisereduce is not None:
        return noisereduce.reduce_noise(y=wav, sr=sample_rate)
    from .ops.mel import istft, stft_complex

    re, im = stft_complex(torch.as_tensor(np.asarray(wav, np.float32))[None])
    mag = torch.sqrt(re ** 2 + im ** 2)
    floor = torch.quantile(mag, 0.2, dim=1, keepdim=True)
    gain = ((mag - 0.5 * floor) / mag.clamp(min=1e-8)).clamp(0.0, 1.0)
    return istft(re * gain, im * gain, length=wav.shape[-1])[0].numpy()


def oracle_roundtrip(
    cfg: CFG,
    wav: np.ndarray,
    generator: Optional[torch.Generator] = None,
    n_iter: int = 100,
    angle: Optional[torch.Tensor] = None,
    device=None,
) -> np.ndarray:
    """wav -> mel -> Griffin-Lim -> wav (the vocoder-error isolation path),
    on ``device`` (the card unless told otherwise)."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(wav, np.float32), device=device)[None]
    mel_log = _mel_frontend(cfg, device)(x)
    return vocode_mel(cfg, mel_log, generator, n_iter, angle=angle)[0][: wav.shape[-1]]


def _write_wav(path: str, sample_rate: int, wav: np.ndarray) -> None:
    from scipy.io import wavfile

    wavfile.write(path, sample_rate, (np.clip(wav, -1, 1) * 32767).astype(np.int16))


def generate_sample(
    ckpt_path: str,
    wav_path: Optional[str] = None,
    num_steps: int = 4,
    out_path: str = "generated.wav",
    oracle: bool = False,
    post_filter: bool = False,
    seed: int = 0,
    sampler: str = "ddim",
    hubert_cfg: Optional[HubertConfig] = None,
    device=None,
) -> Tuple[np.ndarray, int]:
    """Full demo: load a port checkpoint, generate from a reference wav,
    write the output.  Returns (waveform, sample_rate).

    ``wav_path`` defaults to LJSpeech's LJ001-0010 under ``cfg.ljspeech_dir``.
    Runs on ``device`` (the card unless told otherwise)."""
    from .data import load_wav, resample_np
    from .inference import EdgeInference
    from .models import EdgeDiffusionDecoder, SemanticEncoder
    from .schedule import DiffusionSchedule
    from .weights import load_checkpoint

    device = resolve_device(device)
    cfg, dec_state, ckpt_hubert, enc_state = load_checkpoint(ckpt_path, with_encoder=not oracle)
    generator = torch.Generator(device=device).manual_seed(seed)

    if wav_path is None:
        wav_path = os.path.join(cfg.ljspeech_dir, "wavs", "LJ001-0010.wav")
    wav, sr = load_wav(wav_path)
    if sr != cfg.sample_rate:
        wav = resample_np(wav, sr, cfg.sample_rate)

    if oracle:
        rec = oracle_roundtrip(cfg, wav, generator, device=device)
        _write_wav(out_path, cfg.sample_rate, rec)
        return rec, cfg.sample_rate

    decoder = EdgeDiffusionDecoder(cfg)
    decoder.load_state_dict(dec_state)
    encoder = SemanticEncoder(cfg, hubert_cfg or ckpt_hubert)
    encoder.load_state_dict(enc_state)
    inf = EdgeInference(
        cfg, DiffusionSchedule.create(cfg.diff_steps), decoder,
        # The checkpoint's cfg records the objective; EdgeInference refuses
        # dpmpp with an eps model.
        prediction="v" if cfg.use_v_prediction else "eps",
        sampler=sampler, device=device, encoder=encoder,
    )
    x = torch.as_tensor(wav, device=device)
    mel_n = inf.generate_from_audio(x, num_steps=num_steps, generator=generator)

    # Denormalize with the reference utterance's own mel statistics
    # (training works in normalized-mel space).
    _, mean, std = normalize_mel(_mel_frontend(cfg, device)(x[None]))
    out = vocode_mel(cfg, denormalize_mel(mel_n, mean, std), generator)[0]
    if post_filter:
        out = denoise_post_filter(out, cfg.sample_rate)
    _write_wav(out_path, cfg.sample_rate, out)
    print(f"wrote {out_path} ({out.shape[-1] / cfg.sample_rate:.2f}s)")
    return out, cfg.sample_rate
