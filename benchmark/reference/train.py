"""The diffusion training step of the edge TTS in plain PyTorch.

One data step of the upstream's phase-1 objective on a batch of 16 kHz wavs
with given timesteps ``t`` and noise: the log-mel (n_fft 1024, hop 160,
periodic Hann, reflect-centred, power 2, HTK mel without norm, log of the
power clamped at 1e-5), normalized per utterance over time (ddof 1, std
clamped at 1e-5); the frozen HuBERT to layer 9; the trained projection and
FSQ (straight-through); the token-alignment loss (token embeddings against
the stopped projected features, weight ``token_align_weight``); the
classifier-free drop of the features (``cfg_dropout``, one draw per row);
then the v-prediction MSE of the decoder (dropout ``dropout``).  The update
is optax's clip_by_global_norm -> adamw(b1 0.9, b2 0.999, eps 1e-8, weight
decay on every trained tensor) at the warmup-cosine learning rate of the
0-based update count.

Every draw (the feature drop, the decoder's dropout masks) comes from the
one generator handed in, in the forward's order.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import decoder as dec
from . import hubert as hub
from .precision import Ops
from .schedule import cosine_tables, warmup_cosine


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int, sr: int) -> np.ndarray:
    """Triangular HTK mel filters [n_freqs, n_mels] (no norm), built in float64."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    freqs = np.linspace(0.0, sr // 2, n_freqs)
    mels = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    pts = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[None, :-1]
    up = slopes[:, 2:] / diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def normalized_log_mel(cfg: dict, wav: torch.Tensor) -> torch.Tensor:
    """[B, N] -> normalized log-mel [B, frames, n_mels]."""
    n_fft, hop, win = cfg["n_fft"], cfg["hop_length"], cfg["win_length"]
    window = torch.hann_window(win, periodic=True, dtype=torch.float32, device=wav.device)
    spec = torch.stft(wav, n_fft, hop, win, window, center=True, pad_mode="reflect",
                      return_complex=True)
    power = (spec.real.square() + spec.imag.square()).transpose(1, 2)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, cfg["f_min"], cfg["f_max"],
                                         cfg["n_mels"], cfg["sample_rate"])).to(wav.device)
    mel = torch.log((power @ fb).clamp(min=1e-5))
    mean = mel.mean(1, keepdim=True)
    std = mel.std(1, keepdim=True, correction=1).clamp(min=1e-5)
    return (mel - mean) / std


def trained_names(cfg: dict, h: dict) -> List[str]:
    """The trained tensors, named as the port's optimizer names them."""
    enc = [f"encoder.{n}" for n in hub.encoder_shapes(cfg, h) if not n.startswith("hubert.")]
    return enc + [f"decoder.{n}" for n in dec.parameter_shapes(cfg)]


def diffusion_loss(cfg: dict, h: dict, frozen, trained, batch, generator, ops: Ops,
                   hubert_rows: int = 16) -> torch.Tensor:
    """The phase-1 loss of one batch {"wav", "t", "noise"}; ``frozen`` holds
    the HuBERT weights, ``trained`` the rest (``encoder.`` / ``decoder.``
    names)."""
    wav, t, noise = batch["wav"], batch["t"], batch["noise"]
    E = {n[len("encoder."):]: p for n, p in trained.items() if n.startswith("encoder.")}
    D = {n[len("decoder."):]: p for n, p in trained.items() if n.startswith("decoder.")}
    with torch.no_grad():
        mel_n = normalized_log_mel(cfg, wav)
        layer = min(cfg["hubert_layer"], h["num_layers"])
        hid = torch.cat([hub.layer(frozen, h, wav[i:i + hubert_rows], ops, layer)
                         for i in range(0, wav.shape[0], hubert_rows)])
    fsq = hub.FSQ(cfg["fsq_levels"], wav.device)
    u = fsq.bounded(E, hub.project(E, hid, ops), ops)
    codes = fsq.codes(u)
    z_low = u + ((codes / fsq.half - 1.0) - u).detach()
    z_q = ops.linear(z_low, E["vq.proj_up.weight"], E["vq.proj_up.bias"])
    tokens = fsq.tokens(codes)
    align = (dec.token_context(D, tokens)
             - dec.feature_context(D, z_q.detach(), ops).detach()).square().mean()
    B = wav.shape[0]
    drop = torch.bernoulli(torch.full((B, 1, 1), float(cfg["cfg_dropout"]), device=wav.device),
                           generator=generator).bool()
    z_q = torch.where(drop, 0.0, z_q)
    tab = cosine_tables(cfg["diff_steps"])
    sab = torch.from_numpy(tab["sqrt_ab"]).to(wav.device)[t][:, None, None]
    s1m = torch.from_numpy(tab["sqrt_1mab"]).to(wav.device)[t][:, None, None]
    x_t = sab * mel_n + s1m * noise
    pred = dec.forward(D, cfg, x_t, t, torch.zeros_like(t), dec.feature_context(D, z_q, ops), ops,
                       dec.Dropout(cfg["dropout"], generator))
    target = sab * noise - s1m * mel_n if cfg["use_v_prediction"] else noise
    return (pred - target).square().mean() + cfg["token_align_weight"] * align


class AdamW:
    """optax's clip_by_global_norm(grad_clip) -> adamw, in float32."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], total_updates: int):
        if int(cfg["grad_accumulation"]) != 1:
            raise ValueError("the reference updates after every data step (grad_accumulation 1)")
        self.params = params
        self.lr = warmup_cosine(float(cfg["lr"]), total_updates, float(cfg["warmup_frac"]))
        self.clip, self.wd = float(cfg["grad_clip"]), float(cfg["weight_decay"])
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Apply one update; returns the clipped gradients."""
        norm = torch.stack([g.square().sum() for g in grads.values()]).sum().sqrt()
        g = {n: x if bool(norm < self.clip) else (x / norm) * self.clip for n, x in grads.items()}
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        step = -self.lr(self.count - 1)
        for n, p in self.params.items():
            self.mu[n] = (1 - self.b1) * g[n] + self.b1 * self.mu[n]
            self.nu[n] = (1 - self.b2) * g[n].square() + self.b2 * self.nu[n]
            u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + self.eps) + self.wd * p
            p.add_(step * u)
        return g


def run_steps(cfg: dict, h: dict, weights: Dict[str, torch.Tensor], batches, generator,
              total_updates: int, ops: Ops) -> dict:
    """The first ``len(batches)`` data steps from ``weights`` (the encoder's
    names under ``encoder.``, the decoder's under ``decoder.``).  Returns
    ``{"losses": [...], "first_grad": {name: clipped gradient of step 1},
    "change": {name: parameters after the last step minus before}}``."""
    frozen = {n[len("encoder."):]: w for n, w in weights.items()
              if n.startswith("encoder.hubert.")}
    names = trained_names(cfg, h)
    trained = {n: weights[n].detach().clone().float().requires_grad_(True) for n in names}
    opt = AdamW(cfg, trained, total_updates)
    out = {"losses": [], "first_grad": None}
    for batch in batches:
        loss = diffusion_loss(cfg, h, frozen, trained, batch, generator, ops)
        grads = torch.autograd.grad(loss, list(trained.values()), allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(trained[n]))
                 for n, g in zip(trained, grads)}
        clipped = opt.update(grads)
        out["losses"].append(float(loss.detach()))
        if out["first_grad"] is None:
            out["first_grad"] = {n: g.detach() for n, g in clipped.items()}
    out["change"] = {n: (p.detach() - weights[n].float()) for n, p in trained.items()}
    return out

