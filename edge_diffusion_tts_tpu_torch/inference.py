"""EdgeInference: few-step mel generation (counterpart of
``edge_diffusion_tts_tpu/inference.py``).

``generate_mel(sem_idx, num_steps)``: semantic tokens [B, S] -> normalized
log-mel [B, 2S, n_mels], by eta=0 DDIM (or DPM-Solver++) over
EdgeDiffusionDecoder.  ``generate_from_audio(wav)``: a 16 kHz reference wav
-> tokens through the ``SemanticEncoder`` (HuBERT layer 9 + projection +
FSQ) -> ``generate_mel``; the encoder routes its own conv frontend
(models/hubert.py: the conv-frontend kernel where it takes the stack at the
encoder's dtype, the modules elsewhere).  Two backends:

- ``"eager"`` (the JAX package's ``"xla"``): the module loop, one decoder
  forward per step; long sequences route their windowed self-attention to
  the banded-attention kernel as the config says;
- ``"fused"``: the whole DDIM loop in one call of the fused CUDA kernel
  sequence (ops/fused_denoise.py), for any AdaLN config, the depthwise
  pre-net (``use_depthwise``, set by every config under configs/)
  included, at ``cfg.compute_dtype`` (the weights packed at it once).  It
  runs the kernels or raises; it never falls back to the module loop.  An
  encoder runs at the dtype it was built at: a configuration's encoder is
  built at its compute dtype (``training.train.init_models``).

Masked (variable-length batch) calls always take the module loop, as in the
JAX package.  The entry point runs on CUDA unless ``device`` names another
device, and raises when there is no card.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import CFG, resolve_device, torch_dtype
from .ops.fused_denoise import fused_generate_mel, pack_decoder_weights, start_noise
from .ops.fused_frontend import fast_encode
from .schedule import DiffusionSchedule, DPMSolverPP, ddim_sample
from .utils.speed import span


class EdgeInference:
    """Few-step (1-4) inference engine around an ``EdgeDiffusionDecoder``.

    ``sampler="dpmpp"`` serves with DPM-Solver++ (order ``solver_order``); it
    reads the decoder as a v- (or x0-) prediction model, so it needs
    ``prediction != "eps"``.  The fused backend implements DDIM only and
    packs the decoder's weights once, when the object is built.  ``encoder``
    (a ``SemanticEncoder``) enables ``generate_from_audio``.
    """

    def __init__(
        self,
        cfg: CFG,
        schedule: DiffusionSchedule,
        decoder,
        prediction: str = "eps",
        backend: str = "eager",
        sampler: str = "ddim",
        solver_order: int = 2,
        device=None,
        encoder=None,
    ):
        if backend not in ("eager", "fused"):
            raise ValueError(f"unknown backend {backend!r}")
        if sampler not in ("ddim", "dpmpp"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if sampler == "dpmpp" and prediction == "eps":
            raise ValueError(
                "DPM-Solver++ serving expects a v-prediction (v2-recipe) "
                "model; train with use_v_prediction or use sampler='ddim'"
            )
        if sampler == "dpmpp" and backend == "fused":
            raise ValueError("the fused backend implements DDIM only")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.schedule = schedule.to(self.device)
        self.decoder = decoder.to(self.device).eval()
        self.prediction = prediction
        self.backend = backend
        self.sampler = sampler
        self.solver_order = solver_order
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        self.fused_weights = (
            pack_decoder_weights(self.decoder, self.compute_dtype) if backend == "fused" else None
        )
        self.encoder = None if encoder is None else encoder.to(self.device).eval()

    def _sample(self, model_fn, x_T: torch.Tensor, num_steps: int) -> torch.Tensor:
        if self.sampler == "dpmpp":
            solver = DPMSolverPP(
                self.schedule, order=self.solver_order,
                predict_x0=self.prediction == "x0",
            )
            max_t = min(self.cfg.max_timestep, self.schedule.T - 1)
            return solver.sample(model_fn, x_T, num_steps, max_t=max_t)
        return ddim_sample(
            self.schedule, model_fn, x_T, num_steps, prediction=self.prediction
        )

    @torch.inference_mode()
    def generate_mel(
        self,
        sem_idx,
        num_steps: Optional[int] = None,
        temperature: float = 1.0,
        generator: Optional[torch.Generator] = None,
        sem_mask=None,
        x_T=None,
    ) -> torch.Tensor:
        """Semantic tokens [B, S] -> normalized log-mel [B, 2S, n_mels].

        The start noise is ``normal * temperature`` drawn from ``generator``
        (seeded 0 when None), or ``x_T`` [B, 2S, n_mels] used as given.
        ``sem_mask`` ([B, S] bool, True = real token) enables exact
        variable-length batching: row i's frames ``[:2 * sem_mask[i].sum()]``
        match that row's unpadded generation.  Returns the final x0 (DDIM) or
        x (DPM-Solver++).
        """
        num_steps = num_steps if num_steps is not None else self.cfg.inference_steps
        if num_steps <= 0:
            raise ValueError(f"num_steps must be positive, got {num_steps}")
        sem_idx = torch.as_tensor(sem_idx, device=self.device).long()
        B, S = sem_idx.shape
        if x_T is None:
            x_T = start_noise(sem_idx, self.cfg.n_mels, temperature, generator)
        else:
            x_T = torch.as_tensor(x_T, dtype=torch.float32, device=self.device)
            if tuple(x_T.shape) != (B, 2 * S, self.cfg.n_mels):
                raise ValueError(f"x_T must be {(B, 2 * S, self.cfg.n_mels)}, "
                                 f"got {tuple(x_T.shape)}")

        if sem_mask is not None:
            sem_mask = torch.as_tensor(sem_mask, device=self.device).bool()
            mel_mask = sem_mask.repeat_interleave(2, dim=1)  # 50 Hz -> 100 Hz

            def masked_fn(x, t, step_idx):
                return self.decoder(x, t, sem_idx=sem_idx, step_idx=step_idx,
                                    sem_mask=sem_mask, mel_mask=mel_mask)

            return self._sample(masked_fn, x_T, num_steps)

        if self.backend == "fused":
            return fused_generate_mel(
                self.cfg, self.schedule, self.decoder, sem_idx, x_T, num_steps,
                self.prediction, weights=self.fused_weights, compute_dtype=self.compute_dtype,
            )

        def model_fn(x, t, step_idx):
            return self.decoder(x, t, sem_idx=sem_idx, step_idx=step_idx)

        return self._sample(model_fn, x_T, num_steps)

    @torch.inference_mode()
    def generate_from_audio(
        self,
        wav,
        num_steps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        x_T=None,
        temperature: float = 1.0,
    ) -> torch.Tensor:
        """Reference wav [T] or [B, T] at 16 kHz -> normalized log-mel.

        The tokens come from ``fast_encode`` (the encoder's ``encode``, on
        its own frontend route); then ``generate_mel(tokens, num_steps,
        temperature, generator, x_T=x_T)``.
        """
        if self.encoder is None:
            raise ValueError("EdgeInference was constructed without an encoder")
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        if wav.dim() == 1:
            wav = wav[None, :]
        with span("prep:encode"):
            sem_idx = fast_encode(self.encoder, wav)
        return self.generate_mel(sem_idx, num_steps, temperature=temperature,
                                 generator=generator, x_T=x_T)
