"""Training and validation steps for all three phases (counterpart of
``edge_diffusion_tts_tpu/training/steps.py``).

A loss closure is ``loss_fn(state, batch, generator) -> (loss, metrics)``
over the state's modules; a step is ``step(state, batch, generator) ->
(state, metrics)``: forward, backward, one optimizer call, the teacher's EMA
where the phase has one, all in place on the state's device.  The mel
frontend runs inside the step on the device.  Every draw of a step (``t``,
the noise, the CFG-drop mask, dropout masks, the VQ dead-code permutation)
comes from the one ``generator`` it is given.  A batch may carry the JAX
package's replay keys (``"t"``, ``"noise"``, ``"step_indices"``, ``"t1"``,
``"t2"``) in place of draws, and here also ``"n"`` (the exact consistency
grid index), so a test can hand both packages the same numbers.

The encode route is fixed when the ``Trainer`` is built, by the rule
``EdgeInference`` follows: the hubert-base conv stack runs on the
conv-frontend kernel (``ops/fused_frontend.py::conv_frontend``, under no
gradient) and hands its features to the frozen HuBERT; any other stack runs
its modules.  A batch with ``"hubert_features"`` skips HuBERT.  The route
runs at the encoder's compute dtype: a bf16 encoder's kernel route takes
the frontend's bf16 variant, which rounds where JAX's frontend kernel rounds
(conv0 in float32, first rounded at its GELU), not where JAX's bf16 module
stack does (the wav cast to bf16 before conv0; ROADMAP Queue C 8).

Metrics are 0-d tensors on the device: nothing here reads the device.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import CFG, resolve_device
from ..ops.fused_frontend import conv_frontend, kernel_serves, pack_frontend_weights
from ..ops.mel import MelFrontend
from ..schedule import DiffusionSchedule, DPMSolverPP, _bcast, ddim_sample
from ..utils.audio import normalize_mel
from ..utils.speed import span
from .state import TrainState, ema_update, freeze_hubert

Batch = Dict[str, torch.Tensor]


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).square().mean()


def _cosine_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean per-sample cosine similarity over flattened [B, -1]."""
    a = a.reshape(a.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    num = (a * b).sum(1)
    den = torch.linalg.vector_norm(a, dim=1) * torch.linalg.vector_norm(b, dim=1) + 1e-8
    return (num / den).mean()


def _bernoulli(p: float, shape, device, generator) -> torch.Tensor:
    """True with probability ``p``; at ``p`` = 0 nothing is drawn."""
    if p <= 0.0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return torch.bernoulli(torch.full(shape, float(p), device=device),
                           generator=generator).bool()


class Trainer:
    """Factory of the phase steps around (encoder, decoder, schedule).

    The modules move to ``device`` (the card unless ``device="cpu"``); the
    frozen HuBERT stays out of every gradient.  ``encode_route`` is
    ``"kernel"`` when the conv-frontend kernel takes the encoder's conv stack
    (``kernel_serves``), else ``"modules"``; ``dtype`` is the encoder's
    compute dtype, which the kernel route runs at.
    """

    def __init__(self, cfg: CFG, encoder, decoder, schedule: DiffusionSchedule, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.encoder = encoder.to(self.device)
        self.decoder = decoder.to(self.device)
        freeze_hubert(self.encoder)
        self.schedule = schedule.to(self.device)
        self.mel_frontend = MelFrontend(
            sample_rate=cfg.sample_rate, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
            win_length=cfg.win_length, n_mels=cfg.n_mels, f_min=cfg.f_min, f_max=cfg.f_max,
        ).to(self.device)
        self.encode_route = "kernel" if kernel_serves(encoder.hubert_cfg) else "modules"
        self.dtype = encoder.dtype
        self.frontend_weights = (pack_frontend_weights(self.encoder.hubert.feature_extractor,
                                                       self.dtype)
                                 if self.encode_route == "kernel" else None)

    # -- shared pieces --------------------------------------------------------

    def put_batch(self, batch) -> Batch:
        """Host batch (numpy or tensors) -> tensors on the device: floats as
        float32, integers as int64."""
        out = {}
        for k, v in batch.items():
            t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            t = t.long() if not t.is_floating_point() else t.float()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def hubert_features(self, state: TrainState, wav: torch.Tensor) -> torch.Tensor:
        """Frozen HuBERT layer features of ``wav`` on the trainer's route,
        under no gradient."""
        with torch.no_grad(), span("train:hubert"):
            conv_feats = None
            if self.encode_route == "kernel":
                conv_feats = conv_frontend(wav.float().contiguous(), self.frontend_weights,
                                           compute_dtype=self.dtype)
            return state.encoder.extract_hubert(wav, conv_feats=conv_feats)

    def _encode(self, state: TrainState, batch: Batch, generator, train: bool):
        """The semantic encoder's 5-tuple on the wav or the precomputed path."""
        feats = batch.get("hubert_features")
        if feats is None:
            feats = self.hubert_features(state, batch["wav"])
        with span("train:encoder"):
            return state.encoder.from_features(feats, train=train, generator=generator)

    def _decode(self, decoder, x_t: torch.Tensor, t: torch.Tensor, **cond) -> torch.Tensor:
        """Every decoder forward of the losses and the validation goes
        through here (the student and the teacher alike), so that a
        pipeline-parallel trainer can stage it (parallel/pipeline_parallel.py)."""
        return decoder(x_t, t, **cond)

    def _backward(self, loss: torch.Tensor) -> None:
        """The step's backward pass; a pipeline-parallel trainer schedules
        its stages' backward explicitly."""
        loss.backward()

    def _mel_normalized(self, wav: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), span("train:mel"):
            return normalize_mel(self.mel_frontend(wav))[0]

    def _teacher_decay(self, applied: bool, base: float) -> float:
        """Under gradient accumulation the teacher moves only on the data steps
        that made an optimizer update: decay 1.0 on the others."""
        if self.cfg.grad_accumulation > 1 and not applied:
            return 1.0
        return base

    def _step(self, loss_fn: Callable, ema: Optional[float] = None,
              with_grad_norm: bool = False) -> Callable:
        """Wrap a loss closure into a training step."""

        def step(state: TrainState, batch: Batch, generator) -> Tuple[TrainState, dict]:
            with span("train:step"):  # its own time: the glue between the ranges below
                params = state.optimizer.params
                for p in params.values():
                    p.grad = None
                state.train()
                loss, metrics = loss_fn(state, batch, generator)
                with span("train:backward"):
                    self._backward(loss)
                with span("train:optimizer"):
                    grads = {n: p.grad for n, p in params.items()}
                    applied = state.optimizer.update(grads)
                    if with_grad_norm:
                        metrics["grad_norm"] = state.optimizer.step_norm(grads)
                    if ema is not None and state.teacher is not None:
                        ema_update(state.teacher, state.decoder, self._teacher_decay(applied, ema))
                for p in params.values():
                    p.grad = None
                state.step += 1
                return state, metrics

        return step

    # -- phase 1: diffusion ---------------------------------------------------

    def make_diffusion_loss(self, vq_weight: Optional[float] = None) -> Callable:
        """v-prediction (or eps) denoising loss with per-sample CFG dropout and
        the token-alignment term."""
        cfg, schedule = self.cfg, self.schedule
        vq_weight = vq_weight if vq_weight is not None else cfg.vq_commit

        def loss_fn(state: TrainState, batch: Batch, g) -> Tuple[torch.Tensor, dict]:
            mel_n = self._mel_normalized(batch["wav"])
            B = mel_n.shape[0]
            z_q, sem_idx, vq_loss, ppl, used = self._encode(state, batch, g, train=True)
            with span("train:decoder"):
                align_loss = torch.zeros((), device=mel_n.device)
                if cfg.token_align_weight > 0:
                    ctx_tok, ctx_feat = state.decoder.align_contexts(sem_idx, z_q.detach())
                    align_loss = _mse(ctx_tok, ctx_feat.detach())
                drop = _bernoulli(cfg.cfg_dropout, (B, 1, 1), mel_n.device, g)
                z_q = torch.where(drop, 0.0, z_q)
                t = batch["t"] if "t" in batch else torch.randint(
                    1, cfg.max_timestep, (B,), device=mel_n.device, generator=g)
                noise = batch["noise"] if "noise" in batch else torch.randn(
                    mel_n.shape, device=mel_n.device, generator=g)
                x_t, _ = schedule.q_sample(mel_n, t, noise)
                pred = self._decode(state.decoder, x_t, t, sem_features=z_q,
                                     step_idx=torch.zeros_like(t), generator=g)
                if cfg.use_v_prediction:
                    target = schedule.get_v_target(mel_n, noise, t)
                    x0_pred = schedule.predict_x0_from_v(x_t, t, pred)
                else:
                    target = noise
                    x0_pred = schedule.predict_x0_from_eps(x_t, t, pred)
                diff_loss = _mse(pred, target)
                loss = diff_loss + vq_weight * vq_loss + cfg.token_align_weight * align_loss
                x0_pred = x0_pred.detach()
                metrics = {
                    "loss": loss.detach(), "diff_loss": diff_loss.detach(),
                    "vq_loss": vq_loss.detach(), "align_loss": align_loss.detach(),
                    "perplexity": ppl, "used_codes": used,
                    "x0_mse": _mse(x0_pred, mel_n), "x0_cos": _cosine_sim(x0_pred, mel_n),
                }
            return loss, metrics

        return loss_fn

    def make_diffusion_step(self, vq_weight: Optional[float] = None) -> Callable:
        return self._step(self.make_diffusion_loss(vq_weight), with_grad_norm=True)

    # -- phase 2: progressive distillation --------------------------------------

    def make_progressive_loss(self, num_steps: int, vq_weight: float = 0.05) -> Callable:
        """The student's x0 against the EMA teacher's at the same t on the
        reduced grid (the reference's objective); without a teacher, or at the
        full grid, the v target."""
        cfg, schedule = self.cfg, self.schedule
        stride = cfg.diff_steps // num_steps

        def loss_fn(state: TrainState, batch: Batch, g):
            mel_n = self._mel_normalized(batch["wav"])
            B, dev = mel_n.shape[0], mel_n.device
            _, sem_idx, vq_loss, ppl, used = self._encode(state, batch, g, train=True)
            with span("train:decoder"):
                step_indices = batch["step_indices"] if "step_indices" in batch else \
                    torch.randint(0, num_steps, (B,), device=dev, generator=g)
                t = (step_indices + 1) * stride - 1
                noise = batch["noise"] if "noise" in batch else torch.randn(
                    mel_n.shape, device=dev, generator=g)
                x_t, _ = schedule.q_sample(mel_n, t, noise)
                v_student = self._decode(state.decoder, x_t, t, sem_idx=sem_idx,
                                         step_idx=step_indices, generator=g)
                x0_student = schedule.predict_x0_from_v(x_t, t, v_student)
                if state.teacher is not None and num_steps < cfg.diff_steps:
                    with torch.no_grad():
                        v_teacher = self._decode(state.teacher, x_t, t, sem_idx=sem_idx,
                                                 step_idx=step_indices)
                        x0_teacher = schedule.predict_x0_from_v(x_t, t, v_teacher)
                    loss = _mse(x0_student, x0_teacher)
                else:
                    loss = _mse(v_student, schedule.get_v_target(mel_n, noise, t))
                loss = loss + vq_weight * vq_loss
                metrics = {"loss": loss.detach(), "vq_loss": vq_loss.detach(),
                           "perplexity": ppl, "used_codes": used,
                           "x0_mse": _mse(x0_student.detach(), mel_n)}
            return loss, metrics

        return loss_fn

    def make_pd_two_step_loss(self, num_steps: int, vq_weight: float = 0.05) -> Callable:
        """Progressive distillation as published (Salimans & Ho): the teacher
        takes two DDIM steps t -> t_mid -> t_next, and the student learns the
        x0 whose one step from t lands on the teacher's endpoint."""
        cfg, schedule = self.cfg, self.schedule
        stride = cfg.diff_steps // num_steps
        half = max(stride // 2, 1)

        def loss_fn(state: TrainState, batch: Batch, g):
            mel_n = self._mel_normalized(batch["wav"])
            B, dev = mel_n.shape[0], mel_n.device
            _, sem_idx, vq_loss, ppl, used = self._encode(state, batch, g, train=True)
            with span("train:decoder"):
                step_indices = batch["step_indices"] if "step_indices" in batch else \
                    torch.randint(0, num_steps, (B,), device=dev, generator=g)
                t = (step_indices + 1) * stride - 1
                t_mid = (t - half).clamp(min=0)
                t_next = (t - stride).clamp(min=0)
                noise = batch["noise"] if "noise" in batch else torch.randn(
                    mel_n.shape, device=dev, generator=g)
                x_t, _ = schedule.q_sample(mel_n, t, noise)

                def teacher_ddim(x, t_a, t_b):
                    v = self._decode(state.teacher, x, t_a, sem_idx=sem_idx,
                                     step_idx=step_indices)
                    eps = schedule.predict_eps_from_v(x, t_a, v)
                    return schedule.get_ddim_step(x, t_a, t_b, eps, eta=0.0)[0]

                with torch.no_grad():
                    x_tgt = teacher_ddim(teacher_ddim(x_t, t, t_mid), t_mid, t_next)
                    sab_t = _bcast(schedule.sqrt_alpha_bar, t)
                    s1m_t = _bcast(schedule.sqrt_one_minus_alpha_bar, t)
                    sab_n = _bcast(schedule.sqrt_alpha_bar, t_next)
                    s1m_n = _bcast(schedule.sqrt_one_minus_alpha_bar, t_next)
                    denom = sab_n - s1m_n * sab_t / s1m_t
                    denom = torch.where(denom.abs() < 1e-6, 1e-6, denom)
                    x0_target = ((x_tgt - (s1m_n / s1m_t) * x_t) / denom).clamp(-3.0, 3.0)
                v_student = self._decode(state.decoder, x_t, t, sem_idx=sem_idx,
                                         step_idx=step_indices, generator=g)
                x0_student = schedule.predict_x0_from_v(x_t, t, v_student)
                loss = _mse(x0_student, x0_target) + vq_weight * vq_loss
                metrics = {"loss": loss.detach(), "vq_loss": vq_loss.detach(),
                           "perplexity": ppl, "used_codes": used,
                           "x0_mse": _mse(x0_student.detach(), mel_n)}
            return loss, metrics

        return loss_fn

    def make_progressive_step(self, num_steps: int, vq_weight: float = 0.05,
                              ema_decay: float = 0.999, exact: bool = False) -> Callable:
        """Student x0 matches the EMA teacher's (``exact``: the two-step
        objective); the teacher EMAs after every optimizer update."""
        loss_fn = (self.make_pd_two_step_loss(num_steps, vq_weight) if exact
                   else self.make_progressive_loss(num_steps, vq_weight))
        return self._step(loss_fn, ema=ema_decay)

    # -- phase 3: consistency ------------------------------------------------------

    def make_consistency_loss(self, vq_weight: float = 0.05,
                              consistency_weight: float = 1.0) -> Callable:
        """x0 at t1 against the stopped x0 at t2 (same noise, both from the
        student), plus half the two reconstruction MSEs."""
        cfg, schedule = self.cfg, self.schedule

        def loss_fn(state: TrainState, batch: Batch, g):
            mel_n = self._mel_normalized(batch["wav"])
            B, dev = mel_n.shape[0], mel_n.device
            _, sem_idx, vq_loss, ppl, used = self._encode(state, batch, g, train=True)
            with span("train:decoder"):
                t1 = batch["t1"] if "t1" in batch else torch.randint(
                    1, cfg.diff_steps, (B,), device=dev, generator=g)
                t2 = batch["t2"] if "t2" in batch else torch.randint(
                    1, cfg.diff_steps, (B,), device=dev, generator=g)
                noise = batch["noise"] if "noise" in batch else torch.randn(
                    mel_n.shape, device=dev, generator=g)
                x_t1, _ = schedule.q_sample(mel_n, t1, noise)
                x_t2, _ = schedule.q_sample(mel_n, t2, noise)
                step_idx = torch.zeros_like(t1)
                v1 = self._decode(state.decoder, x_t1, t1, sem_idx=sem_idx, step_idx=step_idx,
                                  generator=g)
                v2 = self._decode(state.decoder, x_t2, t2, sem_idx=sem_idx, step_idx=step_idx,
                                  generator=g)
                x0_1 = schedule.predict_x0_from_v(x_t1, t1, v1)
                x0_2 = schedule.predict_x0_from_v(x_t2, t2, v2)
                consistency = _mse(x0_1, x0_2.detach())
                recon = 0.5 * (_mse(x0_1, mel_n) + _mse(x0_2, mel_n))
                loss = consistency_weight * consistency + recon + vq_weight * vq_loss
                metrics = {"loss": loss.detach(), "consistency_loss": consistency.detach(),
                           "recon_loss": recon.detach(), "vq_loss": vq_loss.detach(),
                           "perplexity": ppl, "used_codes": used,
                           "x0_mse": _mse(x0_1.detach(), mel_n)}
            return loss, metrics

        return loss_fn

    def make_consistency_exact_loss(self, vq_weight: float = 0.05, grid_size: int = 40,
                                    consistency_weight: float = 1.0) -> Callable:
        """Consistency training as published (Song et al.): adjacent steps of a
        ``grid_size`` grid, same noise, the EMA teacher's clipped x0 at the
        lower step as the target.  Needs a teacher."""
        cfg, schedule = self.cfg, self.schedule
        grid = np.linspace(1, cfg.diff_steps - 1, grid_size).astype(np.int64)
        t_lo_tbl = torch.as_tensor(grid[:-1], device=self.device)
        t_hi_tbl = torch.as_tensor(grid[1:], device=self.device)

        def loss_fn(state: TrainState, batch: Batch, g):
            mel_n = self._mel_normalized(batch["wav"])
            B, dev = mel_n.shape[0], mel_n.device
            _, sem_idx, vq_loss, ppl, used = self._encode(state, batch, g, train=True)
            with span("train:decoder"):
                n = batch["n"] if "n" in batch else torch.randint(
                    0, grid_size - 1, (B,), device=dev, generator=g)
                t_lo, t_hi = t_lo_tbl[n], t_hi_tbl[n]
                noise = batch["noise"] if "noise" in batch else torch.randn(
                    mel_n.shape, device=dev, generator=g)
                x_hi, _ = schedule.q_sample(mel_n, t_hi, noise)
                x_lo, _ = schedule.q_sample(mel_n, t_lo, noise)
                step_idx = torch.zeros_like(t_hi)
                v_s = self._decode(state.decoder, x_hi, t_hi, sem_idx=sem_idx,
                                   step_idx=step_idx, generator=g)
                x0_s = schedule.predict_x0_from_v(x_hi, t_hi, v_s)
                with torch.no_grad():
                    v_t = self._decode(state.teacher, x_lo, t_lo, sem_idx=sem_idx,
                                       step_idx=step_idx)
                    x0_t = schedule.predict_x0_from_v(x_lo, t_lo, v_t).clamp(-3.0, 3.0)
                consistency = _mse(x0_s, x0_t)
                loss = consistency_weight * consistency + vq_weight * vq_loss
                metrics = {"loss": loss.detach(), "consistency_loss": consistency.detach(),
                           "vq_loss": vq_loss.detach(), "perplexity": ppl,
                           "used_codes": used, "x0_mse": _mse(x0_s.detach(), mel_n)}
            return loss, metrics

        return loss_fn

    def make_consistency_step(self, vq_weight: float = 0.05, exact: bool = False,
                              ema_decay: float = 0.999,
                              consistency_weight: float = 1.0) -> Callable:
        """The reference's two-timestep objective, or (``exact``) the adjacent-
        step EMA-teacher objective with the teacher EMA'd per update."""
        if exact:
            return self._step(self.make_consistency_exact_loss(
                vq_weight, consistency_weight=consistency_weight), ema=ema_decay)
        return self._step(self.make_consistency_loss(
            vq_weight, consistency_weight=consistency_weight))

    # -- chained steps --------------------------------------------------------------

    def make_chained_step(self, kind: str = "diffusion", num_steps: Optional[int] = None,
                          vq_weight: Optional[float] = None, ema_decay: float = 0.999,
                          exact: bool = False, consistency_weight: float = 1.0) -> Callable:
        """K steps per call with the corpus on the device:

            (state, corpus, idx, generator) -> (state, stacked_metrics)

        ``corpus`` is a dict of [N, ...] device tensors, ``idx`` [K, B] row
        indices (K from its shape); each step gathers its rows on the device,
        and the metrics come back stacked [K], for one host fetch per call.
        ``kind`` and the knobs select the phase as the single-step factories
        do; every kind records ``grad_norm``."""
        if kind == "diffusion":
            loss_fn, ema = self.make_diffusion_loss(vq_weight), None
        elif kind == "progressive":
            if num_steps is None:
                raise ValueError("progressive chaining needs num_steps")
            w = vq_weight if vq_weight is not None else 0.05
            loss_fn = (self.make_pd_two_step_loss(num_steps, w) if exact
                       else self.make_progressive_loss(num_steps, w))
            ema = ema_decay
        elif kind == "consistency":
            w = vq_weight if vq_weight is not None else 0.05
            if exact:
                loss_fn = self.make_consistency_exact_loss(
                    w, consistency_weight=consistency_weight)
                ema = ema_decay
            else:
                loss_fn = self.make_consistency_loss(w, consistency_weight=consistency_weight)
                ema = None
        else:
            raise ValueError(f"unknown chained kind {kind!r}")
        step = self._step(loss_fn, ema=ema, with_grad_norm=True)

        def chained(state: TrainState, corpus: Batch, idx: torch.Tensor, generator):
            rows = []
            for row_idx in idx:
                state, metrics = step(state, {k: v[row_idx] for k, v in corpus.items()},
                                      generator)
                rows.append(metrics)
            return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

        return chained

    # -- validation ----------------------------------------------------------------

    @contextlib.contextmanager
    def _evaluating(self, state: TrainState):
        state.eval()
        try:
            with torch.no_grad():
                yield
        finally:
            state.train()

    def _conditioning(self, conditioning: str):
        if conditioning not in ("features", "tokens"):
            raise ValueError(f"unknown conditioning {conditioning!r}")

        def kwargs(z_q, sem_idx):
            return dict(sem_features=z_q) if conditioning == "features" else dict(sem_idx=sem_idx)

        return kwargs

    def make_validate_fn(self, num_steps: int = 4, order: int = 2,
                         conditioning: str = "features") -> Callable:
        """``num_steps``-step DPM-Solver++ generation scored by cosine
        similarity to the ground truth: ``(state, batch, generator) ->
        {"val_cos", "val_mse"}``.  ``conditioning`` picks the decoder's context
        path: "features" (sem_proj, the v2 recipe's) or "tokens" (token_emb,
        what the distillation phases train)."""
        cfg = self.cfg
        solver = DPMSolverPP(self.schedule, order=order)
        cond = self._conditioning(conditioning)

        def validate(state: TrainState, batch: Batch, generator):
            with self._evaluating(state):
                mel_n = self._mel_normalized(batch["wav"])
                z_q, sem_idx, _, _, _ = self._encode(state, batch, generator, train=False)
                x_T = torch.randn(mel_n.shape, device=mel_n.device, generator=generator)
                kw = cond(z_q, sem_idx)

                def model_fn(x, t, step_idx):
                    return self._decode(state.decoder, x, t, step_idx=step_idx, **kw)

                x0 = solver.sample(model_fn, x_T, num_steps, max_t=cfg.max_timestep)
                return {"val_cos": _cosine_sim(x0, mel_n), "val_mse": _mse(x0, mel_n)}

        return validate

    def make_validate_ddim_fn(self, num_steps: int, conditioning: str = "tokens") -> Callable:
        """Few-step raw DDIM validation, the sampler distillation serves:
        ``(state, batch, generator) -> {"val_cos", "val_mse"}``."""
        cfg, schedule = self.cfg, self.schedule
        cond = self._conditioning(conditioning)

        def validate(state: TrainState, batch: Batch, generator):
            with self._evaluating(state):
                mel_n = self._mel_normalized(batch["wav"])
                z_q, sem_idx, _, _, _ = self._encode(state, batch, generator, train=False)
                x_T = torch.randn(mel_n.shape, device=mel_n.device, generator=generator)
                kw = cond(z_q, sem_idx)

                def model_fn(x, t, step_idx):
                    return self._decode(state.decoder, x, t, step_idx=step_idx, **kw)

                x0 = ddim_sample(schedule, model_fn, x_T, num_steps,
                                 prediction="v" if cfg.use_v_prediction else "eps")
                return {"val_cos": _cosine_sim(x0, mel_n), "val_mse": _mse(x0, mel_n)}

        return validate

    def make_eval_eps_fn(self) -> Callable:
        """The prediction-target MSE on a validation batch at t drawn from
        [1, max_timestep), the range the diffusion phase trains on:
        ``(state, batch, generator) -> {"val_eps_mse"}``."""
        cfg, schedule = self.cfg, self.schedule

        def evaluate(state: TrainState, batch: Batch, generator):
            with self._evaluating(state):
                mel_n = self._mel_normalized(batch["wav"])
                B, dev = mel_n.shape[0], mel_n.device
                _, sem_idx, _, _, _ = self._encode(state, batch, generator, train=False)
                t = torch.randint(1, cfg.max_timestep, (B,), device=dev, generator=generator)
                noise = torch.randn(mel_n.shape, device=dev, generator=generator)
                x_t, _ = schedule.q_sample(mel_n, t, noise)
                pred = self._decode(state.decoder, x_t, t, sem_idx=sem_idx,
                                    step_idx=torch.zeros_like(t))
                target = schedule.get_v_target(mel_n, noise, t) if cfg.use_v_prediction \
                    else noise
                return {"val_eps_mse": _mse(pred, target)}

        return evaluate
