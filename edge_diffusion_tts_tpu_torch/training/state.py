"""Train state and optimizer (counterpart of ``edge_diffusion_tts_tpu/training/state.py``).

``TrainState`` holds the modules (the encoder, whose frozen HuBERT never
trains and whose VQ statistics are buffers; the decoder), the optimizer, the
EMA teacher of the distillation phases and the data-step counter: all a step
needs and all a checkpoint holds.

``Optimizer`` reproduces the JAX package's optax chain update for update,
not torch's look-alikes:

- ``optax.MultiSteps(every_k=grad_accumulation)``: the running mean of k
  mini-step gradients, ``acc + (g - acc) / (n + 1)``; one inner update per k
  data steps, none in between;
- ``clip_by_global_norm``: ``g`` where the norm is under ``max_norm``, else
  ``(g / norm) * max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
- ``adamw(b1=0.9, b2=0.999, eps=1e-8)``: moments, bias correction at the
  1-based update count, weight decay on every trainable tensor, scaled by
  ``-lr(count)`` at the 0-based update count, so the first update runs at the
  schedule's value at 0 (0 under warmup);
- the frozen HuBERT has no entry at all (optax masks it to zero updates).

Counts live on the host: no step reads the device to decide anything.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import CFG
from ..models.encoder import is_hubert_param

Schedule = Callable[[int], float]


def make_lr_schedule(cfg: CFG, total_steps: int, base_lr: Optional[float] = None) -> Schedule:
    """``optax.warmup_cosine_decay_schedule(0 -> lr, end 1e-6)`` evaluated in
    float32 as optax evaluates it: linear warmup over ``max(int(total *
    warmup_frac), 1)`` updates, then cosine decay to ``max(total, warmup + 1)``."""
    f32 = np.float32
    peak_d = float(base_lr if base_lr is not None else cfg.lr)
    peak = f32(peak_d)
    warmup = max(int(total_steps * cfg.warmup_frac), 1)
    decay = max(total_steps, warmup + 1) - warmup
    alpha_d = 0.0 if peak_d == 0.0 else 1e-6 / peak_d
    alpha, one_minus_alpha = f32(alpha_d), f32(1.0 - alpha_d)

    def schedule(count: int) -> float:
        if count < warmup:
            c = f32(min(max(count, 0), warmup))
            frac = f32(1) - c / f32(warmup)
            return float(f32(-peak_d) * frac + peak)
        c = f32(min(count - warmup, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return float(peak * (one_minus_alpha * cosine + alpha))

    return schedule


def constant_schedule(value: float) -> Schedule:
    return lambda count: float(np.float32(value))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


class Optimizer:
    """Clip -> AdamW (-> under MultiSteps), over named trainable parameters.

    ``update(grads)`` takes one data step's gradients ({name: tensor}; a name
    the loss never reached takes zeros, as ``jax.grad`` gives) and returns
    whether the inner update ran (every ``accumulation``-th call).
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict[str, nn.Parameter], cfg: CFG, total_updates: int,
                 base_lr: Optional[float] = None, learning_rate: Optional[Schedule] = None):
        self.params = dict(params)
        self.lr = learning_rate or make_lr_schedule(cfg, total_updates, base_lr)
        self.max_norm = float(cfg.grad_clip)
        self.weight_decay = float(cfg.weight_decay)
        self.accumulation = max(int(cfg.grad_accumulation), 1)
        zeros = lambda: {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                         for n, p in self.params.items()}
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if self.accumulation > 1 else None
        self.count = 0  # inner updates applied (optax's adam and schedule counts)
        self.mini_step = 0  # MultiSteps' data steps since the last update
        # (names, tensors) -> the global norm the clip reads; a pipeline stage
        # holds only its blocks and sums their squares over the stages.
        self.norm_fn: Callable = lambda names, tensors: global_norm(tensors)
        self.clip_norm: Optional[torch.Tensor] = None  # the last inner update's norm

    def _named(self, grads: Dict[str, torch.Tensor]):
        names = list(self.params)
        return names, [grads[n] if grads.get(n) is not None
                       else torch.zeros_like(self.params[n]) for n in names]

    @torch.no_grad()
    def step_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of one data step's gradients (the steps'
        ``grad_norm`` metric), called after ``update(grads)``: with one data
        step per update it is the norm that update clipped with."""
        if self.acc is None:
            return self.clip_norm
        return self.norm_fn(*self._named(grads))

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> bool:
        names, g = self._named(grads)
        if self.acc is not None:
            acc = [self.acc[n] for n in names]
            diff = torch._foreach_sub(g, acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(acc, diff)
            emit = self.mini_step == self.accumulation - 1
            self.mini_step = (self.mini_step + 1) % self.accumulation
            if not emit:
                return False
            g = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        self.clip_norm = norm = self.norm_fn(names, g)
        keep = norm < self.max_norm
        g = [torch.where(keep, x, (x / norm) * self.max_norm) for x in g]
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        step_size = -self.lr(self.count - 1)
        for n, x in zip(names, g):
            p, mu, nu = self.params[n], self.mu[n], self.nu[n]
            mu.copy_((1 - self.b1) * x + self.b1 * mu)
            nu.copy_((1 - self.b2) * x.square() + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(step_size * u)
        return True

    def set_learning_rate(self, schedule: Schedule) -> None:
        """Swap the schedule, keeping every moment and count (the JAX driver
        rebuilds its optax chain; the opt_state carries over unchanged)."""
        self.lr = schedule

    def state_dict(self) -> dict:
        return {"mu": {n: t.detach().cpu() for n, t in self.mu.items()},
                "nu": {n: t.detach().cpu() for n, t in self.nu.items()},
                "acc": None if self.acc is None else {
                    n: t.detach().cpu() for n, t in self.acc.items()},
                "count": self.count, "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        for name in ("mu", "nu"):
            _copy_into(getattr(self, name), d[name], f"optimizer {name}")
        if self.acc is not None:
            if d.get("acc") is None:
                raise ValueError("the checkpoint has no accumulated gradients, but this "
                                 "optimizer accumulates")
            _copy_into(self.acc, d["acc"], "optimizer acc")
        self.count = int(d["count"])
        self.mini_step = int(d["mini_step"])


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f"{what}: names differ ({sorted(set(dst) ^ set(src))[:5]})")
    for n, t in dst.items():
        if tuple(src[n].shape) != tuple(t.shape):
            raise ValueError(f"{what}.{n}: shape {tuple(src[n].shape)} != {tuple(t.shape)}")
        t.copy_(src[n])


def trainable_parameters(encoder: nn.Module, decoder: nn.Module) -> Dict[str, nn.Parameter]:
    """``{"encoder.<name>" | "decoder.<name>": parameter}`` for everything
    that trains: all but the encoder's frozen HuBERT."""
    out = {f"encoder.{n}": p for n, p in encoder.named_parameters() if not is_hubert_param(n)}
    out.update({f"decoder.{n}": p for n, p in decoder.named_parameters()})
    return out


def freeze_hubert(encoder: nn.Module) -> None:
    """The frozen HuBERT: no gradient, eval mode."""
    encoder.hubert.requires_grad_(False)
    encoder.hubert.eval()


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, decay: float = 0.999) -> None:
    """teacher <- teacher * decay + student * (1 - decay), over parameters;
    decay 1.0 leaves the teacher bit for bit."""
    t = list(teacher.parameters())
    s = [p.to(q.dtype) for p, q in zip(student.parameters(), t)]
    torch._foreach_mul_(t, decay)
    torch._foreach_add_(t, torch._foreach_mul(s, 1.0 - decay))


class TrainState:
    """All training state: modules, optimizer, teacher, data-step count."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, optimizer: Optimizer,
                 teacher: Optional[nn.Module] = None, step: int = 0):
        self.encoder = encoder
        self.decoder = decoder
        self.optimizer = optimizer
        self.teacher = teacher
        self.step = step

    def with_teacher(self) -> "TrainState":
        """(Re-)initialize the EMA teacher from the current decoder."""
        teacher = copy.deepcopy(self.decoder).eval()
        teacher.requires_grad_(False)
        self.teacher = teacher
        return self

    def train(self) -> None:
        """Training mode for the trainable modules (the HuBERT stays in eval)."""
        self.encoder.train()
        self.encoder.hubert.eval()
        self.decoder.train()

    def eval(self) -> None:
        self.encoder.eval()
        self.decoder.eval()

    def state_dict(self, with_hubert: bool = True) -> dict:
        """CPU tensors: ``step``, ``encoder`` (VQ buffers included; the HuBERT
        left out unless ``with_hubert``), ``decoder``, ``teacher`` (or None),
        ``optimizer``."""

        def cpu(sd):
            return {k: v.detach().cpu() for k, v in sd.items()}

        enc = {k: v for k, v in self.encoder.state_dict().items()
               if with_hubert or not is_hubert_param(k)}
        return {"step": self.step, "encoder": cpu(enc), "decoder": cpu(self.decoder.state_dict()),
                "teacher": None if self.teacher is None else cpu(self.teacher.state_dict()),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, d: dict) -> None:
        """Load ``state_dict()``'s layout.  An encoder dict without the HuBERT
        keeps this state's HuBERT; a teacher present in one and absent in the
        other is made or dropped to match ``d`` (the JAX restore retries with
        the other arity); one whose tensors do not fit raises ValueError."""
        enc = d["encoder"]
        missing, unexpected = self.encoder.load_state_dict(enc, strict=False)
        missing = [k for k in missing if not is_hubert_param(k)]
        if missing or unexpected:
            raise ValueError(f"encoder state: missing {missing[:5]}, unexpected {unexpected[:5]}")
        self.decoder.load_state_dict(d["decoder"])
        if d.get("teacher") is None:
            self.teacher = None
        else:
            if self.teacher is None:
                self.with_teacher()
            try:
                self.teacher.load_state_dict(d["teacher"])
            except RuntimeError as e:
                raise ValueError(f"the checkpoint's teacher does not fit this decoder: {e}")
        self.optimizer.load_state_dict(d["optimizer"])
        self.step = int(d["step"])


def make_optimizer(cfg: CFG, encoder: nn.Module, decoder: nn.Module, total_steps: int,
                   base_lr: Optional[float] = None,
                   learning_rate: Optional[Schedule] = None) -> Optimizer:
    """The masked AdamW chain over the encoder's and decoder's trainable
    parameters (``total_steps`` sizes the schedule, in updates)."""
    return Optimizer(trainable_parameters(encoder, decoder), cfg, total_steps, base_lr,
                     learning_rate)


def create_train_state(encoder: nn.Module, decoder: nn.Module,
                       optimizer: Optimizer) -> TrainState:
    freeze_hubert(encoder)
    return TrainState(encoder, decoder, optimizer)


__all__ = ["Optimizer", "TrainState", "constant_schedule", "create_train_state", "ema_update",
           "freeze_hubert", "global_norm", "make_lr_schedule", "make_optimizer",
           "trainable_parameters"]
