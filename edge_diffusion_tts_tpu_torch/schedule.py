"""Diffusion schedule math over precomputed cosine tables, in PyTorch.

Counterpart of ``edge_diffusion_tts_tpu/schedule.py``.  The tables are built
in numpy float32 with exactly the same operations as the JAX package, so they
are bit-identical; every sampling step is a plain tensor function
``x_{t-1} = f(tables, x_t, t, model_output)``.  Stochastic steps take an
explicit ``torch.Generator`` (or injected noise) where JAX threads a key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

_TABLES = (
    "betas",
    "alphas",
    "alpha_bar",
    "sqrt_alpha_bar",
    "sqrt_one_minus_alpha_bar",
    "sqrt_recip_alpha_bar",
    "sqrt_recip_alpha_bar_minus_one",
    "posterior_variance",
    "lambda_t",
)


def _bcast(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Gather per-timestep scalars and broadcast to [B, 1, 1]."""
    return table[t][:, None, None]


def cosine_tables(T: int) -> dict:
    """The schedule's float32 numpy tables, computed as the JAX package does."""
    s = np.float32(0.008)
    x = np.linspace(0.0, T, T + 1, dtype=np.float32)
    ab = np.cos(((x / np.float32(T)) + s) / (1 + s) * np.float32(math.pi) * 0.5)
    ab = (ab * ab).astype(np.float32)
    ab = ab / ab[0]
    betas = (np.float32(1.0) - (ab[1:] / ab[:-1])).astype(np.float32)
    betas = np.clip(betas, 0.0001, 0.9999).astype(np.float32)

    alphas = (np.float32(1.0) - betas).astype(np.float32)
    alpha_bar = np.cumprod(alphas, axis=0, dtype=np.float32)

    sqrt_ab = np.sqrt(alpha_bar)
    sqrt_1mab = np.sqrt(1.0 - alpha_bar)
    alpha_bar_prev = np.concatenate([[1.0], alpha_bar[:-1]])
    posterior_var = betas * (1.0 - alpha_bar_prev) / (1.0 - alpha_bar)
    lambda_t = np.log(sqrt_ab / sqrt_1mab)
    tables = {
        "betas": betas,
        "alphas": alphas,
        "alpha_bar": alpha_bar,
        "sqrt_alpha_bar": sqrt_ab,
        "sqrt_one_minus_alpha_bar": sqrt_1mab,
        "sqrt_recip_alpha_bar": np.sqrt(1.0 / alpha_bar),
        "sqrt_recip_alpha_bar_minus_one": np.sqrt(1.0 / alpha_bar - 1.0),
        "posterior_variance": posterior_var,
        "lambda_t": lambda_t,
    }
    return {k: np.asarray(v, dtype=np.float32) for k, v in tables.items()}


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed cosine-schedule tables (float32 tensors of shape [T]).

    Like the reference, ``beta_start``/``beta_end`` are accepted but the
    schedule is cosine.  ``to(device)`` returns a copy whose tables live on
    ``device``; the step functions index them with ``t`` on the same device.
    """

    T: int
    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bar: torch.Tensor
    sqrt_alpha_bar: torch.Tensor
    sqrt_one_minus_alpha_bar: torch.Tensor
    sqrt_recip_alpha_bar: torch.Tensor
    sqrt_recip_alpha_bar_minus_one: torch.Tensor
    posterior_variance: torch.Tensor
    lambda_t: torch.Tensor

    @classmethod
    def create(
        cls,
        T: int,
        beta_start: float = 1e-4,
        beta_end: float = 2e-2,
        device="cpu",
    ) -> "DiffusionSchedule":
        del beta_start, beta_end  # cosine schedule; kept for API parity
        tables = cosine_tables(T)
        return cls(
            T=T,
            **{k: torch.from_numpy(v).to(device) for k, v in tables.items()},
        )

    def to(self, device) -> "DiffusionSchedule":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _TABLES}
        )

    # ---- forward process ---------------------------------------------------------

    def q_sample(self, x0, t, noise):
        """Forward noising q(x_t | x_0); returns ``(x_t, noise)``."""
        x_t = _bcast(self.sqrt_alpha_bar, t) * x0 + _bcast(
            self.sqrt_one_minus_alpha_bar, t
        ) * noise
        return x_t, noise

    # ---- parameterization conversions ----------------------------------------------

    def predict_x0_from_eps(self, x_t, t, eps):
        return (
            _bcast(self.sqrt_recip_alpha_bar, t) * x_t
            - _bcast(self.sqrt_recip_alpha_bar_minus_one, t) * eps
        )

    def predict_x0_from_v(self, x_t, t, v):
        """x0 = sqrt(ab)*x_t - sqrt(1-ab)*v."""
        return (
            _bcast(self.sqrt_alpha_bar, t) * x_t
            - _bcast(self.sqrt_one_minus_alpha_bar, t) * v
        )

    def predict_eps_from_v(self, x_t, t, v):
        """eps = sqrt(1-ab)*x_t + sqrt(ab)*v."""
        return (
            _bcast(self.sqrt_one_minus_alpha_bar, t) * x_t
            + _bcast(self.sqrt_alpha_bar, t) * v
        )

    def get_v_target(self, x0, noise, t):
        """v = sqrt(ab)*eps - sqrt(1-ab)*x0."""
        return (
            _bcast(self.sqrt_alpha_bar, t) * noise
            - _bcast(self.sqrt_one_minus_alpha_bar, t) * x0
        )

    # ---- reverse-process steps ----------------------------------------------------------

    def get_ddim_step(
        self,
        x_t: torch.Tensor,
        t: torch.Tensor,
        t_prev: torch.Tensor,
        eps_pred: torch.Tensor,
        eta: float = 0.0,
        generator: Optional[torch.Generator] = None,
        x0_clip: float = 3.0,
    ):
        """One DDIM update (deterministic at eta=0), x0 clamped to +-x0_clip.

        ``t_prev < 0`` selects alpha_bar=1 (the clean endpoint).
        Returns ``(x_prev, x0_pred)``.
        """
        ab_t = _bcast(self.alpha_bar, t)
        ab_prev = torch.where(
            t_prev[:, None, None] >= 0,
            _bcast(self.alpha_bar, t_prev.clamp(0, self.T - 1)),
            torch.ones_like(ab_t),
        )

        x0_pred = (x_t - torch.sqrt(1.0 - ab_t) * eps_pred) / torch.sqrt(ab_t)
        x0_pred = x0_pred.clamp(-x0_clip, x0_clip)

        sigma = eta * torch.sqrt(
            (1.0 - ab_prev) / (1.0 - ab_t) * (1.0 - ab_t / ab_prev)
        )
        dir_xt = torch.sqrt(1.0 - ab_prev - sigma**2) * eps_pred

        if eta > 0:
            if generator is None:
                raise ValueError("eta > 0 requires an explicit torch.Generator")
            noise = torch.randn(
                x_t.shape, generator=generator, device=x_t.device, dtype=x_t.dtype
            )
        else:
            noise = 0.0
        x_prev = torch.sqrt(ab_prev) * x0_pred + dir_xt + sigma * noise
        return x_prev, x0_pred

    def ddpm_step(
        self,
        x_t: torch.Tensor,
        t: torch.Tensor,
        eps_pred: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One ancestral DDPM step with posterior variance; no noise at t=0.

        The Gaussian draw comes from ``generator``, or is ``noise`` when given.
        """
        alpha = _bcast(self.alphas, t)
        alpha_bar = _bcast(self.alpha_bar, t)
        beta = _bcast(self.betas, t)

        mean = (x_t - beta / torch.sqrt(1.0 - alpha_bar) * eps_pred) / torch.sqrt(alpha)
        var = _bcast(self.posterior_variance, t)
        if noise is None:
            noise = torch.randn(
                x_t.shape, generator=generator, device=x_t.device, dtype=x_t.dtype
            )
        nonzero = (t > 0).to(x_t.dtype)[:, None, None]
        return mean + nonzero * torch.sqrt(var) * noise

    # ---- timestep grids -----------------------------------------------------------------

    def get_schedule_for_steps(self, num_steps: int) -> List[int]:
        """Evenly strided timestep grid: ``range(T-1, 0, -stride)[:n]``."""
        stride = max(self.T // num_steps, 1)
        return list(range(self.T - 1, 0, -stride))[:num_steps]


# ---------------------------------------------------------------------------
# Samplers (model_fn: (x, t[B], step_idx[B]) -> output)
# ---------------------------------------------------------------------------


def _full(B: int, value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((B,), value, dtype=torch.long, device=like.device)


def ddim_sample(
    schedule: DiffusionSchedule,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    num_steps: int,
    prediction: str = "eps",
) -> torch.Tensor:
    """Few-step eta=0 DDIM loop; returns the final x0 prediction.

    timesteps = range(T-1, 0, -stride)[:n], t_prev = max(t - stride, 0).
    """
    B = x_T.shape[0]
    stride = max(schedule.T // num_steps, 1)
    ts = schedule.get_schedule_for_steps(num_steps)
    x, x0 = x_T, torch.zeros_like(x_T)
    for i, t in enumerate(ts):
        t_b = _full(B, t, x)
        tp_b = _full(B, max(t - stride, 0), x)
        out = model_fn(x, t_b, _full(B, i, x))
        eps = schedule.predict_eps_from_v(x, t_b, out) if prediction == "v" else out
        x, x0 = schedule.get_ddim_step(x, t_b, tp_b, eps, eta=0.0)
    return x0


def ddpm_sample(
    schedule: DiffusionSchedule,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    prediction: str = "eps",
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Full-schedule ancestral sampling, t = T-1 .. 0, with step_idx 0.

    Per-step noise comes from ``generator``; ``noise`` (one tensor per step,
    in loop order) replaces the draws, so a test can feed both packages the
    same numbers.
    """
    B = x_T.shape[0]
    x = x_T
    zeros = _full(B, 0, x)
    for i, t in enumerate(range(schedule.T - 1, -1, -1)):
        t_b = _full(B, t, x)
        out = model_fn(x, t_b, zeros)
        eps = schedule.predict_eps_from_v(x, t_b, out) if prediction == "v" else out
        x = schedule.ddpm_step(
            x, t_b, eps, generator=generator,
            noise=None if noise is None else noise[i],
        )
    return x


class DPMSolverPP:
    """DPM-Solver++ sampler (orders 1-3) over log-SNR-spaced timesteps.

    Timesteps are chosen on the host from a numpy copy of the lambda table;
    the loop keeps a 2-deep x0 history, as the JAX package does.
    """

    def __init__(
        self,
        schedule: DiffusionSchedule,
        order: int = 2,
        predict_x0: bool = False,
    ):
        self.schedule = schedule
        self.order = order
        self.predict_x0 = predict_x0
        self._lambda_np = schedule.lambda_t.detach().cpu().numpy()

    def get_time_steps(self, num_steps: int, max_t: Optional[int] = None) -> List[int]:
        """Log-SNR-uniform grid as python ints."""
        max_t = max_t or (self.schedule.T - 1)
        lam = self._lambda_np
        lambda_max = lam[1]
        lambda_min = lam[max_t]
        lambdas = np.linspace(lambda_min, lambda_max, num_steps + 1)
        ts = []
        for l in lambdas[:-1]:
            t = int(np.abs(lam - l).argmin())
            ts.append(max(1, min(t, max_t)))
        return ts

    def model_to_x0(self, model_output, x_t, t):
        if self.predict_x0:
            return model_output
        return self.schedule.predict_x0_from_v(x_t, t, model_output)

    def first_order_update(self, x, x0_pred, t, t_prev):
        s = self.schedule
        alpha_prev = _bcast(s.sqrt_alpha_bar, t_prev)
        sigma_t = _bcast(s.sqrt_one_minus_alpha_bar, t)
        sigma_prev = _bcast(s.sqrt_one_minus_alpha_bar, t_prev)
        h = _bcast(s.lambda_t, t_prev) - _bcast(s.lambda_t, t)
        return (sigma_prev / sigma_t) * x + alpha_prev * (1 - torch.exp(-h)) * x0_pred

    def second_order_update(self, x, x0_pred, x0_prev, t, t_prev, t_prev2):
        s = self.schedule
        alpha_prev = _bcast(s.sqrt_alpha_bar, t_prev)
        sigma_t = _bcast(s.sqrt_one_minus_alpha_bar, t)
        sigma_prev = _bcast(s.sqrt_one_minus_alpha_bar, t_prev)
        lam_t = _bcast(s.lambda_t, t)
        lam_prev = _bcast(s.lambda_t, t_prev)
        lam_prev2 = _bcast(s.lambda_t, t_prev2)
        h = lam_prev - lam_t
        r = (lam_prev2 - lam_prev) / h
        D0 = x0_pred
        D1 = (1.0 / r) * (x0_pred - x0_prev)
        return (
            (sigma_prev / sigma_t) * x
            + alpha_prev * (1 - torch.exp(-h)) * D0
            + alpha_prev * ((1 - torch.exp(-h)) / h + 1) * D1 * 0.5
        )

    def third_order_update(self, x, x0_preds, t, t_prev):
        s = self.schedule
        alpha_prev = _bcast(s.sqrt_alpha_bar, t_prev)
        sigma_t = _bcast(s.sqrt_one_minus_alpha_bar, t)
        sigma_prev = _bcast(s.sqrt_one_minus_alpha_bar, t_prev)
        h = _bcast(s.lambda_t, t_prev) - _bcast(s.lambda_t, t)
        D0 = x0_preds[0]
        D1 = x0_preds[0] - x0_preds[1]
        D2 = x0_preds[0] - 2 * x0_preds[1] + x0_preds[2]
        return (
            (sigma_prev / sigma_t) * x
            + alpha_prev * (1 - torch.exp(-h)) * D0
            + alpha_prev * ((1 - torch.exp(-h)) / h + 1) * D1 * 0.5
            + alpha_prev * ((1 - torch.exp(-h)) / (h**2) + 0.5 / h + 0.5) * D2 / 6
        )

    def sample(
        self,
        model_fn: ModelFn,
        x_T: torch.Tensor,
        num_steps: int = 10,
        max_t: Optional[int] = None,
        return_intermediates: bool = False,
        x0_clip: float = 3.0,
    ):
        """Run the solver; returns x (and the clipped x0 predictions)."""
        max_t = max_t or 950
        timesteps = self.get_time_steps(num_steps, max_t)
        B = x_T.shape[0]
        x = x_T
        x0_history: list = []
        t_history: list = []
        intermediates = []

        for i, t in enumerate(timesteps):
            t_b = _full(B, t, x)
            out = model_fn(x, t_b, _full(B, i, x))
            x0_pred = self.model_to_x0(out, x, t_b).clamp(-x0_clip, x0_clip)
            if return_intermediates:
                intermediates.append(x0_pred)

            t_prev = timesteps[i + 1] if i < len(timesteps) - 1 else 0
            tp_b = _full(B, t_prev, x)

            if self.order == 1 or len(x0_history) == 0:
                x = self.first_order_update(x, x0_pred, t_b, tp_b)
            elif self.order == 2 or len(x0_history) == 1:
                x = self.second_order_update(
                    x, x0_pred, x0_history[-1], t_b, tp_b, t_history[-1]
                )
            else:
                x = self.third_order_update(
                    x, [x0_pred] + x0_history[-2:], t_b, tp_b
                )

            x0_history.append(x0_pred)
            t_history.append(tp_b)
            if len(x0_history) > 2:
                x0_history.pop(0)
                t_history.pop(0)

        if return_intermediates:
            return x, intermediates
        return x
