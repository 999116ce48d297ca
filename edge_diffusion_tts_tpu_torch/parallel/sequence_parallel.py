"""Sequence-parallel long-form generation (counterpart of
``edge_diffusion_tts_tpu/parallel/sequence_parallel.py``).

One long utterance's mel frames split over the ranks of an axis.  The
decoder mixes mel frames only in its windowed self-attention, so the stack's
receptive field is ``layers * window`` frames: a rank that decodes an
extended window with that margin on each side gets its own ``T / n`` frames
exactly (the halo argument; edge ranks shift their window inward, so the
band's clipping at the sequence ends matches too).

Each DDIM step every rank:

1. slices its window ``[start, start + Te)`` from the replicated x, ``Te =
   min(T, T/n + 2 * margin)``, ``start`` clipped into ``[0, T - Te]``;
2. runs its decoder replica on the window with ``pos_offset=start`` (the
   true positions) and applies the DDIM update;
3. crops its ``T/n`` frames, and one ``all_gather`` reassembles x.

A last ``all_gather`` assembles the final x0.  A window of at least
``cfg.pallas_min_seq_len`` frames takes the banded-attention kernel in every
layer, as the eager decoder always does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import CFG
from ..schedule import DiffusionSchedule
from .mesh import DATA_AXIS, Mesh


def seq_margin(cfg: CFG) -> int:
    """Receptive-field margin of the decoder stack in mel frames."""
    return cfg.layers * (cfg.attn_window_size or cfg.max_mel_positions)


def make_seq_parallel_generate(cfg: CFG, decoder, schedule: DiffusionSchedule, mesh: Mesh,
                               num_steps: int, axis: str = DATA_AXIS,
                               prediction: Optional[str] = None) -> Callable:
    """``(sem_idx, x_T) -> x0`` with the mel time axis of one utterance split
    over ``mesh``'s ``axis``; every rank passes the same replicated inputs
    and gets the whole x0.  ``decoder`` is this rank's replica (eval mode on
    the rank's device).  Same grid, eta 0 and final x0 as
    ``schedule.ddim_sample``; ``prediction`` defaults to the config's
    objective.  ``x_T.shape[1]`` must divide by the axis size."""
    ax = mesh.axis(axis)
    n = ax.size
    stride = max(schedule.T // num_steps, 1)
    ts = schedule.get_schedule_for_steps(num_steps)
    if prediction is None:
        prediction = "v" if cfg.use_v_prediction else "eps"

    @torch.inference_mode()
    def generate(sem_idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        if T % n:
            raise ValueError(f"sequence length {T} must divide by the {n}-rank {axis!r} "
                             "axis (pad the mel frames to a multiple)")
        T_loc = T // n
        M = seq_margin(cfg)
        Te = min(T, T_loc + 2 * M)
        start = min(max(ax.index * T_loc - M, 0), T - Te)
        crop = ax.index * T_loc - start
        x0 = None
        for si, t in enumerate(ts):
            x_ext = x[:, start:start + Te]
            full = lambda v: torch.full((B,), v, dtype=torch.long, device=x.device)  # noqa: E731
            t_b = full(t)
            out = decoder(x_ext, t_b, sem_idx=sem_idx, step_idx=full(si), pos_offset=start)
            eps = schedule.predict_eps_from_v(x_ext, t_b, out) if prediction == "v" else out
            x_next, x0 = schedule.get_ddim_step(x_ext, t_b, full(max(t - stride, 0)), eps,
                                                eta=0.0)
            x = ax.all_gather(x_next[:, crop:crop + T_loc], dim=1)
        return ax.all_gather(x0[:, crop:crop + T_loc], dim=1)

    return generate


def seq_parallel_generate(cfg: CFG, decoder, schedule: DiffusionSchedule,
                          sem_idx: torch.Tensor, x_T: torch.Tensor, num_steps: int, mesh: Mesh,
                          axis: str = DATA_AXIS,
                          prediction: Optional[str] = None) -> torch.Tensor:
    """One-shot wrapper around ``make_seq_parallel_generate``."""
    return make_seq_parallel_generate(cfg, decoder, schedule, mesh, num_steps, axis,
                                      prediction)(sem_idx, x_T)
