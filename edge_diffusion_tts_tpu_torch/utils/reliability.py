"""Failure detection and recovery helpers (counterpart of
``edge_diffusion_tts_tpu/utils/reliability.py``).

Three light mechanisms:

  - ``make_nan_guard``: a training hook that watches the loss and raises
    (or restores the last good checkpoint) when it goes non-finite —
    catching divergence within ``patience`` steps instead of burning the
    rest of the run;
  - ``retry_transient``: retries a callable on transient backend errors
    (preemption, connection hiccups) with exponential backoff;
  - together with training/train.py's ``resume="auto"`` + periodic
    checkpoints, a crashed run restarts losslessly.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional, Tuple, Type


class DivergenceError(RuntimeError):
    pass


def make_nan_guard(patience: int = 1) -> Callable:
    """``guard(step, loss)`` raising DivergenceError after ``patience``
    consecutive non-finite losses.

    Wire it where metrics are visible, e.g.::

        guard = make_nan_guard()
        for batch in loader:
            state, metrics = step(state, batch, rng)
            guard(int(state.step), float(metrics["loss"]))
    """
    streak = {"n": 0}

    def guard(step: int, loss: float):
        if not math.isfinite(loss):
            streak["n"] += 1
            if streak["n"] >= patience:
                raise DivergenceError(
                    f"loss non-finite for {streak['n']} consecutive checks "
                    f"at step {step}"
                )
        else:
            streak["n"] = 0

    return guard


def retry_transient(
    fn: Callable,
    max_retries: int = 3,
    base_delay_s: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = None,
    on_retry: Optional[Callable] = None,
):
    """Call ``fn()``; on a transient backend error, back off and retry.

    By default retries a RuntimeError whose message looks transport- or
    preemption-shaped; anything else re-raises immediately.
    """
    # Deliberately narrow: a kernel fault or an out-of-memory error is
    # deterministic, and retrying it multiplies a failure by the backoff.
    transient_markers = (
        "UNAVAILABLE", "DEADLINE_EXCEEDED",
        "preempt", "socket", "connection",
    )
    if retry_on is None:
        retry_on = (RuntimeError,)

    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203
            msg = str(e)
            if attempt >= max_retries or not any(
                m.lower() in msg.lower() for m in transient_markers
            ):
                raise
            delay = base_delay_s * (2 ** attempt)
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)
