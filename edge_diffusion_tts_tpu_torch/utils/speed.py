"""Performance utilities: timing, benchmarking, profiling, checkpointed blocks
(counterpart of ``edge_diffusion_tts_tpu/utils/speed.py``).

  TimingContext    host clock between two ``torch.cuda.synchronize`` calls
  benchmark        warmup + timed runs, each ending in a synchronize
  fit_device_ms    per-iteration time of a chain by a two-point fit
  scan_chain_builder  the chain ``fit_device_ms`` times, from one body
  profile_trace    ``torch.profiler`` around a block, Chrome trace written
  remat_decoder    each decoder block under ``torch.utils.checkpoint``
  memory_stats     ``torch.cuda.memory_stats`` in MB

PyTorch returns before the card finishes, so a host clock measures device
work only up to a synchronize; the kernels' own times come from CUDA events
(``chip_smoke.py``'s ``timed_ms`` and ``graph_ms``).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict, Optional

import torch

from ..config import resolve_device


def _synchronize(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sync_result(result) -> None:
    """Wait for the device behind ``result``'s first tensor (a tensor, or a
    tuple, list or dict holding tensors)."""
    stack = [result]
    while stack:
        node = stack.pop(0)
        if torch.is_tensor(node):
            _synchronize(node.device)
            return
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)


class TimingContext:
    """Host-clock time of a block, synchronized with ``device`` (the card
    unless told otherwise) on entry and exit; ``elapsed_ms`` after it."""

    def __init__(self, name: str = "block", verbose: bool = True, device=None):
        self.name = name
        self.verbose = verbose
        self.device = resolve_device(device)
        self.elapsed_ms: float = 0.0

    def __enter__(self):
        _synchronize(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _synchronize(self.device)
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        if self.verbose:
            print(f"[{self.name}] {self.elapsed_ms:.2f} ms")
        return False


def benchmark(
    fn: Callable,
    *args,
    warmup: int = 5,
    runs: int = 20,
    **kwargs,
) -> Dict[str, float]:
    """Warmup + timed runs of ``fn(*args, **kwargs)``; stats in ms.  Each run
    ends by synchronizing the device of the result's first tensor."""
    for _ in range(warmup):
        _sync_result(fn(*args, **kwargs))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        _sync_result(fn(*args, **kwargs))
        times.append((time.perf_counter() - t0) * 1e3)
    return {
        "mean_ms": statistics.mean(times),
        "median_ms": statistics.median(times),
        "min_ms": min(times),
        "max_ms": max(times),
        "std_ms": statistics.stdev(times) if len(times) > 1 else 0.0,
        "runs": float(runs),
    }


def scan_chain_builder(body: Callable, args: tuple = (), carry=None):
    """Build the ``chain_builder`` for :func:`fit_device_ms` from one body.

    ``chain_builder(reps)`` returns a callable that runs ``reps`` dependent
    iterations and returns the sum of their scalars as a tensor, which
    ``fit_device_ms`` fetches (``float``): the fetch waits for the device.
    Two body shapes, ``i`` being the iteration's index (a body seeds its
    draws from it):
      ``body(i, *args) -> scalar``                       (carry=None)
      ``body(carry, i, *args) -> (carry, scalar)``       (an explicit carry,
        e.g. an op's output fed back as its next input)
    """

    def build(reps: int):
        def run():
            c, total = carry, None
            for i in range(reps):
                if carry is None:
                    s = body(i, *args)
                else:
                    c, s = body(c, i, *args)
                s = torch.as_tensor(s, dtype=torch.float32)
                total = s if total is None else total + s
            return total

        return run

    return build


def fit_device_ms(
    chain_builder: Callable,
    args: tuple = (),
    reps: tuple = (25, 200),
    runs: int = 5,
    min_spread_ms: float = 300.0,
    max_reps: int = 200_000,
) -> Dict[str, float]:
    """Per-iteration time of a chained program via a two-point fit.

    Models ``wall(reps) = overhead + reps * device_ms`` and fits the slope
    between chains of two lengths, growing the long chain until the two
    median wall times differ by at least ``min_spread_ms``.
    ``chain_builder(reps)`` must return a callable whose result is a
    scalar that is fetched (``float``): the fetch is the completion barrier.

    Returns {"device_ms", "overhead_ms", "wall_lo_ms", "wall_hi_ms",
    "reps_hi"}.
    """

    def median_wall(r):
        fn = chain_builder(r)
        float(fn(*args))  # warmup, fetched
        ts = []
        for _ in range(runs):
            t0 = time.perf_counter()
            float(fn(*args))
            ts.append((time.perf_counter() - t0) * 1e3)
        ts.sort()
        return ts[len(ts) // 2]

    lo, hi = reps
    wall_lo = median_wall(lo)
    # The short chain's time per iteration bounds device_ms from above:
    # a first guess at a long-enough chain, grown below as needed.
    d_ub = wall_lo / lo
    hi = max(hi, lo + int(min_spread_ms / max(d_ub, 1e-9)))
    hi = min(hi, max_reps)
    wall_hi = median_wall(hi)
    while wall_hi - wall_lo < min_spread_ms and hi < max_reps:
        hi = min(hi * 4, max_reps)
        wall_hi = median_wall(hi)

    d = max((wall_hi - wall_lo) / (hi - lo), 0.0)
    return {
        "device_ms": d,
        "overhead_ms": max(wall_lo - lo * d, 0.0),
        "wall_lo_ms": wall_lo,
        "wall_hi_ms": wall_hi,
        "reps_hi": float(hi),
    }


@contextlib.contextmanager
def profile_trace(log_dir: str = "torch_trace"):
    """``torch.profiler`` over the block (CPU, and CUDA when the card is
    there); the Chrome trace goes to ``<log_dir>/trace.json`` (Perfetto or
    chrome://tracing).  Yields the profiler, for ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _ReplayBlock:
    """One decoder block's call under ``torch.utils.checkpoint``.  A training
    call draws dropout masks from an explicit generator, which checkpoint's
    own RNG bookkeeping does not cover: the recompute in the backward resets
    the generator to the state the forward started from, draws the same
    masks, and puts the generator back."""

    def __init__(self, block, generator: Optional[torch.Generator]):
        self.block, self.generator = block, generator
        self.start = None if generator is None else generator.get_state()
        self.ran = False

    def __call__(self, h, context, t_cond, mel_mask, ctx_mask):
        def call():
            return self.block(h, context, cond=t_cond, mel_mask=mel_mask, ctx_mask=ctx_mask,
                              generator=self.generator)

        if self.generator is None or not self.ran:
            self.ran = True
            return call()
        now = self.generator.get_state()
        self.generator.set_state(self.start)
        try:
            return call()
        finally:
            self.generator.set_state(now)


def remat_decoder(decoder_cls):
    """A subclass of ``decoder_cls`` (an ``EdgeDiffusionDecoder``) whose
    backbone runs each block under ``torch.utils.checkpoint``
    (``use_reentrant=False``): the blocks' activations are recomputed in the
    backward instead of kept, device memory traded for compute.  Usage:
    ``RematDecoder = remat_decoder(EdgeDiffusionDecoder); RematDecoder(cfg)``.
    """
    from torch.utils.checkpoint import checkpoint

    class RematDecoder(decoder_cls):
        def backbone(self, h, context, t_cond, mel_mask=None, ctx_mask=None,
                     generator=None):
            for block in self.layers:
                h = checkpoint(_ReplayBlock(block, generator), h, context, t_cond, mel_mask,
                               ctx_mask, use_reentrant=False)
            return h

    RematDecoder.__name__ = RematDecoder.__qualname__ = f"Remat{decoder_cls.__name__}"
    return RematDecoder


def memory_stats(device=None) -> Dict[str, float]:
    """``torch.cuda.memory_stats(device)`` in MB (numbers only); the card
    unless told otherwise, and empty for the CPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: v / 1e6 for k, v in stats.items() if isinstance(v, (int, float))}
