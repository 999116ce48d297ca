"""Benchmark: 4-step mel generation latency for a 5 s utterance on the card
(the port of the JAX package's root ``bench.py``, packaged so that the CLI's
``bench`` works from any working directory).

The flagship decoder (``CFG()``: hidden 160, 4 layers, eps prediction,
weights from ``torch.manual_seed(0)``) generates B=1, S=250 tokens -> T=500
mel frames in 4 DDIM steps through ``EdgeInference.generate_mel`` on two
backends, ``"fused"`` (the fused DDIM kernel, one launch per call) and
``"eager"`` (the module loop).  Per backend: the host-clock median of
``RUNS`` calls, each ending in a synchronize, and the device time per call
by CUDA events around ``RUNS`` back-to-back calls.  A failing backend fails
the command: nothing falls back.

Prints ONE JSON line: ``metric``, ``value`` (the fastest backend's device
ms), ``unit``, ``backend`` (which), the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and every backend's readings.  There is no baseline: the JAX
package's 50 ms target is a TPU v5e's.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

AUDIO_SECS = 5.0
RUNS = 20
WARMUP = 3
BACKENDS = ("fused", "eager")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def measure(engine, sem_idx, runs: int = RUNS) -> dict:
    """Host-clock median and CUDA-event device ms per 4-step call."""
    def call():
        return engine.generate_mel(sem_idx, num_steps=4,
                                   generator=torch.Generator(device=engine.device).manual_seed(9))

    for _ in range(WARMUP):
        call()
    torch.cuda.synchronize(engine.device)
    host = []
    for _ in range(runs):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize(engine.device)
        host.append((time.perf_counter() - t0) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        call()
    stop.record()
    torch.cuda.synchronize(engine.device)
    return {"host_median_ms": float(np.median(host)),
            "device_ms": start.elapsed_time(stop) / runs}


def main(device=None) -> dict:
    """Run the benchmark on ``device`` (the card unless told otherwise; it
    times the card, so another device is refused) and print its line."""
    from .config import CFG, resolve_device
    from .inference import EdgeInference
    from .models import EdgeDiffusionDecoder
    from .schedule import DiffusionSchedule

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"bench times the CUDA card; device {device} is refused")
    cfg = CFG()
    torch.manual_seed(0)
    decoder = EdgeDiffusionDecoder(cfg)
    schedule = DiffusionSchedule.create(cfg.diff_steps)
    n_tokens = int(AUDIO_SECS * 50)  # 50 Hz tokens -> 100 Hz mel frames (T = 2S)
    sem_idx = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.effective_codebook_size(), (1, n_tokens))).to(device)
    results = {}
    for backend in BACKENDS:
        engine = EdgeInference(cfg, schedule, decoder, backend=backend, device=device)
        results[backend] = measure(engine, sem_idx)
    best = min(results, key=lambda b: results[b]["device_ms"])
    line = {"metric": "4step_melgen_latency_5s", "value": results[best]["device_ms"],
            "unit": "ms", "backend": best, "card": card_line(), "backends": results}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
