#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's two paths, on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 port_profile.py

Profiles (``torch.profiler``, CPU + CUDA activity) a steady window of
calls of each path with the weights and inputs of chip_smoke.py:

- flagship: ``EdgeInference(backend="fused").generate_mel``, B=1, S=250,
  4 DDIM steps (5 calls);
- long-form: ``EdgeInference(backend="eager", sampler="dpmpp")`` at
  configs/longform.json, S=2000 -> T=4000, 4 steps (3 calls).

For each it prints the wall time per call, the device busy share (summed
kernel time over the window's wall time) and the device time per call of
the kernels by name, and writes the same as JSON to
build/port_profile.json.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_calls(torch, fn, calls: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up (kernel build and load happen before the window)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type is not None and "cuda" in str(evt.device_type).lower():
            kernels.append({"name": evt.key[:90], "ms_per_call": us / 1e3 / calls,
                            "count_per_call": evt.count / calls})
    kernels.sort(key=lambda k: -k["ms_per_call"])
    busy_ms = sum(k["ms_per_call"] for k in kernels)
    return {"wall_ms_per_call": wall_ms / calls, "device_ms_per_call": busy_ms,
            "busy_share": busy_ms / (wall_ms / calls), "kernels": kernels}


def report(name: str, r: dict) -> None:
    print(f"[{name}] wall {r['wall_ms_per_call']:.4f} ms/call, device "
          f"{r['device_ms_per_call']:.4f} ms/call, busy share {r['busy_share']:.3f}")
    for k in r["kernels"][:12]:
        print(f"[{name}]   {k['ms_per_call']:.5f} ms  x{k['count_per_call']:.0f}  {k['name']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_profile: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"device": torch.cuda.get_device_name(0)}

    cfg = CFG(dropout=0.0)
    dec = chip_smoke.seeded_decoder(torch, cfg, chip_smoke.SEED).cuda()
    engine = EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), dec,
                           backend="fused")
    rng = np.random.RandomState(1000 + chip_smoke.SEED)
    sem = torch.from_numpy(rng.randint(0, 2304, (1, 250))).cuda()
    x_T = torch.from_numpy(rng.randn(1, 500, cfg.n_mels).astype(np.float32)).cuda()
    out["flagship_fused"] = profile_calls(
        torch, lambda: engine.generate_mel(sem, num_steps=4, x_T=x_T), calls=5)
    report("flagship_fused", out["flagship_fused"])

    with open(os.path.join(ROOT, "configs", "longform.json")) as f:
        lcfg = CFG.from_json(f.read())
    ldec = chip_smoke.seeded_decoder(torch, lcfg, chip_smoke.SEED).cuda()
    lengine = EdgeInference(lcfg, DiffusionSchedule.create(lcfg.diff_steps), ldec,
                            prediction="v", sampler="dpmpp")
    rng = np.random.RandomState(2000 + chip_smoke.SEED)
    lsem = torch.from_numpy(rng.randint(0, 2304, (1, 2000))).cuda()
    lx = torch.from_numpy(rng.randn(1, 4000, lcfg.n_mels).astype(np.float32)).cuda()
    out["longform_eager"] = profile_calls(
        torch, lambda: lengine.generate_mel(lsem, num_steps=4, x_T=lx), calls=3)
    report("longform_eager", out["longform_eager"])

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "port_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
