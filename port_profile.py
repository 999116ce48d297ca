#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's paths, on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 port_profile.py

Profiles (``torch.profiler``, CPU + CUDA activity) a steady window of
calls of each path with the weights and inputs of chip_smoke.py:

- flagship: ``EdgeInference(backend="fused").generate_mel``, B=1, S=250,
  4 DDIM steps (5 calls);
- long-form: ``EdgeInference(backend="eager", sampler="dpmpp")`` at
  configs/longform.json, S=2000 -> T=4000, 4 steps (3 calls);
- audio: ``EdgeInference(backend="fused", encoder=...).generate_from_audio``
  on a 5 s wav (80,000 samples) at B=1, full HuBERT-base width (5 calls);
- ddpm: ``FusedEdgeInference.sample_ddpm``, 1000 steps at B=1, S=250 (1 call).

For each it prints the wall time per call, the device busy time (the union
of the kernels' intervals) and its share of the wall time, the device time
per call of the kernels by name and by group (the frontend kernel, the
decoder-loop kernels, cuBLAS/cuDNN products such as HuBERT's, the rest), and
the host gap (wall minus busy time).  For the audio path it also times each
stage alone with CUDA events.  It writes the same as JSON to
build/port_profile.json and exits non-zero without a CUDA device.
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
    # Busy time is the union of the device intervals: kernels that overlap
    # (cuDNN runs a grouped conv's groups side by side) count once.
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type is not None and "cuda" in str(e.device_type).lower())
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    busy_ms = busy_us / 1e3 / calls
    return {"wall_ms_per_call": wall_ms / calls,
            "kernel_ms_per_call": sum(k["ms_per_call"] for k in kernels),
            "device_ms_per_call": busy_ms, "busy_share": busy_ms / (wall_ms / calls),
            "kernels": kernels}


# Kernel-name substrings -> group, first match wins.
GROUPS = (
    ("conv_gemm_kernel", "conv frontend kernel"),
    ("gemm_kernel<", "decoder loop kernels"),
    ("band_attention_kernel", "decoder loop kernels"),
    ("rownorm_kernel", "decoder loop kernels"),
    ("ddim_kernel", "decoder loop kernels"),
    ("ddpm_kernel", "decoder loop kernels"),
    ("gemm", "cuBLAS/cuDNN products"),
    ("cutlass", "cuBLAS/cuDNN products"),
    ("conv", "cuBLAS/cuDNN products"),
)


def group_of(name: str) -> str:
    return next((g for key, g in GROUPS if key in name), "other (elementwise, norms, copies)")


def report(name: str, r: dict) -> None:
    groups = {}
    for k in r["kernels"]:
        g = group_of(k["name"])
        groups[g] = groups.get(g, 0.0) + k["ms_per_call"]
    r["groups_ms_per_call"] = groups
    r["host_gap_ms_per_call"] = r["wall_ms_per_call"] - r["device_ms_per_call"]
    print(f"[{name}] wall {r['wall_ms_per_call']:.4f} ms/call, device busy "
          f"{r['device_ms_per_call']:.4f} ms/call (kernel times summed "
          f"{r['kernel_ms_per_call']:.4f}), busy share {r['busy_share']:.3f}, "
          f"host gap {r['host_gap_ms_per_call']:.4f} ms/call")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{name}]   group {ms:.5f} ms  {g}")
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
    torch.backends.cudnn.allow_tf32 = False
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

    from edge_diffusion_tts_tpu_torch.ops.fused_denoise import FusedEdgeInference

    encoder = chip_smoke.seeded_encoder(torch, cfg, chip_smoke.SEED).cuda()
    aengine = EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), dec,
                            backend="fused", encoder=encoder)
    rng = np.random.RandomState(3000 + chip_smoke.SEED)
    wav = torch.from_numpy((0.2 * rng.randn(1, 80000)).astype(np.float32)).cuda()
    out["audio_fused"] = profile_calls(
        torch, lambda: aengine.generate_from_audio(wav, num_steps=4), calls=5)
    report("audio_fused", out["audio_fused"])
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff

    w = aengine.frontend_weights
    with torch.no_grad():
        feats = ff.conv_frontend(wav, w)
        h = encoder.hubert.feature_projection(feats)
        tokens = ff.fast_encode(encoder, wav, w)
        stages = {
            "frontend kernel": lambda: ff.conv_frontend(wav, w),
            "HuBERT positional conv (cuDNN, groups 16)":
                lambda: encoder.hubert.encoder.pos_conv_embed(h),
            "HuBERT to layer 9 from the conv features":
                lambda: encoder.extract_hubert(wav, conv_feats=feats),
            "fast_encode (all of the encode)": lambda: ff.fast_encode(encoder, wav, w),
            "generate_mel (4-step fused DDIM)": lambda: aengine.generate_mel(tokens, num_steps=4),
        }
        out["audio_stage_ms"] = {k: chip_smoke.timed_ms(torch, fn, iters=10)
                                 for k, fn in stages.items()}
    for k, ms in out["audio_stage_ms"].items():
        print(f"[audio_stages] {ms:.4f} ms  {k}")

    dengine = FusedEdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), dec)
    out["ddpm_1000"] = profile_calls(
        torch, lambda: dengine.sample_ddpm(sem, generator=torch.Generator(device="cuda")
                                           .manual_seed(chip_smoke.SEED)), calls=1)
    report("ddpm_1000", out["ddpm_1000"])

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "port_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
