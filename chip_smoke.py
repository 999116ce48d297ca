#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (edge_diffusion_tts_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, each asserting:

1. the card (nvidia-smi name and power limit) and the build of every CUDA
   kernel from csrc/ (one nvcc per source, in parallel), with its time;
2. the banded-attention kernel against its plain version at [1,4,500,40] and
   [1,4,4000,40], window 64, atol 2e-5; timed beside the plain version and a
   band-masked ``scaled_dot_product_attention`` (a yardstick only);
3. the fused DDIM kernel against its plain version at the flagship shape
   (hidden 160, 4 layers, 4 heads of 40, window 64; B=1, S=250, T=500,
   4 steps), eps and v prediction (tolerances below);
4. the main path: ``EdgeInference(backend="fused").generate_mel`` answers
   three requests; outputs finite, one fused launch per request;
5. the long-form shape (configs/longform.json, S=2000 -> T=4000) through
   ``backend="eager"``, 4 steps: one banded launch per layer per step, and
   the same output as with the banded route forced to its plain version.

Why the DDIM tolerances are stated as they are: the DDIM grid starts at
t=999 where sqrt(alpha_bar) = 1.56e-5, and the update divides by it.  With
eps prediction every first-step x0 whose raw value leaves [-3, 3] is
clipped, so the comparison is well conditioned only if no element stays
inside; the script checks that precondition on its inputs and then holds the
kernel to 2e-4 everywhere (the summation order differs from the plain
version's).  With v prediction the reference forms eps = sqrt(1-ab)*x +
sqrt(ab)*v and then x0 = (x - sqrt(1-ab)*eps)/sqrt(ab): a one-ulp difference
in eps moves x0 by ulp(x)/1.56e-5 (about 0.03), so a handful of elements
differ by such a quantum whenever the model outputs differ in the last bit.
v is held to 2e-4 on at least 99.9% of elements and to 0.05 on all.  The
long-form phase samples with DPM-Solver++ (v), which starts at t=950 and
reads x0 = sqrt(ab)*x - sqrt(1-ab)*v, well conditioned, and is held to 1e-4.

Prints one ``{"kernels": [...]}`` line, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device, without the port package beside it, or on any
failed check.  The ptxas report of the build goes to build/chip_smoke_build.log.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_PEAK_FLOPS = 67e12  # H100 SXM float32 without tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SEED = 7  # first-step x0 fully clipped for these weights and inputs (see above)
DEVICE = "cuda"  # the phases' device; a CPU rehearsal of the script sets "cpu"


def bound(flops: float, nbytes: float):
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def band_pairs(T: int, window: int, kv_len: int) -> int:
    i = np.arange(T)
    lo = np.maximum(0, i - window)
    hi = np.minimum(min(T, kv_len) - 1, i + window)
    return int(np.maximum(0, hi - lo + 1).sum())


def seeded_decoder(torch, cfg, seed: int):
    """A decoder whose every weight comes from numpy RandomState(seed): torch's
    default-init ranges, then 0.02*N(0,1) on every parameter (so the
    zero-init out head and AdaLN projections are nontrivial)."""
    from torch import nn

    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder

    dec = EdgeDiffusionDecoder(cfg)
    rng = np.random.RandomState(seed)

    def put(p, a):
        p.copy_(torch.from_numpy(np.asarray(a, np.float32)))

    with torch.no_grad():
        for m in dec.modules():
            if isinstance(m, nn.Linear):
                b = 1.0 / np.sqrt(m.in_features)
                put(m.weight, rng.uniform(-b, b, m.weight.shape))
                if m.bias is not None:
                    put(m.bias, rng.uniform(-b, b, m.bias.shape))
            elif isinstance(m, nn.Embedding):
                put(m.weight, rng.randn(*m.weight.shape))
        for p in dec.parameters():
            put(p, p.numpy() + 0.02 * rng.randn(*p.shape))
    return dec.eval()


def phase_build():
    from edge_diffusion_tts_tpu_torch import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_build.log"), "w") as f:
        for name, info in built.items():
            f.write(f"=== {name} ({info['seconds']:.1f} s)\n{info['log']}\n")
    print(f"[build] {sorted(built) or 'cached'} in {seconds:.2f} s "
          f"-> {_build.build_dir()}")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line and " 0 bytes spill" not in line:
                print(f"[build] {name}: {line.strip()}")
    return seconds


def phase_banded(torch):
    import torch.nn.functional as F

    from edge_diffusion_tts_tpu_torch.layers.attention import local_attention_mask
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa

    results = {}
    for T in (500, 4000):
        B, H, d, w = 1, 4, 40, 64
        rng = np.random.RandomState(T)
        q, k, v = (torch.from_numpy(rng.randn(B, H, T, d).astype(np.float32)).to(DEVICE)
                   for _ in range(3))
        got = wa.banded_attention(q, k, v, w)
        torch.cuda.synchronize()
        want = wa.banded_attention_plain(q, k, v, w)
        err = (got - want).abs().max().item()
        assert err <= 2e-5, f"banded T={T}: max err {err} > 2e-5"
        mask = local_attention_mask(T, w, q.device)
        ms = timed_ms(torch, lambda: wa.banded_attention(q, k, v, w))
        plain_ms = timed_ms(torch, lambda: wa.banded_attention_plain(q, k, v, w))
        lib_ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
        flops = 4 * d * band_pairs(T, w, T) * B * H
        bound_ms, bound_by = bound(flops, 4 * B * H * T * d * 4)
        results[T] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        print(f"[banded] T={T}: max_abs_err={err:.3g} ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"sdpa_ms={lib_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by})")
    return results


def fused_flops_bytes(B, T, S, M, H, heads, L, F, window, steps, tensors):
    dh = H // heads
    per_row = 4 * M * H + L * (2 * H * 3 * H + 6 * H * H + 4 * H * F + 2 * F * H)
    attn = L * heads * 4 * dh * (band_pairs(T, window, T) + T * S)
    flops = steps * (B * T * per_row + B * attn)
    nbytes = 4 * (sum(t.numel() for t in tensors) + B * T * M)
    return flops, nbytes


def phase_fused(torch, cfg, decoder, schedule):
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    dev = torch.device(DEVICE)
    B, S, steps = 1, 250, 4
    T = 2 * S
    rng = np.random.RandomState(1000 + SEED)
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (B, S))).to(dev)
    x_T = torch.from_numpy(rng.randn(B, T, cfg.n_mels).astype(np.float32)).to(dev)
    ts, coef = fd.ddim_coefficients(schedule, steps)
    coef = coef.to(dev)
    loop = fd.prepare_loop_inputs(decoder, sem_idx, T, ts)
    w = fd.pack_decoder_weights(decoder)
    args = (x_T, loop["pos"], loop["mods"], loop["ckv"], coef, w)

    # Precondition of the strict eps check: every first-step x0 is clipped.
    with torch.no_grad():
        eps1 = decoder(x_T, torch.full((B,), ts[0], device=dev), sem_idx=sem_idx,
                       step_idx=torch.zeros(B, dtype=torch.long, device=dev))
        raw = (x_T - coef[0, 1] * eps1) / coef[0, 0]
    unclipped = int((raw.abs() < 3.0).sum())
    assert unclipped == 0, f"{unclipped} first-step x0 unclipped: eps check ill-conditioned"

    out = {}
    for prediction in ("eps", "v"):
        kw = dict(heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction)
        got = fd.fused_ddim(*args, **kw)
        torch.cuda.synchronize()
        want = fd.fused_ddim_plain(*args, **kw)
        diff = (got - want).abs()
        err = diff.max().item()
        frac_over = (diff > 2e-4).float().mean().item()
        assert torch.isfinite(got).all(), f"fused {prediction}: non-finite output"
        if prediction == "eps":
            assert err <= 2e-4, f"fused eps: max err {err} > 2e-4"
        else:
            assert frac_over <= 1e-3 and err <= 0.05, (
                f"fused v: {frac_over:.2e} of elements over 2e-4, max err {err}")
        ms = timed_ms(torch, lambda: fd.fused_ddim(*args, **kw), iters=10)
        plain_ms = timed_ms(torch, lambda: fd.fused_ddim_plain(*args, **kw), iters=5)
        out[prediction] = dict(max_abs_err=err, frac_over_2e4=frac_over, ms=ms,
                               plain_ms=plain_ms, x0=got)
        print(f"[fused] {prediction}: max_abs_err={err:.3g} frac>2e-4={frac_over:.2e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
    flops, nbytes = fused_flops_bytes(
        B, T, S, cfg.n_mels, cfg.hidden, cfg.heads, cfg.layers, cfg.hidden * cfg.ffn_mult,
        cfg.attn_window_size, len(ts),
        [x_T, loop["pos"], loop["mods"], loop["ckv"], coef, *w.values()])
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[fused] {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB per call: "
          f"bound_ms={bound_ms:.5f} ({bound_by})")
    out.update(bound_ms=bound_ms, bound_by=bound_by, x_T=x_T, sem_idx=sem_idx)
    return out


def phase_main_path(torch, cfg, decoder, schedule, fused):
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa

    engine = EdgeInference(cfg, schedule, decoder, backend="fused", device=DEVICE)
    engine.generate_mel(fused["sem_idx"], num_steps=4, x_T=fused["x_T"])  # warm-up
    torch.cuda.synchronize()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    requests = [
        dict(sem_idx=fused["sem_idx"], x_T=fused["x_T"]),
        dict(sem_idx=torch.randint(0, 2304, (2, 128), device=DEVICE, generator=gen),
             generator=gen),
        dict(sem_idx=fused["sem_idx"], temperature=0.7, generator=gen),
    ]
    fd.fused_ddim.launches = wa.banded_attention.launches = 0
    times, outs = [], []
    for req in requests:
        t0 = time.perf_counter()
        mel = engine.generate_mel(num_steps=4, **req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(mel)
    launches = fd.fused_ddim.launches
    assert launches == len(requests), f"fused launches {launches} != {len(requests)}"
    for req, mel in zip(requests, outs):
        B, S = req["sem_idx"].shape
        assert mel.shape == (B, 2 * S, cfg.n_mels), mel.shape
        assert torch.isfinite(mel).all(), "non-finite mel"
    # The first request repeats phase 3's eps inputs through the entry point.
    err = (outs[0] - fused["eps"]["x0"]).abs().max().item()
    assert err <= 1e-5, f"entry point differs from the kernel by {err}"
    print(f"[main] fused generate_mel per-call ms: "
          + ", ".join(f"{t:.3f}" for t in times) + f"; fused launches={launches}")
    return launches, times


def phase_longform(torch):
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    with open(os.path.join(ROOT, "configs", "longform.json")) as f:
        cfg = CFG.from_json(f.read())
    decoder = seeded_decoder(torch, cfg, SEED).to(DEVICE)
    schedule = DiffusionSchedule.create(cfg.diff_steps)
    engine = EdgeInference(cfg, schedule, decoder, prediction="v", sampler="dpmpp",
                           device=DEVICE)
    rng = np.random.RandomState(2000 + SEED)
    S, steps = 2000, cfg.inference_steps
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (1, S))).to(DEVICE)
    x_T = torch.from_numpy(rng.randn(1, 2 * S, cfg.n_mels).astype(np.float32)).to(DEVICE)

    engine.generate_mel(sem_idx, num_steps=steps, x_T=x_T)  # warm-up
    torch.cuda.synchronize()
    wa.banded_attention.launches = 0
    t0 = time.perf_counter()
    mel = engine.generate_mel(sem_idx, num_steps=steps, x_T=x_T)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = wa.banded_attention.launches
    assert launches == cfg.layers * steps, f"banded launches {launches}"
    assert mel.shape == (1, 2 * S, cfg.n_mels) and torch.isfinite(mel).all()

    kernel_route = wa.banded_attention
    wa.banded_attention = wa.banded_attention_plain
    try:
        t0 = time.perf_counter()
        plain = engine.generate_mel(sem_idx, num_steps=steps, x_T=x_T)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        wa.banded_attention = kernel_route
    err = (mel - plain).abs().max().item()
    assert err <= 1e-4, f"long-form: max err {err} > 1e-4"
    print(f"[longform] T={2 * S} eager dpmpp {steps} steps: {ms:.3f} ms "
          f"(banded route plain: {plain_ms:.3f} ms), banded launches={launches}, "
          f"max_abs_err={err:.3g}")
    return launches


def run(torch) -> None:
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    banded = phase_banded(torch)

    cfg = CFG(dropout=0.0)
    decoder = seeded_decoder(torch, cfg, SEED).to(DEVICE)
    schedule = DiffusionSchedule.create(cfg.diff_steps)
    fused = phase_fused(torch, cfg, decoder, schedule.to(DEVICE))
    fused_launches, _ = phase_main_path(torch, cfg, decoder, schedule, fused)
    banded_launches = phase_longform(torch)

    b = banded[4000]
    kernels = [
        {"name": "banded_attention", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/attention.cuh",
         "replaces": "edge_diffusion_tts_tpu/ops/window_attention.py:48",
         "launches": banded_launches,
         "max_abs_err": max(r["max_abs_err"] for r in banded.values()),
         "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
         "bound_by": b["bound_by"], "library_ms": b["library_ms"]},
        {"name": "fused_ddim", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/fused_ddim.cu",
         "replaces": "edge_diffusion_tts_tpu/ops/fused_denoise.py:127",
         "launches": fused_launches,
         "max_abs_err": fused["eps"]["max_abs_err"],
         "ms": fused["eps"]["ms"], "plain_ms": fused["eps"]["plain_ms"],
         "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"],
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "edge_diffusion_tts_tpu_torch", "csrc")):
        print("chip_smoke: the port package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        run(torch)
    except Exception:  # any failed phase: report it and print no result
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
