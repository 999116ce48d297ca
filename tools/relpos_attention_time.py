#!/usr/bin/env python3
"""WavLM's gated relative-position attention on the card: the kernel
(csrc/relpos_attention16.cuh) against the module's plain route
(models/hubert.py::gated_attention) at the shapes of the benchmark's
WavLM-Large cell.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/relpos_attention_time.py [--out FILE]

For each 1 s bucket of the cell's traffic (2-10 s at 16 kHz: S frames of the
conv stack) at B = 32 rows, 16 heads of 64, it times one layer's attention on
a seeded packed input (bf16 q, k, v and gate projections, an offset vector
and gate constants) by CUDA events over many launches, with the plain
route's extra peak memory (its [B, heads, S, S] float32 tensors) and the
kernel's rate of products (4 B heads S^2 64 over its time).  Then one
call's attention ms, 21 layers averaged over the traffic's 40-call block
(2, 3, 3, 4, 4, 5, 5, 6, 8 calls of the 2-10 s buckets), for each route.
The result goes to stdout (and ``--out``) as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, HEADS, LAYERS = 32, 16, 21
BLOCK = dict(zip(range(2, 11), (2, 3, 3, 4, 4, 5, 5, 6, 8)))  # calls of each bucket


def frames(samples: int) -> int:
    for k, s in zip((10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)):
        samples = (samples - k) // s + 1
    return samples


def device_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from edge_diffusion_tts_tpu_torch.models.hubert import gated_attention
    from edge_diffusion_tts_tpu_torch.ops.relpos_attention import relpos_attention16

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "rows": []}
    for sec in BLOCK:
        S = frames(16000 * sec)
        g = torch.Generator(device=dev).manual_seed(S)
        y = torch.randn(B, S, HEADS * (3 * 64 + 8), generator=g, device=dev).to(torch.bfloat16)
        rel = 0.25 * torch.randn(HEADS, 2 * S - 1, generator=g, device=dev)
        const = 0.25 * torch.randn(HEADS, generator=g, device=dev)
        kernel = device_ms(lambda: relpos_attention16(y, rel, const), 50)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plain = device_ms(lambda: gated_attention(y, rel, const), 5)
        row = dict(bucket_s=sec, S=S, kernel_ms=kernel, plain_ms=plain,
                   plain_peak_bytes=torch.cuda.max_memory_allocated() - base,
                   kernel_tflops=4 * B * HEADS * S * S * 64 / kernel / 1e9)
        out["rows"].append(row)
        print(row, file=sys.stderr, flush=True)
    n = sum(BLOCK.values())
    for route in ("kernel", "plain"):
        out[f"call_{route}_ms"] = sum(LAYERS * r[f"{route}_ms"] * BLOCK[r["bucket_s"]]
                                      for r in out["rows"]) / n
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
