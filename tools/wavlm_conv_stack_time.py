#!/usr/bin/env python3
"""WavLM-Large's conv feature extractor on the card: the modules route
(models/hubert.py::FeatureExtractor at bf16: cuDNN convolutions, each
followed by a transposed float32 LayerNorm and GELU) against the kernel
route (ops/fused_frontend.py::conv_frontend, the bf16 frontend kernels in
their LayerNorm mode) at the shapes of the benchmark's WavLM-Large cell.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/wavlm_conv_stack_time.py [--out FILE]

For each 1 s bucket of the cell's traffic (2-10 s at 16 kHz, rows padded to
the bucket's edge) at B = 32 rows it times the whole conv stack on a seeded
wav by CUDA events over several calls, with each route's extra peak memory.
Then one call's conv stack ms, averaged over the traffic's 40-call block
(2, 3, 3, 4, 4, 5, 5, 6, 8 calls of the 2-10 s buckets), for each route.
A checkout whose frontend has no LayerNorm mode reports the modules route
alone.  The result goes to stdout (and ``--out``) as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32
BLOCK = dict(zip(range(2, 11), (2, 3, 3, 4, 4, 5, 5, 6, 8)))  # calls of each bucket


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


def peak_bytes(fn) -> int:
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="")
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from edge_diffusion_tts_tpu_torch.models.hubert import FeatureExtractor, HubertConfig
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    torch.manual_seed(0)
    fe = FeatureExtractor(HubertConfig.wavlm_large(), dtype=bf16)
    with torch.no_grad():
        for layer in fe.conv_layers:
            layer.layer_norm.weight.add_(0.1 * torch.randn_like(layer.layer_norm.weight))
            layer.layer_norm.bias.add_(0.1 * torch.randn_like(layer.layer_norm.bias))
    fe = fe.to(dev).eval()
    routes = {"modules": None}
    if hasattr(ff, "ln_launches"):  # the frontend kernels have a LayerNorm mode
        routes["kernel"] = ff.pack_frontend_weights(fe, bf16)
    out = {"device": torch.cuda.get_device_name(0), "rows": B, "routes": list(routes),
           "buckets": []}
    for sec in BLOCK:
        g = torch.Generator(device=dev).manual_seed(sec)
        wav = 0.1 * torch.randn(B, 16000 * sec, generator=g, device=dev)
        row = dict(bucket_s=sec, samples=16000 * sec)
        with torch.inference_mode():
            for route, w in routes.items():
                fn = (lambda: fe(wav)) if w is None else (
                    lambda: ff.conv_frontend(wav, w, compute_dtype=bf16))
                row[f"{route}_ms"] = device_ms(fn, args.reps)
                row[f"{route}_peak_bytes"] = peak_bytes(fn)
        out["buckets"].append(row)
        print(row, file=sys.stderr, flush=True)
    n = sum(BLOCK.values())
    for route in routes:
        out[f"call_{route}_ms"] = sum(r[f"{route}_ms"] * BLOCK[r["bucket_s"]]
                                      for r in out["buckets"]) / n
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
