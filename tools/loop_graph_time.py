#!/usr/bin/env python3
"""The token call's host cost on the card: ``fused_generate_mel`` on its
eager route against its graph route (ops/fused_denoise.py, ``LoopPlans``)
at the synthesis cells' largest token shape, B = 64 rows of S = 500 tokens.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/loop_graph_time.py [--out FILE] [--calls N]

For configs/tpu_large_batch.json (bf16 compute) and configs/flagship.json
(float32), on seeded parameters and inputs, three routes of one call:
``host_grid``, the eager call on a grid built on the host each call (the
route before the device grid and the plans: ``ddim_coefficients``, whose
``.cpu()`` waits for the card, then ``prepare_loop_inputs`` on the list);
``eager``, the entry's eager route (a decoder whose plans keep no shape);
``replay``, the entry's graph route.  Per route and call, on the host's
clock: ``return_ms`` (until the call returns) and ``wall_ms`` (until the
card is done, as a closed-loop caller waits); by CUDA events, ``span_ms``
(the card's time from the call's first op to its last, idle included)
and ``busy_ms`` (the call's graph replayed back to back: its device work
with no host in between).  ``host_ms`` is ``wall_ms`` less ``busy_ms``,
the benchmark's ``host_ms_per_call.synth`` without the mel's copy.  Means
over ``--calls`` calls after three.  The result goes to stdout (and
``--out``) as JSON, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"bfloat16": "configs/tpu_large_batch.json", "float32": "configs/flagship.json"}
B, S = 64, 500


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def decoder(torch, cfg, dtype, dev):
    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder

    torch.manual_seed(0)
    dec = EdgeDiffusionDecoder(cfg, dtype=dtype)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in dec.parameters():  # off the init: the output head starts at zero
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return dec.to(dev).eval()


def timed(torch, call, calls: int) -> dict:
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    returned, wall, span = [], [], []
    for _ in range(calls):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        call()
        t1 = time.perf_counter()
        b.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        returned.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
        span.append(a.elapsed_time(b))
    return {"return_ms": statistics.fmean(returned), "wall_ms": statistics.fmean(wall),
            "span_ms": statistics.fmean(span)}


def busy_ms(torch, graph, calls: int) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graph.replay()
    torch.cuda.synchronize()
    a.record()
    for _ in range(calls):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="")
    p.add_argument("--calls", type=int, default=30)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    result = {"card": card(), "torch": torch.__version__, "B": B, "S": S}
    for name, path in CONFIGS.items():
        with open(os.path.join(ROOT, path)) as f:
            cfg = CFG.from_dict(json.load(f))
        dtype = getattr(torch, name)
        steps, pred = cfg.inference_steps, "v" if cfg.use_v_prediction else "eps"
        sched = DiffusionSchedule.create(cfg.diff_steps).to(dev)
        dec, dec_eager = decoder(torch, cfg, dtype, dev), decoder(torch, cfg, dtype, dev)
        fd.loop_plans(dec_eager).limit = 0  # keeps no shape: every call eager
        packed = fd.pack_decoder_weights(dec, dtype)
        packed_eager = fd.pack_decoder_weights(dec_eager, dtype)
        g = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.effective_codebook_size(), (B, S), generator=g, device=dev)
        x = torch.randn(B, 2 * S, cfg.n_mels, generator=g, device=dev)

        def host_grid():
            with torch.no_grad():
                ts, coef = fd.ddim_coefficients(sched, steps)
                loop = fd.prepare_loop_inputs(dec_eager, tokens, x.shape[1], ts)
                return fd.fused_ddim(x, loop["pos"], loop["mods"], loop["ckv"].to(dtype),
                                     coef.to(dev), packed_eager, heads=cfg.heads,
                                     window=cfg.attn_window_size, prediction=pred,
                                     compute_dtype=dtype)

        routes = {
            "host_grid": host_grid,
            "eager": lambda: fd.fused_generate_mel(cfg, sched, dec_eager, tokens, x, steps, pred,
                                                   weights=packed_eager, compute_dtype=dtype),
            "replay": lambda: fd.fused_generate_mel(cfg, sched, dec, tokens, x, steps, pred,
                                                    weights=packed, compute_dtype=dtype),
        }
        for call in routes.values():  # the graph route: eager, capture, then replays
            for _ in range(3):
                call()
        outs = {r: call() for r, call in routes.items()}
        torch.cuda.synchronize()
        same = all(torch.equal(o, outs["host_grid"]) for o in outs.values())
        fd.zero_plan_counts()
        row = {r: timed(torch, call, args.calls) for r, call in routes.items()}
        counts = (fd.fused_generate_mel.eager, fd.fused_generate_mel.captures,
                  fd.fused_generate_mel.replays)
        busy = busy_ms(torch, next(iter(fd.loop_plans(dec).plans.values())).graph, args.calls)
        for r in row.values():
            r["busy_ms"] = busy
            r["host_ms"] = r["wall_ms"] - busy
        row.update(bit_equal=same, routes_eager_captures_replays=counts)
        result[name] = row
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
