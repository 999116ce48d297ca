#!/usr/bin/env python3
"""The bf16 decoder step's two attentions apart, on the card, at the
shapes of the benchmark's bf16 token cell.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/attention16_split.py [--tile host|keys|rows ...] [--sweep] [--out FILE]

For each 1 s bucket of the cell's traffic (2-10 s: S = 50 x bucket tokens,
T = 2S frames) at B = 64 rows, 4 heads of 40 (configs/tpu_large_batch.json),
and at the edge call's B = 1, S = 250, it launches ``step_attention`` on
seeded bf16 q, k, v: the band self-attention (window 64) and the
cross-attention (every key), each in the tiles named (``host``: the
launcher's own pick; ``keys`` and ``rows`` force csrc/attention16.cuh's
key-split or row-split tile, where the port has ``step_attention(tile=)``),
and prints the device µs of one launch (CUDA-graph replay between CUDA
events, chip_smoke.py's ``graph_ms``) and the output's normwise distance
from ``_attention_rounded`` at bf16 (the plain version of the same
roundings) over its distance from the float32 attention.  Then, per tile,
one call's attention ms averaged over the traffic's 40-call block (2, 3, 3,
4, 4, 5, 5, 6, 8 calls of the 2-10 s buckets), 4 layers x 4 steps of each
attention a call.  ``--sweep`` adds B = 2-32 rows at S = 250 and 500 (the
shapes where the host's rule passes from one tile to the other).  The
whole result goes to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKET_CALLS = {2: 2, 3: 3, 4: 3, 5: 4, 6: 4, 7: 5, 8: 5, 9: 6, 10: 8}  # a 40-call block
HEADS, D, WINDOW, LAUNCHES = 4, 40, 64, 16  # 4 layers x 4 steps of each attention a call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tile", nargs="+", default=["host"], choices=["host", "keys", "rows"])
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--out", default="build/attention16_split.json")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from chip_smoke import _rel, graph_ms
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    if not torch.cuda.is_available():
        print("attention16_split: no CUDA device is available", file=sys.stderr)
        return 2
    has_tile = "tile" in inspect.signature(fd.step_attention).parameters
    tiles = [t for t in args.tile if t == "host" or has_tile]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {smi} | torch {torch.__version__} | tiles {tiles}")
    bf16, dev = torch.bfloat16, torch.device("cuda")
    shapes = [(64, 50 * s, s) for s in BUCKET_CALLS] + [(1, 250, 0)]
    if args.sweep:
        shapes += [(B, S, 0) for S in (250, 500) for B in (2, 4, 8, 16, 32)]
    rows = []
    for B, S, bucket in shapes:
        T = 2 * S
        g = torch.Generator().manual_seed(23_000 + S + B)
        for kind, tk, window in (("self", T, WINDOW), ("cross", S, None)):
            q, k, v = (torch.randn(B, HEADS, n, D, generator=g).to(dev, bf16) for n in (T, tk, tk))
            mask = None
            if window is not None:
                i = torch.arange(T, device=dev)
                mask = (i[:, None] - torch.arange(tk, device=dev)[None, :]).abs() <= window
            q32, k32, v32 = q.float(), k.float(), v.float()
            plain = fd._attention_rounded(q32, k32, v32, bf16, mask).to(bf16)
            exact = fd._attention_rounded(q32, k32, v32, torch.float32, mask)
            e_p = _rel(plain, exact)
            del q32, k32, v32
            for tile in tiles:
                kw = {"tile": tile} if tile != "host" else {}
                got = fd.step_attention(q, k, v, window, compute_dtype=bf16, **kw)
                torch.cuda.synchronize()
                gap = _rel(got, plain) / e_p
                us = 1e3 * graph_ms(torch, lambda: fd.step_attention(
                    q, k, v, window, compute_dtype=bf16, **kw), n=20, replays=5)
                rows.append(dict(B=B, T=T, S=S, bucket=bucket, kind=kind, tile=tile, us=us,
                                 gap=gap))
                print(f"[split] B={B} T={T} S={S} {kind:5s} tile={tile:4s} {us:10.3f} us  "
                      f"|kernel - plain| / |plain - float32| {gap:.4f}")
            del plain, exact
    per_call = {}
    for tile in tiles:
        ms = {kind: sum(n * next(r["us"] for r in rows if r["bucket"] == b and r["kind"] == kind
                                 and r["tile"] == tile) for b, n in BUCKET_CALLS.items())
              * LAUNCHES / 1e3 / sum(BUCKET_CALLS.values()) for kind in ("self", "cross")}
        per_call[tile] = ms
        print(f"[split] tile={tile}: a call of the 40-call block: self {ms['self']:.4f} ms, "
              f"cross {ms['cross']:.4f} ms, both {ms['self'] + ms['cross']:.4f} ms")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "rows": rows, "per_call_ms": per_call}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
