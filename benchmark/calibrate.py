"""Readings that set the limits of ``correct``: the program's numbers over many
seeds, and the control's and the planted faults' on a few.

    python3 -m benchmark.calibrate --workload <name> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--seconds 3] [--out FILE]

Runs on the card from the root of a checkout: each seed a short window of
the cell as ``benchmark.run`` runs it (a warm process: kernels load once),
then, with no program, the control: the reference at the precision below
the configuration's (TF32 for float32, fp8 for bfloat16) in the program's
place; for a training cell also the fault of half the batch left out (the
reference's loss taken over the first half of each batch's rows).  Prints
one JSON object of every reading; the limits stay in ``limits/``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def summary(diag: dict) -> dict:
    """A training reading's per-leaf gaps: the median leaf's and the worst three."""
    out = {}
    for k in ("grad", "update", "grad_diff"):
        if diag.get(k):
            v = sorted(diag[k].items(), key=lambda kv: -kv[1])
            out[f"{k}_median"] = v[len(v) // 2][1]
            out[f"{k}_worst"] = [(n, round(g, 6)) for n, g in v[:3]]
    if "losses" in diag:
        out["loss_steps"] = diag["losses"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    from types import SimpleNamespace

    import torch

    from benchmark.harness.manifest import Manifest
    from benchmark.harness.runner import run_cell

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    m = Manifest()
    cell = m.cell(args.workload)
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0), "program": {},
           "control": {}, "faults": {}}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        diag = {}
        r = run_cell(args.workload, seed, args.seconds, False, "cuda", m, diagnostics=diag)
        out["program"][seed] = dict({k: v["value"] for k, v in r["checks"].items()},
                                    **summary(diag))
        print(f"program seed {seed}: {out['program'][seed]} ({time.perf_counter() - t:.1f} s)",
              file=sys.stderr, flush=True)
    config, traffic = m.config(cell["config"]), m.traffic(cell["traffic"])
    driver = m.driver(traffic["driver"])
    lower = LOWER[config["compute_dtype"]]
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        run = SimpleNamespace(config=config, traffic=traffic, seed=seed, device="cuda", limits={})
        if traffic["driver"] == "train":
            diag, half = {}, {}
            out["control"][seed] = {lower: dict(driver.control(run, lower, diagnostics=diag),
                                                **summary(diag))}
            out["faults"][seed] = {"half_batch": dict(
                driver.control(run, "float32", half_batch=True, diagnostics=half), **summary(half))}
        else:
            out["control"][seed] = {lower: driver.control(run, lower)}
        print(f"control seed {seed}: {out['control'][seed]} {out['faults'].get(seed, '')}",
              file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
