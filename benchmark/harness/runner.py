"""One run of one cell: its driver module's window, the metrics, the check, the line.

``run_cell`` is what ``benchmark.run`` calls once it has found the chips;
tests call it with ``device="cpu"`` and small ``overrides`` to drive a whole
run on the port's plain CPU paths.  On the card it first has the port build
whatever kernel library the checkout lacks, and reports that time apart as
``build_s`` (0 once built; ``setup_s`` holds it too).
"""

from __future__ import annotations

import math
import sys
import time
from types import SimpleNamespace
from typing import Optional

from . import compare
from .manifest import Manifest


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             manifest: Optional[Manifest] = None, t0: Optional[float] = None,
             overrides: Optional[dict] = None, diagnostics: Optional[dict] = None) -> dict:
    import torch

    m = manifest or Manifest()
    cell = m.cell(name)
    config, traffic, limits = m.config(cell["config"]), m.traffic(cell["traffic"]), m.limits(name)
    for part, d in (("config", config), ("traffic", traffic), ("limits", limits)):
        d.update((overrides or {}).get(part, {}))
    run = SimpleNamespace(name=name, cell=cell, config=config, traffic=traffic, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace), device=device, limits=limits,
                          t0=time.perf_counter() if t0 is None else t0)
    build_s = 0.0
    if device != "cpu":
        from edge_diffusion_tts_tpu_torch import _build

        t = time.perf_counter()
        _build.build_all()
        build_s = time.perf_counter() - t
    out = m.driver(traffic["driver"]).run(run)
    if diagnostics is not None:
        diagnostics.update(getattr(run, "diagnostics", {}))
    checks = compare.judge(out["numbers"], limits)
    cuda = device != "cpu"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": all(c["ok"] for c in checks.values()) and bool(checks),
              "attempted": int(out["attempted"]), "failed": int(out["failed"])}
    if trace:
        view = out["trace"]
        dev["busy_s"] = view.busy_s()
        dev["window_s"] = view.window_s
        metrics = {}
        for pm in m.per_layer(name):
            value = m.reader(pm["name"])(view)
            if value is not None and math.isfinite(value):
                metrics[pm["name"]] = {"value": value, "unit": pm["unit"]}
        result.update(metrics=metrics, device=dev, breakdown=view.breakdown())
    else:
        metrics = {em["name"]: {"value": out["e2e"][em["name"]], "unit": em["unit"]}
                   for em in m.end_to_end(name)}
        result.update(metrics=metrics, device=dev)
    result["build_s"] = build_s
    print(f"build_s {build_s!r} (inside setup_s)", file=sys.stderr)
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    return result
