"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the chips the cell asks
for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared, with its limit);
the last lines of standard error repeat the checks.  Exits non-zero, with no
result, without CUDA or with fewer cards than the cell asks for, and when
JAX or the JAX package is loaded once the window has closed.  Kernel builds
and caches stay under ``build/`` in the checkout.  The process's malloc
thresholds are fixed first (``steady_host_heap``).
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "edge_diffusion_tts_tpu")


def process_start() -> float:
    """``time.perf_counter()``'s reading at the start of this process (from
    /proc where it has it, else this module's import)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def steady_host_heap() -> None:
    """Fix glibc's malloc thresholds for this process: blocks up to 32 MiB
    come from the heap, and the heap is never trimmed.  Under glibc's
    dynamic thresholds, whether a call's host mel (up to 20 MB) is mapped
    and faulted in anew depends on the order of the sizes before it, that
    is, on the seed; fixed, the pages are mapped once, in set-up."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.mallopt(-3, 32 << 20)  # M_MMAP_THRESHOLD
    libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD


def main(argv=None) -> int:
    t0 = process_start()
    steady_host_heap()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    build = ROOT / "build"
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda_cache"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(build / sub))

    from benchmark.harness.manifest import Manifest

    manifest = Manifest(ROOT)
    chips = int(manifest.cell(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from benchmark.harness.runner import run_cell

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      manifest, t0)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded after the window: {bad} (the port must load no JAX)", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
