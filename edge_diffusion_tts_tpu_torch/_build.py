"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each source in ``csrc/`` with a plain C interface becomes one shared
library for ``sm_90a`` (Hopper).  Libraries land in ``build/kernels/<hash>/``
at the root of the checkout, keyed by a hash of every file in ``csrc/`` and
the compiler flags, so an edited source builds anew and an unchanged one is
reused.  ``build_all()`` compiles every missing library at once, one nvcc
process per source, all started together.  Nothing is compiled or loaded
at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"

# library name -> source file in csrc/
SOURCES = {
    "band_attention": "band_attention.cu",
    "conv_frontend": "conv_frontend.cu",
    "fused_ddim": "fused_ddim.cu",  # also holds the DDPM loop (edt_fused_ddpm)
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"libedt_{name}.so"


def build_all() -> Dict[str, dict]:
    """Compile every library that is not built yet, all nvcc runs in parallel.

    Returns ``{name: {"seconds": float, "log": str}}`` for the libraries it
    built (ptxas's register and shared-memory report is in ``log``).  Raises
    RuntimeError with the compiler's output if any build fails.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = {n: s for n, s in SOURCES.items() if not library_path(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, src in todo.items():
        tmp = out_dir / f".libedt_{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    results, failures = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        results[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failures.append(f"--- {SOURCES[name]} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return results


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building all missing libraries first)."""
    if not library_path(name).exists():
        build_all()
    return ctypes.CDLL(str(library_path(name)))


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
