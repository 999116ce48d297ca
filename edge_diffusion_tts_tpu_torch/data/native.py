"""ctypes bindings for the native (C++) audio-ingest library (counterpart of
``edge_diffusion_tts_tpu/data/native.py``, the same calls).

Builds the repository's ``native/wavio.cpp`` on first use with g++ into the
git-ignored ``build/native/`` (never into ``native/``) and exposes
``NativeCollate``, whose decode -> resample -> crop -> clamp path runs in
parallel C++ worker threads.  Without a compiler ``native_available()`` is
False and the Python ``Collate`` serves.

The resampler consumes ``ops/resample.py``'s windowed-sinc kernel bank, so
native and host outputs agree in float32.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ..config import CFG
from ..ops.resample import _sinc_kernel

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC_PATH = os.path.join(_ROOT, "native", "wavio.cpp")
_LIB_PATH = os.path.join(_ROOT, "build", "native", "libedtaudio.so")

_lib = None
_build_error: Optional[str] = None
_LOCK = threading.Lock()


def _build() -> Optional[str]:
    """Compile the shared library; returns an error string or None."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        "-o", tmp, _SRC_PATH, "-lpthread",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return str(e)
    if proc.returncode != 0:
        return proc.stderr[-2000:]
    os.replace(tmp, _LIB_PATH)
    return None


def _load():
    with _LOCK:
        return _load_locked()


def _load_locked():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) or (
        os.path.exists(_SRC_PATH)
        and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_LIB_PATH)
    ):
        _build_error = _build()
        if _build_error is not None:
            return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.edt_read_wav.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.edt_read_wav.restype = ctypes.c_int
    lib.edt_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.edt_collate.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,  # kernel_sr: the source rate the kernel bank is for
        ctypes.c_uint64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.edt_collate.restype = ctypes.c_int
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def read_wav_native(path: str) -> Tuple[np.ndarray, int]:
    """Decode one WAV via the C++ reader -> (float32 mono, sample_rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    rc = lib.edt_read_wav(path.encode(), ctypes.byref(out),
                          ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        raise IOError(f"edt_read_wav({path}) failed with {rc}")
    try:
        wav = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.edt_free(out)
    return wav, sr.value


class NativeCollate:
    """Path batch -> {"wav": [B, segment_len] float32}; all work in C++.

    Unlike data.collate.Collate (which takes decoded (wav, sr) items), this
    consumes file paths, so decode+resample+crop run in native worker threads
    with no Python per item.  Pair with a path-yielding dataset
    (e.g. ``LJSpeechDataset.ids`` joined to wav paths).
    """

    def __init__(
        self,
        cfg: CFG,
        orig_sr: int = 22050,
        deterministic: bool = False,
        seed: int = 0,
        threads: Optional[int] = None,
    ):
        self.cfg = cfg
        self.deterministic = deterministic
        self.seed = seed
        self.threads = threads or min(8, os.cpu_count() or 1)
        # The kernel bank is valid ONLY for orig_sr-rate files; the C++
        # side errors on any other rate instead of silently pitch-shifting.
        self.orig_sr = orig_sr
        g = math.gcd(orig_sr, cfg.sample_rate)
        self.orig_g, self.new_g = orig_sr // g, cfg.sample_rate // g
        kernel, self.width = _sinc_kernel(self.orig_g, self.new_g)
        self.kernel = np.ascontiguousarray(kernel, np.float32)
        self._batch_idx = 0

    def __call__(self, paths: Sequence[str]) -> dict:
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        n = len(paths)
        out = np.empty((n, self.cfg.segment_len), np.float32)
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        self._batch_idx += 1
        rc = lib.edt_collate(
            c_paths,
            n,
            self.cfg.segment_len,
            self.cfg.sample_rate,
            self.kernel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.kernel.shape[1],
            self.orig_g,
            self.new_g,
            self.width,
            self.orig_sr,
            (self.seed << 20) + self._batch_idx,
            int(self.deterministic),
            self.threads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise IOError(f"edt_collate failed on item {-rc - 1}: "
                          f"{paths[-rc - 1]}")
        return {"wav": out}
