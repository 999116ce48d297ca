"""The profiler's trace of the measured window, reduced for the readers.

The arithmetic is port_profile.py's, frozen here: device busy time is the
union of the intervals of every device activity (kernels, copies, memsets),
so that overlapping kernels count once; kernels are grouped by the name of
their ``__global__`` function (``kernels.json``); a kernel is charged to the
innermost ``record_function`` range above the host op that launched it (the
autograd engine's functions count as the backward's).  The harness's own ranges are
``bench:window`` around the window, ``bench:call`` around each call of a
synthesis cell and ``bench:step`` around each training step.
"""

from __future__ import annotations

import bisect
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

ANNOTATIONS = ("bench:", "train:", "prep:")  # ranges, shown on the device timeline too
KERNEL_GROUPS = Path(__file__).resolve().parents[1] / "kernels.json"


def function_name(kernel: str) -> str:
    """The ``__global__`` function's own name in a demangled kernel name:
    ``void ns::gemm_kernel<32, 64>(GemmArgs)`` -> ``gemm_kernel``."""
    name = re.sub(r"^void\s+", "", kernel.strip()).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            if depth == 0:
                cut = min(cut, i)
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = min(cut, i)
            break
    return name[:cut].split("::")[-1].strip()


def _range_of(event) -> Optional[str]:
    """The innermost ``train:*`` range above a host event; the autograd
    engine's functions (the backward, on its own thread) count as
    ``train:backward``."""
    p = event
    while p is not None:
        if p.name.startswith("train:"):
            return p.name
        if p.name.startswith("autograd::engine::evaluate_function"):
            return "train:backward"
        p = p.cpu_parent
    return None


def union_ns(spans: List[Tuple[int, int]], lo: float = float("-inf"),
             hi: float = float("inf")) -> float:
    """Length of the union of sorted ``spans`` clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for a, b in spans:
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


class TraceView:
    """What the readers read: device activities, host ranges, the window.

    Built from ``torch.profiler``'s events (``prof.events()``, the API
    port_profile.py reads on the card).  ``info`` holds what the cell's driver module knows
    of the window's calls or steps (their sizes) and the configuration."""

    def __init__(self, prof, info: dict):
        with open(KERNEL_GROUPS) as f:
            self.groups: Dict[str, List[str]] = json.load(f)
        self.info = info
        self._group_of: Dict[str, str] = {}
        self._merged = None
        self.kernels: List[Tuple[int, int, str]] = []  # start, end (ns), name
        self.host: List[Tuple[int, int, str]] = []
        self.marks: Dict[str, List[Tuple[int, int]]] = {}
        self.by_range: Dict[str, List[Tuple[str, float]]] = {}  # range -> (kernel, ns)
        for e in prof.events():
            a, b = int(e.time_range.start * 1e3), int(e.time_range.end * 1e3)
            if "cuda" in str(e.device_type).lower():
                if not e.name.startswith(ANNOTATIONS):
                    self.kernels.append((a, b, e.name))
                continue
            if e.name.startswith("bench:"):
                self.marks.setdefault(e.name, []).append((a, b))
            self.host.append((a, b, e.name))
            kernels = getattr(e, "kernels", None)
            if kernels:
                r = _range_of(e)
                if r is not None:
                    self.by_range.setdefault(r, []).extend(
                        (k.name, k.duration * 1e3) for k in kernels)
        self.kernels.sort()
        for v in self.marks.values():
            v.sort()
        win = self.marks.get("bench:window", [])
        self.window = win[0] if win else None

    # -- the window and the device -------------------------------------------------

    @property
    def window_s(self) -> Optional[float]:
        return None if self.window is None else (self.window[1] - self.window[0]) / 1e9

    def spans(self) -> List[Tuple[int, int]]:
        return [(a, b) for a, b, _ in self.kernels]

    def busy_s(self, lo=None, hi=None) -> float:
        lo = self.window[0] if lo is None and self.window else lo
        hi = self.window[1] if hi is None and self.window else hi
        return union_ns(self.spans(), lo if lo is not None else float("-inf"),
                        hi if hi is not None else float("inf")) / 1e9

    def merged(self) -> List[Tuple[int, int]]:
        """The device activities' union as disjoint, sorted intervals."""
        if getattr(self, "_merged", None) is None:
            out: List[Tuple[int, int]] = []
            for a, b in self.spans():
                if out and a <= out[-1][1]:
                    if b > out[-1][1]:
                        out[-1] = (out[-1][0], b)
                else:
                    out.append((a, b))
            self._merged = out
        return self._merged

    def busy_in(self, intervals: List[Tuple[int, int]]) -> List[float]:
        """Device busy ns inside each of ``intervals``."""
        merged = self.merged()
        starts = [a for a, _ in merged]
        out = []
        for lo, hi in intervals:
            i = max(bisect.bisect_right(starts, lo) - 1, 0)
            busy = 0
            while i < len(merged) and merged[i][0] < hi:
                a, b = merged[i]
                busy += max(0, min(b, hi) - max(a, lo))
                i += 1
            out.append(busy)
        return out

    def group(self, name: str) -> str:
        g = self._group_of.get(name)
        if g is None:
            fn = function_name(name)
            g = next((k for k, fns in self.groups.items() if fn in fns), "other")
            self._group_of[name] = g
        return g

    def device_s(self, group: Optional[str] = None, exclude: Iterable[str] = ()) -> float:
        """Summed durations of the window's kernels of ``group`` (all
        groups but ``exclude`` when None)."""
        lo, hi = self.window if self.window else (float("-inf"), float("inf"))
        total = 0
        for a, b, n in self.kernels:
            if a < lo or a > hi:
                continue
            g = self.group(n)
            if (group is None and g not in exclude) or g == group:
                total += b - a
        return total / 1e9

    def calls(self, mark: str) -> List[Tuple[int, int]]:
        return self.marks.get(mark, [])

    # -- host ranges ------------------------------------------------------------------

    def device_s_by_range(self, names: Iterable[str], exclude_groups: Iterable[str] = ()) -> float:
        """Summed durations of the kernels launched inside a range of ``names``."""
        exclude = set(exclude_groups)
        return sum(ns for r in names for k, ns in self.by_range.get(r, [])
                   if self.group(k) not in exclude) / 1e9

    # -- the breakdown --------------------------------------------------------------

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the innermost host activity open at their middle."""
        lo, hi = self.window if self.window else (float("-inf"), float("inf"))
        ops: Dict[str, float] = {}
        for a, b, n in self.kernels:
            if lo <= a <= hi:
                key = (function_name(n) or n)[:80]
                ops[key] = ops.get(key, 0.0) + (b - a) / 1e9
        gaps = []
        end = None
        for a, b in self.spans():
            if b < lo or a > hi:
                continue
            if end is not None and a > end:
                gaps.append((a - end, end, a))
            end = b if end is None else max(end, b)
        gaps.sort(reverse=True)
        gaps = gaps[:300]
        labels: Dict[str, float] = {}
        if gaps:
            hs = np.array([h[0] for h in self.host], dtype=np.int64)
            he = np.array([h[1] for h in self.host], dtype=np.int64)
            dur = he - hs
            for length, a, b in gaps:
                mid = (a + b) // 2
                inside = np.nonzero((hs <= mid) & (he >= mid))[0]
                label = "host: nothing traced"
                if len(inside):
                    label = self.host[int(inside[np.argmin(dur[inside])])][2][:80]
                labels[label] = labels.get(label, 0.0) + length / 1e9
        return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in labels.items()), key=lambda kv: -kv[1])[:top]}
