"""Operations and bytes of the benchmark's work, from shapes alone.

Each module counts one component (``decoder``, ``frontend``, ``hubert``) the
way the kernel table's "Bound ms" column counts it (chip_smoke.py): two
operations per multiply-add of every product the model needs, the banded
self-attention over its admissible pairs only, each input byte read once and
each output byte written once.  ``least_s`` turns a count into the least
time the card could take, from ``peaks.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def peaks() -> dict:
    with open(PEAKS) as f:
        return json.load(f)


def least_s(products: float, product_dtype: str, nbytes: float, f32: float = 0.0) -> float:
    """The least time of work of ``products`` operations at ``product_dtype``'s
    peak and ``f32`` operations at float32's, moving ``nbytes``: the largest of
    the three times (each unit could run beside the others)."""
    p = peaks()
    rate = p["flops_per_s"]
    return max(products / rate[product_dtype], f32 / rate["float32"], nbytes / p["hbm_bytes_per_s"])
