"""The numbers that decide ``correct``, each held to its limit.

Synthesis: ``row_rms_gap``, the worst row's RMS distance between the mel the
timed path returned and the reference's, over the reference's RMS;
``token_margin`` (audio in), how far from a rounding edge the reference's
FSQ value lay at the worst token digit where the timed path's tokens differ
from the reference's (0 where all agree).  Training: ``loss_gap``, the worst
of the first steps' |loss - reference| / reference; ``grad_gap`` and
``update_gap``, the worst leaf's |norm - reference norm| over the larger of
the reference's norm of that leaf and of the median leaf, for step 1's
clipped gradient and for the parameters' change over the steps (leaves whose
reference gradient is under a thousandth of the median leaf's left out of
the change: round-off alone moves them under Adam); ``median_update_gap``,
the median leaf's gap of the change, and ``median_grad_diff``, the median
leaf's norm of (gradient - reference) over the reference's: steady from
seed to seed where the worst leaf's swing with the few small leaves behind
the FSQ rounding, and first order in the rounding error where a norm's gap
is second order.  A cell's limits file names the numbers it compares.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import torch


def row_rms_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of RMS(got - want) / RMS(want), rows on dim 0."""
    got, want = got.double().to(want.device), want.double()
    if got.shape != want.shape:
        return math.inf
    d = (got - want).square().flatten(1).mean(1).sqrt()
    r = want.square().flatten(1).mean(1).sqrt().clamp(min=1e-30)
    gap = (d / r).max()
    return float(gap) if bool(torch.isfinite(gap)) else math.inf


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def moved_leaves(first_grad: Dict[str, float], floor: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient norm is at least ``floor`` x the median leaf's."""
    ref = sorted(first_grad.values())
    median = ref[len(ref) // 2]
    return [n for n, v in first_grad.items() if v >= floor * median]


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], names: Iterable[str]) -> Dict[str, float]:
    """Each leaf's |got - want| / max(want, median of want)."""
    names = list(names)
    ref = sorted(want[n] for n in names)
    median = ref[len(ref) // 2] if ref else 0.0
    return {n: abs(got.get(n, math.nan) - want[n]) / max(want[n], median, 1e-30) for n in names}


def leaf_diffs(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               names: Iterable[str]) -> Dict[str, float]:
    """Each leaf's norm of (got - want) / max(norm of want, median of those)."""
    names = list(names)
    ref = norms({n: want[n] for n in names})
    median = sorted(ref.values())[len(ref) // 2] if ref else 0.0
    return {n: float((got[n].double() - want[n].double()).norm()) / max(ref[n], median, 1e-30)
            if n in got and got[n].shape == want[n].shape else math.inf for n in names}


def training_numbers(prog: dict, ref: dict, diagnostics: dict = None) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [...], "first_grad": {name: tensor},
    "change": {name: tensor}}.  ``diagnostics``, where given, receives each
    leaf's gaps and each step's loss gap."""
    losses = [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf
              for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    g_ref, d_ref = norms(ref["first_grad"]), norms(ref["change"])
    moved = moved_leaves(g_ref)
    leaves = {
        "grad": leaf_gaps(norms(prog["first_grad"]), g_ref, g_ref),
        "update": leaf_gaps(norms(prog["change"]), d_ref, moved),
        "grad_diff": leaf_diffs(prog["first_grad"], ref["first_grad"], g_ref)}
    if diagnostics is not None:
        diagnostics.update(losses=losses, **leaves)
    return {"loss_gap": max(losses), "grad_gap": _worst(leaves["grad"]),
            "update_gap": _worst(leaves["update"]),
            "median_update_gap": _median(leaves["update"]),
            "median_grad_diff": _median(leaves["grad_diff"])}


def _worst(gaps: Dict[str, float]) -> float:
    if not all(math.isfinite(x) for x in gaps.values()):
        return math.inf
    return max(gaps.values()) if gaps else 0.0


def _median(gaps: Dict[str, float]) -> float:
    if not gaps or not all(math.isfinite(x) for x in gaps.values()):
        return math.inf
    v = sorted(gaps.values())
    return v[len(v) // 2]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit", "ok"}} for every number that has a limit."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        out[name] = {"value": v, "limit": limit, "ok": bool(math.isfinite(v) and v <= limit)}
    return out
