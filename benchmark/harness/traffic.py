"""The one generator of traffic: seeded, balanced calls of bucketed utterances.

A synthesis mix states a corpus's utterance durations (``durations``: the
``min_s``, ``mean_s`` and ``max_s`` its source publishes) and the buckets a
batcher sorts them into (``bucket_s``: each bucket's upper edge in seconds;
the last edge also cuts the longest utterances).  The durations follow the
maximum-entropy law with that minimum, mean and maximum, a truncated
exponential.  A call holds ``rows`` utterances of one bucket, each padded
to the bucket's length (``bucket_s x units_per_s`` in its driver's unit);
its rows' own durations are fixed quantiles of the law inside the bucket,
so every seed sends the same sizes.  Calls come in blocks of ``block``,
each bucket its share of the block by the law (largest remainder), each
block in its own seeded order.  ``checked`` picks from the seed, inside the
first block, ``check_per_length`` calls of each bucket to compare with the
reference.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import numpy as np


def subseed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of a run, from the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Durations:
    """The maximum-entropy law on [lo, hi] with the given mean: density
    proportional to exp(rate x)."""

    def __init__(self, lo: float, mean: float, hi: float):
        if not lo < mean < hi:
            raise ValueError(f"need min < mean < max, got {lo}, {mean}, {hi}")
        self.lo, self.hi = lo, hi
        a, b = -200.0 / (hi - lo), 200.0 / (hi - lo)
        for _ in range(200):  # the law's mean rises with the rate
            self.rate = (a + b) / 2
            a, b = (self.rate, b) if self.mean() < mean else (a, self.rate)

    def _e(self, x: float) -> float:  # exp(rate (x - lo)) - 1, over rate where rate = 0
        r = self.rate
        return x - self.lo if abs(r) < 1e-12 else math.expm1(r * (x - self.lo)) / r

    def cdf(self, x: float) -> float:
        return self._e(min(max(x, self.lo), self.hi)) / self._e(self.hi)

    def quantile(self, u: float) -> float:
        r, z = self.rate, u * self._e(self.hi)
        return self.lo + (z if abs(r) < 1e-12 else math.log1p(r * z) / r)

    def mean(self) -> float:
        r, w = self.rate, self.hi - self.lo
        if abs(r) < 1e-12:
            return self.lo + w / 2
        return self.lo + w / -math.expm1(-r * w) - 1.0 / r


def buckets(traffic: dict) -> List[dict]:
    """Per bucket: ``length`` (the call's size in the driver's unit),
    ``share`` (calls per block), ``row_s`` (each row's own seconds) and
    ``p`` (the law's share of utterances)."""
    d = traffic["durations"]
    law = Durations(d["min_s"], d["mean_s"], d["max_s"])
    top, rows, block = traffic["bucket_s"], int(traffic["rows"]), int(traffic["block"])
    edges = [law.lo] + list(top[:-1]) + [law.hi]
    out = []
    for k, cut in enumerate(top):
        f0, f1 = law.cdf(edges[k]), law.cdf(edges[k + 1])
        out.append({"length": int(round(cut * traffic["units_per_s"])), "p": f1 - f0,
                    "row_s": [min(law.quantile(f0 + (j + 0.5) / rows * (f1 - f0)), cut)
                              for j in range(rows)]})
    whole = [int(b["p"] * block) for b in out]
    rest = sorted(range(len(out)), key=lambda k: whole[k] - out[k]["p"] * block)
    for k in rest[:block - sum(whole)]:
        whole[k] += 1
    if min(whole) < 1:
        raise ValueError(f"a block of {block} calls leaves a bucket out: {whole}")
    for b, n in zip(out, whole):
        b["share"] = n
    return out


def block(traffic: dict) -> List[int]:
    """Bucket indices of one block (each bucket its share of times)."""
    return [i for i, b in enumerate(buckets(traffic)) for _ in range(b["share"])]


def plan(traffic: dict, seed: int, calls: int) -> List[int]:
    """The bucket index of each of the first ``calls`` calls."""
    rng = np.random.Generator(np.random.PCG64(subseed(seed, "order")))
    base = np.array(block(traffic))
    out: List[int] = []
    while len(out) < calls:
        out.extend(int(i) for i in rng.permutation(base))
    return out[:calls]


def checked(traffic: dict, seed: int) -> Dict[int, int]:
    """{call index: bucket index} of the calls compared with the reference:
    ``check_per_length`` of each bucket (at most its share), drawn from the
    seed among that bucket's calls in the first block."""
    rng = np.random.Generator(np.random.PCG64(subseed(seed, "checked")))
    first = plan(traffic, seed, len(block(traffic)))
    per = int(traffic["check_per_length"])
    out: Dict[int, int] = {}
    for li in sorted(set(first)):
        idx = [i for i, l in enumerate(first) if l == li]
        for i in rng.choice(len(idx), size=min(per, len(idx)), replace=False):
            out[idx[int(i)]] = li
    return dict(sorted(out.items()))


def padding_share(traffic: dict) -> float:
    """The share of a block's row-seconds that is padding."""
    bs = buckets(traffic)
    held = sum(b["share"] * sum(b["row_s"]) for b in bs)
    padded = sum(b["share"] * len(b["row_s"]) * b["length"] / traffic["units_per_s"] for b in bs)
    return 1.0 - held / padded
