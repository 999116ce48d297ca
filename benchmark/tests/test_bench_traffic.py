"""The seeded traffic: the same for a seed, another order for another seed,
the stated mix of buckets whatever the number of calls, and sizes drawn
from the published durations' law, the same for every seed."""

from __future__ import annotations

from collections import Counter

import pytest

from benchmark.harness import traffic
from benchmark.harness.manifest import Manifest

SEEDS = (0, 7, 2**31 + 11, 2**31 + 4_000_000)


def mixes():
    m = Manifest()
    return [m.traffic(w["traffic"]) for w in m.cells.values()
            if "bucket_s" in m.traffic(w["traffic"])]


def test_same_seed_same_plan_and_checked_calls():
    for tr in mixes():
        for seed in SEEDS:
            assert traffic.plan(tr, seed, 600) == traffic.plan(tr, seed, 600)
            assert traffic.checked(tr, seed) == traffic.checked(tr, seed)
        assert traffic.plan(tr, SEEDS[0], 600) != traffic.plan(tr, SEEDS[1], 600)


def test_every_block_holds_each_length_its_share():
    for tr in mixes():
        shares = [b["share"] for b in traffic.buckets(tr)]
        size = sum(shares)
        assert size == tr["block"] and min(shares) >= 1
        for seed in SEEDS:
            order = traffic.plan(tr, seed, 300 * size)
            for k in range(0, len(order), size):
                assert Counter(order[k:k + size]) == Counter(
                    {i: s for i, s in enumerate(shares)})
            # any window of calls holds each bucket within one block of its share
            for n in (17, 100, 301):
                c = Counter(order[:n])
                for i, s in enumerate(shares):
                    assert abs(c[i] - n * s / size) <= s


def test_checked_calls_cover_every_length_with_the_longest():
    for tr in mixes():
        n_buckets, size = len(tr["bucket_s"]), tr["block"]
        for seed in SEEDS:
            order = traffic.plan(tr, seed, size)
            chk = traffic.checked(tr, seed)
            assert Counter(chk.values()) == Counter(
                {i: tr["check_per_length"] for i in range(n_buckets)})
            assert max(chk) < size  # inside the first block
            assert all(order[i] == li for i, li in chk.items())


def test_the_law_has_the_published_minimum_mean_and_maximum():
    for tr in mixes():
        d = tr["durations"]
        law = traffic.Durations(d["min_s"], d["mean_s"], d["max_s"])
        assert law.mean() == pytest.approx(d["mean_s"], abs=1e-9)
        assert law.cdf(d["min_s"]) == 0 and law.cdf(d["max_s"]) == 1
        assert law.quantile(0) == pytest.approx(d["min_s"])
        assert law.quantile(1) == pytest.approx(d["max_s"])
        for u in (0.1, 0.5, 0.9):
            assert law.cdf(law.quantile(u)) == pytest.approx(u)
        bs = traffic.buckets(tr)
        assert sum(b["p"] for b in bs) == pytest.approx(1.0)
        for b in bs:  # each bucket's share of the block within one call of the law's
            assert abs(b["share"] - b["p"] * tr["block"]) < 1


def test_rows_hold_their_buckets_durations_with_the_padding_stated():
    for tr in mixes():
        bs, cuts = traffic.buckets(tr), tr["bucket_s"]
        lower = [tr["durations"]["min_s"]] + cuts[:-1]
        for b, lo, cut in zip(bs, lower, cuts):
            assert len(b["row_s"]) == tr["rows"]
            assert all(lo <= x <= cut for x in b["row_s"])
            assert b["row_s"] == sorted(b["row_s"])
            assert b["length"] == round(cut * tr["units_per_s"])
        assert traffic.padding_share(tr) == pytest.approx(0.068, abs=5e-4)  # the cells' why


@pytest.mark.parametrize("lo,mean,hi", [(1.0, 2.0, 5.0), (1.0, 3.1, 5.0), (0.5, 4.9, 5.0)])
def test_the_law_takes_a_mean_on_either_side_of_the_midpoint(lo, mean, hi):
    law = traffic.Durations(lo, mean, hi)
    assert law.mean() == pytest.approx(mean, rel=1e-9)
    assert (law.rate > 0) == (mean > (lo + hi) / 2)


def test_subseeds_take_large_seeds_and_differ_by_purpose():
    s = traffic.subseed(2**31 + 9, "weights")
    assert 0 <= s < 2**63
    assert s != traffic.subseed(2**31 + 9, "inputs") != traffic.subseed(2**31 + 10, "weights")
