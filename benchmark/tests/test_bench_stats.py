"""Percentiles, spreads and interval arithmetic."""

import math

import numpy as np
import pytest

from benchmark import stats


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    xs = list(rng.standard_normal(101))
    for q in (0, 5, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))
    assert math.isnan(stats.percentile([], 95))


def test_union_and_merge():
    ivs = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(ivs) == pytest.approx(4.0)
    assert stats.merge(ivs) == [(0, 3), (5, 6)]


def test_covered_within_and_gaps():
    busy = [(0, 1), (2, 4), (6, 7)]
    assert stats.covered_within(busy, [(0.5, 3), (6.5, 10)]) == pytest.approx(0.5 + 1 + 0.5)
    assert stats.gaps(busy, 0, 8) == [(1, 2), (4, 6), (7, 8)]
    assert stats.clip(busy, 0.5, 2.5) == [(0.5, 1), (2, 2.5)]


def test_overlap_share():
    assert stats.overlap_share(0, 10, 5, 20) == pytest.approx(0.5)
    assert stats.overlap_share(0, 10, 0, 20) == pytest.approx(1.0)
    assert stats.overlap_share(30, 40, 0, 20) == 0.0
