"""The length generator: every seed gets the same pool of batches in
another order, and the pool reaches each length bucket at about the rate
at which batches drawn one by one from the histogram would."""

from __future__ import annotations

import numpy as np
import pytest

import harness
import traffic

PROBS = harness.load_json(harness.BENCH, "configs", "ours_ms.json")["assumed"][
    "question_length_probs"]


def _cdf(m):
    total = sum(PROBS.values())
    return sum(v for k, v in PROBS.items() if int(k) <= m) / total


@pytest.mark.parametrize("batches,batch", [(8, 512), (8, 120), (5, 7)])
def test_batch_maxima_are_quantiles_of_the_longest_of_independent_draws(batches, batch):
    lens = sorted(int(k) for k in PROBS)
    maxima = traffic.batch_maxima(PROBS, batches, batch)
    for j, m in enumerate(maxima):
        u = (j + 0.5) / batches
        assert _cdf(m) ** batch >= u
        below = [k for k in lens if k < m]
        assert not below or _cdf(below[-1]) ** batch < u


def test_every_seed_gets_the_same_pool_in_another_order():
    a = traffic.batch_lengths(PROBS, 8, 512, np.random.default_rng(1))
    b = traffic.batch_lengths(PROBS, 8, 512, np.random.default_rng(2 ** 33 + 5))
    assert a.shape == (8, 512) and a.dtype == np.int64
    assert sorted(map(tuple, np.sort(a, 1))) == sorted(map(tuple, np.sort(b, 1)))
    assert not np.array_equal(a, b)
    assert sorted(a.max(1)) == list(traffic.batch_maxima(PROBS, 8, 512))


def test_the_pool_reaches_the_top_bucket_at_the_histograms_rate():
    """Past 16 words (the training ladder's top below seq_len 26): batches
    of 512 drawn one by one get there 80% of the time; so does the pool,
    to within one batch in eight."""
    rate = 1 - _cdf(16) ** 512
    lengths = traffic.batch_lengths(PROBS, 8, 512, np.random.default_rng(3))
    share = float((lengths.max(1) > 16).mean())
    assert 0.7 < rate < 0.9
    assert abs(share - rate) <= 1 / 8
    # each batch's other lengths follow the histogram, cut at its longest
    counts = np.bincount(lengths.ravel(), minlength=27)
    assert abs(counts[5] / lengths.size - PROBS["5"] / sum(PROBS.values())) < 0.005


def test_training_pool_puts_one_batch_of_each_bucket_first():
    driver = harness.load_module("drivers", "train")
    assert driver.buckets_first([26, 26, 16, 26, 16]) == [0, 2, 1, 3, 4]
    assert driver.buckets_first([16, 16]) == [0, 1]
