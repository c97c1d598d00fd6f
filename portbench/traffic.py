"""The one generator of every cell's inputs, driven by the parameters in the
cell's and the configuration's files.

A pool of batches holds its question lengths at the rates of the length
histogram: batch j's longest question is the (j + 1/2) / P quantile of the
longest of B independent draws, so that the batches reach each length
bucket about as often as batches drawn one by one would, and its other
lengths are the histogram's multiset cut at that longest one.  Every seed
gets the same batches, in another order and each in its own order, so that
two seeds give the encoder the same work and the same buckets; the tokens,
features, images and labels are drawn from the seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _histogram(probs: Dict):
    """(lengths ascending, their probabilities normalized)."""
    items = sorted((int(k), float(v)) for k, v in probs.items())
    p = np.array([v for _, v in items])
    return np.array([k for k, _ in items]), p / p.sum()


def length_multiset(probs: Dict, n: int) -> np.ndarray:
    """``n`` question lengths whose counts follow ``probs`` ({length:
    probability}, normalized here) by the largest remainder, sorted."""
    lens, p = _histogram(probs)
    want = p * n
    counts = np.floor(want).astype(np.int64)
    short = n - int(counts.sum())
    counts[np.argsort(-(want - counts), kind="stable")[:short]] += 1
    return np.repeat(lens, counts)


def question_lengths(probs: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``length_multiset`` in an order drawn from ``rng``, int64."""
    return rng.permutation(length_multiset(probs, n)).astype(np.int64)


def batch_maxima(probs: Dict, batches: int, batch: int) -> np.ndarray:
    """The longest question of each of ``batches`` batches of ``batch``,
    ascending: the (j + 1/2) / batches quantiles of the longest of ``batch``
    independent draws from ``probs``, whose distribution function is
    F(m) ** batch."""
    lens, p = _histogram(probs)
    at_most = np.cumsum(p) ** batch
    at_most[-1] = 1.0
    u = (np.arange(batches) + 0.5) / batches
    return lens[np.searchsorted(at_most, u)]


def batch_lengths(probs: Dict, batches: int, batch: int, rng: np.random.Generator) -> np.ndarray:
    """int64 [batches, batch]: batch j holds its ``batch_maxima`` length and
    the ``length_multiset`` of ``batch - 1`` lengths from ``probs`` cut at
    it; the batches in an order drawn from ``rng``, and each batch's
    lengths in its own."""
    lens, p = _histogram(probs)
    pool = []
    for m in batch_maxima(probs, batches, batch):
        cut = lens <= m
        rest = length_multiset(dict(zip(lens[cut], p[cut])), batch - 1)
        pool.append(rng.permutation(np.append(rest, m)))
    return np.stack([pool[j] for j in rng.permutation(batches)]).astype(np.int64)


def question_tokens(lengths: np.ndarray, seq_len: int, vocab_size: int,
                    rng: np.random.Generator) -> np.ndarray:
    """int64 [..., seq_len] token ids: ids in [1, vocab_size) up to each
    question's length, 0 (ZEROPAD) after it."""
    tok = rng.integers(1, vocab_size, size=lengths.shape + (seq_len,), dtype=np.int64)
    tok[np.arange(seq_len) >= lengths[..., None]] = 0
    return tok


def zipf_labels(n: int, answer_size: int, exponent: float,
                rng: np.random.Generator) -> np.ndarray:
    """int64 [n] answer labels in [0, answer_size) with P(k) ~ 1 / (k + 1)^s,
    the head of VQA's answer distribution."""
    p = 1.0 / np.arange(1, answer_size + 1) ** exponent
    return rng.choice(answer_size, size=n, p=p / p.sum()).astype(np.int64)
