"""Movie-review sentiment (counterpart of
``paddle_tpu/dataset/sentiment.py``; reference: v2/dataset/sentiment.py — NLTK
movie_reviews corpus, 2 classes). Samples: (word-id sequence, label).
Synthetic fallback: class-specific vocabulary halves."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

VOCAB_SIZE = 8000
NUM_LABEL = 2


def get_word_dict(synthetic: bool = True):
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _synthetic(n, seed):
    def reader():
        rng = common.synthetic_rng("sentiment", seed)
        half = VOCAB_SIZE // 2
        for _ in range(n):
            label = int(rng.randint(0, NUM_LABEL))
            length = int(rng.randint(10, 80))
            lo, hi = (0, half) if label else (half, VOCAB_SIZE)
            yield (rng.randint(lo, hi, size=length).astype(np.int64)
                   .tolist(), label)

    return reader


def train(synthetic: bool = True, n: int = 1600):
    if synthetic:
        return _synthetic(n, seed=0)
    common.must_download("sentiment", "nltk movie_reviews")


def test(synthetic: bool = True, n: int = 400):
    if synthetic:
        return _synthetic(n, seed=1)
    common.must_download("sentiment", "nltk movie_reviews")
