"""IMDB sentiment (counterpart of ``paddle_tpu/dataset/imdb.py``; reference:
v2/dataset/imdb.py).  Samples: (word-id sequence, label 0/1).  The
synthetic stream draws each class's words from its own half of the
vocabulary, sample for sample the JAX package's; the raw archive is not
parsed here, so a non-synthetic call raises through ``must_download``."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

VOCAB_SIZE = 5148          # the synthetic stream's fixed vocabulary


def word_dict(synthetic: bool = True):
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _synthetic(n, seed):
    def reader():
        rng = common.synthetic_rng("imdb", seed)
        half = VOCAB_SIZE // 2
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(8, 64))
            if label:
                ids = rng.randint(0, half, size=length)
            else:
                ids = rng.randint(half, VOCAB_SIZE, size=length)
            yield ids.astype(np.int64).tolist(), label

    return reader


def train(word_idx=None, synthetic: bool = True, n: int = 2048):
    if synthetic:
        return _synthetic(n, seed=0)
    common.must_download("imdb", "aclImdb_v1.tar.gz")


def test(word_idx=None, synthetic: bool = True, n: int = 256):
    if synthetic:
        return _synthetic(n, seed=1)
    common.must_download("imdb", "aclImdb_v1.tar.gz")
