"""MovieLens-1M (counterpart of ``paddle_tpu/dataset/movielens.py``;
reference: v2/dataset/movielens.py): samples (user id, gender, age, job,
movie id, category ids, title ids, rating), the recommender book format;
the synthetic stream only, sample for sample the JAX package's."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

MAX_USER = 6040
MAX_MOVIE = 3952
NUM_JOBS = 21
NUM_AGES = 7
NUM_CATEGORIES = 18
TITLE_VOCAB = 5174


def max_user_id():
    return MAX_USER


def max_movie_id():
    return MAX_MOVIE


def max_job_id():
    return NUM_JOBS - 1


def _synthetic(n, seed):
    def reader():
        rng = common.synthetic_rng("movielens", seed)
        user_taste = rng.randn(MAX_USER + 1, 4).astype(np.float32)
        movie_vibe = rng.randn(MAX_MOVIE + 1, 4).astype(np.float32)
        for _ in range(n):
            u = int(rng.randint(1, MAX_USER + 1))
            m = int(rng.randint(1, MAX_MOVIE + 1))
            affinity = float(user_taste[u] @ movie_vibe[m])
            rating = float(np.clip(3.0 + affinity, 1.0, 5.0))
            yield (u, int(rng.randint(0, 2)), int(rng.randint(0, NUM_AGES)),
                   int(rng.randint(0, NUM_JOBS)), m,
                   rng.randint(0, NUM_CATEGORIES, size=3).tolist(),
                   rng.randint(0, TITLE_VOCAB, size=5).tolist(),
                   np.asarray([rating], dtype=np.float32))

    return reader


def train(synthetic: bool = True, n: int = 4096):
    if synthetic:
        return _synthetic(n, seed=0)
    common.must_download("movielens", "ml-1m.zip")


def test(synthetic: bool = True, n: int = 512):
    if synthetic:
        return _synthetic(n, seed=1)
    common.must_download("movielens", "ml-1m.zip")
