"""MQ2007 LETOR learning-to-rank (counterpart of
``paddle_tpu/dataset/mq2007.py``; reference: v2/dataset/mq2007.py).

Modes mirror the reference Query/QueryList API surface at reader level:
  * pointwise: (feature[46], relevance)
  * pairwise:  (feature_hi[46], feature_lo[46]) with rel_hi > rel_lo
  * listwise:  (label list, feature list) per query

Synthetic fallback: relevance is a noisy linear function of the features,
so rank models actually learn."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

FEATURE_DIM = 46
REL_LEVELS = 3


def _query(rng, w):
    n_docs = int(rng.randint(5, 20))
    feats = rng.rand(n_docs, FEATURE_DIM).astype(np.float32)
    scores = feats @ w + 0.1 * rng.randn(n_docs)
    # quantize to relevance levels 0..2
    order = np.argsort(scores)
    rel = np.zeros(n_docs, np.int64)
    rel[order[-max(1, n_docs // 4):]] = 2
    rel[order[-max(2, n_docs // 2):-max(1, n_docs // 4)]] = 1
    return feats, rel


def _reader(n_queries, seed, format):
    def reader():
        rng = common.synthetic_rng("mq2007", seed)
        # ONE latent ranking function shared by every split — held-out
        # evaluation must measure generalization, not a different task
        w = common.synthetic_rng("mq2007-w", 0).randn(
            FEATURE_DIM).astype(np.float32)
        for _ in range(n_queries):
            feats, rel = _query(rng, w)
            if format == "pointwise":
                for f, r in zip(feats, rel):
                    yield f, int(r)
            elif format == "pairwise":
                for i in range(len(rel)):
                    for j in range(len(rel)):
                        if rel[i] > rel[j]:
                            yield feats[i], feats[j]
            elif format == "listwise":
                yield rel.tolist(), [f for f in feats]
            else:
                raise ValueError(f"unknown format {format!r}")

    return reader


def train(format: str = "pairwise", synthetic: bool = True, n: int = 200):
    if synthetic:
        return _reader(n, seed=0, format=format)
    common.must_download("mq2007", "MQ2007.rar")


def test(format: str = "pairwise", synthetic: bool = True, n: int = 50):
    if synthetic:
        return _reader(n, seed=1, format=format)
    common.must_download("mq2007", "MQ2007.rar")
