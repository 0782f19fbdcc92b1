"""UCI housing regression dataset (counterpart of
``paddle_tpu/dataset/uci_housing.py``; reference: v2/dataset/uci_housing.py).
Samples: (features float32[13], price float32[1])."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

FEATURE_DIM = 13


def _synthetic(n, seed):
    def reader():
        rng = common.synthetic_rng("uci_housing", seed)
        w = rng.randn(FEATURE_DIM).astype(np.float32)
        for _ in range(n):
            x = rng.randn(FEATURE_DIM).astype(np.float32)
            y = float(x @ w + 0.1 * rng.randn())
            yield x, np.asarray([y], dtype=np.float32)

    return reader


def _file_reader(frac_from, frac_to):
    def reader():
        raw = np.loadtxt(common.cache_path("uci_housing", "housing.data"))
        feats = raw[:, :-1].astype(np.float32)
        feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-6)
        prices = raw[:, -1:].astype(np.float32)
        n = len(raw)
        for i in range(int(n * frac_from), int(n * frac_to)):
            yield feats[i], prices[i]

    return reader


def train(synthetic: bool = True, n: int = 2048):
    if common.have_file("uci_housing", "housing.data"):
        return _file_reader(0.0, 0.8)
    if synthetic:
        return _synthetic(n, seed=0)
    common.must_download("uci_housing", "UCI housing.data")


def test(synthetic: bool = True, n: int = 256):
    if common.have_file("uci_housing", "housing.data"):
        return _file_reader(0.8, 1.0)
    if synthetic:
        return _synthetic(n, seed=1)
    common.must_download("uci_housing", "UCI housing.data")
