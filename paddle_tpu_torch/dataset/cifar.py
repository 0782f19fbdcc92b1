"""CIFAR-10/100 (counterpart of ``paddle_tpu/dataset/cifar.py``;
reference: v2/dataset/cifar.py).  Samples: (image float32[3072] in [0, 1],
CHW-flattened as the reference's; the DataFeeder reshapes image data to
NHWC, label int).  The archive in the cache directory is read when it is
there; else, with ``synthetic=True``, a seeded stream of per-class
templates plus noise, sample for sample the JAX package's; with neither
it raises, downloading nothing."""

from __future__ import annotations

import pickle
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

IMG_DIM = 3072


def _synthetic(n, num_classes, seed):
    def reader():
        rng = common.synthetic_rng("cifar", seed)
        templates = rng.rand(num_classes, IMG_DIM).astype(np.float32)
        for _ in range(n):
            c = int(rng.randint(0, num_classes))
            img = 0.7 * templates[c] + 0.3 * rng.rand(IMG_DIM).astype(np.float32)
            yield img, c

    return reader


def _tar_reader(fname, key_prefix, num_classes):
    def reader():
        with tarfile.open(common.cache_path("cifar", fname)) as tar:
            for member in tar.getmembers():
                if key_prefix not in member.name:
                    continue
                batch = pickle.load(tar.extractfile(member),
                                    encoding="latin1")
                labels = batch.get("labels") or batch.get("fine_labels")
                for img, lbl in zip(batch["data"], labels):
                    yield img.astype(np.float32) / 255.0, int(lbl)

    return reader


def train10(synthetic: bool = True, n: int = 4096):
    if common.have_file("cifar", "cifar-10-python.tar.gz"):
        return _tar_reader("cifar-10-python.tar.gz", "data_batch", 10)
    if synthetic:
        return _synthetic(n, 10, seed=0)
    common.must_download("cifar", "cifar-10-python.tar.gz")


def test10(synthetic: bool = True, n: int = 512):
    if common.have_file("cifar", "cifar-10-python.tar.gz"):
        return _tar_reader("cifar-10-python.tar.gz", "test_batch", 10)
    if synthetic:
        return _synthetic(n, 10, seed=1)
    common.must_download("cifar", "cifar-10-python.tar.gz")


def train100(synthetic: bool = True, n: int = 4096):
    if common.have_file("cifar", "cifar-100-python.tar.gz"):
        return _tar_reader("cifar-100-python.tar.gz", "train", 100)
    if synthetic:
        return _synthetic(n, 100, seed=0)
    common.must_download("cifar", "cifar-100-python.tar.gz")


def test100(synthetic: bool = True, n: int = 512):
    if common.have_file("cifar", "cifar-100-python.tar.gz"):
        return _tar_reader("cifar-100-python.tar.gz", "test", 100)
    if synthetic:
        return _synthetic(n, 100, seed=1)
    common.must_download("cifar", "cifar-100-python.tar.gz")
