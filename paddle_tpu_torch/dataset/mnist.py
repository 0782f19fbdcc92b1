"""MNIST loader (counterpart of ``paddle_tpu/dataset/mnist.py``;
reference: v2/dataset/mnist.py).

Samples are (image: float32[784] scaled to [-1, 1], label: int).  The
idx-ubyte files are parsed when the cache holds them; otherwise the
synthetic stream draws class-separable digit blobs (a smooth template a
class, plus noise), sample for sample the JAX package's, so that a model
learns on it."""

from __future__ import annotations

import gzip
import struct

import numpy as np

from paddle_tpu_torch.dataset import common

IMG_DIM = 784
NUM_CLASSES = 10


def _idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows * cols).astype(np.float32) / 127.5 - 1.0


def _idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.astype(np.int64)


def _file_reader(img_file, lbl_file):
    def reader():
        images = _idx_images(common.cache_path("mnist", img_file))
        labels = _idx_labels(common.cache_path("mnist", lbl_file))
        for img, lbl in zip(images, labels):
            yield img, int(lbl)

    return reader


def _synthetic_reader(n: int, seed: int):
    """Deterministic, learnable stand-in: each class is a distinct smooth
    template + noise."""

    def reader():
        rng = common.synthetic_rng("mnist", seed)
        xs = np.linspace(0, 1, 28)
        grid_x, grid_y = np.meshgrid(xs, xs)
        templates = []
        for c in range(NUM_CLASSES):
            t = (np.sin((c + 1) * np.pi * grid_x) *
                 np.cos((c + 2) * np.pi * grid_y))
            templates.append(t.reshape(-1).astype(np.float32))
        for _ in range(n):
            c = int(rng.randint(0, NUM_CLASSES))
            img = templates[c] + 0.3 * rng.randn(IMG_DIM).astype(np.float32)
            yield np.clip(img, -1.0, 1.0), c

    return reader


def train(synthetic: bool = True, n: int = 8192):
    if common.have_file("mnist", "train-images-idx3-ubyte.gz"):
        return _file_reader("train-images-idx3-ubyte.gz",
                            "train-labels-idx1-ubyte.gz")
    if synthetic:
        return _synthetic_reader(n, seed=0)
    common.must_download("mnist", "yann.lecun.com/exdb/mnist")


def test(synthetic: bool = True, n: int = 1024):
    if common.have_file("mnist", "t10k-images-idx3-ubyte.gz"):
        return _file_reader("t10k-images-idx3-ubyte.gz",
                            "t10k-labels-idx1-ubyte.gz")
    if synthetic:
        return _synthetic_reader(n, seed=1)
    common.must_download("mnist", "yann.lecun.com/exdb/mnist")
