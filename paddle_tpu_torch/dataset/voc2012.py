"""PASCAL VOC2012 segmentation pairs (counterpart of
``paddle_tpu/dataset/voc2012.py``; reference: v2/dataset/voc2012.py).
Samples: (image HWC float, mask HW int). Synthetic fallback: images with a
colored rectangle whose footprint is the mask (learnable segmentation)."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

NUM_CLASSES = 21          # 20 objects + background
IMAGE_SIZE = 32


def _synthetic(n, seed, image_size):
    def reader():
        rng = common.synthetic_rng("voc2012", seed)
        for _ in range(n):
            c = int(rng.randint(1, NUM_CLASSES))
            img = 0.1 * rng.randn(image_size, image_size, 3)
            mask = np.zeros((image_size, image_size), np.int64)
            w = int(rng.randint(image_size // 4, image_size // 2))
            h = int(rng.randint(image_size // 4, image_size // 2))
            x0 = int(rng.randint(0, image_size - w))
            y0 = int(rng.randint(0, image_size - h))
            # class-coded color paints the object; mask marks its footprint
            color = np.array([np.sin(c * 1.7), np.cos(c * 2.3),
                              np.sin(c * 0.9)])
            img[y0:y0 + h, x0:x0 + w] += color
            mask[y0:y0 + h, x0:x0 + w] = c
            yield img.astype(np.float32), mask

    return reader


def train(synthetic: bool = True, n: int = 1024,
          image_size: int = IMAGE_SIZE):
    if synthetic:
        return _synthetic(n, seed=0, image_size=image_size)
    common.must_download("voc2012", "VOCtrainval_11-May-2012.tar")


def test(synthetic: bool = True, n: int = 256,
         image_size: int = IMAGE_SIZE):
    if synthetic:
        return _synthetic(n, seed=1, image_size=image_size)
    common.must_download("voc2012", "VOCtrainval_11-May-2012.tar")


val = test
