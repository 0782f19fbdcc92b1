"""Oxford 102 Flowers (counterpart of ``paddle_tpu/dataset/flowers.py``;
reference: v2/dataset/flowers.py).  Samples: (image HWC float32 in
[-1, 1], label).  The synthetic stream (per-class smooth colour patterns
plus noise, at any ``image_size``) is sample for sample the JAX
package's; the archive is not parsed here, so a non-synthetic call
raises through ``must_download``."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

NUM_CLASSES = 102
IMAGE_SIZE = 32          # synthetic resolution (reference crops to 224)


def _synthetic(n, seed, image_size):
    def reader():
        rng = common.synthetic_rng("flowers", seed)
        xs = np.linspace(0, 1, image_size)
        gx, gy = np.meshgrid(xs, xs)
        for _ in range(n):
            c = int(rng.randint(0, NUM_CLASSES))
            phase, freq = (c % 17) / 17.0, 1 + c % 7
            img = np.stack([
                np.sin(freq * np.pi * gx + phase),
                np.cos(freq * np.pi * gy - phase),
                np.sin(freq * np.pi * (gx + gy)),
            ], axis=-1).astype(np.float32)
            img += 0.25 * rng.randn(*img.shape).astype(np.float32)
            yield np.clip(img, -1, 1), c

    return reader


def train(synthetic: bool = True, n: int = 2048,
          image_size: int = IMAGE_SIZE):
    if synthetic:
        return _synthetic(n, seed=0, image_size=image_size)
    common.must_download("flowers", "102flowers.tgz")


def test(synthetic: bool = True, n: int = 256,
         image_size: int = IMAGE_SIZE):
    if synthetic:
        return _synthetic(n, seed=1, image_size=image_size)
    common.must_download("flowers", "102flowers.tgz")


valid = test
