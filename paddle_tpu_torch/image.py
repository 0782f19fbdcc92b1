"""Image preprocessing for reader pipelines (counterpart of
``paddle_tpu/image.py``; reference: python/paddle/v2/image.py).

Host-side numpy transforms, equal bit for bit to the JAX package's: resize
of the short edge, crops, flips, normalisation.  Images are HWC float
arrays (the NHWC convention); ``to_chw`` converts to the reference's CHW.
"""

from __future__ import annotations

import numpy as np

__all__ = ["resize_short", "center_crop", "random_crop", "left_right_flip",
           "simple_transform", "to_chw", "to_hwc", "normalize"]


def _bilinear_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ih, iw = img.shape[:2]
    ys = (np.arange(h) + 0.5) * ih / h - 0.5
    xs = (np.arange(w) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return ((a * (1 - wx) + b * wx) * (1 - wy)
            + (c * (1 - wx) + d * wx) * wy).astype(img.dtype)


def resize_short(img: np.ndarray, size: int) -> np.ndarray:
    """Scale so the short edge equals `size` (aspect preserved)."""
    h, w = img.shape[:2]
    if h <= w:
        return _bilinear_resize(img, size, int(round(w * size / h)))
    return _bilinear_resize(img, int(round(h * size / w)), size)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    y0 = max(0, (h - size) // 2)
    x0 = max(0, (w - size) // 2)
    return img[y0:y0 + size, x0:x0 + size]


def random_crop(img: np.ndarray, size: int,
                rng: np.random.RandomState = None) -> np.ndarray:
    rng = rng or np.random
    h, w = img.shape[:2]
    y0 = rng.randint(0, max(h - size, 0) + 1)
    x0 = rng.randint(0, max(w - size, 0) + 1)
    return img[y0:y0 + size, x0:x0 + size]


def left_right_flip(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1]


def normalize(img: np.ndarray, mean=None, std=None) -> np.ndarray:
    img = img.astype(np.float32)
    if mean is not None:
        img = img - np.asarray(mean, np.float32)
    if std is not None:
        img = img / np.asarray(std, np.float32)
    return img


def simple_transform(img: np.ndarray, resize_size: int, crop_size: int,
                     is_train: bool, mean=None, std=None,
                     rng=None) -> np.ndarray:
    """The reference's standard train/eval pipeline: resize-short →
    (random|center) crop → (train-only) random flip → normalize."""
    img = resize_short(img, resize_size)
    if is_train:
        rng = rng or np.random
        img = random_crop(img, crop_size, rng)
        if rng.randint(2):
            img = left_right_flip(img)
    else:
        img = center_crop(img, crop_size)
    return normalize(img, mean, std)


def to_chw(img: np.ndarray) -> np.ndarray:
    """HWC → CHW (reference layout, for interop)."""
    return np.transpose(img, (2, 0, 1))


def to_hwc(img: np.ndarray) -> np.ndarray:
    return np.transpose(img, (1, 2, 0))
