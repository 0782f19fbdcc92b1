"""MNIST MLP (counterpart of ``paddle_tpu/models/mlp.py``): book ch.02
recognize_digits (reference: python/paddle/v2/fluid/tests/book/
test_recognize_digits.py, the mlp variant)."""

from __future__ import annotations

import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer


def build(img_dim: int = 784, num_classes: int = 10,
          hidden: tuple = (128, 64)):
    img = layer.data("image", paddle.data_type.dense_vector(img_dim))
    lbl = layer.data("label", paddle.data_type.integer_value(num_classes))
    x = img
    for i, h in enumerate(hidden):
        x = layer.fc(x, size=h, act="relu", name=f"hidden{i+1}")
    pred = layer.fc(x, size=num_classes, act=None, name="prediction")
    cost = layer.classification_cost(pred, lbl, name="cost")
    return cost, pred
