"""VGG (counterpart of ``paddle_tpu/models/vgg.py``; reference:
benchmark/paddle/image/vgg.py).

``depth`` 11, 13, 16 or 19; NHWC.  With ``with_bn`` every 3x3 conv is
bias-free and followed by a relu ``batch_norm``, which under
``init(fused_bn_impl="pallas")`` takes the CUDA statistic kernels 7a and
7b on the card (16 each a step at depth 19).  fc6 flattens the NHWC map as
the JAX package does, so weights cross with no transpose.
"""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer

_CFG = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


def build(depth: int = 16, image_size: int = 224, num_classes: int = 1000,
          with_bn: bool = True, fc_dim: int = 4096):
    """(cost, prediction): five stages of 3x3 convs (64, 128, 256, 512,
    512 filters) each closed by a 2x2 max pool, fc6 and fc7 of ``fc_dim``
    with dropout 0.5, fc to ``num_classes`` and the classification cost."""
    counts = _CFG[depth]
    img = layer.data("image", data_type.dense_vector(
        3 * image_size * image_size), height=image_size, width=image_size)
    lbl = layer.data("label", data_type.integer_value(num_classes))

    x = img
    filters = (64, 128, 256, 512, 512)
    for stage, (nf, count) in enumerate(zip(filters, counts)):
        for i in range(count):
            name = f"conv{stage+1}_{i+1}"
            x = layer.img_conv(x, filter_size=3, num_filters=nf, padding=1,
                               act=None if with_bn else "relu",
                               bias_attr=not with_bn, name=name)
            if with_bn:
                x = layer.batch_norm(x, act="relu", name=name + "_bn")
        x = layer.img_pool(x, pool_size=2, stride=2, name=f"pool{stage+1}")
    x = layer.fc(x, size=fc_dim, act="relu", name="fc6")
    x = layer.dropout(x, 0.5, name="drop6")
    x = layer.fc(x, size=fc_dim, act="relu", name="fc7")
    x = layer.dropout(x, 0.5, name="drop7")
    pred = layer.fc(x, size=num_classes, act=None, name="prediction")
    cost = layer.classification_cost(pred, lbl, name="cost")
    return cost, pred
