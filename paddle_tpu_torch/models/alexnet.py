"""AlexNet (counterpart of ``paddle_tpu/models/alexnet.py``; reference:
benchmark/paddle/image/alexnet.py): conv, cross-map norm and pool, with
conv2, conv4 and conv5 in two groups."""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer


def build(image_size: int = 227, num_classes: int = 1000):
    """(cost, prediction) of AlexNet on ``image_size`` RGB images."""
    img = layer.data("image", data_type.dense_vector(
        3 * image_size * image_size), height=image_size, width=image_size)
    lbl = layer.data("label", data_type.integer_value(num_classes))

    x = layer.img_conv(img, filter_size=11, num_filters=96, stride=4,
                       act="relu", name="conv1")
    x = layer.img_cmrnorm(x, size=5, name="norm1")
    x = layer.img_pool(x, pool_size=3, stride=2, name="pool1")
    x = layer.img_conv(x, filter_size=5, num_filters=256, padding=2,
                       groups=2, act="relu", name="conv2")
    x = layer.img_cmrnorm(x, size=5, name="norm2")
    x = layer.img_pool(x, pool_size=3, stride=2, name="pool2")
    x = layer.img_conv(x, filter_size=3, num_filters=384, padding=1,
                       act="relu", name="conv3")
    x = layer.img_conv(x, filter_size=3, num_filters=384, padding=1,
                       groups=2, act="relu", name="conv4")
    x = layer.img_conv(x, filter_size=3, num_filters=256, padding=1,
                       groups=2, act="relu", name="conv5")
    x = layer.img_pool(x, pool_size=3, stride=2, name="pool5")
    x = layer.fc(x, size=4096, act="relu", name="fc6")
    x = layer.dropout(x, 0.5, name="drop6")
    x = layer.fc(x, size=4096, act="relu", name="fc7")
    x = layer.dropout(x, 0.5, name="drop7")
    pred = layer.fc(x, size=num_classes, act=None, name="prediction")
    cost = layer.classification_cost(pred, lbl, name="cost")
    return cost, pred
