"""GoogLeNet / Inception-v1 (counterpart of
``paddle_tpu/models/googlenet.py``; reference:
benchmark/paddle/image/googlenet.py): the main tower, without the two
auxiliary classifiers, as the reference benchmark runs it."""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer


def inception(x, name, f1, f3r, f3, f5r, f5, proj):
    """Four towers (1x1; 1x1 then 3x3; 1x1 then 5x5; a floor-mode 3x3 max
    pool then 1x1) concatenated on the channels."""
    c1 = layer.img_conv(x, 1, f1, act="relu", name=name + "_1x1")
    c3r = layer.img_conv(x, 1, f3r, act="relu", name=name + "_3x3r")
    c3 = layer.img_conv(c3r, 3, f3, padding=1, act="relu", name=name + "_3x3")
    c5r = layer.img_conv(x, 1, f5r, act="relu", name=name + "_5x5r")
    c5 = layer.img_conv(c5r, 5, f5, padding=2, act="relu", name=name + "_5x5")
    pool = layer.img_pool(x, pool_size=3, stride=1, padding=1,
                          pool_type="max", ceil_mode=False,
                          name=name + "_pool")
    pp = layer.img_conv(pool, 1, proj, act="relu", name=name + "_proj")
    return layer.concat([c1, c3, c5, pp], name=name + "_cat")


def build(image_size: int = 224, num_classes: int = 1000):
    """(cost, prediction) of GoogLeNet on ``image_size`` RGB images."""
    img = layer.data("image", data_type.dense_vector(
        3 * image_size * image_size), height=image_size, width=image_size)
    lbl = layer.data("label", data_type.integer_value(num_classes))

    x = layer.img_conv(img, 7, 64, stride=2, padding=3, act="relu",
                       name="conv1")
    x = layer.img_pool(x, 3, stride=2, padding=1, name="pool1")
    x = layer.img_conv(x, 1, 64, act="relu", name="conv2r")
    x = layer.img_conv(x, 3, 192, padding=1, act="relu", name="conv2")
    x = layer.img_pool(x, 3, stride=2, padding=1, name="pool2")
    x = inception(x, "icp3a", 64, 96, 128, 16, 32, 32)
    x = inception(x, "icp3b", 128, 128, 192, 32, 96, 64)
    x = layer.img_pool(x, 3, stride=2, padding=1, name="pool3")
    x = inception(x, "icp4a", 192, 96, 208, 16, 48, 64)
    x = inception(x, "icp4b", 160, 112, 224, 24, 64, 64)
    x = inception(x, "icp4c", 128, 128, 256, 24, 64, 64)
    x = inception(x, "icp4d", 112, 144, 288, 32, 64, 64)
    x = inception(x, "icp4e", 256, 160, 320, 32, 128, 128)
    x = layer.img_pool(x, 3, stride=2, padding=1, name="pool4")
    x = inception(x, "icp5a", 256, 160, 320, 32, 128, 128)
    x = inception(x, "icp5b", 384, 192, 384, 48, 128, 128)
    x = layer.global_pool(x, pool_type="avg", name="gap")
    x = layer.dropout(x, 0.4, name="drop")
    pred = layer.fc(x, size=num_classes, act=None, name="prediction")
    cost = layer.classification_cost(pred, lbl, name="cost")
    return cost, pred
