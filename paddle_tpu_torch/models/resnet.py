"""ResNet (counterpart of ``paddle_tpu/models/resnet.py``; reference:
benchmark/paddle/image/resnet.py bottleneck topology).

NHWC; ResNet-50/101/152 by ``depth``.  Under ``init(fuse_conv_bn=True)``
the 1x1 stride-1 conv + BN pairs become ``conv_bn`` layers (kernel 8 on
the card), under ``fuse_conv_bn="all"`` the 3x3 stride-1 ones too (kernel
9), with the JAX package's eligibility rules and layer names.
"""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core.ir import LayerOutput


def conv_bn(input, num_filters, filter_size, stride=1, padding=None,
            act="relu", name=None, space_to_depth=False):
    mode = cfg.get_option("fuse_conv_bn", False)
    if mode == "all":
        eligible = (1, 3)
    elif mode:            # any truthy value = the 1x1 tier
        eligible = (1,)
    else:
        eligible = ()
    if (filter_size in eligible and stride == 1 and not space_to_depth
            and padding in (None, (filter_size - 1) // 2)   # SAME only
            and act in (None, "linear", "relu")):
        return LayerOutput(
            "conv_bn", [input],
            {"num_filters": num_filters, "act": act or "linear",
             "filter_size": filter_size},
            name=name and name + "_fused", size=num_filters)
    conv = layer.img_conv(
        input, filter_size=filter_size, num_filters=num_filters,
        stride=stride,
        padding=(padding if padding is not None else (filter_size - 1) // 2),
        act=None, bias_attr=False, name=name and name + "_conv")
    if space_to_depth:
        # the exact stem rewrite (layers/conv.py _s2d_conv)
        conv.attrs["space_to_depth"] = True
    return layer.batch_norm(conv, act=act, name=name and name + "_bn")


def bottleneck(input, num_filters, stride, name, shortcut_proj: bool):
    """1x1 -> 3x3 -> 1x1 (x4) with an identity or projection shortcut."""
    c1 = conv_bn(input, num_filters, 1, stride=stride, name=name + "_a")
    c2 = conv_bn(c1, num_filters, 3, name=name + "_b")
    c3 = conv_bn(c2, num_filters * 4, 1, act=None, name=name + "_c")
    if shortcut_proj:
        short = conv_bn(input, num_filters * 4, 1, stride=stride, act=None,
                        name=name + "_proj")
    else:
        short = input
    return layer.addto([c3, short], act="relu", name=name + "_add")


_DEPTH_CFG = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def build(depth: int = 50, image_size: int = 224, num_classes: int = 1000,
          class_dim: int = None, space_to_depth: bool = False):
    """(cost, prediction) of ResNet-``depth`` on ``image_size`` RGB images:
    a 7x7 stride-2 stem, a floor-mode 3x3 stride-2 max pool, four stages
    of bottlenecks, global average pool, fc to ``num_classes``, and the
    classification cost."""
    num_classes = class_dim or num_classes
    counts = _DEPTH_CFG[depth]
    img = layer.data("image", data_type.dense_vector(
        3 * image_size * image_size), height=image_size, width=image_size)
    lbl = layer.data("label", data_type.integer_value(num_classes))
    x = conv_bn(img, 64, 7, stride=2, padding=3, name="stem",
                space_to_depth=space_to_depth)
    x = layer.img_pool(x, pool_size=3, stride=2, padding=1, pool_type="max",
                       ceil_mode=False, name="stem_pool")
    filters = (64, 128, 256, 512)
    for stage, (nf, count) in enumerate(zip(filters, counts)):
        for block in range(count):
            stride = 2 if (block == 0 and stage > 0) else 1
            x = bottleneck(x, nf, stride,
                           name=f"res{stage+2}{chr(ord('a')+block)}",
                           shortcut_proj=(block == 0))
    x = layer.global_pool(x, pool_type="avg", name="gap")
    pred = layer.fc(x, size=num_classes, act=None, name="prediction")
    cost = layer.classification_cost(pred, lbl, name="cost")
    return cost, pred
