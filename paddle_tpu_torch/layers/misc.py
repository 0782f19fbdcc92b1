"""The 3-D image layers of the long-tail catalog (counterpart of
``paddle_tpu/layers/misc.py``: ``Conv3DLayer``, ``Deconv3DLayer``,
``Pool3DLayer``).

Volumes are NDHWC and kernels DHWIO, as in the JAX package, so weights
cross with no transpose; the convs are ``F.conv3d`` and
``F.conv_transpose3d`` on NCDHW views, the transposed one with the
kernel flipped as ``ops/conv_bn.conv_transpose_nhwc`` sets out.  Pooling
takes VALID windows, and avg divides by k^3.  A batch norm on a volume
(rank 5) takes the plain statistics, as the JAX package routes it.

The rest of ``misc.py`` (the math, sequence and shape layers) is
``ROADMAP.md`` section 1, item 11.
"""

from __future__ import annotations

import torch.nn.functional as F

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch.core.ir import ParamSpec
from paddle_tpu_torch.core.registry import LayerDef, register_layer
from paddle_tpu_torch.ops.conv_bn import conv_transpose_nhwc


def _kernel_specs(attrs, in_shapes):
    k = attrs["filter_size"]
    specs = [ParamSpec("w", (k, k, k, in_shapes[0][3], attrs["num_filters"]),
                       "xavier")]
    if attrs.get("bias", True):
        specs.append(ParamSpec("b", (attrs["num_filters"],), "zeros"))
    return specs


def _bias_act(attrs, params, out):
    if "b" in params:
        out = out + params["b"]
    return act_mod.apply(attrs.get("act", "linear"), out)


@register_layer
class Conv3DLayer(LayerDef):
    """3-D convolution, NDHWC (reference: Conv3DLayer.cpp, fluid
    conv3d)."""

    kind = "conv3d"

    def infer_shape(self, attrs, in_shapes):
        k = attrs["filter_size"]
        st = attrs.get("stride", 1)
        pd = attrs.get("padding", 0)
        s = in_shapes[0]
        return tuple((s[i] + 2 * pd - k) // st + 1
                     for i in range(3)) + (attrs["num_filters"],)

    def param_specs(self, attrs, in_shapes):
        return _kernel_specs(attrs, in_shapes)

    def apply(self, attrs, params, inputs, ctx):
        y = F.conv3d(inputs[0].permute(0, 4, 1, 2, 3),
                     params["w"].permute(4, 3, 0, 1, 2), None,
                     attrs.get("stride", 1), attrs.get("padding", 0))
        return _bias_act(attrs, params, y.permute(0, 2, 3, 4, 1))


@register_layer
class Deconv3DLayer(LayerDef):
    """3-D transposed convolution, NDHWC (reference: DeConv3DLayer.cpp);
    out = (in - 1) * stride + k - 2 * padding."""

    kind = "deconv3d"

    def infer_shape(self, attrs, in_shapes):
        k = attrs["filter_size"]
        st = attrs.get("stride", 1)
        pd = attrs.get("padding", 0)
        s = in_shapes[0]
        return tuple((s[i] - 1) * st + k - 2 * pd
                     for i in range(3)) + (attrs["num_filters"],)

    def param_specs(self, attrs, in_shapes):
        return _kernel_specs(attrs, in_shapes)

    def apply(self, attrs, params, inputs, ctx):
        y = conv_transpose_nhwc(inputs[0], params["w"],
                                attrs.get("stride", 1),
                                attrs.get("padding", 0))
        return _bias_act(attrs, params, y)


@register_layer
class Pool3DLayer(LayerDef):
    """3-D max or avg pooling over VALID k^3 windows (reference:
    Pool3DLayer.cpp)."""

    kind = "pool3d"

    def infer_shape(self, attrs, in_shapes):
        k = attrs["pool_size"]
        st = attrs.get("stride", k)
        s = in_shapes[0]
        return tuple((s[i] - k) // st + 1 for i in range(3)) + (s[3],)

    def apply(self, attrs, params, inputs, ctx):
        k = attrs["pool_size"]
        st = attrs.get("stride", k)
        x = inputs[0].permute(0, 4, 1, 2, 3)
        if attrs.get("pool_type", "max") == "max":
            y = F.max_pool3d(x, k, st)
        else:
            y = F.avg_pool3d(x, k, st)
        return y.permute(0, 2, 3, 4, 1)
