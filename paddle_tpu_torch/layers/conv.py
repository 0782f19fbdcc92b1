"""Normalisation layers: ``LayerNormLayer`` (the part of
``paddle_tpu/layers/conv.py`` the transformer LM needs; the conv, pool and
batch-norm stack comes with the conv slice).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.ir import ParamSpec
from paddle_tpu_torch.core.registry import LayerDef, register_layer


class _LayerNorm(torch.autograd.Function):
    """LayerNorm over the last axis with population variance, float32
    stats, and the JAX package's custom vjp (``_layer_norm``): the backward
    recomputes x-hat from (x, mean, rstd) instead of saving it."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, mean, rstd, scale)
        return ((xf - mean) * rstd * scale + bias).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, scale = ctx.saved_tensors
        gf = g.float()
        xhat = (x.float() - mean) * rstd
        gs = gf * scale
        m1 = gs.mean(dim=-1, keepdim=True)
        m2 = (gs * xhat).mean(dim=-1, keepdim=True)
        dx = (rstd * (gs - m1 - xhat * m2)).to(x.dtype)
        red = tuple(range(x.ndim - 1))
        dscale = (gf * xhat).sum(dim=red).to(scale.dtype)
        dbias = gf.sum(dim=red).to(scale.dtype)
        return dx, dscale, dbias, None


@register_layer
class LayerNormLayer(LayerDef):
    """layer normalisation (reference: fluid layer_norm_op)."""

    kind = "layer_norm"

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def param_specs(self, attrs, in_shapes):
        d = in_shapes[0][-1]
        return [ParamSpec(name="scale", shape=(d,), initializer="ones"),
                ParamSpec(name="bias", shape=(d,), initializer="zeros")]

    def apply(self, attrs, params, inputs, ctx):
        return _LayerNorm.apply(inputs[0], params["scale"], params["bias"],
                                float(attrs.get("epsilon", 1e-5)))
