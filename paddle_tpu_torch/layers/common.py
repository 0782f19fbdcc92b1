"""Core dense layers (counterpart of ``paddle_tpu/layers/common.py``,
less its sparse tables): data, fc, embedding, dropout, addto, concat,
mixed and its projections and operators, the elementwise and row-wise
helpers (scaling, slope_intercept, interpolation, dot_prod, cos_sim,
reshape, trans, slice, activation, bilinear_tensor_product,
row_l2_norm) and data_norm.

``fc`` lowers to one ``torch.matmul`` per input, as the JAX package leaves
it to XLA; under a reduced-precision policy each input and weight is cast
to the compute dtype first, and the bias to the product's dtype.
``mixed`` casts nothing, as in the JAX package.  ``embedding`` is a row
gather of the float32 table (no cast, as in the JAX package) whose
backward is autograd's scatter-add.  ``dropout`` draws its keep mask from
the forward's generator in train mode and is the identity at eval.
Sparse (ids + values) inputs and sparse-update tables are not ported yet
and raise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch.core.ir import ParamSpec
from paddle_tpu_torch.core.registry import LayerDef, register_layer
from paddle_tpu_torch.ops.conv_bn import conv2d_nhwc


def _flat_dim(shape) -> int:
    return int(math.prod(shape)) if shape else 1


@register_layer
class DataLayer(LayerDef):
    kind = "data"

    def infer_shape(self, attrs, in_shapes):
        return tuple(attrs["shape"])

    def apply(self, attrs, params, inputs, ctx):
        raise RuntimeError("data layers are fed, not applied")


def _shared(ctx, src: str, pname: str, what: str):
    """The tensor ``pname`` of layer ``src`` (tied weights: the reference's
    shared-ParameterConfig-name idiom)."""
    if src not in ctx.params_tree or pname not in ctx.params_tree[src]:
        raise ValueError(
            f"{what} share_from={src!r}: no {what} layer of that name owns "
            f"{'weights' if what == 'fc' else 'a table'} in this topology")
    return ctx.params_tree[src]


@register_layer
class FCLayer(LayerDef):
    """fc: out = act(sum_i in_i @ W_i + b), one weight per input."""

    kind = "fc"

    def infer_shape(self, attrs, in_shapes):
        return (attrs["size"],)

    def param_specs(self, attrs, in_shapes):
        if attrs.get("share_from"):
            return []          # weights borrowed from another fc layer
        size = attrs["size"]
        specs = []
        for i, s in enumerate(in_shapes):
            specs.append(ParamSpec(
                name=f"w{i}", shape=(_flat_dim(s), size),
                initializer=attrs.get("param_initializer") or "xavier",
                learning_rate=attrs.get("param_lr", 1.0),
                l2_decay=attrs.get("param_l2", 0.0),
                is_static=attrs.get("param_static", False)))
        if attrs.get("bias", True):
            specs.append(ParamSpec(
                name="b", shape=(size,),
                initializer=attrs.get("bias_initializer") or "zeros",
                learning_rate=attrs.get("bias_lr", 1.0)))
        return specs

    def apply(self, attrs, params, inputs, ctx):
        src = attrs.get("share_from")
        if src:
            params = _shared(ctx, src, "w0", "fc")
        out = None
        for i, x in enumerate(inputs):
            x2 = x.reshape(x.shape[0], -1)
            w = params[f"w{i}"]
            if w.shape[0] != x2.shape[1] or w.shape[1] != attrs["size"]:
                raise ValueError(
                    f"fc share_from: source weights {tuple(w.shape)} don't "
                    f"fit input {x2.shape[1]} -> size {attrs['size']}")
            if ctx.compute_dtype is not None:
                x2 = x2.to(ctx.compute_dtype)
                w = w.to(ctx.compute_dtype)
            y = x2 @ w
            out = y if out is None else out + y
        if "b" in params:
            # in the product's dtype: the output stays in the compute dtype
            out = out + params["b"].to(out.dtype)
        return act_mod.apply(attrs.get("act", "linear"), out)


@register_layer
class EmbeddingLayer(LayerDef):
    """embedding: ids -> rows of a learnable table."""

    kind = "embedding"

    def infer_shape(self, attrs, in_shapes):
        return tuple(in_shapes[0]) + (attrs["size"],)

    def param_specs(self, attrs, in_shapes):
        if attrs.get("share_from"):
            return []          # table borrowed from another embedding layer
        return [ParamSpec(
            name="w", shape=(attrs["vocab_size"], attrs["size"]),
            initializer=attrs.get("param_initializer") or "normal",
            learning_rate=attrs.get("param_lr", 1.0),
            is_static=attrs.get("param_static", False),
            sparse_update=attrs.get("param_sparse", False))]

    def apply(self, attrs, params, inputs, ctx):
        if attrs.get("param_sparse"):
            raise NotImplementedError(
                "sparse_update embedding tables are not ported to "
                "paddle_tpu_torch yet (ROADMAP.md section 1, item 4)")
        src = attrs.get("share_from")
        if src:
            table = _shared(ctx, src, "w", "embedding")["w"]
            if tuple(table.shape) != (attrs["vocab_size"], attrs["size"]):
                raise ValueError(
                    f"embedding share_from={src!r}: source table is "
                    f"{tuple(table.shape)} but this layer declares "
                    f"({attrs['vocab_size']}, {attrs['size']})")
        else:
            table = params["w"]
        return table[inputs[0].long()]


@register_layer
class AddtoLayer(LayerDef):
    """addto: elementwise sum of inputs (+optional bias/act)."""

    kind = "addto"

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def param_specs(self, attrs, in_shapes):
        if attrs.get("bias", False):
            return [ParamSpec(name="b", shape=(_flat_dim(in_shapes[0]),),
                              initializer="zeros")]
        return []

    def apply(self, attrs, params, inputs, ctx):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        if "b" in params:
            out = out + params["b"].reshape((1,) + tuple(out.shape[1:]))
        return act_mod.apply(attrs.get("act", "linear"), out)


@register_layer
class ConcatLayer(LayerDef):
    """concat along a per-sample axis, the feature (last) axis by default
    (reference: ConcatenateLayer)."""

    kind = "concat"

    def infer_shape(self, attrs, in_shapes):
        axis = attrs.get("axis", -1)
        base = list(in_shapes[0])
        base[axis] = sum(s[axis] for s in in_shapes)
        return tuple(base)

    def apply(self, attrs, params, inputs, ctx):
        axis = attrs.get("axis", -1)
        # per-sample axis -> batched axis
        if axis >= 0:
            axis += 1
        return act_mod.apply(attrs.get("act", "linear"),
                             torch.cat(inputs, dim=axis))


@register_layer
class SliceLayer(LayerDef):
    """slice features along the last axis."""

    kind = "slice"

    def infer_shape(self, attrs, in_shapes):
        s = list(in_shapes[0])
        s[-1] = attrs["end"] - attrs["start"]
        return tuple(s)

    def apply(self, attrs, params, inputs, ctx):
        return inputs[0][..., attrs["start"]:attrs["end"]]


@register_layer
class DropoutLayer(LayerDef):
    """dropout: in train mode each element is kept with probability
    1 - rate and scaled by 1 / (1 - rate); at eval the identity.  The
    keep mask is drawn from the forward's generator, so a CUDA graph that
    captured it (a registered generator) draws a new mask each replay."""

    kind = "dropout"

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def apply(self, attrs, params, inputs, ctx):
        x = inputs[0]
        rate = attrs.get("rate", 0.5)
        if not ctx.train or rate <= 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=ctx.rng(),
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


_TWO_INPUT_PROJECTIONS = ("conv_op", "dotmul_op")


@register_layer
class MixedLayer(LayerDef):
    """mixed: the sum of projections and operators (reference:
    MixedLayer.cpp + Projection.h).  attrs["projections"] holds one
    descriptor per projection, {"type": "full_matrix" |
    "trans_full_matrix" | "identity" | "dotmul" | "scaling" | "table" |
    "slice" | "conv" | "conv_trans" | "conv_op" | "dotmul_op", ...}; the
    operators (conv_op, dotmul_op) take two inputs each."""

    kind = "mixed"

    def infer_shape(self, attrs, in_shapes):
        return (attrs["size"],)

    def _walk(self, attrs, seq):
        """(i, descriptor, items): the 1 or 2 entries of ``seq`` that
        projection i consumes."""
        cur = 0
        for i, proj in enumerate(attrs["projections"]):
            n = 2 if proj["type"] in _TWO_INPUT_PROJECTIONS else 1
            yield i, proj, seq[cur:cur + n]
            cur += n

    def param_specs(self, attrs, in_shapes):
        size = attrs["size"]
        specs = []
        for i, proj, shapes in self._walk(attrs, in_shapes):
            p = proj["type"]
            s = shapes[0]
            d = _flat_dim(s)
            if p == "full_matrix":
                specs.append(ParamSpec(f"w{i}", (d, size), "xavier"))
            elif p == "trans_full_matrix":
                specs.append(ParamSpec(f"w{i}", (size, d), "xavier"))
            elif p == "dotmul":
                specs.append(ParamSpec(f"w{i}", (size,), "ones"))
            elif p == "scaling":
                specs.append(ParamSpec(f"w{i}", (1,), "ones"))
            elif p == "table":
                specs.append(ParamSpec(
                    f"w{i}", (proj["vocab_size"], size), "normal"))
            elif p in ("conv", "conv_trans"):
                _, _, c = s
                k = proj["filter_size"]
                cin = c if p == "conv_trans" else c // proj.get("groups", 1)
                specs.append(ParamSpec(
                    f"w{i}", (k, k, cin, proj["num_filters"]), "msra"))
            elif p in ("identity", "slice", "conv_op", "dotmul_op"):
                pass
            else:
                raise ValueError(f"unknown projection {p!r}")
        if attrs.get("bias", False):
            specs.append(ParamSpec("b", (size,), "zeros"))
        return specs

    def apply(self, attrs, params, inputs, ctx):
        out = None
        for i, proj, items in self._walk(attrs, inputs):
            p = proj["type"]
            x = items[0]
            if p == "full_matrix":
                y = x.reshape(x.shape[0], -1) @ params[f"w{i}"]
            elif p == "trans_full_matrix":
                y = x.reshape(x.shape[0], -1) @ params[f"w{i}"].t()
            elif p == "dotmul":
                y = x * params[f"w{i}"]
            elif p == "scaling":
                y = x * params[f"w{i}"][0]
            elif p == "table":
                y = params[f"w{i}"][x.long()]
            elif p == "identity":
                y = x
            elif p == "conv":
                st, pd = proj.get("stride", 1), proj.get("padding", 0)
                y = conv2d_nhwc(x, params[f"w{i}"], (st, st), (pd, pd),
                                groups=proj.get("groups", 1))
                y = y.reshape(y.shape[0], -1)
            elif p == "conv_trans":
                y = _conv_transpose_nhwc(x, params[f"w{i}"],
                                         proj.get("stride", 1),
                                         proj.get("padding", 0))
                y = y.reshape(y.shape[0], -1)
            elif p == "conv_op":
                y = _conv_operator(items[0], items[1], proj)
            elif p == "dotmul_op":
                a, b = items
                y = proj.get("scale", 1.0) * a * b
            elif p == "slice":
                y = x[..., proj["start"]:proj["end"]]
            out = y if out is None else out + y
        if "b" in params:
            out = out + params["b"]
        return act_mod.apply(attrs.get("act", "linear"), out)


def _conv_transpose_nhwc(x, w, stride, padding):
    """``lax.conv_transpose`` of NHWC x with an HWIO kernel at padding
    k - 1 - padding a side: the kernel is not flipped there, so here it is
    flipped into ``F.conv_transpose2d``'s [in, out, kh, kw] layout."""
    wt = w.permute(2, 3, 0, 1).flip(2, 3)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, None, stride, padding)
    return y.permute(0, 2, 3, 1)


def _conv_operator(img, filt, proj):
    """conv_op: each sample's image convolved with its own filters (the
    filter layer's row is the (num_filters, channels * kh * kw) weight);
    one grouped conv over the batch, NHWC out, flattened."""
    b, h, w, _ = img.shape
    k = proj["filter_size"]
    cin, cout = proj["num_channels"], proj["num_filters"]
    st, pd = proj.get("stride", 1), proj.get("padding", 0)
    xs = img.permute(0, 3, 1, 2).reshape(1, b * cin, h, w)
    ws = filt.reshape(b * cout, cin, k, k)
    y = F.conv2d(xs, ws, None, st, pd, 1, b)
    y = y.reshape(b, cout, y.shape[-2], y.shape[-1]).permute(0, 2, 3, 1)
    return y.reshape(b, -1)


@register_layer
class ScalingLayer(LayerDef):
    """rows of the input scaled by a per-sample weight (reference:
    ScalingLayer.cpp); inputs: weight (B, 1) or (B,), x."""

    kind = "scaling"

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[1]

    def apply(self, attrs, params, inputs, ctx):
        w, x = inputs
        w = w.reshape((w.shape[0],) + (1,) * (x.ndim - 1))
        return w * x


@register_layer
class SlopeInterceptLayer(LayerDef):
    """y = slope * x + intercept (reference: SlopeInterceptLayer.cpp)."""

    kind = "slope_intercept"

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def apply(self, attrs, params, inputs, ctx):
        return (attrs.get("slope", 1.0) * inputs[0]
                + attrs.get("intercept", 0.0))


@register_layer
class InterpolationLayer(LayerDef):
    """out = w * x + (1 - w) * y, w per sample (reference:
    InterpolationLayer.cpp)."""

    kind = "interpolation"

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[1]

    def apply(self, attrs, params, inputs, ctx):
        w, x, y = inputs
        w = w.reshape((w.shape[0],) + (1,) * (x.ndim - 1))
        return w * x + (1.0 - w) * y


@register_layer
class DotProdLayer(LayerDef):
    """row-wise dot product of two inputs (reference: DotProdLayer.cpp)."""

    kind = "dot_prod"

    def infer_shape(self, attrs, in_shapes):
        return (1,)

    def apply(self, attrs, params, inputs, ctx):
        a, b = inputs
        return torch.sum(a * b, dim=-1, keepdim=True)


@register_layer
class CosSimLayer(LayerDef):
    """scaled cosine similarity (reference: CosSimLayer.cpp)."""

    kind = "cos_sim"

    def infer_shape(self, attrs, in_shapes):
        return (1,)

    def apply(self, attrs, params, inputs, ctx):
        a, b = inputs
        a2 = a.reshape(a.shape[0], -1)
        b2 = b.reshape(b.shape[0], -1)
        num = torch.sum(a2 * b2, dim=-1)
        den = (torch.linalg.vector_norm(a2, dim=-1)
               * torch.linalg.vector_norm(b2, dim=-1))
        return (attrs.get("scale", 1.0) * num
                / torch.clamp(den, min=1e-12))[:, None]


@register_layer
class ReshapeLayer(LayerDef):
    kind = "reshape"

    def infer_shape(self, attrs, in_shapes):
        return tuple(attrs["shape"])

    def apply(self, attrs, params, inputs, ctx):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(attrs["shape"]))


@register_layer
class TransLayer(LayerDef):
    """transpose of per-sample 2-D features (reference: TransLayer.cpp)."""

    kind = "trans"

    def infer_shape(self, attrs, in_shapes):
        s = in_shapes[0]
        return (s[1], s[0])

    def apply(self, attrs, params, inputs, ctx):
        return inputs[0].transpose(1, 2)


@register_layer
class SumCostInputLayer(LayerDef):
    """an activation applied on its own (reference: a mixed layer of one
    identity projection and the activation)."""

    kind = "activation"

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def apply(self, attrs, params, inputs, ctx):
        return act_mod.apply(attrs["act"], inputs[0])


@register_layer
class BilinearTensorProductLayer(LayerDef):
    """out_k = x^T W_k y (reference: bilinear_tensor_product_op)."""

    kind = "bilinear_tensor_product"

    def infer_shape(self, attrs, in_shapes):
        return (attrs["size"],)

    def param_specs(self, attrs, in_shapes):
        dx = _flat_dim(in_shapes[0])
        dy = _flat_dim(in_shapes[1])
        return [ParamSpec("w", (attrs["size"], dx, dy), "xavier")]

    def apply(self, attrs, params, inputs, ctx):
        x, y = inputs
        return torch.einsum("bi,kij,bj->bk", x, params["w"], y)


@register_layer
class NormLayer(LayerDef):
    """l2 row normalisation."""

    kind = "row_l2_norm"

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def apply(self, attrs, params, inputs, ctx):
        x = inputs[0]
        n = torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=-1)
        return x / torch.clamp(n, min=1e-12).reshape(
            (-1,) + (1,) * (x.ndim - 1))


def _identity_stats(generator, shape):
    """rows [min, 1/(max-min), mean, 1/std, 1/10^j] = [0, 1, 0, 1, 1]:
    every strategy the identity map."""
    col = torch.tensor([0.0, 1.0, 0.0, 1.0, 1.0])
    return col[:, None].expand(shape).clone()


@register_layer
class DataNormLayer(LayerDef):
    """Feature-wise normalisation from precomputed statistics (reference:
    DataNormLayer.cpp): one static (5, size) parameter ``stats`` with rows
    [min, 1/(max-min), mean, 1/std, 1/10^j], initialised to the identity
    statistics; strategies z-score, min-max and decimal-scaling."""

    kind = "data_norm"

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def param_specs(self, attrs, in_shapes):
        return [ParamSpec("stats", (5, in_shapes[0][-1]),
                          initializer=_identity_stats, is_static=True)]

    def apply(self, attrs, params, inputs, ctx):
        x = inputs[0]
        stats = params["stats"]
        strategy = attrs.get("data_norm_strategy", "z-score")
        if strategy == "z-score":
            return (x - stats[2]) * stats[3]
        if strategy == "min-max":
            return (x - stats[0]) * stats[1]
        if strategy == "decimal-scaling":
            return x * stats[4]
        raise ValueError(
            f"unknown data normalization strategy {strategy!r}; expected "
            "z-score | min-max | decimal-scaling")
