"""Core dense layers: data, fc, embedding, addto, concat, slice (the part
of ``paddle_tpu/layers/common.py`` the ported models need).

``fc`` lowers to one ``torch.matmul`` per input, as the JAX package leaves
it to XLA; under a reduced-precision policy each input and weight is cast
to the compute dtype first, and the bias to the product's dtype.
``embedding`` is a row gather of the float32 table (no cast, as in the JAX
package) whose backward is autograd's scatter-add.  Sparse (ids + values) inputs and sparse-update tables are not
ported yet and raise.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch.core.ir import ParamSpec
from paddle_tpu_torch.core.registry import LayerDef, register_layer


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
                "paddle_tpu_torch yet")
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
