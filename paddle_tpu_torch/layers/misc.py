"""The long-tail layer catalog (counterpart of ``paddle_tpu/layers/misc.py``):
the stateless math, shape and selection layers registered by ``_simple``
(clip, power, sum_to_one_norm, cross_channel_norm, l2_distance, out_prod,
linear_comb, multiplex, repeat, resize, rotate, switch_order, scale_shift,
scale_sub_region, prelu, maxid, sampling_id, eos, print, tensor, eltmul,
selective_fc, conv_shift), ``RowConvLayer``, ``FactorizationMachineLayer``,
``BlockExpandLayer`` and the 3-D image layers.

Each is the JAX package's computation in eager PyTorch, with its shapes
and its constants: ``selective_fc`` under softmax masks with -1e30, not
``-inf``; ``sampling_id`` draws Gumbel noise from the forward's generator
(``ctx.rng()``), as ``jax.random.categorical`` does from its key (the
draws themselves differ); ``print`` prints on the host, and inside a
captured CUDA graph it raises rather than read the card back.

Volumes are NDHWC and kernels DHWIO, as in the JAX package, so weights
cross with no transpose; the convs are ``F.conv3d`` and
``F.conv_transpose3d`` on NCDHW views, the transposed one with the
kernel flipped as ``ops/conv_bn.conv_transpose_nhwc`` sets out.  Pooling
takes VALID windows, and avg divides by k^3.  A batch norm on a volume
(rank 5) takes the plain statistics, as the JAX package routes it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch.core.ir import ParamSpec
from paddle_tpu_torch.core.registry import LayerDef, register_layer
from paddle_tpu_torch.layers.sequence import SeqLayerDef
from paddle_tpu_torch.ops.conv_bn import conv_transpose_nhwc


def _simple(kind_name, infer, fn, params=None):
    """Register a stateless layer from two functions."""

    class _L(LayerDef):
        kind = kind_name

        def infer_shape(self, attrs, in_shapes):
            return infer(attrs, in_shapes)

        def param_specs(self, attrs, in_shapes):
            return params(attrs, in_shapes) if params else []

        def apply(self, attrs, p, inputs, ctx):
            return fn(attrs, p, inputs, ctx)

    _L.__name__ = f"{kind_name.title().replace('_', '')}Layer"
    register_layer(_L)


_simple("clip",
        lambda a, s: s[0],
        lambda a, p, x, c: torch.clamp(x[0], a["min"], a["max"]))

# y = x ^ w, the exponent from input 0 (width 1), the base from input 1
# (reference PowerLayer.cpp)
_simple("power",
        lambda a, s: s[1],
        lambda a, p, x, c: torch.pow(x[1], x[0].reshape(x[0].shape[0], 1)))

_simple("sum_to_one_norm",
        lambda a, s: s[0],
        lambda a, p, x, c: x[0] / torch.clamp(
            torch.sum(x[0], -1, keepdim=True), min=1e-12))

_simple("cross_channel_norm",
        lambda a, s: s[0],
        lambda a, p, x, c: x[0] / torch.sqrt(
            torch.sum(x[0] ** 2, -1, keepdim=True) + 1e-10) * p["scale"],
        params=lambda a, s: [ParamSpec("scale", (s[0][-1],), "ones")])

_simple("l2_distance",
        lambda a, s: (1,),
        lambda a, p, x, c: torch.sqrt(
            torch.sum((x[0] - x[1]) ** 2, -1, keepdim=True) + 1e-12))

_simple("out_prod",
        lambda a, s: (s[0][-1] * s[1][-1],),
        lambda a, p, x, c: torch.einsum(
            "bi,bj->bij", x[0], x[1]).reshape(x[0].shape[0], -1))

# weights [M], features [M * N] -> [N]: the weighted sum of M blocks
_simple("linear_comb",
        lambda a, s: (a["size"],),
        lambda a, p, x, c: torch.einsum(
            "bm,bmn->bn", x[0], x[1].reshape(x[1].shape[0], -1, a["size"])))


def _multiplex(a, p, x, c):
    """index [B] picks which of the other inputs gives each row."""
    stacked = torch.stack(x[1:], 1)                      # [B, K, ...]
    idx = x[0].long().reshape((-1, 1) + (1,) * (x[1].ndim - 1))
    idx = idx.expand((stacked.shape[0], 1) + tuple(stacked.shape[2:]))
    return torch.gather(stacked, 1, idx)[:, 0]


_simple("multiplex", lambda a, s: s[1], _multiplex)

# as_row_vector=True tiles the whole row [a,b,c,a,b,c]; False repeats each
# element [a,a,b,b,c,c] (reference repeat_layer)
_simple("repeat",
        lambda a, s: (s[0][-1] * a["num_repeats"],),
        lambda a, p, x, c: (
            x[0].repeat(1, a["num_repeats"])
            if a.get("as_row_vector", True)
            else torch.repeat_interleave(x[0], a["num_repeats"], -1)))

_simple("resize",
        lambda a, s: (a["size"],),
        lambda a, p, x, c: x[0].reshape(x[0].shape[0], -1, a["size"])
        .reshape(-1, a["size"]))

# H and W of an image swapped and H flipped (reference RotateLayer: 90
# degrees counter-clockwise)
_simple("rotate",
        lambda a, s: (s[0][1], s[0][0]) + tuple(s[0][2:]),
        lambda a, p, x, c: torch.flip(x[0].transpose(1, 2), (1,)))

# permute the non-batch axes by their 1-based numbers (reference
# SwitchOrderLayer)
_simple("switch_order",
        lambda a, s: tuple(s[0][i - 1] for i in a["reshape_axis"]),
        lambda a, p, x, c: x[0].permute((0,) + tuple(a["reshape_axis"])))


def _scale_shift_params(attrs, in_shapes):
    specs = [ParamSpec("w", (1,), "ones")]
    if attrs.get("bias", True):
        specs.append(ParamSpec("b", (1,), "zeros"))
    return specs


_simple("scale_shift",
        lambda a, s: s[0],
        lambda a, p, x, c: x[0] * p["w"] + p.get("b", 0.0),
        params=_scale_shift_params)


def _ssr(a, p, x, c):
    """Scale the [x1, x2] x [y1, y2] sub-region of each image (columns 0
    to 3 of the indices input, 1-based inclusive pixels)."""
    img, idx = x[0], x[1]
    h, w = img.shape[1], img.shape[2]
    ys = torch.arange(h, dtype=torch.float32,
                      device=img.device)[None, :, None, None]
    xs = torch.arange(w, dtype=torch.float32,
                      device=img.device)[None, None, :, None]
    x1, x2, y1, y2 = (idx[:, i].reshape(-1, 1, 1, 1) - 1 for i in range(4))
    inside = (ys >= y1) & (ys <= y2) & (xs >= x1) & (xs <= x2)
    return torch.where(inside, img * a.get("value", 1.0), img)


_simple("scale_sub_region", lambda a, s: s[0], _ssr)


def _prelu_params(attrs, in_shapes):
    n = {"all": 1, "channel": in_shapes[0][-1]}.get(
        attrs.get("partial_sum_mode", "all"), 1)
    return [ParamSpec("w", (n,), initializer=0.25)]


_simple("prelu",
        lambda a, s: s[0],
        lambda a, p, x, c: torch.where(x[0] >= 0, x[0], x[0] * p["w"]),
        params=_prelu_params)

_simple("maxid",
        lambda a, s: (),
        lambda a, p, x, c: torch.argmax(x[0], -1).to(torch.int32))


def _sampling_id(a, p, x, c):
    """A draw from each row's distribution: argmax of log p plus Gumbel
    noise from the forward's generator, the Gumbel-max draw of
    ``jax.random.categorical``."""
    probs = x[0]
    u = torch.rand(probs.shape, generator=c.rng(), device=probs.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    logits = torch.log(torch.clamp(probs.float(), min=1e-20))
    return torch.argmax(logits - torch.log(-torch.log(u)), -1).to(
        torch.int32)


_simple("sampling_id", lambda a, s: (), _sampling_id)

_simple("eos",
        lambda a, s: (),
        lambda a, p, x, c: (x[0].to(torch.int32) == a["eos_id"]).to(
            torch.int32))


def _print_layer(a, p, x, c):
    if x[0].is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "print layer inside a captured CUDA graph: printing reads the "
            "card back to the host, which a capture cannot do; run the "
            "step eagerly (steps_per_dispatch=1) to print")
    print(a.get("format", "{}").format(x[0].detach().cpu().numpy()),
          flush=True)
    return x[0]


_simple("print", lambda a, s: s[0], _print_layer)


# x [N], y [M] -> x^T W_k y + b_k for each output unit k (reference
# TensorLayer: one [N, M] slab a unit)
def _tensor_params(attrs, in_shapes):
    specs = [ParamSpec("w", (attrs["size"], in_shapes[0][-1],
                             in_shapes[1][-1]), "xavier")]
    if attrs.get("bias", True):
        specs.append(ParamSpec("b", (attrs["size"],), "zeros"))
    return specs


_simple("tensor", lambda a, s: (a["size"],),
        lambda a, p, x, c: act_mod.apply(
            a.get("act", "linear"),
            torch.einsum("bn,knm,bm->bk", x[0], p["w"], x[1])
            + p.get("b", 0.0)),
        params=_tensor_params)

# the elementwise product of two layers (reference DotMulOperator; the
# gate of gated_unit)
_simple("eltmul",
        lambda a, s: s[0],
        lambda a, p, x, c: x[0] * x[1])


def _selective_fc_params(attrs, in_shapes):
    d = int(math.prod(in_shapes[0])) if in_shapes[0] else 1
    specs = [ParamSpec("w", (d, attrs["size"]), "xavier")]
    if attrs.get("bias", True):
        specs.append(ParamSpec("b", (attrs["size"],), "zeros"))
    return specs


def _selective_fc(a, p, x, c):
    """fc whose output keeps the selected columns (reference
    SelectiveFcLayer): the dense product and a mask; under softmax the
    normalisation runs over the selected columns only, the others at the
    finite -1e30 so an empty selection gives zeros, not NaN."""
    feat, sel = x
    logits = feat.reshape(feat.shape[0], -1) @ p["w"] + p.get("b", 0.0)
    act = a.get("act", "linear")
    if act == "softmax":
        masked = torch.where(sel > 0, logits, torch.full((), -1e30,
                                                         device=sel.device))
        out = torch.softmax(masked, -1)
        return torch.where(sel > 0, out, torch.zeros((), device=sel.device))
    return act_mod.apply(act, logits) * sel


_simple("selective_fc", lambda a, s: (a["size"],), _selective_fc,
        params=_selective_fc_params)


def _conv_shift(a, p, x, c):
    """circular convolution: out[i] = sum_j a[(i + j - M // 2) mod N] b[j]."""
    xa, xb = x
    n, m = xa.shape[-1], xb.shape[-1]
    ar = torch.arange
    idx = (ar(n, device=xa.device)[:, None] + ar(m, device=xa.device)[None, :]
           - m // 2) % n
    return torch.einsum("bnm,bm->bn", xa[:, idx], xb)


_simple("conv_shift", lambda a, s: s[0], _conv_shift)


@register_layer
class RowConvLayer(SeqLayerDef):
    """Look-ahead row convolution over a sequence (reference row_conv_op):
    out[t] = sum_j x[t + j] * w[j] over ``context`` steps, the frames past
    each sequence's end zero."""

    kind = "row_conv"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def param_specs(self, attrs, in_shapes):
        return [ParamSpec("w", (attrs["context"], in_shapes[0][-1]),
                          "xavier")]

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, mask = inputs[0], masks[0]
        if mask is not None:
            x = x * mask[..., None]
        k = attrs["context"]
        w = params["w"]
        xp = F.pad(x, (0, 0, 0, k - 1))
        out = torch.zeros_like(x)
        for j in range(k):
            out = out + xp[:, j:j + x.shape[1]] * w[j]
        return out


@register_layer
class FactorizationMachineLayer(LayerDef):
    """The second-order factorization machine term (reference
    FactorizationMachineLayer.cpp): 0.5 * sum_k [(x . v_k)^2 - x^2 .
    v_k^2]."""

    kind = "factorization_machine"

    def infer_shape(self, attrs, in_shapes):
        return (1,)

    def param_specs(self, attrs, in_shapes):
        return [ParamSpec("w", (in_shapes[0][-1], attrs["factor_size"]),
                          "xavier")]

    def apply(self, attrs, params, inputs, ctx):
        x, v = inputs[0], params["w"]
        return 0.5 * torch.sum((x @ v) ** 2 - (x ** 2) @ (v ** 2), -1,
                               keepdim=True)


@register_layer
class BlockExpandLayer(SeqLayerDef):
    """im2col patches as a sequence (reference BlockExpandLayer.cpp, the
    OCR-CTC front end): an NHWC image becomes [blocks, block_y * block_x *
    C] steps in row-major block order, every sequence full (mask None);
    one gather of the patches."""

    kind = "block_expand"
    out_is_seq = True

    @staticmethod
    def _geom(attrs, in_shape):
        h, w = in_shape[0], in_shape[1]
        bx, by = attrs["block_x"], attrs["block_y"]
        sx = attrs.get("stride_x", bx)
        sy = attrs.get("stride_y", by)
        return bx, by, sx, sy, (w - bx) // sx + 1, (h - by) // sy + 1

    def infer_shape(self, attrs, in_shapes):
        bx, by, sx, sy, ox, oy = self._geom(attrs, in_shapes[0])
        return (ox * oy, bx * by * in_shapes[0][2])

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x = inputs[0]                                   # [B, H, W, C]
        bx, by, sx, sy, ox, oy = self._geom(attrs, x.shape[1:])
        ar = torch.arange
        iy = (ar(oy, device=x.device) * sy)[:, None] + ar(by,
                                                          device=x.device)
        ix = (ar(ox, device=x.device) * sx)[:, None] + ar(bx,
                                                          device=x.device)
        # [B, oy, by, ox, bx, C] -> [B, oy, ox, by, bx, C]
        patches = x[:, iy[:, :, None, None], ix[None, None, :, :], :]
        patches = patches.permute(0, 1, 3, 2, 4, 5)
        return patches.reshape(x.shape[0], oy * ox, by * bx * x.shape[3])


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
