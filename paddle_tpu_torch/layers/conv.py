"""Image stack and normalisation layers (counterpart of
``paddle_tpu/layers/conv.py``): conv, pool, global pool, batch norm,
cross-map norm, the fused conv + batch norm ``conv_bn``, and layer norm.

Images are NHWC and conv kernels HWIO, as in the JAX package, so weights
cross with no transpose; the plain convs are ``F.conv2d`` on NCHW views
(``ops/conv_bn.conv2d_nhwc``).  Train-mode batch norm keeps its moving
mean and variance in the forward's running state (``ApplyContext``
``get_state`` / ``set_state``).  Two routes reach the CUDA kernels on the
card: a relu ``batch_norm`` under ``fused_bn_impl="pallas"`` (kernels 7a
and 7b, ``ops/fused_bn.py``) and ``conv_bn`` (kernels 8 and 9,
``ops/conv_bn.py``).

Under a reduced-precision policy (``ApplyContext.compute_dtype``, bf16
under ``bf16`` and ``mixed``) the layers keep the JAX package's dtypes:
conv and conv_bn cast x and w to the compute dtype (conv's bias to its
output's), so activations stay bf16 between the convs; batch norm folds
its float32 scalars into x's dtype and keeps float32 statistics and
moving state; pooling keeps its input's dtype.

Not ported yet: conv_transpose, maxout, bilinear_interp, pad, crop, spp,
featmap_expand and the 3-D layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch.core.ir import ParamSpec
from paddle_tpu_torch.core.registry import LayerDef, register_layer
from paddle_tpu_torch.ops import conv_bn as cb
from paddle_tpu_torch.ops import fused_bn


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)


def _compute_cast(ctx, x, w):
    """x and w in the compute dtype, where a policy sets one."""
    if ctx.compute_dtype is None:
        return x, w
    return x.to(ctx.compute_dtype), w.to(ctx.compute_dtype)


def _conv_out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


@register_layer
class ConvLayer(LayerDef):
    """2-D convolution, NHWC, kernel HWIO. attrs: num_filters, filter_size,
    stride, padding, groups, act, bias, dilation, space_to_depth."""

    kind = "conv"

    def infer_shape(self, attrs, in_shapes):
        h, w, c = in_shapes[0]
        kh, kw = _pair(attrs["filter_size"])
        sh, sw = _pair(attrs.get("stride", 1))
        ph, pw = _pair(attrs.get("padding", 0))
        dh, dw = _pair(attrs.get("dilation", 1))
        ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        return (_conv_out(h, ekh, sh, ph), _conv_out(w, ekw, sw, pw),
                attrs["num_filters"])

    def param_specs(self, attrs, in_shapes):
        h, w, c = in_shapes[0]
        kh, kw = _pair(attrs["filter_size"])
        groups = attrs.get("groups", 1)
        specs = [ParamSpec(
            name="w", shape=(kh, kw, c // groups, attrs["num_filters"]),
            initializer=attrs.get("param_initializer") or "msra")]
        if attrs.get("bias", True):
            specs.append(ParamSpec(name="b", shape=(attrs["num_filters"],),
                                   initializer="zeros"))
        return specs

    def apply(self, attrs, params, inputs, ctx):
        sh, sw = _pair(attrs.get("stride", 1))
        ph, pw = _pair(attrs.get("padding", 0))
        dh, dw = _pair(attrs.get("dilation", 1))
        x, w = _compute_cast(ctx, inputs[0], params["w"])
        if (attrs.get("space_to_depth") and (sh, sw) == (2, 2)
                and (dh, dw) == (1, 1) and attrs.get("groups", 1) == 1
                and w.shape[0] % 2 == 1 and w.shape[1] % 2 == 1
                and ph == w.shape[0] // 2
                and pw == w.shape[1] // 2 and x.shape[1] % 2 == 0
                and x.shape[2] % 2 == 0
                # the 2x2 packing parity only lines up for ODD half-pad
                # (k = 3, 7, 11, ...)
                and (w.shape[0] // 2) % 2 == 1
                and (w.shape[1] // 2) % 2 == 1):
            out = _s2d_conv(x, w)
        else:
            out = cb.conv2d_nhwc(x, w, (sh, sw), (ph, pw), (dh, dw),
                                 attrs.get("groups", 1))
        if "b" in params:
            out = out + params["b"].to(out.dtype)
        return act_mod.apply(attrs.get("act", "linear"), out)


def _s2d_conv(x, w):
    """Space-to-depth form of an odd-k, stride-2, half-pad conv (the MLPerf
    ResNet stem rewrite, exact): pack 2x2 pixels into channels and run a
    stride-1 conv with the kernel rearranged to match (the JAX package's
    ``_s2d_conv``, whose docstring derives it)."""
    b, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    xs = x.reshape(b, h // 2, 2, wd // 2, 2, c)
    xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, wd // 2, 4 * c)
    # kernel: pad to even at the leading edge, split even/odd taps
    wp = F.pad(w, (0, 0, 0, 0, 1, 0, 1, 0))
    khp, kwp = kh + 1, kw + 1
    w4 = wp.reshape(khp // 2, 2, kwp // 2, 2, c, o)
    w4 = w4.permute(0, 2, 1, 3, 4, 5).reshape(khp // 2, kwp // 2, 4 * c, o)
    lo_h, hi_h = (khp // 2) // 2, (khp // 2 - 1) // 2
    lo_w, hi_w = (kwp // 2) // 2, (kwp // 2 - 1) // 2
    xs = F.pad(xs, (0, 0, lo_w, hi_w, lo_h, hi_h))
    return cb.conv2d_nhwc(xs, w4)


@register_layer
class PoolLayer(LayerDef):
    """max/avg pooling. attrs: pool_type, pool_size, stride, padding,
    ceil_mode.  Max pads with -inf; avg leaves the padding out of its
    divisor (the reference's semantics)."""

    kind = "pool"

    def infer_shape(self, attrs, in_shapes):
        h, w, c = in_shapes[0]
        kh, kw = _pair(attrs["pool_size"])
        sh, sw = _pair(attrs.get("stride", attrs["pool_size"]))
        ph, pw = _pair(attrs.get("padding", 0))
        if attrs.get("ceil_mode", True):
            oh = math.ceil((h + 2 * ph - kh) / sh) + 1
            ow = math.ceil((w + 2 * pw - kw) / sw) + 1
        else:
            oh, ow = _conv_out(h, kh, sh, ph), _conv_out(w, kw, sw, pw)
        return (oh, ow, c)

    def apply(self, attrs, params, inputs, ctx):
        x = inputs[0]
        kh, kw = _pair(attrs["pool_size"])
        sh, sw = _pair(attrs.get("stride", attrs["pool_size"]))
        ph, pw = _pair(attrs.get("padding", 0))
        oh, ow, _ = self.infer_shape(attrs, [tuple(x.shape[1:])])
        # effective (possibly asymmetric, ceil-mode) padding
        pad = (pw, max(0, (ow - 1) * sw + kw - x.shape[2] - pw),
               ph, max(0, (oh - 1) * sh + kh - x.shape[1] - ph))
        xn = x.permute(0, 3, 1, 2)
        if attrs.get("pool_type", "max") == "max":
            out = F.max_pool2d(F.pad(xn, pad, value=-math.inf), (kh, kw),
                               (sh, sw))
            return out.permute(0, 2, 3, 1)
        s = F.avg_pool2d(F.pad(xn, pad), (kh, kw), (sh, sw),
                         divisor_override=1)
        ones = torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype,
                          device=x.device)
        cnt = F.avg_pool2d(F.pad(ones, pad), (kh, kw), (sh, sw),
                           divisor_override=1)
        return (s / torch.clamp_min(cnt, 1.0)).permute(0, 2, 3, 1)


@register_layer
class GlobalPoolLayer(LayerDef):
    """global spatial pooling to (C,)."""

    kind = "global_pool"

    def infer_shape(self, attrs, in_shapes):
        return (in_shapes[0][-1],)

    def apply(self, attrs, params, inputs, ctx):
        x = inputs[0]
        if attrs.get("pool_type", "avg") == "max":
            return x.amax(dim=(1, 2))
        return x.mean(dim=(1, 2))


def _bn_fold(x, scale, bias, mean, var, eps):
    """Normalisation folded into per-channel float32 scalars, cast to x's
    dtype, then x * w + b as ``fused_bn._fold`` evaluates it (one multiply
    and one add in x's dtype; one float32 multiply-add rounded once at
    float16, as the JAX package's jitted steps and ``SGD.test`` evaluate
    its fold): the train path's and the eval path's single form."""
    inv = torch.rsqrt(var + eps)
    return fused_bn._fold(x, scale * inv, bias - mean * scale * inv)


def _bn_train(x, scale, bias, eps):
    """Training batch norm with the linear fold, the activation applied
    after it (the path of activations other than relu and linear)."""
    return fused_bn.bn_act_train(x, scale, bias, eps, "linear", "xla")


@register_layer
class BatchNormLayer(LayerDef):
    """Batch normalisation over the channel (last) axis with running stats.

    Reference: BatchNormalizationLayer.cpp (moving_average_fraction 0.9,
    epsilon 1e-5, biased batch variance).  The moving mean and variance
    are running state, updated in train mode and used in eval mode (or
    whenever ``use_global_stats``)."""

    kind = "batch_norm"

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def param_specs(self, attrs, in_shapes):
        c = in_shapes[0][-1]
        return [
            ParamSpec(name="scale", shape=(c,), initializer="ones"),
            ParamSpec(name="bias", shape=(c,), initializer="zeros"),
            ParamSpec(name="moving_mean", shape=(c,), initializer="zeros",
                      is_state=True),
            ParamSpec(name="moving_var", shape=(c,), initializer="ones",
                      is_state=True),
        ]

    def apply(self, attrs, params, inputs, ctx):
        x = inputs[0]
        eps = attrs.get("epsilon", 1e-5)
        momentum = attrs.get("moving_average_fraction", 0.9)
        act = attrs.get("act", "linear") or "linear"
        use_global = attrs.get("use_global_stats", None)
        if use_global is None:
            use_global = not ctx.train
        if use_global:
            out = _bn_fold(x, params["scale"], params["bias"],
                           ctx.get_state("moving_mean"),
                           ctx.get_state("moving_var"), eps)
        elif act in ("linear", "relu"):
            impl = attrs.get("fused_bn_impl") or fused_bn.default_impl()
            if impl == "pallas" and act != "relu":
                # the JAX package's rule: a linear BN takes the plain
                # statistics even under "pallas"
                impl = "xla"
            out, mean, var = fused_bn.bn_act_train(
                x, params["scale"], params["bias"], eps, act, impl)
            self._update_stats(ctx, momentum, mean, var)
            return out
        else:
            out, mean, var = _bn_train(x, params["scale"], params["bias"],
                                       eps)
            self._update_stats(ctx, momentum, mean, var)
        return act_mod.apply(act, out)

    @staticmethod
    def _update_stats(ctx, momentum, mean, var):
        ctx.set_state("moving_mean", momentum * ctx.get_state("moving_mean")
                      + (1 - momentum) * mean)
        ctx.set_state("moving_var", momentum * ctx.get_state("moving_var")
                      + (1 - momentum) * var)


@register_layer
class CMRNormLayer(LayerDef):
    """cross-map response normalisation / LRN (reference:
    CMRProjectionNormLayer): out = x / (k + alpha / size * sum over a
    window of ``size`` channels of x^2)^beta."""

    kind = "img_cmrnorm"

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def apply(self, attrs, params, inputs, ctx):
        x = inputs[0]
        size = attrs.get("size", 5)
        alpha = attrs.get("alpha", 1e-4)
        beta = attrs.get("beta", 0.75)
        k = attrs.get("k", 1.0)
        half = size // 2
        c = x.shape[-1]
        sq = F.pad(x * x, (half, size - 1 - half))
        acc = sq[..., 0:c]
        for j in range(1, size):
            acc = acc + sq[..., j:j + c]
        return x * torch.pow(k + (alpha / size) * acc, -beta)


class _BnApplyStats(torch.autograd.Function):
    """Normalise y with given batch statistics (``conv_bn``'s path: they
    come from the conv kernel's epilogue), with the JAX package's vjp
    (``_bn_apply_stats_bwd``): residuals y and per-channel scalars, x-hat
    recomputed, and the mean and var cotangents that flow back into the
    conv's statistics."""

    @staticmethod
    def forward(ctx, y, mean, var, scale, bias, eps):
        ctx.save_for_backward(y, mean, var, scale)
        ctx.eps = eps
        return _bn_fold(y, scale, bias, mean, var, eps)

    @staticmethod
    def backward(ctx, g):
        # float32 throughout: g and y upcast; dy back in y's dtype
        y, mean, var, scale = ctx.saved_tensors
        inv = torch.rsqrt(var + ctx.eps)
        red = tuple(range(y.ndim - 1))
        g = g.float()
        yf = y.float()
        xhat = (yf - mean) * inv
        dbias = g.sum(dim=red)
        dscale = (g * xhat).sum(dim=red)
        dy = (g * (scale * inv)).to(y.dtype)
        # d/dmean of (y - mean) * inv * scale = -inv * scale, over pixels
        dmean = -g.sum(dim=red) * scale * inv
        # d/dvar: (y - mean) * scale * d(inv)/dvar = -0.5 inv^3 (y - mean)
        dvar = (g * (yf - mean)).sum(dim=red) * scale * (-0.5) * inv ** 3
        return (dy, dmean.float(), dvar.float(), dscale.to(scale.dtype),
                dbias.to(scale.dtype), None)


@register_layer
class ConvBNLayer(LayerDef):
    """Fused stride-1 SAME conv + batch norm (+act): the conv's kernel takes
    the batch-norm sum and sum of squares in its epilogue (kernel 8 for
    filter_size 1, kernel 9 for 3), so the forward makes no pass of its
    own over the conv output.  Train mode only; eval runs the plain conv
    and folds the moving statistics.  Owns both parameter sets (w, scale,
    bias) and the moving statistics.  ``conv_bn_impl`` (attr): None or
    "pallas" routes by device, "xla" / "interpret" take the plain
    version."""

    kind = "conv_bn"

    def infer_shape(self, attrs, in_shapes):
        return tuple(in_shapes[0][:-1]) + (attrs["num_filters"],)

    def param_specs(self, attrs, in_shapes):
        ci = in_shapes[0][-1]
        co = attrs["num_filters"]
        fs = int(attrs.get("filter_size", 1))
        return [
            ParamSpec(name="w", shape=(fs, fs, ci, co),
                      initializer=attrs.get("param_initializer") or "msra"),
            ParamSpec(name="scale", shape=(co,), initializer="ones"),
            ParamSpec(name="bias", shape=(co,), initializer="zeros"),
            ParamSpec(name="moving_mean", shape=(co,), initializer="zeros",
                      is_state=True),
            ParamSpec(name="moving_var", shape=(co,), initializer="ones",
                      is_state=True),
        ]

    def apply(self, attrs, params, inputs, ctx):
        eps = attrs.get("epsilon", 1e-5)
        momentum = attrs.get("moving_average_fraction", 0.9)
        act = attrs.get("act", "linear") or "linear"
        use_global = attrs.get("use_global_stats", None)
        if use_global is None:
            use_global = not ctx.train
        # the fused product runs on the operands the unfused conv would
        x, w = _compute_cast(ctx, inputs[0], params["w"])
        fs = w.shape[0]
        if use_global:
            # eval: plain conv + folded stats (no statistics computed)
            y = (x @ w[0, 0] if fs == 1
                 else cb.conv2d_nhwc(x, w, padding=(1, 1)))
            out = _bn_fold(y, params["scale"], params["bias"],
                           ctx.get_state("moving_mean"),
                           ctx.get_state("moving_var"), eps)
            return act_mod.apply(act, out)

        impl = attrs.get("conv_bn_impl")
        if fs == 1:
            y, s, ss = cb.conv1x1_stats(x, w, impl)
        else:
            y, s, ss = cb.conv3x3_stats(x, w, impl)
        p = y.shape[0] * y.shape[1] * y.shape[2]
        mean = s / p
        var = torch.clamp_min(ss / p - mean * mean, 0.0)
        self._update_stats(ctx, momentum, mean, var)
        out = _BnApplyStats.apply(y, mean, var, params["scale"],
                                  params["bias"], float(eps))
        return act_mod.apply(act, out)

    _update_stats = staticmethod(BatchNormLayer._update_stats)


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
