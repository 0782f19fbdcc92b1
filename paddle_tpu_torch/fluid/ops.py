"""Fluid op catalog: the op registry and the PyTorch implementations
(counterpart of ``paddle_tpu/fluid/ops.py``).

The reference registers ~160 operators with paired CPU/CUDA kernels
(``paddle/fluid/operators``, registry ``framework/op_registry.h:62``).
Here an op is a function of torch tensors, ``fn(ctx, attrs, ins) ->
{slot: [tensor, ...]}``; the executor calls it eagerly, op by op, on the
executor's place.  No op has a hand-written grad kernel: the executor
derives each ``<type>_grad`` op from the forward function by autograd.

This catalog is the JAX catalog, op for op, with the same slots, attrs,
static padded output layouts (the -1 padding of NMS, of bipartite_match
and of the beams) and values; the control-flow ops (``recurrent``,
``while``, ``bounded_while``, ``conditional_block``, ``array_write``,
``array_read``) register from ``control_flow.py``.  An op whose value
must come back to the host to decide what runs next (``host_sync``: the
unbounded ``while``, ``conditional_block``'s branch, ``print``) cannot
be captured in a CUDA graph; ``Executor.run_n`` stands down for it.

Integers: a variable declared ``int64`` holds torch.int64 here (torch's
index dtype), where the JAX package, with x64 off, holds int32; the
values are the same.
"""

from __future__ import annotations

import types
from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.fluid import framework

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
    "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a fluid dtype name (or numpy dtype)."""
    return _DTYPES[framework.convert_dtype(dtype)]


class OpDef:
    def __init__(self, name: str, fn: Callable,
                 inputs: Sequence[str], outputs: Sequence[str],
                 list_slots: Sequence[str] = (),
                 differentiable: Sequence[str] = None,
                 stateful_rng: bool = False, host_sync: bool = False):
        self.name = name
        self.fn = fn  # fn(ctx, attrs, ins: Dict[slot, List[tensor]]) -> Dict
        self.inputs = tuple(inputs)
        self.outputs = tuple(outputs)
        self.list_slots = frozenset(list_slots)
        # slots whose inputs can receive gradients; None = all float inputs
        self.differentiable = (tuple(differentiable)
                               if differentiable is not None else None)
        self.stateful_rng = stateful_rng
        # reads a value back to the host while it runs
        self.host_sync = host_sync


OPS: Dict[str, OpDef] = {}

def register_op(name: str, inputs, outputs, list_slots=(),
                differentiable=None, stateful_rng=False, host_sync=False):
    def deco(fn):
        OPS[name] = OpDef(name, fn, inputs, outputs, list_slots,
                          differentiable, stateful_rng, host_sync)
        if stateful_rng:
            framework.STATEFUL_RNG_OPS.add(name)
        return fn

    return deco


def get_op(name: str) -> OpDef:
    if name not in OPS:
        raise KeyError(f"op {name!r} is not registered")
    return OPS[name]


def simple(name: str, inputs=("X",), outputs=("Out",), list_slots=(),
           differentiable=None, stateful_rng=False, host_sync=False):
    """Register an op whose fn takes unpacked tensors and returns
    tensor(s)."""

    def deco(f):
        def wrapper(ctx, attrs, ins):
            args = []
            for slot in OPS[name].inputs:
                vals = ins.get(slot, [])
                if slot in OPS[name].list_slots:
                    args.append(vals)
                else:
                    args.append(vals[0] if vals else None)
            out = f(ctx, attrs, *args)
            if not isinstance(out, tuple):
                out = (out,)
            return {s: [v] for s, v in zip(OPS[name].outputs, out)}

        OPS[name] = OpDef(name, wrapper, inputs, outputs, list_slots,
                          differentiable, stateful_rng, host_sync)
        if stateful_rng:
            framework.STATEFUL_RNG_OPS.add(name)
        return f

    return deco


# ---------------------------------------------------------------------------
# elementwise binary (with fluid's axis-broadcast semantics)
# ---------------------------------------------------------------------------

def _bcast(x, y, attrs):
    """Fluid broadcasts Y into X at ``axis`` (reference
    ``operators/elementwise_op.h``): Y's shape must match a contiguous
    run of X's dims starting at axis."""
    axis = attrs.get("axis", -1)
    if x.ndim == y.ndim:
        return x, y
    if axis < 0:
        axis = x.ndim - y.ndim
    shape = [1] * x.ndim
    for i, s in enumerate(y.shape):
        shape[axis + i] = s
    return x, y.reshape(shape)


def _register_elementwise(name, fn):
    @simple(name, inputs=("X", "Y"))
    def _impl(ctx, attrs, x, y, _fn=fn):
        x, y = _bcast(x, y, attrs)
        return _fn(x, y)


for _n, _f in [
    ("elementwise_add", torch.add), ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul), ("elementwise_div", torch.div),
    ("elementwise_max", torch.maximum), ("elementwise_min", torch.minimum),
    ("elementwise_pow", torch.pow),
]:
    _register_elementwise(_n, _f)


# ---------------------------------------------------------------------------
# unary math / activations (reference ``operators/activation_op.cc``)
# ---------------------------------------------------------------------------

def _register_unary(name, fn):
    @simple(name)
    def _impl(ctx, attrs, x, _fn=fn):
        return _fn(x)


for _n, _f in [
    ("sigmoid", torch.sigmoid), ("logsigmoid", F.logsigmoid),
    ("relu", torch.relu), ("tanh", torch.tanh),
    ("sqrt", torch.sqrt), ("abs", torch.abs), ("square", torch.square),
    ("exp", torch.exp), ("log", torch.log),
    ("reciprocal", torch.reciprocal), ("floor", torch.floor),
    ("ceil", torch.ceil), ("round", torch.round),
    # log(1 + e^x) without F.softplus's linear switch above x = 20
    ("softplus", lambda x: torch.logaddexp(x, torch.zeros_like(x))),
    ("softsign", lambda x: x / (1 + torch.abs(x))), ("sign", torch.sign),
]:
    _register_unary(_n, _f)


@simple("leaky_relu")
def _leaky_relu(ctx, attrs, x):
    return F.leaky_relu(x, attrs.get("alpha", 0.02))


@simple("brelu")
def _brelu(ctx, attrs, x):
    return torch.clamp(x, attrs.get("t_min", 0.0), attrs.get("t_max", 24.0))


@simple("soft_relu")
def _soft_relu(ctx, attrs, x):
    t = attrs.get("threshold", 40.0)
    return torch.log1p(torch.exp(torch.clamp(x, -t, t)))


@simple("elu")
def _elu(ctx, attrs, x):
    return F.elu(x, attrs.get("alpha", 1.0))


@simple("relu6")
def _relu6(ctx, attrs, x):
    return torch.clamp(x, 0.0, attrs.get("threshold", 6.0))


@simple("pow")
def _pow(ctx, attrs, x):
    return torch.pow(x, attrs.get("factor", 1.0))


@simple("stanh")
def _stanh(ctx, attrs, x):
    return attrs.get("scale_b", 1.7159) * torch.tanh(
        attrs.get("scale_a", 2.0 / 3.0) * x)


@simple("hard_sigmoid")
def _hard_sigmoid(ctx, attrs, x):
    return torch.clamp(
        attrs.get("slope", 0.2) * x + attrs.get("offset", 0.5), 0.0, 1.0)


@simple("swish")
def _swish(ctx, attrs, x):
    return x * torch.sigmoid(attrs.get("beta", 1.0) * x)


@simple("softmax")
def _softmax(ctx, attrs, x):
    return torch.softmax(x, dim=-1)


@simple("scale")
def _scale(ctx, attrs, x):
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return x * s + b
    return (x + b) * s


@simple("clip")
def _clip(ctx, attrs, x):
    return torch.clamp(x, attrs["min"], attrs["max"])


@simple("clip_by_norm")
def _clip_by_norm(ctx, attrs, x):
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


@simple("cumsum")
def _cumsum(ctx, attrs, x):
    return torch.cumsum(x, dim=attrs.get("axis", -1))


@simple("cast", differentiable=())
def _cast(ctx, attrs, x):
    return x.to(torch_dtype(attrs["out_dtype"]))


@simple("mean")
def _mean(ctx, attrs, x):
    return torch.mean(x)


@simple("increment", differentiable=())
def _increment(ctx, attrs, x):
    return x + attrs.get("step", 1.0)


# ---------------------------------------------------------------------------
# matmul family
# ---------------------------------------------------------------------------

@simple("mul", inputs=("X", "Y"))
def _mul(ctx, attrs, x, y):
    """Flattening matmul (reference ``mul_op.cc``): X flattened at
    x_num_col_dims, Y at y_num_col_dims."""
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xd])), -1)
    y2 = y.reshape(int(np.prod(ys[:yd])), -1)
    return (x2 @ y2).reshape(xs[:xd] + ys[yd:])


@simple("matmul", inputs=("X", "Y"))
def _matmul(ctx, attrs, x, y):
    if attrs.get("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    return out if alpha == 1.0 else out * alpha


# ---------------------------------------------------------------------------
# reductions / shape ops
# ---------------------------------------------------------------------------

def _reduce_axes(attrs, ndim):
    dim = attrs.get("dim", None)
    if attrs.get("reduce_all", False) or dim is None:
        return tuple(range(ndim))
    if isinstance(dim, int):
        dim = [dim]
    return tuple(d % ndim for d in dim)


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _register_reduce(name, fn):
    @simple(name)
    def _impl(ctx, attrs, x, _fn=fn):
        axes = _reduce_axes(attrs, x.ndim)
        return _fn(x, dim=axes, keepdim=attrs.get("keep_dim", False))


for _n, _f in [("reduce_sum", torch.sum), ("reduce_mean", torch.mean),
               ("reduce_max", torch.amax), ("reduce_min", torch.amin),
               ("reduce_prod", _prod)]:
    _register_reduce(_n, _f)


@simple("reshape")
def _reshape(ctx, attrs, x):
    shape = list(attrs["shape"])
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return x.reshape(shape)


@simple("transpose")
def _transpose(ctx, attrs, x):
    return x.permute(*attrs["axis"])


@simple("concat", inputs=("X",), list_slots=("X",))
def _concat(ctx, attrs, xs):
    return torch.cat(xs, dim=attrs.get("axis", 0))


@register_op("split", inputs=("X",), outputs=("Out",), list_slots=("X",))
def _split(ctx, attrs, ins):
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    if "sections" in attrs and attrs["sections"]:
        outs = torch.split(x, list(attrs["sections"]), dim=axis)
    else:
        outs = torch.chunk(x, attrs["num"], dim=axis)
    return {"Out": list(outs)}


@simple("sum", inputs=("X",), list_slots=("X",))
def _sum(ctx, attrs, xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@simple("expand")
def _expand(ctx, attrs, x):
    return x.repeat(*attrs["expand_times"])


@simple("crop", inputs=("X",))
def _crop(ctx, attrs, x):
    offsets = attrs["offsets"]
    shape = attrs["shape"]
    # -1 in shape = "to the end of the dim" (build-time unknown batch dim)
    slices = tuple(slice(o, None) if s == -1 else slice(o, o + s)
                   for o, s in zip(offsets, shape))
    return x[slices]


def _top(x, k):
    """(values, indices) of the k largest along the last axis, ties to
    the lower index first, as ``lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("top_k", inputs=("X",), outputs=("Out", "Indices"),
             differentiable=())
def _top_k(ctx, attrs, ins):
    vals, idx = _top(ins["X"][0], attrs["k"])
    return {"Out": [vals], "Indices": [idx]}


@simple("lookup_table", inputs=("W", "Ids"), differentiable=("W",))
def _lookup_table(ctx, attrs, w, ids):
    flat = ids.reshape(ids.shape[:-1]) if ids.shape[-1] == 1 else ids
    out = w[flat.long()]
    if attrs.get("padding_idx") is not None:
        mask = (flat != attrs["padding_idx"])[..., None]
        out = out * mask.to(out.dtype)
    return out


@simple("fill_zeros_like", differentiable=())
def _fill_zeros_like(ctx, attrs, x):
    return torch.zeros_like(x)


@simple("fill_constant", inputs=(), differentiable=())
def _fill_constant(ctx, attrs):
    return torch.full(tuple(attrs["shape"]), attrs["value"],
                      dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)


@simple("fill_constant_batch_size_like", inputs=("Input",),
        differentiable=())
def _fill_constant_bsl(ctx, attrs, ref):
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return torch.full(tuple(shape), attrs["value"],
                      dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)


@simple("assign")
def _assign(ctx, attrs, x):
    return x


@simple("assign_value", inputs=(), differentiable=())
def _assign_value(ctx, attrs):
    dt = framework.convert_dtype(attrs.get("dtype", "float32"))
    arr = np.asarray(attrs["values"], dtype=dt).reshape(tuple(attrs["shape"]))
    return torch.as_tensor(arr, device=ctx.device)


@simple("uniform_random", inputs=(), differentiable=(), stateful_rng=True)
def _uniform_random(ctx, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = ctx.uniform(tuple(attrs["shape"]))
    return (lo + u * (hi - lo)).to(
        torch_dtype(attrs.get("dtype", "float32")))


@simple("gaussian_random", inputs=(), differentiable=(), stateful_rng=True)
def _gaussian_random(ctx, attrs):
    z = ctx.normal(tuple(attrs["shape"]))
    return (attrs.get("mean", 0.0) + z * attrs.get("std", 1.0)).to(
        torch_dtype(attrs.get("dtype", "float32")))


@simple("dropout", outputs=("Out", "Mask"), stateful_rng=True)
def _dropout(ctx, attrs, x):
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("is_test", False) or not ctx.train:
        return x, torch.ones_like(x)
    u = ctx.uniform(tuple(x.shape))
    mask = (u < 1.0 - p).to(x.dtype)
    return x * mask / (1.0 - p), mask


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _flat_label(label):
    flat = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
    return flat.long()[..., None]


@simple("cross_entropy", inputs=("X", "Label"), differentiable=("X",))
def _cross_entropy(ctx, attrs, x, label):
    eps = 1e-8
    if attrs.get("soft_label", False):
        return -torch.sum(label * torch.log(x + eps), dim=-1, keepdim=True)
    return -torch.log(torch.gather(x, -1, _flat_label(label)) + eps)


@register_op("softmax_with_cross_entropy", inputs=("Logits", "Label"),
             outputs=("Softmax", "Loss"), differentiable=("Logits",))
def _softmax_ce(ctx, attrs, ins):
    logits, label = ins["Logits"][0], ins["Label"][0]
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        loss = -torch.gather(logp, -1, _flat_label(label))
    return {"Softmax": [torch.exp(logp)], "Loss": [loss]}


@simple("square_error_cost", inputs=("X", "Y"))
def _square_error(ctx, attrs, x, y):
    return torch.square(x - y)


@simple("squared_l2_norm")
def _squared_l2_norm(ctx, attrs, x):
    return torch.sum(torch.square(x)).reshape(1)


@register_op("accuracy", inputs=("Out", "Indices", "Label"),
             outputs=("Accuracy", "Correct", "Total"), differentiable=())
def _accuracy(ctx, attrs, ins):
    idx, label = ins["Indices"][0], ins["Label"][0]
    flat = label.reshape(-1).to(idx.dtype)
    correct = torch.sum(torch.any(idx == flat[:, None], dim=1))
    total = flat.shape[0]
    return {"Accuracy": [correct.float() / total],
            "Correct": [correct.to(torch.int32)],
            "Total": [torch.full((), total, dtype=torch.int32,
                                 device=idx.device)]}


# ---------------------------------------------------------------------------
# NN ops: conv / pool / norm (NCHW, the fluid layout)
# ---------------------------------------------------------------------------

@simple("conv2d", inputs=("Input", "Filter"), outputs=("Output",))
def _conv2d(ctx, attrs, x, w):
    return F.conv2d(x, w, stride=tuple(attrs.get("strides", (1, 1))),
                    padding=tuple(attrs.get("paddings", (0, 0))),
                    dilation=tuple(attrs.get("dilations", (1, 1))),
                    groups=attrs.get("groups", 1))


@simple("pool2d", inputs=("X",))
def _pool2d(ctx, attrs, x):
    ksize = tuple(attrs["ksize"])
    strides = tuple(attrs.get("strides", ksize))
    pads = tuple(attrs.get("paddings", (0, 0)))
    if attrs.get("global_pooling", False):
        ksize, strides, pads = tuple(x.shape[2:]), (1, 1), (0, 0)
    if attrs.get("pooling_type", "max") == "max":
        return F.max_pool2d(x, ksize, strides, pads)
    # exclusive (the default) divides a padded window by its real cells
    return F.avg_pool2d(x, ksize, strides, pads,
                        count_include_pad=not attrs.get("exclusive", True))


@register_op("batch_norm",
             inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             outputs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"),
             differentiable=("X", "Scale", "Bias"))
def _batch_norm(ctx, attrs, ins):
    x, scale, bias = ins["X"][0], ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    axes = tuple(i for i in range(x.ndim) if i != 1)
    bshape = [1] * x.ndim
    bshape[1] = x.shape[1]
    if attrs.get("is_test", False) or not ctx.train:
        use_mean, use_var = mean, var
        new_mean, new_var = mean, var
    else:
        use_mean = torch.mean(x, dim=axes)
        use_var = torch.var(x, dim=axes, unbiased=False)
        new_mean = momentum * mean + (1 - momentum) * use_mean
        new_var = momentum * var + (1 - momentum) * use_var
    xhat = (x - use_mean.reshape(bshape)) / torch.sqrt(
        use_var.reshape(bshape) + eps)
    y = xhat * scale.reshape(bshape) + bias.reshape(bshape)
    return {"Y": [y], "MeanOut": [new_mean], "VarianceOut": [new_var],
            "SavedMean": [use_mean],
            "SavedVariance": [1.0 / torch.sqrt(use_var + eps)]}


# ---------------------------------------------------------------------------
# optimizer ops (the reference registers optimizers as ops too,
# ``operators/sgd_op.cc`` etc.)
# ---------------------------------------------------------------------------

@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), differentiable=())
def _sgd(ctx, attrs, ins):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    return {"ParamOut": [p - lr.reshape(()) * g]}


@register_op("momentum",
             inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"), differentiable=())
def _momentum(ctx, attrs, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    v, lr = ins["Velocity"][0], ins["LearningRate"][0].reshape(())
    mu = attrs.get("mu", 0.9)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


@register_op("adagrad", inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"), differentiable=())
def _adagrad(ctx, attrs, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, lr = ins["Moment"][0], ins["LearningRate"][0].reshape(())
    eps = attrs.get("epsilon", 1e-6)
    m_new = m + g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register_op("adam",
             inputs=("Param", "Grad", "Moment1", "Moment2", "LearningRate",
                     "Beta1Pow", "Beta2Pow"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"),
             differentiable=())
def _adam(ctx, attrs, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    lr = ins["LearningRate"][0].reshape(())
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    p_new = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {"ParamOut": [p_new], "Moment1Out": [m1n], "Moment2Out": [m2n],
            "Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}


@register_op("adamax",
             inputs=("Param", "Grad", "Moment", "InfNorm", "LearningRate",
                     "Beta1Pow"),
             outputs=("ParamOut", "MomentOut", "InfNormOut", "Beta1PowOut"),
             differentiable=())
def _adamax(ctx, attrs, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, u = ins["Moment"][0], ins["InfNorm"][0]
    lr = ins["LearningRate"][0].reshape(())
    b1p = ins["Beta1Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    u_new = torch.maximum(b2 * u, torch.abs(g))
    p_new = p - (lr / (1 - b1p.reshape(()))) * m_new / (u_new + eps)
    return {"ParamOut": [p_new], "MomentOut": [m_new], "InfNormOut": [u_new],
            "Beta1PowOut": [b1p * b1]}


@register_op("adadelta",
             inputs=("Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"),
             outputs=("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"),
             differentiable=())
def _adadelta(ctx, attrs, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    ag, au = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    ag_new = rho * ag + (1 - rho) * g * g
    update = -torch.sqrt((au + eps) / (ag_new + eps)) * g
    au_new = rho * au + (1 - rho) * update * update
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [ag_new],
            "AvgSquaredUpdateOut": [au_new]}


@register_op("decayed_adagrad",
             inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"), differentiable=())
def _decayed_adagrad(ctx, attrs, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, lr = ins["Moment"][0], ins["LearningRate"][0].reshape(())
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register_op("rmsprop",
             inputs=("Param", "Grad", "MeanSquare", "Moment",
                     "LearningRate"),
             outputs=("ParamOut", "MeanSquareOut", "MomentOut"),
             differentiable=())
def _rmsprop(ctx, attrs, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0].reshape(())
    eps = attrs.get("epsilon", 1e-10)
    decay = attrs.get("decay", 0.9)
    mu = attrs.get("momentum", 0.0)
    ms_new = decay * ms + (1 - decay) * g * g
    mom_new = mu * mom + lr * g / torch.sqrt(ms_new + eps)
    return {"ParamOut": [p - mom_new], "MeanSquareOut": [ms_new],
            "MomentOut": [mom_new]}


@register_op("ftrl",
             inputs=("Param", "Grad", "SquaredAccumulator",
                     "LinearAccumulator", "LearningRate"),
             outputs=("ParamOut", "SquaredAccumOut", "LinearAccumOut"),
             differentiable=())
def _ftrl(ctx, attrs, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    lr = ins["LearningRate"][0].reshape(())
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    sq_new = sq + g * g
    sigma = (torch.pow(sq_new, -power) - torch.pow(sq, -power)) / lr
    lin_new = lin + g - sigma * p
    pre = torch.where(torch.abs(lin_new) > l1,
                      l1 * torch.sign(lin_new) - lin_new,
                      torch.zeros_like(lin_new))
    denom = torch.pow(sq_new, -power) / lr + 2 * l2
    return {"ParamOut": [pre / denom], "SquaredAccumOut": [sq_new],
            "LinearAccumOut": [lin_new]}


# ---------------------------------------------------------------------------
# RNN ops (reference: operators/lstm_op.cc, gru_op.cc): an eager loop over
# T on padded [B, T, ...] inputs, a [B, T] mask carrying the state through
# padded steps unchanged
# ---------------------------------------------------------------------------

def _lstm_cell(gates, c_prev):
    i, f, c_t, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c = f * c_prev + i * torch.tanh(c_t)
    return c, o * torch.tanh(c)


def _gru_gates(g, h_prev, w):
    """The GRU gate math (reference gru layout: [:, :2H] update/reset,
    [:, 2H:] candidate; h = (1 - u) h_prev + u c, gru_kernel.h):
    (ur, candidate, reset hidden prev, h_new)."""
    h = h_prev.shape[-1]
    ur = torch.sigmoid(g[:, :2 * h] + h_prev @ w[:, :2 * h])
    u, r = ur[:, :h], ur[:, h:]
    c = torch.tanh(g[:, 2 * h:] + (r * h_prev) @ w[:, 2 * h:])
    return ur, c, r * h_prev, (1.0 - u) * h_prev + u * c


def _steps(x, mask, reverse):
    """(time order, the per-step mask [B, 1] list)."""
    b, t = x.shape[0], x.shape[1]
    if mask is None:
        mask = torch.ones((b, t), dtype=x.dtype, device=x.device)
    order = range(t - 1, -1, -1) if reverse else range(t)
    return list(order), [mask[:, s, None] for s in range(t)]


@register_op("lstm", inputs=("Input", "Weight", "Bias", "C0", "H0", "Mask"),
             outputs=("Hidden", "Cell"))
def _lstm(ctx, attrs, ins):
    """dynamic LSTM over padded [B, T, 4H] gate projections with recurrent
    weight [H, 4H] (reference: lstm_op.cc)."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    b, t, four_h = x.shape
    h_dim = four_h // 4
    zeros = torch.zeros((b, h_dim), dtype=x.dtype, device=x.device)
    c = ins["C0"][0] if ins.get("C0") else zeros
    h = ins["H0"][0] if ins.get("H0") else zeros
    order, ms = _steps(x, ins["Mask"][0] if ins.get("Mask") else None,
                       attrs.get("is_reverse", False))
    hs, cs = [None] * t, [None] * t
    for s in order:
        gates = x[:, s] + h @ w
        if bias is not None:
            gates = gates + bias
        c_new, h_new = _lstm_cell(gates, c)
        c = ms[s] * c_new + (1 - ms[s]) * c
        h = ms[s] * h_new + (1 - ms[s]) * h
        hs[s], cs[s] = h, c
    return {"Hidden": [torch.stack(hs, 1)], "Cell": [torch.stack(cs, 1)]}


@register_op("gru", inputs=("Input", "Weight", "Bias", "H0", "Mask"),
             outputs=("Hidden",))
def _gru(ctx, attrs, ins):
    """dynamic GRU over padded [B, T, 3H] gate projections (reference:
    gru_op.cc)."""
    x = ins["Input"][0]
    w = ins["Weight"][0]                      # [H, 3H]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    b, t, three_h = x.shape
    h = (ins["H0"][0] if ins.get("H0")
         else torch.zeros((b, three_h // 3), dtype=x.dtype, device=x.device))
    order, ms = _steps(x, ins["Mask"][0] if ins.get("Mask") else None,
                       attrs.get("is_reverse", False))
    hs = [None] * t
    for s in order:
        g = x[:, s] + bias if bias is not None else x[:, s]
        h = ms[s] * _gru_gates(g, h, w)[3] + (1 - ms[s]) * h
        hs[s] = h
    return {"Hidden": [torch.stack(hs, 1)]}


# ---------------------------------------------------------------------------
# CRF ops (reference: linear_chain_crf_op.cc, crf_decoding_op.cc): the
# v2 layers' dynamic programs, layers/crf_ctc.py
# ---------------------------------------------------------------------------

def _crf_mask(ins, x):
    b, t = x.shape[0], x.shape[1]
    if ins.get("Length"):
        lens = ins["Length"][0].reshape(b)
    else:
        lens = torch.full((b,), t, device=x.device)
    pos = torch.arange(t, device=x.device)
    return (pos[None, :] < lens[:, None]).to(torch.float32)


@register_op("linear_chain_crf",
             inputs=("Emission", "Transition", "Label", "Length"),
             outputs=("LogLikelihood",), differentiable=("Emission",
                                                         "Transition"))
def _linear_chain_crf(ctx, attrs, ins):
    from paddle_tpu_torch.layers.crf_ctc import crf_nll
    x = ins["Emission"][0]
    w = ins["Transition"][0]                   # [(C+2), C] reference layout
    y = ins["Label"][0].long()
    if y.ndim == 3 and y.shape[-1] == 1:
        y = y[..., 0]
    nll = crf_nll(x, y, _crf_mask(ins, x), w[0], w[1], w[2:])
    return {"LogLikelihood": [(-nll).reshape(x.shape[0], 1)]}


@register_op("crf_decoding",
             inputs=("Emission", "Transition", "Label", "Length"),
             outputs=("ViterbiPath",), differentiable=())
def _crf_decoding(ctx, attrs, ins):
    from paddle_tpu_torch.core.registry import get_layer_def
    x = ins["Emission"][0]
    layer_inputs = [x] + ([ins["Label"][0]] if ins.get("Label") else [])
    lctx = types.SimpleNamespace(params_tree={}, train=False,
                                 compute_dtype=None)
    out = get_layer_def("crf_decoding").apply_seq(
        {}, {"w": ins["Transition"][0]}, layer_inputs, [_crf_mask(ins, x)],
        lctx)
    return {"ViterbiPath": [out]}


# ---------------------------------------------------------------------------
# NCE (reference: nce_op.cc; one batch of negatives shared by every row,
# as the v2 NCECost layer)
# ---------------------------------------------------------------------------

def nce_negatives(ctx, num_neg: int, num_classes: int) -> torch.Tensor:
    """The op's negative class ids [num_neg], uniform over the classes,
    from the op's random stream (the same draw in the op and its grad
    op).  A test may replace this function to feed another package's
    draws."""
    return ctx.randint(num_classes, (num_neg,))


@register_op("nce", inputs=("Input", "Label", "Weight", "Bias"),
             outputs=("Cost",), differentiable=("Input", "Weight", "Bias"),
             stateful_rng=True)
def _nce(ctx, attrs, ins):
    x = ins["Input"][0]
    label = ins["Label"][0].long().reshape(-1)
    w = ins["Weight"][0]                        # [C, D]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    num_neg = attrs.get("num_neg_samples", 10)
    c = w.shape[0]
    neg = nce_negatives(ctx, num_neg, c).long()
    pos_logit = torch.sum(x * w[label], dim=-1)
    neg_logit = x @ w[neg].t()                  # [B, S]
    if bias is not None:
        pos_logit = pos_logit + bias[label]
        neg_logit = neg_logit + bias[neg]
    # NCE logistic loss with uniform noise P(w) = 1/C: subtract log(k/C)
    log_kq = float(np.log(np.float32(num_neg / c)))
    pos_loss = -F.logsigmoid(pos_logit - log_kq)
    neg_loss = -torch.sum(F.logsigmoid(-(neg_logit - log_kq)), dim=-1)
    return {"Cost": [(pos_loss + neg_loss).reshape(-1, 1)]}


# ---------------------------------------------------------------------------
# beam search ops (reference: beam_search_op.cc, beam_search_decode_op.cc;
# ragged LoD beams become fixed [B, K] tensors with parent pointers)
# ---------------------------------------------------------------------------

@register_op("beam_search",
             inputs=("pre_ids", "pre_scores", "scores"),
             outputs=("selected_ids", "selected_scores", "parent_idx"),
             differentiable=())
def _beam_search(ctx, attrs, ins):
    """one expansion: probs [B, K, V] + running scores [B, K] -> top-K of
    the K*V joint candidates.  Finished rows (pre_id == end_id) keep
    exactly one continuation (end_id, same score)."""
    end_id = attrs.get("end_id", 1)
    pre_ids = ins["pre_ids"][0].long()                       # [B, K]
    pre_scores = ins["pre_scores"][0]                        # [B, K]
    probs = ins["scores"][0]                                 # [B, K, V]
    b, k, v = probs.shape
    logp = torch.log(torch.clamp(probs, min=1e-12))
    finished = pre_ids == end_id
    cont = pre_scores[:, :, None] + logp
    eos_only = torch.full((b, k, v), -1e9, dtype=cont.dtype,
                          device=cont.device)
    eos_only[:, :, end_id] = pre_scores
    cand = torch.where(finished[:, :, None], eos_only, cont)
    top_sc, top_ix = _top(cand.reshape(b, k * v), k)
    return {"selected_ids": [(top_ix % v).to(torch.int32)],
            "selected_scores": [top_sc],
            "parent_idx": [torch.div(top_ix, v, rounding_mode="floor")
                           .to(torch.int32)]}


@register_op("beam_search_decode",
             inputs=("Ids", "Parents", "Scores"),
             outputs=("SentenceIds", "SentenceScores"), differentiable=())
def _beam_search_decode(ctx, attrs, ins):
    """backtrack stacked per-step ids / parents [T, B, K] into sequences
    [B, K, T] and final scores [B, K]."""
    ids = ins["Ids"][0].long()                   # [T, B, K]
    parents = ins["Parents"][0].long()
    scores = ins["Scores"][0]                    # [T, B, K]
    t, b, k = ids.shape
    cur = torch.arange(k, device=ids.device)[None, :].expand(b, k)
    toks = [None] * t
    for s in range(t - 1, -1, -1):
        toks[s] = torch.gather(ids[s], 1, cur)
        cur = torch.gather(parents[s], 1, cur)
    return {"SentenceIds": [torch.stack(toks, 2).to(torch.int32)],
            "SentenceScores": [scores[-1]]}


# ---------------------------------------------------------------------------
# gather / scatter / pad / one_hot / multiplex / where
# ---------------------------------------------------------------------------

@simple("gather", inputs=("X", "Index"), differentiable=("X",))
def _gather(ctx, attrs, x, index):
    return x[index.long()]


@simple("scatter", inputs=("X", "Ids", "Updates"),
        differentiable=("X", "Updates"))
def _scatter(ctx, attrs, x, ids, updates):
    return x.index_put((ids.long(),), updates)


@simple("pad")
def _pad(ctx, attrs, x):
    p = attrs["paddings"]
    flat = []
    for i in reversed(range(x.ndim)):
        flat += [p[2 * i], p[2 * i + 1]]
    return F.pad(x, flat, value=attrs.get("pad_value", 0.0))


@simple("one_hot", differentiable=())
def _one_hot(ctx, attrs, x):
    depth = attrs["depth"]
    flat = x.reshape(x.shape[:-1]) if x.shape and x.shape[-1] == 1 else x
    # a compare, not F.one_hot: that one reads the ids' range back to
    # the host; an id out of range gives a zero row, as jax.nn.one_hot
    classes = torch.arange(depth, device=x.device)
    return (flat.long()[..., None] == classes).to(torch.float32)


@simple("multiplex", inputs=("Ids", "X"), list_slots=("X",),
        differentiable=("X",))
def _multiplex(ctx, attrs, ids, xs):
    stacked = torch.stack(xs, dim=0)                     # [n, batch, d]
    sel = ids.reshape(-1).long()
    return stacked[sel, torch.arange(stacked.shape[1], device=sel.device)]


@simple("where", inputs=("Cond", "X", "Y"), differentiable=("X", "Y"))
def _where(ctx, attrs, cond, x, y):
    """elementwise select (the row-split semantics of split /
    merge_lod_tensor); the unselected side's NaN does not leak."""
    return torch.where(cond.to(torch.bool), x, y)


# Out = X - Y (reference: minus_op.cc), elementwise_sub's function under
# the reference's historical name
_register_elementwise("minus", torch.sub)


# ---------------------------------------------------------------------------
# comparison / logical (for control flow)
# ---------------------------------------------------------------------------

def _register_compare(name, fn):
    @simple(name, inputs=("X", "Y"), differentiable=())
    def _impl(ctx, attrs, x, y, _fn=fn):
        return _fn(x, y)


for _n, _f in [("less_than", torch.lt), ("less_equal", torch.le),
               ("greater_than", torch.gt), ("greater_equal", torch.ge),
               ("equal", torch.eq), ("not_equal", torch.ne),
               ("logical_and", torch.logical_and),
               ("logical_or", torch.logical_or),
               ("logical_xor", torch.logical_xor)]:
    _register_compare(_n, _f)


@simple("logical_not", differentiable=())
def _logical_not(ctx, attrs, x):
    return torch.logical_not(x)


@simple("sequence_mask", differentiable=())
def _sequence_mask(ctx, attrs, x):
    """lens [B] -> [B, maxlen] validity mask (fluid sequence_mask)."""
    pos = torch.arange(attrs["maxlen"], device=x.device)
    return (pos[None, :] < x.reshape(-1, 1).to(torch.int32)).to(
        torch_dtype(attrs.get("dtype", "float32")))


# ---------------------------------------------------------------------------
# losses and distances (reference: operators/*_loss_op.cc, cos_sim_op.cc,
# squared_l2_distance_op.cc, label_smooth_op.cc)
# ---------------------------------------------------------------------------

@simple("sigmoid_cross_entropy_with_logits", inputs=("X", "Label"),
        differentiable=("X",))
def _sigmoid_ce(ctx, attrs, x, label):
    return (torch.clamp(x, min=0) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))


@simple("smooth_l1", inputs=("X", "Y"), differentiable=("X",))
def _smooth_l1(ctx, attrs, x, y):
    sigma2 = attrs.get("sigma", 1.0) ** 2
    d = x - y
    a = torch.abs(d)
    loss = torch.where(a < 1.0 / sigma2, 0.5 * sigma2 * d * d,
                       a - 0.5 / sigma2)
    return torch.sum(loss, dim=-1, keepdim=True)


@simple("log_loss", inputs=("Predicted", "Labels"), outputs=("Loss",),
        differentiable=("Predicted",))
def _log_loss(ctx, attrs, p, y):
    eps = attrs.get("epsilon", 1e-4)
    return -y * torch.log(p + eps) - (1.0 - y) * torch.log(1.0 - p + eps)


@simple("hinge_loss", inputs=("Logits", "Labels"), outputs=("Loss",),
        differentiable=("Logits",))
def _hinge_loss(ctx, attrs, x, y):
    return torch.clamp(1.0 - (2.0 * y - 1.0) * x, min=0.0)


@simple("huber_loss", inputs=("X", "Y"), outputs=("Out",),
        differentiable=("X",))
def _huber_loss(ctx, attrs, x, y):
    delta = attrs.get("delta", 1.0)
    d = y - x
    a = torch.abs(d)
    return torch.where(a <= delta, 0.5 * d * d, delta * (a - 0.5 * delta))


@simple("squared_l2_distance", inputs=("X", "Y"))
def _squared_l2_distance(ctx, attrs, x, y):
    return torch.sum(torch.square(x - y), dim=-1, keepdim=True)


@simple("l1_norm")
def _l1_norm(ctx, attrs, x):
    return torch.sum(torch.abs(x)).reshape(1)


@simple("cos_sim", inputs=("X", "Y"))
def _cos_sim(ctx, attrs, x, y):
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    return torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn + 1e-12)


@simple("rank_loss", inputs=("Label", "Left", "Right"))
def _rank_loss(ctx, attrs, label, left, right):
    o = left - right
    return (torch.log1p(torch.exp(-torch.abs(o))) + torch.clamp(o, min=0.0)
            - label.to(o.dtype) * o)


@simple("margin_rank_loss", inputs=("Label", "X1", "X2"),
        outputs=("Out", "Activated"))
def _margin_rank_loss(ctx, attrs, label, x1, x2):
    raw = attrs.get("margin", 0.0) - label.to(x1.dtype) * (x1 - x2)
    return torch.clamp(raw, min=0.0), (raw > 0).to(x1.dtype)


@simple("modified_huber_loss", inputs=("X", "Y"),
        outputs=("Out", "IntermediateVal"))
def _modified_huber_loss(ctx, attrs, x, y):
    # y in {0, 1} -> {-1, 1}; z = pred * y, the margin
    z = x * (2.0 * y.to(x.dtype) - 1.0)
    out = torch.where(z < -1.0, -4.0 * z,
                      torch.square(torch.clamp(1.0 - z, min=0.0)))
    return out, z


@simple("label_smooth", inputs=("X", "PriorDist"))
def _label_smooth(ctx, attrs, x, prior):
    eps = attrs.get("epsilon", 0.1)
    if prior is not None:
        return (1.0 - eps) * x + eps * prior
    return (1.0 - eps) * x + eps / x.shape[-1]


# ---------------------------------------------------------------------------
# layers: norms, bilinear, prelu, the transposed conv, conv_shift /
# row_conv, lrn (reference: the matching operators/*_op.cc)
# ---------------------------------------------------------------------------

@register_op("layer_norm", inputs=("X", "Scale", "Bias"),
             outputs=("Y", "Mean", "Variance"),
             differentiable=("X", "Scale", "Bias"))
def _layer_norm(ctx, attrs, ins):
    x = ins["X"][0]
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(begin, x.ndim))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, unbiased=False, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    shape = [1] * begin + list(x.shape[begin:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(shape)
    return {"Y": [y], "Mean": [mean.reshape(-1)],
            "Variance": [var.reshape(-1)]}


@simple("lrn", inputs=("X",), outputs=("Out",))
def _lrn(ctx, attrs, x):
    n = attrs.get("n", 5)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    k = attrs.get("k", 1.0)
    half = n // 2
    pad = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    acc = pad[:, 0:x.shape[1]]
    for i in range(1, n):
        acc = acc + pad[:, i:i + x.shape[1]]
    return x / torch.pow(k + alpha * acc, beta)


@simple("bilinear_tensor_product", inputs=("X", "Y", "Weight", "Bias"))
def _bilinear_tensor_product(ctx, attrs, x, y, w, bias):
    # out[b, k] = x[b] @ w[k] @ y[b] (reference
    # bilinear_tensor_product_op.h)
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    return out + bias if bias is not None else out


@simple("norm", inputs=("X",))
def _norm(ctx, attrs, x):
    axis = attrs.get("axis", 1)
    eps = attrs.get("epsilon", 1e-10)
    return x / torch.sqrt(torch.sum(torch.square(x), dim=axis,
                                    keepdim=True) + eps)


@simple("prelu", inputs=("X", "Alpha"))
def _prelu(ctx, attrs, x, alpha):
    return torch.where(x > 0, x, alpha * x)


@simple("conv2d_transpose", inputs=("Input", "Filter"), outputs=("Output",))
def _conv2d_transpose(ctx, attrs, x, w):
    """filter layout IOHW (reference conv2d_transpose_op.cc: [in, out, h,
    w]); out size (H - 1) * stride - 2 * pad + k."""
    return F.conv_transpose2d(x, w,
                              stride=tuple(attrs.get("strides", (1, 1))),
                              padding=tuple(attrs.get("paddings", (0, 0))))


@simple("row_conv", inputs=("X", "Filter"))
def _row_conv(ctx, attrs, x, filt):
    """future-context (lookahead) conv over time (reference:
    row_conv_op.cc): out[b, t] = sum_j filt[j] * x[b, t + j]."""
    k, t = filt.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, 0, k - 1))
    out = pad[:, 0:t, :] * filt[0]
    for j in range(1, k):
        out = out + pad[:, j:j + t, :] * filt[j]
    return out


@simple("conv_shift", inputs=("X", "Y"))
def _conv_shift(ctx, attrs, x, y):
    """circular correlation (reference: conv_shift_op.cc), the NTM
    attention shift.  x [B, D], y [B, K] (K odd, K <= D)."""
    d, k = x.shape[1], y.shape[1]
    half = k // 2
    dev = x.device
    idx = torch.remainder(torch.arange(d, device=dev)[:, None]
                          + torch.arange(-half, half + 1, device=dev)[None],
                          d)
    return torch.einsum("bdk,bk->bd", x[:, idx], y)


@simple("is_empty", differentiable=())
def _is_empty(ctx, attrs, x):
    return torch.full((), x.numel() == 0, dtype=torch.bool, device=x.device)


@simple("print", differentiable=("X",), host_sync=True)
def _print(ctx, attrs, x):
    """pass-through debug print (reference: print_op.cc): the first
    ``summarize`` values, read back to the host as the op runs."""
    msg = attrs.get("message", "")
    n = attrs.get("summarize", 20)
    print(msg, x.detach().reshape(-1)[:n].cpu().tolist(), flush=True)
    return x


# ---------------------------------------------------------------------------
# RNN units (reference: lstm_unit_op.cc, gru_unit_op.cc, lstmp_op.cc)
# ---------------------------------------------------------------------------

@simple("lstm_unit", inputs=("X", "C_prev"), outputs=("C", "H"))
def _lstm_unit(ctx, attrs, x, c_prev):
    """one LSTM step on pre-projected gates X [B, 4H] (gate order i, f,
    c, o; forget_bias added to the f slice)."""
    fb = attrs.get("forget_bias", 0.0)
    if fb:
        h = x.shape[-1] // 4
        shift = torch.zeros((4 * h,), dtype=x.dtype, device=x.device)
        shift[h:2 * h] = fb
        x = x + shift
    return _lstm_cell(x, c_prev)


@simple("gru_unit", inputs=("Input", "HiddenPrev", "Weight", "Bias"),
        outputs=("Gate", "ResetHiddenPrev", "Hidden"))
def _gru_unit(ctx, attrs, x, h_prev, weight, bias):
    """one GRU step: x [B, 3H] input projection, weight [H, 3H]
    recurrent."""
    if bias is not None:
        x = x + bias
    ur, c, rhp, h_new = _gru_gates(x, h_prev, weight)
    return torch.cat([ur, c], dim=-1), rhp, h_new


@register_op("lstmp",
             inputs=("Input", "Weight", "ProjWeight", "Bias", "C0", "H0",
                     "Mask"),
             outputs=("Projection", "Cell"))
def _lstmp(ctx, attrs, ins):
    """LSTM with a recurrent projection r = h Wp (reference: lstmp_op.cc;
    the recurrent weight [P, 4H] acts on the projected state)."""
    x = ins["Input"][0]
    w = ins["Weight"][0]                       # [P, 4H]
    wp = ins["ProjWeight"][0]                  # [H, P]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    b, t, four_h = x.shape
    dev = x.device
    c = (ins["C0"][0] if ins.get("C0")
         else torch.zeros((b, four_h // 4), dtype=x.dtype, device=dev))
    r = (ins["H0"][0] if ins.get("H0")
         else torch.zeros((b, wp.shape[1]), dtype=x.dtype, device=dev))
    order, ms = _steps(x, ins["Mask"][0] if ins.get("Mask") else None,
                       False)
    rs, cs = [], []
    for s in order:
        gates = x[:, s] + r @ w
        if bias is not None:
            gates = gates + bias
        c_new, h = _lstm_cell(gates, c)
        c = ms[s] * c_new + (1 - ms[s]) * c
        r = ms[s] * (h @ wp) + (1 - ms[s]) * r
        rs.append(r)
        cs.append(c)
    return {"Projection": [torch.stack(rs, 1)], "Cell": [torch.stack(cs, 1)]}


# ---------------------------------------------------------------------------
# optimizer ops: the proximal family (reference: proximal_gd_op.cc,
# proximal_adagrad_op.cc)
# ---------------------------------------------------------------------------

def _proximal(prox, lr, l1, l2):
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                           min=0.0) / (1.0 + lr * l2))


@register_op("proximal_gd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), differentiable=())
def _proximal_gd(ctx, attrs, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    return {"ParamOut": [_proximal(p - lr * g, lr, attrs.get("l1", 0.0),
                                   attrs.get("l2", 0.0))]}


@register_op("proximal_adagrad",
             inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"), differentiable=())
def _proximal_adagrad(ctx, attrs, ins):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0].reshape(())
    m_new = m + g * g
    alr = lr / torch.sqrt(m_new)
    return {"ParamOut": [_proximal(p - alr * g, alr, attrs.get("l1", 0.0),
                                   attrs.get("l2", 0.0))],
            "MomentOut": [m_new]}


# ---------------------------------------------------------------------------
# sequence and LoD ops on padded batches (reference: sequence_*_op.cc,
# lod_*_op.cc; the LoD becomes length tensors and masks)
# ---------------------------------------------------------------------------

def _lens(v, b, t, dev):
    return (v.reshape(b) if v is not None
            else torch.full((b,), t, dtype=torch.int32, device=dev))


def _take_time(x, idx):
    """x [B, T, ...] gathered along time at idx [B, T']."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx.long()]


def _bcast_rows(m, x):
    """a [B, T] mask shaped to broadcast over x [B, T, ...]."""
    return m.reshape(m.shape + (1,) * (x.ndim - 2))


def _left_compact(x, keep):
    """the kept tokens of x [B, T] moved left in order, zeros after them,
    and their counts (int32)."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    key = torch.where(keep, pos, torch.full_like(pos, t + 1))
    order = torch.sort(key, dim=1, stable=True)[1]
    out = torch.gather(x, 1, order)
    new_len = torch.sum(keep, dim=1).to(torch.int32)
    out = torch.where(pos < new_len[:, None], out, torch.zeros_like(out))
    return out, new_len


@simple("sequence_concat", inputs=("X", "Y", "XLen", "YLen"),
        outputs=("Out", "OutLen"), differentiable=("X", "Y"))
def _sequence_concat(ctx, attrs, x, y, xlen, ylen):
    """concat per sample along time honouring the lengths (reference:
    sequence_concat_op.cc)."""
    b, tx, ty = x.shape[0], x.shape[1], y.shape[1]
    dev = x.device
    xlen, ylen = _lens(xlen, b, tx, dev), _lens(ylen, b, ty, dev)
    pos = torch.arange(tx + ty, device=dev)[None, :]
    from_x = pos < xlen[:, None]
    from_y = (pos >= xlen[:, None]) & (pos < (xlen + ylen)[:, None])
    x_g = _take_time(x, torch.clamp(pos, 0, tx - 1).expand(b, tx + ty))
    y_g = _take_time(y, torch.clamp(pos - xlen[:, None], 0, ty - 1))
    out = torch.where(_bcast_rows(from_x, x), x_g,
                      torch.where(_bcast_rows(from_y, x), y_g,
                                  torch.zeros_like(y_g)))
    return out, xlen + ylen


@simple("sequence_erase", inputs=("X", "XLen"), outputs=("Out", "OutLen"),
        differentiable=())
def _sequence_erase(ctx, attrs, x, xlen):
    """remove the tokens of attrs['tokens'] and left-compact (reference:
    sequence_erase_op.cc).  x [B, T] ids."""
    b, t = x.shape
    xlen = _lens(xlen, b, t, x.device)
    keep = torch.arange(t, device=x.device)[None, :] < xlen[:, None]
    for tok in attrs.get("tokens", []):
        keep = keep & (x != tok)
    return _left_compact(x, keep)


@simple("sequence_slice", inputs=("X", "Offset", "Length"))
def _sequence_slice(ctx, attrs, x, offset, length):
    """the per-sample window [offset, offset + length), left-aligned
    (reference: sequence_slice_op.cc); T stays the static length."""
    b, t = x.shape[0], x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    src = torch.clamp(pos + offset.reshape(b, 1).to(torch.int32), 0, t - 1)
    out = _take_time(x, src)
    keep = pos < length.reshape(b, 1).to(torch.int32)
    return torch.where(_bcast_rows(keep, x), out, torch.zeros_like(out))


@simple("sequence_reshape", inputs=("X",))
def _sequence_reshape(ctx, attrs, x):
    """re-chunk the time axis into new_dim-wide rows (reference:
    sequence_reshape_op.cc)."""
    new_dim = attrs["new_dim"]
    b, t, d = x.shape
    return x.reshape(b, t * d // new_dim, new_dim)


@simple("sequence_conv", inputs=("X", "Filter"))
def _sequence_conv(ctx, attrs, x, filt):
    """context-window projection over time (reference:
    sequence_conv_op.cc, math/context_project.h): a k-step window around
    each position, one GEMM with the filter [k * D, M]."""
    k = attrs.get("context_length", 3)
    start = attrs.get("context_start", -(k // 2))
    t = x.shape[1]
    cols = []
    for j in range(k):
        shift = start + j
        pos = torch.arange(t, device=x.device) + shift
        ok = ((pos >= 0) & (pos < t)).to(x.dtype)[None, :, None]
        cols.append(torch.roll(x, -shift, dims=1) * ok)
    return torch.cat(cols, dim=-1) @ filt


@simple("lod_reset", inputs=("X", "Y"), differentiable=("X",))
def _lod_reset(ctx, attrs, x, y):
    """the identity on padded batches (reference: lod_reset_op.cc
    rewrites LoD metadata, which padded batching keeps in length
    tensors)."""
    return x


@simple("lod_rank_table", differentiable=())
def _lod_rank_table(ctx, attrs, lens):
    """the sequences' indices by length, longest first (reference:
    lod_rank_table_op.cc)."""
    return torch.sort(-lens.reshape(-1).to(torch.int32), stable=True)[1] \
        .to(torch.int32)


@simple("shrink_rnn_memory", inputs=("X", "Lens", "I"),
        differentiable=("X",))
def _shrink_rnn_memory(ctx, attrs, x, lens, i):
    """zero the rows past k = #sequences longer than step I (reference:
    shrink_rnn_memory_op.cc shrinks the length-sorted batch to its first
    k rows; the static shape keeps [B, ...])."""
    step = i.reshape(()).to(torch.int32)
    active = torch.sum(lens.reshape(-1).to(torch.int32) > step)
    mask = (torch.arange(x.shape[0], device=x.device) < active).to(x.dtype)
    return x * mask.reshape((-1,) + (1,) * (x.ndim - 1))


@simple("lod_tensor_to_array", inputs=("X",))
def _lod_tensor_to_array(ctx, attrs, x):
    """batch-major [B, T, ...] -> the step array [T, B, ...] (reference:
    lod_tensor_to_array_op.cc)."""
    return x.transpose(0, 1)


@simple("array_to_lod_tensor", inputs=("X",))
def _array_to_lod_tensor(ctx, attrs, x):
    return x.transpose(0, 1)


@simple("im2sequence", inputs=("X",))
def _im2sequence(ctx, attrs, x):
    """NCHW image -> patch rows [B, oh * ow, C * kh * kw] (reference:
    im2sequence_op.cc)."""
    kh, kw = attrs["kernels"]
    sh, sw = attrs.get("strides", [1, 1])
    pads = list(attrs.get("paddings", [0, 0]))
    if len(pads) == 2:                  # symmetric (up = down, left = right)
        pads = [pads[0], pads[1], pads[0], pads[1]]
    up, left, down, right = pads        # the reference's 4-element layout
    b, c, h, w = x.shape
    xp = F.pad(x, (left, right, up, down))
    oh = (h + up + down - kh) // sh + 1
    ow = (w + left + right - kw) // sw + 1
    st = torch.stack([xp[:, :, i:i + oh * sh:sh, j:j + ow * sw:sw]
                      for i in range(kh) for j in range(kw)])
    return st.permute(1, 3, 4, 2, 0).reshape(b, oh * ow, c * kh * kw)


# ---------------------------------------------------------------------------
# pooling variants (reference: spp_op.cc, pool_with_index_op.cc,
# unpool_op.cc, roi_pool_op.cc)
# ---------------------------------------------------------------------------

@simple("spp", inputs=("X",))
def _spp(ctx, attrs, x):
    """spatial pyramid pooling, NCHW: levels of n x n bins concatenated
    into [B, C * sum(n^2)], ceil-split bins, channel-major."""
    levels = attrs.get("pyramid_height", 3)
    mx = attrs.get("pooling_type", "max") == "max"
    b, c, h, w = x.shape
    feats = []
    for lv in range(levels):
        n = 2 ** lv
        ys = [-(-i * h // n) for i in range(n + 1)]
        xs = [-(-i * w // n) for i in range(n + 1)]
        cells = []
        for yi in range(n):
            for xi in range(n):
                cell = x[:, :, ys[yi]:max(ys[yi + 1], ys[yi] + 1),
                         xs[xi]:max(xs[xi + 1], xs[xi] + 1)]
                cells.append(torch.amax(cell, dim=(2, 3)) if mx
                             else torch.mean(cell, dim=(2, 3)))
        feats.append(torch.stack(cells, dim=-1).reshape(b, c * n * n))
    return torch.cat(feats, dim=1)


@register_op("max_pool2d_with_index", inputs=("X",),
             outputs=("Out", "Mask"))
def _max_pool2d_with_index(ctx, attrs, ins):
    """max pool emitting each maximum's flat input position (the Mask
    that unpool reads)."""
    x = ins["X"][0]
    kh, kw = attrs["ksize"]
    sh, sw = attrs.get("strides", attrs["ksize"])
    h, w = x.shape[2], x.shape[3]
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    wins = torch.stack([x[:, :, i:i + oh * sh:sh, j:j + ow * sw:sw]
                        for i in range(kh) for j in range(kw)], dim=-1)
    arg = torch.argmax(wins, dim=-1)
    dev = x.device
    rows = torch.arange(oh, device=dev)[None, None, :, None] * sh + arg // kw
    cols = torch.arange(ow, device=dev)[None, None, None, :] * sw + arg % kw
    return {"Out": [torch.amax(wins, dim=-1)],
            "Mask": [(rows * w + cols).to(torch.int32)]}


@simple("unpool", inputs=("X", "Indices"))
def _unpool(ctx, attrs, x, indices):
    """the pooled values scattered back to their maxima's positions
    (reference: unpool_op.cc; overlapping windows write one value)."""
    uh, uw = attrs["unpool_size"]
    b, c, oh, ow = x.shape
    flat = torch.zeros((b, c, uh * uw), dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, indices.reshape(b, c, oh * ow).long(),
                        x.reshape(b, c, oh * ow))
    return flat.reshape(b, c, uh, uw)


@simple("roi_pool", inputs=("X", "ROIs"), outputs=("Out", "Argmax"),
        differentiable=("X",))
def _roi_pool(ctx, attrs, x, rois):
    """ROI max pooling, NHWC (reference: roi_pool_op.cc).  rois [R, 5] =
    (batch index, x1, y1, x2, y2) in input coordinates.  Out [R, ph, pw,
    C]; Argmax the flat h * W + w index of each maximum, -1 in an empty
    bin (whose value is 0)."""
    ph, pw = attrs["pooled_height"], attrs["pooled_width"]
    scale = attrs.get("spatial_scale", 1.0)
    b, h, w, c = x.shape
    dev = x.device
    rois = rois.to(torch.float32)
    fmap = x[torch.clamp(rois[:, 0].to(torch.int32), 0, b - 1).long()]
    x1 = torch.clamp(torch.floor(rois[:, 1] * scale), 0, w - 1)
    y1 = torch.clamp(torch.floor(rois[:, 2] * scale), 0, h - 1)
    x2 = torch.clamp(torch.maximum(torch.ceil(rois[:, 3] * scale), x1 + 1),
                     max=w)
    y2 = torch.clamp(torch.maximum(torch.ceil(rois[:, 4] * scale), y1 + 1),
                     max=h)
    bin_w, bin_h = (x2 - x1) / pw, (y2 - y1) / ph
    by = torch.arange(ph, dtype=torch.float32, device=dev)
    bx = torch.arange(pw, dtype=torch.float32, device=dev)
    y_lo = y1[:, None] + by[None] * bin_h[:, None]
    y_hi = y1[:, None] + (by[None] + 1) * bin_h[:, None]
    x_lo = x1[:, None] + bx[None] * bin_w[:, None]
    x_hi = x1[:, None] + (bx[None] + 1) * bin_w[:, None]
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    my = ((ys >= torch.floor(y_lo)[..., None])
          & (ys < torch.ceil(y_hi)[..., None]))              # [R, ph, H]
    mxx = ((xs >= torch.floor(x_lo)[..., None])
           & (xs < torch.ceil(x_hi)[..., None]))             # [R, pw, W]
    m = my[:, :, None, :, None] & mxx[:, None, :, None, :]   # [R,ph,pw,H,W]
    sel = torch.where(m[..., None], fmap[:, None, None],
                      torch.full((), float("-inf"), dtype=x.dtype,
                                 device=dev))
    v = torch.amax(sel, dim=(3, 4))
    am = torch.argmax(sel.reshape(sel.shape[:3] + (h * w, c)), dim=3)
    fin = torch.isfinite(v)
    return (torch.where(fin, v, torch.zeros_like(v)),
            torch.where(fin, am, torch.full_like(am, -1)).to(torch.int32))


# ---------------------------------------------------------------------------
# CTC and edit distance (reference: warpctc_op.cc, ctc_align_op.cc,
# edit_distance_op.cc) on the v2 layers' CTC, layers/crf_ctc.py
# ---------------------------------------------------------------------------

@register_op("warpctc",
             inputs=("Logits", "Label", "LogitsLength", "LabelLength"),
             outputs=("Loss",), differentiable=("Logits",))
def _warpctc(ctx, attrs, ins):
    """CTC loss on padded [B, T, C] logits: the log-space recurrence of
    the v2 CTC layer (the reference loads warp-ctc)."""
    from paddle_tpu_torch.layers.crf_ctc import ctc_loss
    logits, label = ins["Logits"][0], ins["Label"][0]
    b, t, lt = logits.shape[0], logits.shape[1], label.shape[1]
    dev = logits.device
    tl = _lens(ins["LogitsLength"][0] if ins.get("LogitsLength") else None,
               b, t, dev)
    ll = _lens(ins["LabelLength"][0] if ins.get("LabelLength") else None,
               b, lt, dev)
    tmask = (torch.arange(t, device=dev)[None] < tl[:, None]).float()
    lmask = (torch.arange(lt, device=dev)[None] < ll[:, None]).float()
    loss = ctc_loss(logits, tmask, label.long(), lmask,
                    blank=attrs.get("blank", 0))
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp(tl.to(loss.dtype), min=1.0)
    return {"Loss": [loss.reshape(b, 1)]}


@simple("ctc_align", inputs=("Input", "InputLength"),
        outputs=("Output", "OutputLength"), differentiable=())
def _ctc_align(ctx, attrs, x, xlen):
    """merge repeats, then drop blanks, left-compacted (reference:
    ctc_align_op.cc).  x [B, T] path ids."""
    b, t = x.shape
    xlen = _lens(xlen, b, t, x.device)
    valid = torch.arange(t, device=x.device)[None, :] < xlen[:, None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=x.dtype,
                                 device=x.device), x[:, :-1]], dim=1)
    return _left_compact(x, valid & (x != attrs.get("blank", 0))
                         & (x != prev))


@register_op("edit_distance",
             inputs=("Hyps", "Refs", "HypsLength", "RefsLength"),
             outputs=("Out", "SequenceNum"), differentiable=())
def _edit_distance(ctx, attrs, ins):
    """batched Levenshtein distance: the dynamic-programming table's rows
    over the reference prefixes, one hypothesis token at a time, every
    row of the batch at once (reference: edit_distance_op.cc)."""
    hyp, ref = ins["Hyps"][0], ins["Refs"][0]
    b, th = hyp.shape
    tr = ref.shape[1]
    dev = hyp.device
    hl = _lens(ins["HypsLength"][0] if ins.get("HypsLength") else None,
               b, th, dev)
    rl = _lens(ins["RefsLength"][0] if ins.get("RefsLength") else None,
               b, tr, dev)
    row = torch.arange(tr + 1, dtype=torch.float32,
                       device=dev).expand(b, tr + 1)
    for i in range(th):
        sub = (ref != hyp[:, i:i + 1]).to(torch.float32)     # [B, Tr]
        vals = [row[:, 0] + 1.0]
        for j in range(tr):
            vals.append(torch.minimum(
                torch.minimum(row[:, j + 1] + 1.0, vals[-1] + 1.0),
                row[:, j] + sub[:, j]))
        row = torch.where((hl > i)[:, None], torch.stack(vals, 1), row)
    dist = torch.gather(row, 1, rl.reshape(b, 1).long())[:, 0]
    if attrs.get("normalized", False):
        dist = dist / torch.clamp(rl.to(dist.dtype), min=1.0)
    return {"Out": [dist.reshape(b, 1)],
            "SequenceNum": [torch.full((), float(b), device=dev)]}


# ---------------------------------------------------------------------------
# detection ops (reference: iou_similarity_op.cc, box_coder_op.cc,
# prior_box_op.cc, bipartite_match_op.cc, target_assign_op.cc,
# mine_hard_examples_op.cc, multiclass_nms_op.cc, detection_map_op.cc) on
# the port's box geometry, ops/boxes.py
# ---------------------------------------------------------------------------

@simple("iou_similarity", inputs=("X", "Y"), differentiable=())
def _iou_similarity(ctx, attrs, x, y):
    from paddle_tpu_torch.ops.boxes import iou_matrix
    return iou_matrix(x, y)


@simple("box_coder", inputs=("PriorBox", "PriorBoxVar", "TargetBox"),
        differentiable=("TargetBox",))
def _box_coder(ctx, attrs, prior, var, target):
    from paddle_tpu_torch.ops.boxes import decode_boxes, encode_boxes
    if var is None:
        var = torch.ones((4,), dtype=torch.float32, device=prior.device)
    if "decode" in attrs.get("code_type", "encode_center_size"):
        return decode_boxes(target, prior, var)
    return encode_boxes(target, prior, var)


@simple("prior_box", inputs=("Input", "Image"),
        outputs=("Boxes", "Variances"), differentiable=())
def _prior_box(ctx, attrs, feat, image):
    """SSD priors for one NHWC feature map (reference: prior_box_op.cc)."""
    fh, fw = feat.shape[1], feat.shape[2]
    ih, iw = image.shape[1], image.shape[2]
    mins = attrs["min_sizes"]
    maxs = attrs.get("max_sizes", [])
    sw = attrs.get("step_w", 0.0) or iw / fw
    sh = attrs.get("step_h", 0.0) or ih / fh
    offset = attrs.get("offset", 0.5)
    dev = feat.device
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) \
        * sw / iw
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) \
        * sh / ih
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")      # [fh, fw]
    whs = []
    for i, m in enumerate(mins):
        for ar in attrs.get("aspect_ratios", [1.0]):
            whs.append((m * (ar ** 0.5) / iw, m / (ar ** 0.5) / ih))
        if i < len(maxs):
            s = (m * maxs[i]) ** 0.5       # the reference pairs max[i], min[i]
            whs.append((s / iw, s / ih))
    out = torch.stack([torch.stack([cxg - w / 2, cyg - h / 2, cxg + w / 2,
                                    cyg + h / 2], dim=-1)
                       for w, h in whs], dim=2).reshape(-1, 4)
    if attrs.get("clip", True):
        out = torch.clamp(out, 0.0, 1.0)
    var = torch.stack([torch.full(out.shape[:1], float(v), device=dev)
                       for v in attrs.get("variances", [0.1, 0.1, 0.2,
                                                        0.2])], dim=1)
    return out, var


@simple("bipartite_match", inputs=("DistMat",),
        outputs=("ColToRowMatchIndices", "ColToRowMatchDist"),
        differentiable=())
def _bipartite_match(ctx, attrs, dist):
    """greedy bipartite matching on an [R, C] distance matrix (reference:
    bipartite_match_op.cc): min(R, C) rounds, each taking the first
    global maximum; -1 for an unmatched column."""
    r, c = dist.shape
    neg = -1e9
    dev = dist.device
    rows, cols = torch.arange(r, device=dev), torch.arange(c, device=dev)
    c2r = torch.full((c,), -1, dtype=torch.int32, device=dev)
    cd = torch.zeros((c,), dtype=dist.dtype, device=dev)
    d = dist
    for _ in range(min(r, c)):
        flat = torch.argmax(d.reshape(-1))
        ri, ci = flat // c, flat % c
        best = d.reshape(-1).gather(0, flat[None])[0]
        at = (cols == ci) & (best > neg / 2)
        c2r = torch.where(at, ri.to(torch.int32), c2r)
        cd = torch.where(at, best, cd)
        d = torch.where((rows == ri)[:, None] | (cols == ci)[None, :],
                        torch.full_like(d, neg), d)
    if attrs.get("match_type") == "per_prediction":
        row_val, row_best = torch.max(dist, dim=0)
        extra = (c2r < 0) & (row_val >= attrs.get("dist_threshold", 0.5))
        c2r = torch.where(extra, row_best.to(torch.int32), c2r)
        cd = torch.where(extra, row_val, cd)
    return c2r, cd


@simple("target_assign", inputs=("X", "MatchIndices", "NegIndices"),
        outputs=("Out", "OutWeight"), differentiable=())
def _target_assign(ctx, attrs, x, match, neg):
    """per-prior targets from the matched ground-truth rows (reference:
    target_assign_op.cc).  x [N, D] (or [N]), match [P] (-1 unmatched)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    out = x[torch.clamp(match, 0, x.shape[0] - 1).long()]
    matched = (match >= 0)[:, None]
    out = torch.where(matched, out,
                      torch.full_like(out, attrs.get("mismatch_value", 0)))
    wt = matched.to(torch.float32)
    if neg is not None:
        pos = torch.arange(match.shape[0], device=x.device)
        wt = torch.maximum(wt, (pos[:, None] == neg[None, :]).any(dim=1)
                           [:, None].to(torch.float32))
    if squeeze:
        return out[:, 0], wt[:, 0]
    return out, wt


@simple("mine_hard_examples", inputs=("ClsLoss", "MatchIndices"),
        outputs=("NegIndices", "UpdatedMatchIndices"), differentiable=())
def _mine_hard_examples(ctx, attrs, cls_loss, match):
    """the top-k hardest negatives of each image by confidence loss
    (reference: mine_hard_examples_op.cc).  cls_loss, match [B, P]."""
    p = cls_loss.shape[1]
    is_neg = match < 0
    n_pos = torch.sum(~is_neg, dim=1, keepdim=True)
    n_neg = torch.minimum((attrs.get("neg_pos_ratio", 3.0) * n_pos)
                          .to(torch.int32),
                          torch.sum(is_neg, dim=1, keepdim=True))
    neg_loss = torch.where(is_neg, cls_loss,
                           torch.full_like(cls_loss, float("-inf")))
    order = torch.sort(-neg_loss, dim=1, stable=True)[1]
    rank = torch.argsort(order, dim=1)
    selected = rank < n_neg
    pos = torch.arange(p, dtype=torch.int32, device=match.device)[None, :]
    return (torch.where(selected, pos, torch.full_like(pos, -1)),
            torch.where(selected, torch.full_like(match, -1), match))


@simple("multiclass_nms", inputs=("BBoxes", "Scores"), differentiable=())
def _multiclass_nms(ctx, attrs, bboxes, scores):
    """per-class NMS and a cross-class top-k (reference:
    multiclass_nms_op.cc).  bboxes [P, 4], scores [C, P] -> [keep_top_k,
    6] rows (class, score, box), -1 padded (the reference's ragged LoD
    output, at a static shape)."""
    from paddle_tpu_torch.ops.boxes import nms
    keep_k = attrs.get("keep_top_k", 100)
    rows = []
    for cls in range(scores.shape[0]):
        if cls == attrs.get("background_label", 0):
            continue
        keep_idx, valid = nms(bboxes, scores[cls],
                              iou_threshold=attrs.get("nms_threshold", 0.45),
                              score_threshold=attrs.get("score_threshold",
                                                        0.01),
                              max_out=attrs.get("nms_top_k", 64))
        safe = torch.clamp(keep_idx, 0, bboxes.shape[0] - 1)
        sc = scores[cls][safe]
        rows.append(torch.cat([
            torch.where(valid, torch.full_like(sc, float(cls)),
                        torch.full_like(sc, -1.0))[:, None],
            torch.where(valid, sc, torch.full_like(sc, -1.0))[:, None],
            bboxes[safe]], dim=1))
    allr = torch.cat(rows, dim=0)
    order = torch.sort(-allr[:, 1], stable=True)[1]
    top = allr[order[:keep_k]]
    if keep_k > top.shape[0]:
        top = torch.cat([top, torch.full((keep_k - top.shape[0], 6), -1.0,
                                         dtype=top.dtype,
                                         device=top.device)], dim=0)
    return top


def _linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in float32, value for value: i * (1 /
    (n - 1)) and the end point exactly 1."""
    delta = float(np.float32(1.0) / np.float32(n - 1))
    out = torch.arange(n, dtype=torch.float32, device=device) * delta
    out[-1] = 1.0
    return out


@simple("detection_map", inputs=("DetectRes", "Label"), differentiable=())
def _detection_map(ctx, attrs, det, gt):
    """single-batch mean average precision (reference:
    detection_map_op.cc).  det [R, 6] = (label, score, x1, y1, x2, y2),
    gt [G, 5] = (label, x1, y1, x2, y2), label < 0 padding.  Greedy
    best-IoU matching in score order at overlap_threshold, then 11-point
    or integral AP averaged over the classes with ground truth."""
    thresh = attrs.get("overlap_threshold", 0.5)
    ap_type = attrs.get("ap_type", "11point")
    if ap_type not in ("11point", "integral"):
        raise ValueError(
            f"detection_map ap_type must be '11point' or 'integral', "
            f"got {ap_type!r}")
    class_num = int(attrs.get("class_num", 21))
    r, g = det.shape[0], gt.shape[0]
    dev = det.device
    dlab, score, dvalid = det[:, 0].to(torch.int32), det[:, 1], det[:, 0] >= 0
    glab, gvalid = gt[:, 0].to(torch.int32), gt[:, 0] >= 0
    ix1 = torch.maximum(det[:, 2][:, None], gt[:, 1][None, :])
    iy1 = torch.maximum(det[:, 3][:, None], gt[:, 2][None, :])
    ix2 = torch.minimum(det[:, 4][:, None], gt[:, 3][None, :])
    iy2 = torch.minimum(det[:, 5][:, None], gt[:, 4][None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    area_d = torch.clamp(det[:, 4] - det[:, 2], min=0) \
        * torch.clamp(det[:, 5] - det[:, 3], min=0)
    area_g = torch.clamp(gt[:, 3] - gt[:, 1], min=0) \
        * torch.clamp(gt[:, 4] - gt[:, 2], min=0)
    iou = inter / torch.clamp(area_d[:, None] + area_g[None, :] - inter,
                              min=1e-10)
    ninf = torch.full_like(score, float("-inf"))
    order = torch.sort(-torch.where(dvalid, score, ninf), stable=True)[1]
    used = torch.zeros(g, dtype=torch.bool, device=dev)
    gidx = torch.arange(g, device=dev)
    hits = []
    for k in range(r):
        i = order[k:k + 1]
        iou_i = iou.index_select(0, i)[0]
        cand = ((glab == dlab.index_select(0, i)) & gvalid & ~used
                & (iou_i >= thresh))
        hit = cand.any() & dvalid.index_select(0, i)[0]
        best = torch.argmax(torch.where(cand, iou_i,
                                        torch.full_like(iou_i, -1.0)))
        used = used | (cand.gather(0, best[None])[0] & hit
                       & (gidx == best))
        hits.append(hit)
    tp = torch.zeros(r, dtype=torch.bool, device=dev).scatter(
        0, order, torch.stack(hits))
    cls = torch.arange(class_num, device=dev)[:, None]
    mask_c = (dlab[None, :] == cls) & dvalid[None, :]           # [K, R]
    npos = torch.sum((glab[None, :] == cls) & gvalid[None, :], dim=1)
    o = torch.sort(-torch.where(mask_c, score[None, :], ninf[None, :]),
                   dim=1, stable=True)[1]
    tp_c = torch.gather(mask_c & tp[None, :], 1, o).to(torch.float32)
    valid_c = torch.gather(mask_c, 1, o).to(torch.float32)
    cum_tp = torch.cumsum(tp_c, dim=1)
    prec = cum_tp / torch.clamp(torch.cumsum(valid_c, dim=1), min=1e-10)
    rec = cum_tp / torch.clamp(npos, min=1)[:, None]
    if ap_type == "11point":
        pts = _linspace01(11, dev)
        ap = torch.mean(torch.amax(torch.where(
            rec[:, None, :] >= pts[None, :, None], prec[:, None, :],
            torch.zeros_like(prec[:, None, :])), dim=2), dim=1)
    else:
        drec = torch.diff(rec, dim=1,
                          prepend=torch.zeros_like(rec[:, :1]))
        ap = torch.sum(prec * drec * valid_c, dim=1)
    has = npos > 0
    aps = torch.where(has, ap, torch.zeros_like(ap))
    return (torch.sum(aps) / torch.clamp(torch.sum(has), min=1)).reshape(1)


# ---------------------------------------------------------------------------
# metric ops (reference: auc_op.cc, precision_recall_op.cc,
# chunk_eval_op.cc, positive_negative_pair_op.cc)
# ---------------------------------------------------------------------------

@simple("auc", inputs=("Out", "Label"), differentiable=())
def _auc(ctx, attrs, probs, label):
    """single-batch ROC AUC over num_thresholds buckets (reference:
    auc_op.cc), the trapezoid over decreasing false-positive rate."""
    pos_prob = (probs[:, 1] if probs.ndim == 2 and probs.shape[1] == 2
                else probs.reshape(-1))
    lab = label.reshape(-1).to(torch.float32)
    th = _linspace01(attrs.get("num_thresholds", 200), probs.device)
    pred_pos = (pos_prob[None, :] >= th[:, None]).to(torch.float32)
    tp = torch.sum(pred_pos * lab[None, :], dim=1)
    fp = torch.sum(pred_pos * (1 - lab)[None, :], dim=1)
    tpr = tp / torch.clamp(torch.sum(lab), min=1.0)
    fpr = fp / torch.clamp(torch.sum(1 - lab), min=1.0)
    return torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)


@simple("precision_recall", inputs=("MaxProbs", "Indices", "Labels"),
        outputs=("BatchMetrics",), differentiable=())
def _precision_recall(ctx, attrs, maxprobs, indices, labels):
    """macro and micro precision, recall and F1 over the classes
    (reference: precision_recall_op.cc): [6]."""
    c = attrs["class_number"]
    classes = torch.arange(c, device=indices.device)
    onehot_p = (indices.reshape(-1, 1).long() == classes).to(torch.float32)
    onehot_l = (labels.reshape(-1, 1).long() == classes).to(torch.float32)
    tp = torch.sum(onehot_p * onehot_l, dim=0)
    fp = torch.sum(onehot_p * (1 - onehot_l), dim=0)
    fn = torch.sum((1 - onehot_p) * onehot_l, dim=0)

    def pr(tp_, fp_, fn_):
        p = tp_ / torch.clamp(tp_ + fp_, min=1e-12)
        r = tp_ / torch.clamp(tp_ + fn_, min=1e-12)
        return p, r, 2 * p * r / torch.clamp(p + r, min=1e-12)

    has = (tp + fn) > 0                       # the classes in the batch
    denom = torch.clamp(torch.sum(has), min=1.0)
    macro = [torch.sum(torch.where(has, v, torch.zeros_like(v))) / denom
             for v in pr(tp, fp, fn)]
    micro = pr(torch.sum(tp), torch.sum(fp), torch.sum(fn))
    return torch.stack(macro + list(micro))


def _chunk_spans(tags, mask, scheme, num_types):
    """(is_start [B, T], end [B, T] (a starting chunk's last position),
    type [B, T]) of the chunks of tags [B, T]."""
    t = tags.shape[1]
    valid = mask > 0

    def prev_of(typ):
        return torch.cat([torch.full_like(typ[:, :1], -2), typ[:, :-1]], 1)

    minus1 = torch.full_like(tags, -1)
    if scheme == "plain":
        typ = torch.where(valid, tags, minus1)
        inside_same = typ == prev_of(typ)
        start = valid & (typ >= 0) & ~inside_same
        cont = valid & (typ >= 0) & inside_same
    elif scheme == "IOB":
        # tag = type * 2 (B) / type * 2 + 1 (I); O = num_types * 2
        is_o = (tags >= num_types * 2) | ~valid
        typ = torch.where(is_o, minus1, torch.div(tags, 2,
                                                  rounding_mode="floor"))
        is_i = ~is_o & (tags % 2 == 1)
        cont = is_i & (typ == prev_of(typ))
        start = ~is_o & ((~is_o & (tags % 2 == 0))
                         | (is_i & (typ != prev_of(typ))))
    elif scheme == "IOBES":
        # tag = type * 4 + {0: B, 1: I, 2: E, 3: S}; O = num_types * 4
        is_o = (tags >= num_types * 4) | ~valid
        typ = torch.where(is_o, minus1, torch.div(tags, 4,
                                                  rounding_mode="floor"))
        pos = tags % 4
        cont = ~is_o & ((pos == 1) | (pos == 2)) & (typ == prev_of(typ))
        start = ~is_o & ~cont
    else:
        raise ValueError(f"chunk scheme {scheme!r} not supported")
    # end[t] = t if the chunk does not continue at t + 1, else end[t + 1]
    cont_next = torch.cat([cont[:, 1:], torch.zeros_like(cont[:, :1])], 1)
    e = torch.full((tags.shape[0],), t - 1, dtype=torch.long,
                   device=tags.device)
    ends = [None] * t
    for i in range(t - 1, -1, -1):
        e = torch.where(cont_next[:, i], e, torch.full_like(e, i))
        ends[i] = e
    return start, torch.stack(ends, 1), typ


@register_op("chunk_eval",
             inputs=("Inference", "Label", "Length"),
             outputs=("Precision", "Recall", "F1-Score", "NumInferChunks",
                      "NumLabelChunks", "NumCorrectChunks"),
             differentiable=())
def _chunk_eval(ctx, attrs, ins):
    pred = ins["Inference"][0].to(torch.int32)
    label = ins["Label"][0].to(torch.int32)
    if pred.ndim == 3 and pred.shape[-1] == 1:
        pred = pred[..., 0]
    if label.ndim == 3 and label.shape[-1] == 1:
        label = label[..., 0]
    b, t = label.shape
    lens = _lens(ins["Length"][0] if ins.get("Length") else None, b, t,
                 label.device)
    mask = (torch.arange(t, device=label.device)[None, :]
            < lens[:, None]).to(torch.float32)
    scheme = attrs.get("chunk_scheme", "IOB")
    ntypes = attrs.get("num_chunk_types", 1)
    sp, ep, tp = _chunk_spans(pred, mask, scheme, ntypes)
    sl, el, tl = _chunk_spans(label, mask, scheme, ntypes)
    correct = torch.sum(sp & sl & (tp == tl) & (ep == el)).to(torch.int32)
    n_pred = torch.sum(sp).to(torch.int32)
    n_label = torch.sum(sl).to(torch.int32)
    prec = correct / torch.clamp(n_pred, min=1)
    rec = correct / torch.clamp(n_label, min=1)
    f1 = 2 * prec * rec / torch.clamp(prec + rec, min=1e-12)
    return {"Precision": [prec.float()], "Recall": [rec.float()],
            "F1-Score": [f1.float()], "NumInferChunks": [n_pred],
            "NumLabelChunks": [n_label], "NumCorrectChunks": [correct]}


@register_op("positive_negative_pair",
             inputs=("Score", "Label", "QueryID"),
             outputs=("PositivePair", "NegativePair", "NeutralPair"),
             differentiable=())
def _positive_negative_pair(ctx, attrs, ins):
    """rank-order statistics within query groups (reference:
    positive_negative_pair_op.cc): O(N^2) pair masks over the batch."""
    score = ins["Score"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1).to(torch.float32)
    qid = ins["QueryID"][0].reshape(-1)
    n = score.shape[0]
    upper = torch.ones((n, n), dtype=torch.bool,
                       device=score.device).triu(1)
    pair = ((qid[:, None] == qid[None, :]) & upper
            & (label[:, None] != label[None, :]))
    s_diff = score[:, None] - score[None, :]
    agree = torch.sign(s_diff) == torch.sign(label[:, None]
                                             - label[None, :])
    tie = s_diff == 0.0
    pos = torch.sum(pair & agree & ~tie)
    neu = torch.sum(pair & tie)
    neg = torch.sum(pair) - pos - neu
    return {"PositivePair": [pos.float().reshape(1)],
            "NegativePair": [neg.float().reshape(1)],
            "NeutralPair": [neu.float().reshape(1)]}


@register_op("split_selected_rows", inputs=("Ids", "Values"),
             outputs=("OutIds", "OutValues"),
             list_slots=("OutIds", "OutValues"),
             differentiable=("Values",))
def _split_selected_rows(ctx, attrs, ins):
    """sparse rows split by height sections (reference:
    split_selected_rows_op.cc routes SelectedRows slices to parameter
    servers): each section keeps the full [N] capacity, its ids
    localized (id - section start), -1 / 0 for the rows routed
    elsewhere.  ids [N] (1-D row indices), values [N, ...]."""
    ids = ins["Ids"][0].reshape(-1).to(torch.int32)
    vals = ins["Values"][0]
    if vals.shape[0] != ids.shape[0]:
        raise ValueError(
            f"split_selected_rows: values rows {vals.shape[0]} != ids "
            f"count {ids.shape[0]} (ids must be the 1-D row index vector "
            f"of a [N, ...] values tensor)")
    sections = attrs["height_sections"]
    starts = np.concatenate([[0], np.cumsum(sections)]).astype(np.int64)
    out_ids, out_vals = [], []
    for k in range(len(sections)):
        inside = (ids >= int(starts[k])) & (ids < int(starts[k + 1]))
        out_ids.append(torch.where(inside, ids - int(starts[k]),
                                   torch.full_like(ids, -1)))
        out_vals.append(torch.where(
            inside.reshape((-1,) + (1,) * (vals.ndim - 1)), vals,
            torch.zeros_like(vals)))
    return {"OutIds": out_ids, "OutValues": out_vals}
