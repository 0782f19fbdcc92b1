"""Fluid op catalog: the op registry and the PyTorch implementations
(counterpart of ``paddle_tpu/fluid/ops.py``).

The reference registers ~160 operators with paired CPU/CUDA kernels
(``paddle/fluid/operators``, registry ``framework/op_registry.h:62``).
Here an op is a function of torch tensors, ``fn(ctx, attrs, ins) ->
{slot: [tensor, ...]}``; the executor calls it eagerly, op by op, on the
executor's place.  No op has a hand-written grad kernel: the executor
derives each ``<type>_grad`` op from the forward function by autograd.

This catalog holds the ops of the Fluid programs that ``ROADMAP.md``
section 1, item 12a names: the elementwise, unary / activation, matmul
and reduce families, the shape and fill ops, the random ops and dropout,
the costs, conv2d / pool2d / batch_norm, lstm and gru, linear_chain_crf
and crf_decoding, nce, beam_search and beam_search_decode, and every
optimizer update op.  Every other op of the JAX catalog (``UNPORTED``)
is refused by ``get_op`` with a ``NotImplementedError`` naming item 12b,
which the executor meets before it runs a program's first op.

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
                 stateful_rng: bool = False):
        self.name = name
        self.fn = fn  # fn(ctx, attrs, ins: Dict[slot, List[tensor]]) -> Dict
        self.inputs = tuple(inputs)
        self.outputs = tuple(outputs)
        self.list_slots = frozenset(list_slots)
        # slots whose inputs can receive gradients; None = all float inputs
        self.differentiable = (tuple(differentiable)
                               if differentiable is not None else None)
        self.stateful_rng = stateful_rng


OPS: Dict[str, OpDef] = {}

#: the JAX catalog's ops (and its control-flow ops) that this port does
#: not run yet
UNPORTED = frozenset((
    "array_read", "array_to_lod_tensor", "array_write", "auc",
    "bilinear_tensor_product", "bipartite_match", "bounded_while",
    "box_coder", "chunk_eval", "conditional_block", "conv2d_transpose",
    "conv_shift", "cos_sim", "ctc_align", "detection_map", "edit_distance",
    "equal", "gather", "greater_equal", "greater_than", "gru_unit",
    "hinge_loss", "huber_loss", "im2sequence", "iou_similarity",
    "is_empty", "l1_norm", "label_smooth", "layer_norm", "less_equal",
    "less_than", "lod_rank_table", "lod_reset", "lod_tensor_to_array",
    "log_loss", "logical_and", "logical_not", "logical_or", "logical_xor",
    "lrn", "lstm_unit", "lstmp", "margin_rank_loss", "max_pool2d_with_index",
    "mine_hard_examples", "minus", "modified_huber_loss", "multiclass_nms",
    "multiplex", "norm", "not_equal", "one_hot", "pad",
    "positive_negative_pair", "precision_recall", "prelu", "print",
    "prior_box", "proximal_adagrad", "proximal_gd", "rank_loss",
    "recurrent", "roi_pool", "row_conv", "scatter", "sequence_concat",
    "sequence_conv", "sequence_erase", "sequence_mask", "sequence_reshape",
    "sequence_slice", "shrink_rnn_memory", "sigmoid_cross_entropy_with_logits",
    "smooth_l1", "split_selected_rows", "spp", "squared_l2_distance",
    "target_assign", "unpool", "warpctc", "where", "while",
))


def register_op(name: str, inputs, outputs, list_slots=(),
                differentiable=None, stateful_rng=False):
    def deco(fn):
        OPS[name] = OpDef(name, fn, inputs, outputs, list_slots,
                          differentiable, stateful_rng)
        if stateful_rng:
            framework.STATEFUL_RNG_OPS.add(name)
        return fn

    return deco


def get_op(name: str) -> OpDef:
    if name in OPS:
        return OPS[name]
    if name in UNPORTED:
        raise NotImplementedError(
            f"fluid op {name!r} is not ported to paddle_tpu_torch yet "
            f"(ROADMAP.md section 1, item 12b)")
    raise KeyError(f"op {name!r} is not registered")


def simple(name: str, inputs=("X",), outputs=("Out",), list_slots=(),
           differentiable=None, stateful_rng=False):
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
                          differentiable, stateful_rng)
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
    out = torch.empty(tuple(attrs["shape"]),
                      dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)
    return out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                        generator=ctx.next_generator())


@simple("gaussian_random", inputs=(), differentiable=(), stateful_rng=True)
def _gaussian_random(ctx, attrs):
    out = torch.empty(tuple(attrs["shape"]),
                      dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)
    return out.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                       generator=ctx.next_generator())


@simple("dropout", outputs=("Out", "Mask"), stateful_rng=True)
def _dropout(ctx, attrs, x):
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("is_test", False) or not ctx.train:
        return x, torch.ones_like(x)
    u = torch.rand(x.shape, generator=ctx.next_generator(),
                   device=x.device)
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


def _gru_cell(g, h_prev, w):
    """The GRU gate math (reference gru layout: [:, :2H] update/reset,
    [:, 2H:] candidate; h = (1 - u) h_prev + u c, gru_kernel.h)."""
    h = h_prev.shape[-1]
    ur = torch.sigmoid(g[:, :2 * h] + h_prev @ w[:, :2 * h])
    u, r = ur[:, :h], ur[:, h:]
    c = torch.tanh(g[:, 2 * h:] + (r * h_prev) @ w[:, 2 * h:])
    return (1.0 - u) * h_prev + u * c


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
        h = ms[s] * _gru_cell(g, h, w) + (1 - ms[s]) * h
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
    from the op's generator (the same draw in the op and its grad op).
    A test may replace this function to feed another package's draws."""
    return torch.randint(0, num_classes, (num_neg,),
                         generator=ctx.next_generator(), device=ctx.device)


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
