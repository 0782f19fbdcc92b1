"""Fluid layer helpers: python functions that append ops to the current
program (reference ``python/paddle/v2/fluid/layers/{nn,tensor,ops}.py``; a
copy of ``paddle_tpu/fluid/layers.py`` on the port's framework).

Each helper creates output variables in the current block and appends the op;
parameters go to the global block with init ops in the startup program.
Shape bookkeeping is best-effort: the executor runs on the real feed shapes;
build-time shapes only have to be right where a later layer reads them (e.g.
``fc`` reading ``input.shape[-1]``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.fluid import initializer as init_mod
from paddle_tpu_torch.fluid.framework import Variable, unique_name
from paddle_tpu_torch.fluid.param_attr import ParamAttr

__all__ = [
    "data", "fc", "embedding", "conv2d", "conv2d_transpose", "pool2d",
    "batch_norm", "layer_norm", "lrn", "dropout", "cross_entropy",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "square_error_cost", "smooth_l1", "log_loss", "hinge_loss", "huber_loss",
    "cos_sim", "accuracy", "mean", "mul", "matmul", "concat", "split",
    "reshape", "transpose", "expand", "sums", "cast", "clip", "clip_by_norm",
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "fill_constant", "fill_constant_batch_size_like", "ones", "zeros",
    "create_tensor", "create_global_var", "assign", "increment", "topk",
    "one_hot", "gather", "scatter", "pad", "crop", "multiplex", "cumsum",
    "lookup_table", "elementwise_op", "elementwise_add", "elementwise_sub",
    "elementwise_mul", "elementwise_div", "elementwise_max",
    "elementwise_min", "elementwise_pow", "uniform_random",
    "gaussian_random", "sigmoid", "relu", "tanh", "sqrt", "abs", "square",
    "exp", "log", "softmax", "softplus", "softsign", "leaky_relu", "brelu",
    "soft_relu", "elu", "relu6", "pow", "stanh", "hard_sigmoid", "swish",
    "scale", "sequence_pool", "sequence_softmax", "sequence_expand",
    "im2sequence", "less_than", "less_equal", "greater_than",
    "greater_equal", "equal", "not_equal", "logical_and", "logical_or",
    "logical_not", "array_read", "array_write", "array_length",
    "increment", "While", "StaticRNN", "maxout", "l2_normalize",
    "roi_pool", "detection_map", "shrink_memory",
    "lod_tensor_to_array", "array_to_lod_tensor",
    "split_selected_rows",
]

_ACT_OPS = {
    "sigmoid", "relu", "tanh", "softmax", "abs", "square", "exp", "log",
    "sqrt", "softplus", "softsign", "brelu", "soft_relu", "stanh",
    "leaky_relu", "elu", "relu6", "swish", "hard_sigmoid",
}


def _block():
    return framework.default_main_program().current_block()


def _tmp(shape=(), dtype="float32", name_hint="tmp"):
    return _block().create_var(name=unique_name(name_hint), shape=shape,
                               dtype=dtype)


def _apply_act(out: Variable, act: Optional[str]) -> Variable:
    if act is None:
        return out
    if act not in _ACT_OPS:
        raise ValueError(f"unknown activation {act!r}")
    res = _tmp(out.shape, out.dtype, act)
    _block().append_op(act, inputs={"X": [out]}, outputs={"Out": [res]})
    return res


def _to_var(x, like: Optional[Variable] = None) -> Variable:
    if isinstance(x, Variable):
        return x
    # assign_value carries exact values (scalars included) — no float() cast
    return assign(np.asarray(x))


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

def data(name: str, shape: Sequence[int], dtype: str = "float32",
         append_batch_size: bool = True, lod_level: int = 0) -> Variable:
    """Feed slot (reference ``layers/io.py`` data)."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = framework.default_main_program().global_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            stop_gradient=True, is_feed=True)


# ---------------------------------------------------------------------------
# parameterized layers
# ---------------------------------------------------------------------------

def _create_param(attr, shape, dtype, default_init):
    attr = ParamAttr.to_attr(attr)
    block = _block()
    name = attr.name or unique_name("param")
    init = attr.initializer or default_init
    return block.create_parameter(
        name=name, shape=shape, dtype=dtype, initializer=init,
        trainable=attr.trainable, regularizer=attr.regularizer,
        gradient_clip=attr.gradient_clip)


def fc(input: Union[Variable, List[Variable]], size: int,
       num_flatten_dims: int = 1, param_attr=None, bias_attr=None,
       act: Optional[str] = None, name=None) -> Variable:
    """Fully-connected (reference ``layers/nn.py`` fc): mul per input +
    sum + bias + act."""
    inputs = input if isinstance(input, (list, tuple)) else [input]
    block = _block()
    mul_outs = []
    for inp in inputs:
        in_dim = int(np.prod(inp.shape[num_flatten_dims:]))
        w = _create_param(param_attr, (in_dim, size), inp.dtype,
                          init_mod.Xavier())
        out = _tmp(inp.shape[:num_flatten_dims] + (size,), inp.dtype, "fc")
        block.append_op("mul", inputs={"X": [inp], "Y": [w]},
                        outputs={"Out": [out]},
                        attrs={"x_num_col_dims": num_flatten_dims,
                               "y_num_col_dims": 1})
        mul_outs.append(out)
    if len(mul_outs) == 1:
        pre_bias = mul_outs[0]
    else:
        pre_bias = _tmp(mul_outs[0].shape, mul_outs[0].dtype, "fc_sum")
        block.append_op("sum", inputs={"X": mul_outs},
                        outputs={"Out": [pre_bias]})
    if bias_attr is not False:
        b = _create_param(bias_attr, (size,), pre_bias.dtype,
                          init_mod.Constant(0.0))
        pre_act = _tmp(pre_bias.shape, pre_bias.dtype, "fc_bias")
        block.append_op("elementwise_add", inputs={"X": [pre_bias],
                                                   "Y": [b]},
                        outputs={"Out": [pre_act]},
                        attrs={"axis": len(pre_bias.shape) - 1})
    else:
        pre_act = pre_bias
    return _apply_act(pre_act, act)


def embedding(input: Variable, size: Sequence[int], param_attr=None,
              dtype="float32", is_sparse: bool = False,
              padding_idx: Optional[int] = None) -> Variable:
    w = _create_param(param_attr, tuple(size), dtype,
                      init_mod.Xavier())
    out_shape = tuple(input.shape) + (size[1],)
    if input.shape and input.shape[-1] == 1:
        out_shape = tuple(input.shape[:-1]) + (size[1],)
    out = _tmp(out_shape, dtype, "embedding")
    _block().append_op("lookup_table", inputs={"W": [w], "Ids": [input]},
                       outputs={"Out": [out]},
                       attrs={"padding_idx": padding_idx})
    return out


lookup_table = embedding


def conv2d(input: Variable, num_filters: int, filter_size, stride=1,
           padding=0, dilation=1, groups: int = 1, param_attr=None,
           bias_attr=None, act: Optional[str] = None,
           name=None) -> Variable:
    """NCHW conv (reference ``layers/nn.py`` conv2d)."""
    fs = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    st = stride if isinstance(stride, (list, tuple)) else (stride, stride)
    pd = padding if isinstance(padding, (list, tuple)) \
        else (padding, padding)
    dl = dilation if isinstance(dilation, (list, tuple)) \
        else (dilation, dilation)
    c_in = input.shape[1]
    w_shape = (num_filters, c_in // groups, fs[0], fs[1])
    fan_in = (c_in // groups) * fs[0] * fs[1]
    w = _create_param(param_attr, w_shape, input.dtype,
                      init_mod.Normal(0.0, float(np.sqrt(2.0 / fan_in))))
    h = _conv_out(input.shape[2], fs[0], st[0], pd[0], dl[0])
    wdim = _conv_out(input.shape[3], fs[1], st[1], pd[1], dl[1])
    out = _tmp((input.shape[0], num_filters, h, wdim), input.dtype, "conv2d")
    _block().append_op("conv2d", inputs={"Input": [input], "Filter": [w]},
                       outputs={"Output": [out]},
                       attrs={"strides": list(st), "paddings": list(pd),
                              "dilations": list(dl), "groups": groups})
    if bias_attr is not False:
        b = _create_param(bias_attr, (num_filters,), input.dtype,
                          init_mod.Constant(0.0))
        pre_act = _tmp(out.shape, out.dtype, "conv2d_bias")
        _block().append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                           outputs={"Out": [pre_act]}, attrs={"axis": 1})
        out = pre_act
    return _apply_act(out, act)


def _conv_out(size, k, s, p, d=1):
    if size < 0:
        return -1
    return (size + 2 * p - (d * (k - 1) + 1)) // s + 1


def conv2d_transpose(input: Variable, num_filters: int, filter_size,
                     stride=1, padding=0, param_attr=None,
                     bias_attr=False, act=None) -> Variable:
    fs = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    st = stride if isinstance(stride, (list, tuple)) else (stride, stride)
    pd = padding if isinstance(padding, (list, tuple)) \
        else (padding, padding)
    c_in = input.shape[1]
    w = _create_param(param_attr, (c_in, num_filters, fs[0], fs[1]),
                      input.dtype, init_mod.Xavier())
    h = -1 if input.shape[2] < 0 else \
        (input.shape[2] - 1) * st[0] - 2 * pd[0] + fs[0]
    wd = -1 if input.shape[3] < 0 else \
        (input.shape[3] - 1) * st[1] - 2 * pd[1] + fs[1]
    out = _tmp((input.shape[0], num_filters, h, wd), input.dtype, "convT")
    _block().append_op("conv2d_transpose",
                       inputs={"Input": [input], "Filter": [w]},
                       outputs={"Output": [out]},
                       attrs={"strides": list(st), "paddings": list(pd)})
    return _apply_act(out, act)


def pool2d(input: Variable, pool_size=2, pool_type: str = "max",
           pool_stride=None, pool_padding=0, global_pooling: bool = False,
           exclusive: bool = True, name=None) -> Variable:
    ks = pool_size if isinstance(pool_size, (list, tuple)) \
        else (pool_size, pool_size)
    st = pool_stride if pool_stride is not None else ks
    st = st if isinstance(st, (list, tuple)) else (st, st)
    pd = pool_padding if isinstance(pool_padding, (list, tuple)) \
        else (pool_padding, pool_padding)
    if global_pooling:
        h = wd = 1
    else:
        h = _conv_out(input.shape[2], ks[0], st[0], pd[0])
        wd = _conv_out(input.shape[3], ks[1], st[1], pd[1])
    out = _tmp((input.shape[0], input.shape[1], h, wd), input.dtype, "pool")
    _block().append_op("pool2d", inputs={"X": [input]},
                       outputs={"Out": [out]},
                       attrs={"ksize": list(ks), "strides": list(st),
                              "paddings": list(pd), "pooling_type": pool_type,
                              "global_pooling": global_pooling,
                              "exclusive": exclusive})
    return out


def batch_norm(input: Variable, act: Optional[str] = None,
               is_test: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, param_attr=None, bias_attr=None,
               name=None) -> Variable:
    c = input.shape[1]
    scale = _create_param(param_attr, (c,), input.dtype,
                          init_mod.Constant(1.0))
    bias = _create_param(bias_attr, (c,), input.dtype,
                         init_mod.Constant(0.0))
    block = _block()
    gblock = framework.default_main_program().global_block()
    mean_name = unique_name("bn_mean")
    var_name = unique_name("bn_variance")
    mean = gblock.create_var(name=mean_name, shape=(c,), dtype=input.dtype,
                             persistable=True)
    variance = gblock.create_var(name=var_name, shape=(c,),
                                 dtype=input.dtype, persistable=True)
    startup = framework.default_main_program().startup_program
    if startup is not None:
        sb = startup.global_block()
        mv = sb.create_var(name=mean_name, shape=(c,), dtype=input.dtype,
                           persistable=True)
        init_mod.Constant(0.0)(mv, sb)
        vv = sb.create_var(name=var_name, shape=(c,), dtype=input.dtype,
                           persistable=True)
        init_mod.Constant(1.0)(vv, sb)
    y = _tmp(input.shape, input.dtype, "bn")
    saved_mean = _tmp((c,), input.dtype, "bn_saved_mean")
    saved_var = _tmp((c,), input.dtype, "bn_saved_var")
    block.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [y], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test})
    return _apply_act(y, act)


def layer_norm(input: Variable, scale: bool = True, shift: bool = True,
               begin_norm_axis: int = 1, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, act=None) -> Variable:
    norm_shape = (int(np.prod(input.shape[begin_norm_axis:])),)
    ins = {"X": [input]}
    if scale:
        s = _create_param(param_attr, norm_shape, input.dtype,
                          init_mod.Constant(1.0))
        ins["Scale"] = [s]
    if shift:
        b = _create_param(bias_attr, norm_shape, input.dtype,
                          init_mod.Constant(0.0))
        ins["Bias"] = [b]
    y = _tmp(input.shape, input.dtype, "layer_norm")
    mean = _tmp((-1,), input.dtype, "ln_mean")
    var = _tmp((-1,), input.dtype, "ln_var")
    _block().append_op("layer_norm", inputs=ins,
                       outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
                       attrs={"begin_norm_axis": begin_norm_axis,
                              "epsilon": epsilon})
    return _apply_act(y, act)


def lrn(input: Variable, n: int = 5, k: float = 1.0, alpha: float = 1e-4,
        beta: float = 0.75) -> Variable:
    out = _tmp(input.shape, input.dtype, "lrn")
    _block().append_op("lrn", inputs={"X": [input]}, outputs={"Out": [out]},
                       attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def dropout(x: Variable, dropout_prob: float = 0.5, is_test: bool = False,
            seed=None, name=None) -> Variable:
    out = _tmp(x.shape, x.dtype, "dropout")
    mask = _tmp(x.shape, x.dtype, "dropout_mask")
    _block().append_op("dropout", inputs={"X": [x]},
                       outputs={"Out": [out], "Mask": [mask]},
                       attrs={"dropout_prob": dropout_prob,
                              "is_test": is_test})
    return out


def maxout(x: Variable, groups: int) -> Variable:
    c = x.shape[1]
    out = reshape(x, [x.shape[0] if x.shape[0] > 0 else -1,
                      c // groups, groups, x.shape[2], x.shape[3]])
    return reduce_max(out, dim=2)


def l2_normalize(x: Variable, axis: int = -1,
                 epsilon: float = 1e-12) -> Variable:
    sq = elementwise_op("elementwise_mul", x, x)
    s = reduce_sum(sq, dim=axis, keep_dim=True)
    floor = fill_constant((1,), x.dtype, epsilon)
    norm = _apply_act(elementwise_max(s, floor), "sqrt")
    return elementwise_op("elementwise_div", x, norm)


# ---------------------------------------------------------------------------
# losses / metrics
# ---------------------------------------------------------------------------

def cross_entropy(input: Variable, label: Variable,
                  soft_label: bool = False) -> Variable:
    out = _tmp(input.shape[:-1] + (1,), input.dtype, "cross_entropy")
    _block().append_op("cross_entropy",
                       inputs={"X": [input], "Label": [label]},
                       outputs={"Out": [out]},
                       attrs={"soft_label": soft_label})
    return out


def softmax_with_cross_entropy(logits: Variable, label: Variable,
                               soft_label: bool = False):
    sm = _tmp(logits.shape, logits.dtype, "softmax")
    loss = _tmp(logits.shape[:-1] + (1,), logits.dtype, "ce_loss")
    _block().append_op("softmax_with_cross_entropy",
                       inputs={"Logits": [logits], "Label": [label]},
                       outputs={"Softmax": [sm], "Loss": [loss]},
                       attrs={"soft_label": soft_label})
    return loss


def sigmoid_cross_entropy_with_logits(x: Variable,
                                      label: Variable) -> Variable:
    out = _tmp(x.shape, x.dtype, "sigmoid_ce")
    _block().append_op("sigmoid_cross_entropy_with_logits",
                       inputs={"X": [x], "Label": [label]},
                       outputs={"Out": [out]})
    return out


def square_error_cost(input: Variable, label: Variable) -> Variable:
    out = _tmp(input.shape, input.dtype, "square_error")
    _block().append_op("square_error_cost",
                       inputs={"X": [input], "Y": [label]},
                       outputs={"Out": [out]})
    return out


def smooth_l1(x: Variable, y: Variable, sigma: float = 1.0) -> Variable:
    out = _tmp(x.shape[:-1] + (1,), x.dtype, "smooth_l1")
    _block().append_op("smooth_l1", inputs={"X": [x], "Y": [y]},
                       outputs={"Out": [out]}, attrs={"sigma": sigma})
    return out


def log_loss(input: Variable, label: Variable,
             epsilon: float = 1e-4) -> Variable:
    out = _tmp(input.shape, input.dtype, "log_loss")
    _block().append_op("log_loss",
                       inputs={"Predicted": [input], "Labels": [label]},
                       outputs={"Loss": [out]}, attrs={"epsilon": epsilon})
    return out


def hinge_loss(logits: Variable, label: Variable) -> Variable:
    out = _tmp(logits.shape, logits.dtype, "hinge")
    _block().append_op("hinge_loss",
                       inputs={"Logits": [logits], "Labels": [label]},
                       outputs={"Loss": [out]})
    return out


def huber_loss(x: Variable, y: Variable, delta: float = 1.0) -> Variable:
    out = _tmp(x.shape, x.dtype, "huber")
    _block().append_op("huber_loss", inputs={"X": [x], "Y": [y]},
                       outputs={"Out": [out]}, attrs={"delta": delta})
    return out


def cos_sim(x: Variable, y: Variable) -> Variable:
    out = _tmp(x.shape[:-1] + (1,), x.dtype, "cos_sim")
    _block().append_op("cos_sim", inputs={"X": [x], "Y": [y]},
                       outputs={"Out": [out]})
    return out


def accuracy(input: Variable, label: Variable, k: int = 1) -> Variable:
    topv, topi = topk(input, k)
    acc = _tmp((), "float32", "accuracy")
    correct = _tmp((), "int32", "correct")
    total = _tmp((), "int32", "total")
    _block().append_op("accuracy",
                       inputs={"Out": [topv], "Indices": [topi],
                               "Label": [label]},
                       outputs={"Accuracy": [acc], "Correct": [correct],
                                "Total": [total]})
    return acc


# ---------------------------------------------------------------------------
# math / tensor manipulation
# ---------------------------------------------------------------------------

def mean(x: Variable, name=None) -> Variable:
    out = _tmp((), x.dtype, "mean")
    _block().append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def mul(x: Variable, y: Variable, x_num_col_dims: int = 1,
        y_num_col_dims: int = 1) -> Variable:
    out_shape = x.shape[:x_num_col_dims] + y.shape[y_num_col_dims:]
    out = _tmp(out_shape, x.dtype, "mul")
    _block().append_op("mul", inputs={"X": [x], "Y": [y]},
                       outputs={"Out": [out]},
                       attrs={"x_num_col_dims": x_num_col_dims,
                              "y_num_col_dims": y_num_col_dims})
    return out


def matmul(x: Variable, y: Variable, transpose_x: bool = False,
           transpose_y: bool = False, alpha: float = 1.0) -> Variable:
    a, b = list(x.shape), list(y.shape)
    if len(a) >= 2 and transpose_x:
        a[-1], a[-2] = a[-2], a[-1]
    if len(b) >= 2 and transpose_y:
        b[-1], b[-2] = b[-2], b[-1]
    if len(a) >= 2 and len(b) >= 2:
        shape = tuple(a[:-1]) + (b[-1],)
    elif len(a) >= 2 and len(b) == 1:
        shape = tuple(a[:-1])
    else:
        shape = ()
    out = _tmp(shape, x.dtype, "matmul")
    _block().append_op("matmul", inputs={"X": [x], "Y": [y]},
                       outputs={"Out": [out]},
                       attrs={"transpose_X": transpose_x,
                              "transpose_Y": transpose_y, "alpha": alpha})
    return out


def elementwise_op(op_type: str, x, y, axis: int = -1,
                   act: Optional[str] = None) -> Variable:
    x = _to_var(x)
    y = _to_var(y)
    out = _tmp(x.shape, x.dtype, op_type)
    _block().append_op(op_type, inputs={"X": [x], "Y": [y]},
                       outputs={"Out": [out]}, attrs={"axis": axis})
    return _apply_act(out, act)


def elementwise_add(x, y, axis=-1, act=None):
    return elementwise_op("elementwise_add", x, y, axis, act)


def elementwise_sub(x, y, axis=-1, act=None):
    return elementwise_op("elementwise_sub", x, y, axis, act)


def elementwise_mul(x, y, axis=-1, act=None):
    return elementwise_op("elementwise_mul", x, y, axis, act)


def elementwise_div(x, y, axis=-1, act=None):
    return elementwise_op("elementwise_div", x, y, axis, act)


def elementwise_max(x, y, axis=-1, act=None):
    return elementwise_op("elementwise_max", x, y, axis, act)


def elementwise_min(x, y, axis=-1, act=None):
    return elementwise_op("elementwise_min", x, y, axis, act)


def elementwise_pow(x, y, axis=-1, act=None):
    return elementwise_op("elementwise_pow", x, y, axis, act)


def concat(input: List[Variable], axis: int = 0) -> Variable:
    shape = list(input[0].shape)
    if shape:
        ax = axis if axis >= 0 else len(shape) + axis
        total = 0
        for v in input:
            d = v.shape[ax] if len(v.shape) > ax else -1
            if d < 0:
                total = -1
                break
            total += d
        shape[ax] = total
    out = _tmp(tuple(shape), input[0].dtype, "concat")
    _block().append_op("concat", inputs={"X": input},
                       outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def split(input: Variable, num_or_sections, dim: int = -1):
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    if not input.shape:                        # unknown-shape placeholder
        outs = [_tmp((), input.dtype, "split") for _ in range(n)]
    else:
        ax = dim if dim >= 0 else len(input.shape) + dim
        if isinstance(num_or_sections, int) and input.shape[ax] > 0:
            secs = [input.shape[ax] // n] * n
        elif not isinstance(num_or_sections, int):
            secs = list(num_or_sections)
        else:
            secs = [-1] * n

        def _sshape(s):
            sh = list(input.shape)
            sh[ax] = s
            return tuple(sh)

        outs = [_tmp(_sshape(s), input.dtype, "split") for s in secs]
    _block().append_op("split", inputs={"X": [input]},
                       outputs={"Out": outs}, attrs=attrs)
    return outs


def reshape(x: Variable, shape: Sequence[int], act=None,
            inplace: bool = False) -> Variable:
    out = _tmp(tuple(shape), x.dtype, "reshape")
    _block().append_op("reshape", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"shape": list(shape)})
    return _apply_act(out, act)


def transpose(x: Variable, perm: Sequence[int]) -> Variable:
    shape = tuple(x.shape[p] if p < len(x.shape) else -1 for p in perm)
    out = _tmp(shape, x.dtype, "transpose")
    _block().append_op("transpose", inputs={"X": [x]},
                       outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def expand(x: Variable, expand_times: Sequence[int]) -> Variable:
    shape = tuple(d if d < 0 else d * t
                  for d, t in zip(x.shape, expand_times))         if len(x.shape) == len(list(expand_times)) else ()
    out = _tmp(shape, x.dtype, "expand")
    _block().append_op("expand", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"expand_times": list(expand_times)})
    return out


def sums(input: List[Variable], out: Optional[Variable] = None) -> Variable:
    out = out or _tmp(input[0].shape, input[0].dtype, "sums")
    _block().append_op("sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def cast(x: Variable, dtype: str) -> Variable:
    out = _tmp(x.shape, dtype, "cast")
    _block().append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"out_dtype": dtype})
    return out


def clip(x: Variable, min: float, max: float) -> Variable:  # noqa: A002
    out = _tmp(x.shape, x.dtype, "clip")
    _block().append_op("clip", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"min": min, "max": max})
    return out


def clip_by_norm(x: Variable, max_norm: float) -> Variable:
    out = _tmp(x.shape, x.dtype, "clip_by_norm")
    _block().append_op("clip_by_norm", inputs={"X": [x]},
                       outputs={"Out": [out]},
                       attrs={"max_norm": max_norm})
    return out


def _reduce(op_type, x, dim, keep_dim):
    out = _tmp((), x.dtype, op_type)
    attrs = {"keep_dim": keep_dim}
    if dim is None:
        attrs["reduce_all"] = True
    else:
        attrs["dim"] = dim
    _block().append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs=attrs)
    return out


def reduce_sum(x, dim=None, keep_dim=False):
    return _reduce("reduce_sum", x, dim, keep_dim)


def reduce_mean(x, dim=None, keep_dim=False):
    return _reduce("reduce_mean", x, dim, keep_dim)


def reduce_max(x, dim=None, keep_dim=False):
    return _reduce("reduce_max", x, dim, keep_dim)


def reduce_min(x, dim=None, keep_dim=False):
    return _reduce("reduce_min", x, dim, keep_dim)


def reduce_prod(x, dim=None, keep_dim=False):
    return _reduce("reduce_prod", x, dim, keep_dim)


def fill_constant(shape, dtype, value, out: Optional[Variable] = None,
                  force_cpu=False) -> Variable:
    out = out or _tmp(tuple(shape), dtype, "fill")
    _block().append_op("fill_constant", outputs={"Out": [out]},
                       attrs={"shape": list(shape), "value": float(value),
                              "dtype": dtype})
    return out


def fill_constant_batch_size_like(input: Variable, shape, dtype, value,
                                  input_dim_idx=0,
                                  output_dim_idx=0) -> Variable:
    out = _tmp(tuple(shape), dtype, "fill_bsl")
    _block().append_op("fill_constant_batch_size_like",
                       inputs={"Input": [input]}, outputs={"Out": [out]},
                       attrs={"shape": list(shape), "value": float(value),
                              "dtype": dtype, "input_dim_idx": input_dim_idx,
                              "output_dim_idx": output_dim_idx})
    return out


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


def create_tensor(dtype, name=None):
    return _block().create_var(name=name or unique_name("tensor"),
                               shape=(), dtype=dtype)


def create_global_var(shape, value, dtype, persistable=False,
                      name=None) -> Variable:
    prog = framework.default_main_program()
    gblock = prog.global_block()
    var = gblock.create_var(name=name or unique_name("global_var"),
                            shape=tuple(shape), dtype=dtype,
                            persistable=persistable)
    startup = prog.startup_program
    if startup is not None:
        sb = startup.global_block()
        sv = sb.create_var(name=var.name, shape=tuple(shape), dtype=dtype,
                           persistable=persistable)
        init_mod.Constant(value)(sv, sb)
    return var


def assign(input, output: Optional[Variable] = None) -> Variable:
    if not isinstance(input, Variable):
        arr = np.asarray(input)
        output = output or _tmp(arr.shape, str(arr.dtype), "assign")
        _block().append_op("assign_value", outputs={"Out": [output]},
                           attrs={"shape": list(arr.shape),
                                  "values": arr.reshape(-1).tolist(),
                                  "dtype": str(arr.dtype)})
        return output
    output = output or _tmp(input.shape, input.dtype, "assign")
    _block().append_op("assign", inputs={"X": [input]},
                       outputs={"Out": [output]})
    return output


def increment(x: Variable, value: float = 1.0,
              in_place: bool = True) -> Variable:
    out = x if in_place else _tmp(x.shape, x.dtype, "increment")
    _block().append_op("increment", inputs={"X": [x]},
                       outputs={"Out": [out]}, attrs={"step": value})
    return out


def topk(input: Variable, k: int):
    vals = _tmp(input.shape[:-1] + (k,), input.dtype, "topk_v")
    idx = _tmp(input.shape[:-1] + (k,), "int64", "topk_i")
    _block().append_op("top_k", inputs={"X": [input]},
                       outputs={"Out": [vals], "Indices": [idx]},
                       attrs={"k": k})
    return vals, idx


def one_hot(input: Variable, depth: int) -> Variable:
    out = _tmp(input.shape[:-1] + (depth,), "float32", "one_hot")
    _block().append_op("one_hot", inputs={"X": [input]},
                       outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def gather(input: Variable, index: Variable) -> Variable:
    gshape = ((index.shape[0],) + tuple(input.shape[1:])
              if (input.shape and index.shape) else ())
    out = _tmp(gshape, input.dtype, "gather")
    _block().append_op("gather", inputs={"X": [input], "Index": [index]},
                       outputs={"Out": [out]})
    return out


def scatter(input: Variable, index: Variable,
            updates: Variable) -> Variable:
    out = _tmp(input.shape, input.dtype, "scatter")
    _block().append_op("scatter",
                       inputs={"X": [input], "Ids": [index],
                               "Updates": [updates]},
                       outputs={"Out": [out]})
    return out


def pad(x: Variable, paddings: Sequence[int],
        pad_value: float = 0.0) -> Variable:
    pshape = tuple(
        (d if d < 0 else d + paddings[2 * i] + paddings[2 * i + 1])
        for i, d in enumerate(x.shape)) if x.shape else ()
    out = _tmp(pshape, x.dtype, "pad")
    _block().append_op("pad", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"paddings": list(paddings),
                              "pad_value": pad_value})
    return out


def crop(x: Variable, shape: Sequence[int],
         offsets: Sequence[int]) -> Variable:
    out = _tmp(tuple(shape), x.dtype, "crop")
    _block().append_op("crop", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"shape": list(shape),
                              "offsets": list(offsets)})
    return out


def multiplex(inputs: List[Variable], index: Variable) -> Variable:
    out = _tmp(inputs[0].shape, inputs[0].dtype, "multiplex")
    _block().append_op("multiplex",
                       inputs={"Ids": [index], "X": inputs},
                       outputs={"Out": [out]})
    return out


def cumsum(x: Variable, axis: int = -1) -> Variable:
    out = _tmp(x.shape, x.dtype, "cumsum")
    _block().append_op("cumsum", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"axis": axis})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0,  # noqa: A002
                   seed=0) -> Variable:
    out = _tmp(tuple(shape), dtype, "uniform")
    _block().append_op("uniform_random", outputs={"Out": [out]},
                       attrs={"shape": list(shape), "min": min, "max": max,
                              "dtype": dtype})
    return out


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0) -> Variable:
    out = _tmp(tuple(shape), dtype, "gaussian")
    _block().append_op("gaussian_random", outputs={"Out": [out]},
                       attrs={"shape": list(shape), "mean": mean,
                              "std": std, "dtype": dtype})
    return out


def scale(x: Variable, scale: float = 1.0,  # noqa: A002
          bias: float = 0.0) -> Variable:
    out = _tmp(x.shape, x.dtype, "scale")
    _block().append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"scale": scale, "bias": bias})
    return out


def _make_unary(op_type):
    def f(x: Variable, name=None) -> Variable:
        out = _tmp(x.shape, x.dtype, op_type)
        _block().append_op(op_type, inputs={"X": [x]},
                           outputs={"Out": [out]})
        return out

    f.__name__ = op_type
    return f


sigmoid = _make_unary("sigmoid")
relu = _make_unary("relu")
tanh = _make_unary("tanh")
sqrt = _make_unary("sqrt")
abs = _make_unary("abs")  # noqa: A001
square = _make_unary("square")
exp = _make_unary("exp")
log = _make_unary("log")
softmax = _make_unary("softmax")
softplus = _make_unary("softplus")
softsign = _make_unary("softsign")


def leaky_relu(x, alpha=0.02):
    out = _tmp(x.shape, x.dtype, "leaky_relu")
    _block().append_op("leaky_relu", inputs={"X": [x]},
                       outputs={"Out": [out]}, attrs={"alpha": alpha})
    return out


def brelu(x, t_min=0.0, t_max=24.0):
    out = _tmp(x.shape, x.dtype, "brelu")
    _block().append_op("brelu", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"t_min": t_min, "t_max": t_max})
    return out


def soft_relu(x, threshold=40.0):
    out = _tmp(x.shape, x.dtype, "soft_relu")
    _block().append_op("soft_relu", inputs={"X": [x]},
                       outputs={"Out": [out]},
                       attrs={"threshold": threshold})
    return out


def elu(x, alpha=1.0):
    out = _tmp(x.shape, x.dtype, "elu")
    _block().append_op("elu", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"alpha": alpha})
    return out


def relu6(x, threshold=6.0):
    out = _tmp(x.shape, x.dtype, "relu6")
    _block().append_op("relu6", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"threshold": threshold})
    return out


def pow(x, factor=1.0):  # noqa: A001
    out = _tmp(x.shape, x.dtype, "pow")
    _block().append_op("pow", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"factor": factor})
    return out


def stanh(x, scale_a=2.0 / 3.0, scale_b=1.7159):
    out = _tmp(x.shape, x.dtype, "stanh")
    _block().append_op("stanh", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"scale_a": scale_a, "scale_b": scale_b})
    return out


def hard_sigmoid(x, slope=0.2, offset=0.5):
    out = _tmp(x.shape, x.dtype, "hard_sigmoid")
    _block().append_op("hard_sigmoid", inputs={"X": [x]},
                       outputs={"Out": [out]},
                       attrs={"slope": slope, "offset": offset})
    return out


def swish(x, beta=1.0):
    out = _tmp(x.shape, x.dtype, "swish")
    _block().append_op("swish", inputs={"X": [x]}, outputs={"Out": [out]},
                       attrs={"beta": beta})
    return out


# ---------------------------------------------------------------------------
# padded-sequence ops.  The reference's fluid uses LoD tensors; this
# design replaces LoD with [batch, time, ...] padding + explicit length
# masks.
# ---------------------------------------------------------------------------

def sequence_mask(x: Variable, maxlen: int, dtype: str = "float32"
                  ) -> Variable:
    """lens [B] → [B, maxlen] validity mask (reference layers sequence_mask)."""
    out = _tmp((x.shape[0] if x.shape else -1, maxlen), dtype, "seqmask")
    _block().append_op("sequence_mask", inputs={"X": [x]},
                       outputs={"Out": [out]},
                       attrs={"maxlen": maxlen, "dtype": dtype})
    return out


def sequence_pool(input: Variable, pool_type: str) -> Variable:
    """Pool over the time axis (axis 1). Padded batches should pre-mask
    the input; for length-aware pooling use the v2 stack's seq_pool layer
    which consumes propagated sequence masks."""
    if pool_type in ("sum", "average", "sqrt"):
        if pool_type == "average":
            out = reduce_mean(input, dim=1)
        elif pool_type == "sqrt":
            t = input.shape[1]
            out = scale(reduce_sum(input, dim=1),
                        scale=float(t) ** -0.5 if t > 0 else 1.0)
        else:
            out = reduce_sum(input, dim=1)
    elif pool_type == "max":
        out = reduce_max(input, dim=1)
    elif pool_type in ("first", "last"):
        idx = 0 if pool_type == "first" else -1
        sliced = _tmp(input.shape[:1] + input.shape[2:], input.dtype, "seq")
        _block().append_op("crop", inputs={"X": [input]},
                           outputs={"Out": [sliced]},
                           attrs={"offsets": [0, 0 if idx == 0 else
                                              input.shape[1] - 1, 0],
                                  "shape": [input.shape[0], 1,
                                            input.shape[2]]})
        return reshape(sliced, [input.shape[0] if input.shape[0] > 0
                                else -1, input.shape[2]])
    else:
        raise ValueError(f"unsupported pool_type {pool_type!r}")
    return out


def sequence_softmax(input: Variable) -> Variable:
    return softmax(input)


def sequence_expand(x: Variable, y: Variable) -> Variable:
    times = [1] * len(x.shape)
    times[1] = y.shape[1] if len(y.shape) > 1 and y.shape[1] > 0 else 1
    return expand(x, times)


# ---------------------------------------------------------------------------
# comparisons (for control flow conditions)
# ---------------------------------------------------------------------------

def _make_compare(op_type):
    def f(x: Variable, y, cond: Optional[Variable] = None) -> Variable:
        y = _to_var(y)
        out = cond or _tmp(x.shape, "bool", op_type)
        _block().append_op(op_type, inputs={"X": [x], "Y": [y]},
                           outputs={"Out": [out]})
        return out

    f.__name__ = op_type
    return f


less_than = _make_compare("less_than")
less_equal = _make_compare("less_equal")
greater_than = _make_compare("greater_than")
greater_equal = _make_compare("greater_equal")
equal = _make_compare("equal")
not_equal = _make_compare("not_equal")
logical_and = _make_compare("logical_and")
logical_or = _make_compare("logical_or")


def logical_not(x: Variable) -> Variable:
    out = _tmp(x.shape, "bool", "logical_not")
    _block().append_op("logical_not", inputs={"X": [x]},
                       outputs={"Out": [out]})
    return out


# control-flow constructs live in their own module; re-export for API parity
def __getattr__(name):
    if name in ("While", "StaticRNN", "DynamicRNN", "IfElse", "Switch",
                "ParallelDo", "array_read", "array_write", "array_length",
                "create_array"):
        from paddle_tpu_torch.fluid import control_flow
        return getattr(control_flow, name)
    raise AttributeError(name)


# ---------------------------------------------------------------------------
# op-catalog additions: losses, RNN compute, sequence, CTC/edit-distance,
# detection, metrics (thin Variable wrappers over fluid/ops.py impls)
# ---------------------------------------------------------------------------

def _simple_call(op, ins: dict, attrs=None, n_out=1, out_shape=None,
                 out_dtype=None, out_slots=("Out",)):
    cands = [v[0] for v in ins.values() if v and v[0] is not None]
    floats = [v for v in cands if "float" in str(getattr(v, "dtype", ""))]
    first = (floats or cands)[0]
    outs = {}
    ovars = []
    for s in out_slots[:n_out]:
        v = _tmp(out_shape if out_shape is not None else first.shape,
                 out_dtype or first.dtype, op)
        outs[s] = [v]
        ovars.append(v)
    _block().append_op(op, inputs={k: v for k, v in ins.items() if v
                                   and v[0] is not None},
                       outputs=outs, attrs=attrs or {})
    return ovars[0] if n_out == 1 else tuple(ovars)


def rank_loss(label, left, right):
    return _simple_call("rank_loss", {"Label": [label], "Left": [left],
                                      "Right": [right]})


def margin_rank_loss(label, left, right, margin=0.0):
    out, act = _simple_call("margin_rank_loss",
                            {"Label": [label], "X1": [left], "X2": [right]},
                            {"margin": margin}, n_out=2,
                            out_slots=("Out", "Activated"))
    return out


def modified_huber_loss(x, y):
    out, _ = _simple_call("modified_huber_loss", {"X": [x], "Y": [y]},
                          n_out=2, out_slots=("Out", "IntermediateVal"))
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1):
    return _simple_call("label_smooth",
                        {"X": [label], "PriorDist": [prior_dist]},
                        {"epsilon": epsilon})


def bilinear_tensor_product(x, y, size, param_attr=None, bias_attr=None):
    w = _create_param(param_attr, (size, x.shape[-1], y.shape[-1]),
                      x.dtype, init_mod.Xavier())
    ins = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        ins["Bias"] = [_create_param(bias_attr, (size,), x.dtype,
                                     init_mod.Constant(0.0))]
    return _simple_call("bilinear_tensor_product", ins,
                        out_shape=(x.shape[0], size))


def norm(x, axis=1, epsilon=1e-10):
    return _simple_call("norm", {"X": [x]},
                        {"axis": axis, "epsilon": epsilon})


def prelu(x, mode="all", param_attr=None):
    n = 1 if mode == "all" else x.shape[-1]
    alpha = _create_param(param_attr, (n,), x.dtype,
                          init_mod.Constant(0.25))
    return _simple_call("prelu", {"X": [x], "Alpha": [alpha]})


def row_conv(input, future_context_size, param_attr=None):
    filt = _create_param(param_attr,
                         (future_context_size + 1, input.shape[-1]),
                         input.dtype, init_mod.Xavier())
    return _simple_call("row_conv", {"X": [input], "Filter": [filt]})


def conv_shift(x, y):
    return _simple_call("conv_shift", {"X": [x], "Y": [y]})


def is_empty(x):
    return _simple_call("is_empty", {"X": [x]}, out_shape=(),
                        out_dtype="bool")


def lstm_unit(x_t, cell_t_prev, forget_bias=0.0):
    h = x_t.shape[-1] // 4
    c, hid = _simple_call("lstm_unit", {"X": [x_t], "C_prev": [cell_t_prev]},
                          {"forget_bias": forget_bias}, n_out=2,
                          out_shape=(x_t.shape[0], h),
                          out_slots=("C", "H"))
    return hid, c


def dynamic_lstm(input, size, mask=None, param_attr=None, bias_attr=None,
                 is_reverse=False, h0=None, c0=None):
    """input: [B,T,4H] pre-projected gates (reference dynamic_lstm's
    fc-then-lstm split). Returns (hidden [B,T,H], cell [B,T,H])."""
    h = size
    w = _create_param(param_attr, (h, 4 * h), input.dtype,
                      init_mod.Xavier())
    ins = {"Input": [input], "Weight": [w]}
    if bias_attr is not False:
        ins["Bias"] = [_create_param(bias_attr, (4 * h,), input.dtype,
                                     init_mod.Constant(0.0))]
    if mask is not None:
        ins["Mask"] = [mask]
    if h0 is not None:
        ins["H0"] = [h0]
    if c0 is not None:
        ins["C0"] = [c0]
    b, t = input.shape[0], input.shape[1]
    hid = _tmp((b, t, h), input.dtype, "lstm_h")
    cell = _tmp((b, t, h), input.dtype, "lstm_c")
    _block().append_op("lstm", inputs=ins,
                       outputs={"Hidden": [hid], "Cell": [cell]},
                       attrs={"is_reverse": is_reverse})
    return hid, cell


def dynamic_lstmp(input, size, proj_size, mask=None, param_attr=None,
                  bias_attr=None):
    """LSTM with projection (reference: dynamic_lstmp / lstmp_op.cc)."""
    h, p = size, proj_size
    w = _create_param(param_attr, (p, 4 * h), input.dtype,
                      init_mod.Xavier())
    wp = _create_param(param_attr, (h, p), input.dtype, init_mod.Xavier())
    ins = {"Input": [input], "Weight": [w], "ProjWeight": [wp]}
    if bias_attr is not False:
        ins["Bias"] = [_create_param(bias_attr, (4 * h,), input.dtype,
                                     init_mod.Constant(0.0))]
    if mask is not None:
        ins["Mask"] = [mask]
    b, t = input.shape[0], input.shape[1]
    proj = _tmp((b, t, p), input.dtype, "lstmp_r")
    cell = _tmp((b, t, h), input.dtype, "lstmp_c")
    _block().append_op("lstmp", inputs=ins,
                       outputs={"Projection": [proj], "Cell": [cell]})
    return proj, cell


def dynamic_gru(input, size, mask=None, param_attr=None, bias_attr=None,
                is_reverse=False, h0=None):
    """input: [B,T,3H] pre-projected gates (reference: dynamic_gru)."""
    h = size
    w = _create_param(param_attr, (h, 3 * h), input.dtype,
                      init_mod.Xavier())
    ins = {"Input": [input], "Weight": [w]}
    if bias_attr is not False:
        ins["Bias"] = [_create_param(bias_attr, (3 * h,), input.dtype,
                                     init_mod.Constant(0.0))]
    if mask is not None:
        ins["Mask"] = [mask]
    if h0 is not None:
        ins["H0"] = [h0]
    b, t = input.shape[0], input.shape[1]
    hid = _tmp((b, t, h), input.dtype, "gru_h")
    _block().append_op("gru", inputs=ins, outputs={"Hidden": [hid]},
                       attrs={"is_reverse": is_reverse})
    return hid


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None):
    h = size
    w = _create_param(param_attr, (h, 3 * h), input.dtype,
                      init_mod.Xavier())
    ins = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if bias_attr is not False:
        ins["Bias"] = [_create_param(bias_attr, (3 * h,), input.dtype,
                                     init_mod.Constant(0.0))]
    b = input.shape[0]
    gate = _tmp((b, 3 * h), input.dtype, "gru_gate")
    rhp = _tmp((b, h), input.dtype, "gru_rhp")
    hid = _tmp((b, h), input.dtype, "gru_hid")
    _block().append_op("gru_unit", inputs=ins,
                       outputs={"Gate": [gate], "ResetHiddenPrev": [rhp],
                                "Hidden": [hid]})
    return hid, rhp, gate


def sequence_concat(x, y, x_len=None, y_len=None):
    b, tx = x.shape[0], x.shape[1]
    ty = y.shape[1]
    out = _tmp((b, tx + ty) + tuple(x.shape[2:]), x.dtype, "seqcat")
    olen = _tmp((b,), "int32", "seqcat_len")
    _block().append_op("sequence_concat",
                       inputs={k: v for k, v in
                               {"X": [x], "Y": [y],
                                "XLen": [x_len] if x_len else None,
                                "YLen": [y_len] if y_len else None}.items()
                               if v},
                       outputs={"Out": [out], "OutLen": [olen]})
    return out


def sequence_erase(x, tokens, x_len=None):
    ins = {"X": [x]}
    if x_len is not None:
        ins["XLen"] = [x_len]
    out = _tmp(x.shape, x.dtype, "seqerase")
    olen = _tmp((x.shape[0],), "int32", "seqerase_len")
    _block().append_op("sequence_erase", inputs=ins,
                       outputs={"Out": [out], "OutLen": [olen]},
                       attrs={"tokens": list(tokens)})
    return out


def sequence_slice(input, offset, length):
    return _simple_call("sequence_slice", {"X": [input], "Offset": [offset],
                                           "Length": [length]})


def sequence_reshape(input, new_dim):
    b, t, d = input.shape
    return _simple_call("sequence_reshape", {"X": [input]},
                        {"new_dim": new_dim},
                        out_shape=(b, t * d // new_dim, new_dim))


def sequence_conv(input, num_filters, filter_size=3, context_start=None,
                  param_attr=None, act=None):
    d = input.shape[-1]
    filt = _create_param(param_attr, (filter_size * d, num_filters),
                         input.dtype, init_mod.Xavier())
    out = _simple_call("sequence_conv", {"X": [input], "Filter": [filt]},
                       {"context_length": filter_size,
                        "context_start": (context_start
                                          if context_start is not None
                                          else -(filter_size // 2))},
                       out_shape=tuple(input.shape[:2]) + (num_filters,))
    return _apply_act(out, act)


def lod_reset(x, y=None):
    return _simple_call("lod_reset", {"X": [x], "Y": [y]})


def warpctc(input, label, input_length=None, label_length=None, blank=0,
            norm_by_times=False):
    ins = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        ins["LogitsLength"] = [input_length]
    if label_length is not None:
        ins["LabelLength"] = [label_length]
    loss = _tmp((input.shape[0], 1), input.dtype, "ctc")
    _block().append_op("warpctc", inputs=ins, outputs={"Loss": [loss]},
                       attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, input_length=None):
    """argmax per step then ctc_align (reference: fluid ctc path)."""
    ids = topk(input, 1)[1]
    ids = reshape(ids, list(input.shape[:2]))
    ins = {"Input": [ids]}
    if input_length is not None:
        ins["InputLength"] = [input_length]
    out = _tmp(ids.shape, ids.dtype, "ctcalign")
    olen = _tmp((ids.shape[0],), "int32", "ctcalign_len")
    _block().append_op("ctc_align", inputs=ins,
                       outputs={"Output": [out], "OutputLength": [olen]},
                       attrs={"blank": blank})
    return out, olen


def edit_distance(input, label, normalized=False, input_length=None,
                  label_length=None):
    ins = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        ins["HypsLength"] = [input_length]
    if label_length is not None:
        ins["RefsLength"] = [label_length]
    out = _tmp((input.shape[0], 1), "float32", "editdist")
    num = _tmp((), "float32", "editdist_n")
    _block().append_op("edit_distance", inputs=ins,
                       outputs={"Out": [out], "SequenceNum": [num]},
                       attrs={"normalized": normalized})
    return out, num


# detection
def iou_similarity(x, y):
    return _simple_call("iou_similarity", {"X": [x], "Y": [y]},
                        out_shape=(x.shape[0], y.shape[0]))


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size"):
    return _simple_call("box_coder",
                        {"PriorBox": [prior_box],
                         "PriorBoxVar": [prior_box_var],
                         "TargetBox": [target_box]},
                        {"code_type": code_type},
                        out_shape=target_box.shape)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, clip=True, steps=None, offset=0.5):
    ars = aspect_ratios or [1.0]
    n_per_cell = (len(min_sizes) * len(ars)
                  + min(len(max_sizes or []), len(min_sizes)))
    n = input.shape[1] * input.shape[2] * n_per_cell
    boxes = _tmp((n, 4), "float32", "priorbox")
    var = _tmp((n, 4), "float32", "priorbox_var")
    _block().append_op("prior_box",
                       inputs={"Input": [input], "Image": [image]},
                       outputs={"Boxes": [boxes], "Variances": [var]},
                       attrs={"min_sizes": list(min_sizes),
                              "max_sizes": list(max_sizes or []),
                              "aspect_ratios": list(ars),
                              "variances": list(variance or
                                                [0.1, 0.1, 0.2, 0.2]),
                              "clip": clip,
                              "step_w": (steps or [0, 0])[0],
                              "step_h": (steps or [0, 0])[1],
                              "offset": offset})
    return boxes, var


def bipartite_match(dist_matrix, match_type=None, dist_threshold=0.5):
    r, c = dist_matrix.shape
    idx = _tmp((c,), "int32", "bimatch_idx")
    d = _tmp((c,), dist_matrix.dtype, "bimatch_d")
    _block().append_op("bipartite_match", inputs={"DistMat": [dist_matrix]},
                       outputs={"ColToRowMatchIndices": [idx],
                                "ColToRowMatchDist": [d]},
                       attrs={"match_type": match_type or "bipartite",
                              "dist_threshold": dist_threshold})
    return idx, d


def target_assign(x, match_indices, negative_indices=None,
                  mismatch_value=0):
    ins = {"X": [x], "MatchIndices": [match_indices]}
    if negative_indices is not None:
        ins["NegIndices"] = [negative_indices]
    p = match_indices.shape[0]
    out = _tmp((p,) + tuple(x.shape[1:]), x.dtype, "tassign")
    w = _tmp((p, 1), "float32", "tassign_w")
    _block().append_op("target_assign", inputs=ins,
                       outputs={"Out": [out], "OutWeight": [w]},
                       attrs={"mismatch_value": mismatch_value})
    return out, w


def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio=3.0):
    neg = _tmp(match_indices.shape, "int32", "hardneg")
    upd = _tmp(match_indices.shape, "int32", "hardneg_upd")
    _block().append_op("mine_hard_examples",
                       inputs={"ClsLoss": [cls_loss],
                               "MatchIndices": [match_indices]},
                       outputs={"NegIndices": [neg],
                                "UpdatedMatchIndices": [upd]},
                       attrs={"neg_pos_ratio": neg_pos_ratio})
    return neg, upd


def multiclass_nms(bboxes, scores, score_threshold=0.01, nms_threshold=0.45,
                   nms_top_k=64, keep_top_k=100, background_label=0):
    return _simple_call("multiclass_nms",
                        {"BBoxes": [bboxes], "Scores": [scores]},
                        {"score_threshold": score_threshold,
                         "nms_threshold": nms_threshold,
                         "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                         "background_label": background_label},
                        out_shape=(keep_top_k, 6))


def auc(input, label, num_thresholds=200):
    return _simple_call("auc", {"Out": [input], "Label": [label]},
                        {"num_thresholds": num_thresholds}, out_shape=())


def precision_recall(max_probs, indices, labels, class_number):
    return _simple_call("precision_recall",
                        {"MaxProbs": [max_probs], "Indices": [indices],
                         "Labels": [labels]},
                        {"class_number": class_number},
                        out_slots=("BatchMetrics",), out_shape=(6,))


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """directly create a trainable parameter (reference:
    fluid/layers/tensor.py create_parameter)."""
    attr = ParamAttr.to_attr(attr)
    if name and not attr.name:
        attr.name = name
    return _create_param(
        attr, tuple(shape), dtype,
        default_initializer or (init_mod.Constant(0.0) if is_bias
                                else init_mod.Xavier()))


def get_places(device_count=None, device_type=None):
    """reference: fluid/layers/device.py get_places: the devices a program
    can run on (the cards, or the host for ``device_type="CPU"``)."""
    import torch
    if device_type is not None and device_type.upper() == "CPU":
        devs = [torch.device("cpu")]
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return devs[:device_count] if device_count else devs


def linear_chain_crf(input, label, param_attr=None, length=None):
    c = input.shape[-1]
    w = _create_param(param_attr, (c + 2, c), input.dtype,
                      init_mod.Uniform(-0.1, 0.1))
    ins = {"Emission": [input], "Transition": [w], "Label": [label]}
    if length is not None:
        ins["Length"] = [length]
    ll = _tmp((input.shape[0], 1), input.dtype, "crf_ll")
    _block().append_op("linear_chain_crf", inputs=ins,
                       outputs={"LogLikelihood": [ll]})
    ll.transition_param = w
    return ll


def crf_decoding(input, param_attr=None, transition=None, label=None,
                 length=None):
    """viterbi decode; pass transition= the linear_chain_crf output's
    .transition_param to share learned transitions (the reference shares
    by parameter name)."""
    if transition is None:
        c = input.shape[-1]
        transition = _create_param(param_attr, (c + 2, c), input.dtype,
                                   init_mod.Uniform(-0.1, 0.1))
    ins = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        ins["Label"] = [label]
    if length is not None:
        ins["Length"] = [length]
    path = _tmp(tuple(input.shape[:2]), "int32", "viterbi")
    _block().append_op("crf_decoding", inputs=ins,
                       outputs={"ViterbiPath": [path]})
    return path


def chunk_eval(input, label, chunk_scheme="IOB", num_chunk_types=1,
               seq_length=None):
    ins = {"Inference": [input], "Label": [label]}
    if seq_length is not None:
        ins["Length"] = [seq_length]
    outs = {}
    names = ["Precision", "Recall", "F1-Score", "NumInferChunks",
             "NumLabelChunks", "NumCorrectChunks"]
    vars_ = []
    for n in names:
        dt = "float32" if n in names[:3] else "int32"
        v = _tmp((), dt, "chunk_" + n.lower().replace("-", ""))
        outs[n] = [v]
        vars_.append(v)
    _block().append_op("chunk_eval", inputs=ins, outputs=outs,
                       attrs={"chunk_scheme": chunk_scheme,
                              "num_chunk_types": num_chunk_types})
    return tuple(vars_)


def nce(input, label, num_total_classes, num_neg_samples=10,
        param_attr=None, bias_attr=None):
    d = input.shape[-1]
    w = _create_param(param_attr, (num_total_classes, d), input.dtype,
                      init_mod.Xavier())
    ins = {"Input": [input], "Label": [label], "Weight": [w]}
    if bias_attr is not False:
        ins["Bias"] = [_create_param(bias_attr, (num_total_classes,),
                                     input.dtype, init_mod.Constant(0.0))]
    cost = _tmp((input.shape[0], 1), input.dtype, "nce")
    _block().append_op("nce", inputs=ins, outputs={"Cost": [cost]},
                       attrs={"num_neg_samples": num_neg_samples})
    return cost


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id=1):
    b = pre_ids.shape[0]
    sel_ids = _tmp((b, beam_size), "int32", "beam_ids")
    sel_sc = _tmp((b, beam_size), "float32", "beam_sc")
    parent = _tmp((b, beam_size), "int32", "beam_parent")
    _block().append_op("beam_search",
                       inputs={"pre_ids": [pre_ids],
                               "pre_scores": [pre_scores],
                               "scores": [scores]},
                       outputs={"selected_ids": [sel_ids],
                                "selected_scores": [sel_sc],
                                "parent_idx": [parent]},
                       attrs={"end_id": end_id, "beam_size": beam_size})
    return sel_ids, sel_sc, parent


def beam_search_decode(ids, parents, scores, beam_size=None, end_id=1):
    t, b, k = ids.shape
    sent = _tmp((b, k, t), "int32", "beam_sent")
    ssc = _tmp((b, k), "float32", "beam_ssc")
    _block().append_op("beam_search_decode",
                       inputs={"Ids": [ids], "Parents": [parents],
                               "Scores": [scores]},
                       outputs={"SentenceIds": [sent],
                                "SentenceScores": [ssc]},
                       attrs={"end_id": end_id})
    return sent, ssc


def detection_output(loc, scores, prior_box=None, prior_box_var=None,
                     background_label=0, nms_threshold=0.45,
                     nms_top_k=64, keep_top_k=100, score_threshold=0.01):
    """decode loc deltas against priors then multiclass NMS (reference:
    fluid/layers/detection.py detection_output)."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    return multiclass_nms(decoded, scores,
                          score_threshold=score_threshold,
                          nms_threshold=nms_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          background_label=background_label)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, loc_loss_weight=1.0, conf_loss_weight=1.0):
    """SSD multibox loss composed from the detection ops (reference:
    fluid/layers/detection.py ssd_loss = iou → bipartite_match →
    target_assign → mined softmax conf + smooth-L1 loc). Single-image
    tensors (the v2 multibox_loss layer handles the batched path)."""
    iou = iou_similarity(gt_box, prior_box)
    match, _dist = bipartite_match(iou, match_type="per_prediction",
                                   dist_threshold=overlap_threshold)
    # loc loss on matched priors
    enc_gt, loc_w = target_assign(gt_box, match)
    enc_tgt = box_coder(prior_box, prior_box_var, enc_gt)
    loc_l = reduce_sum(
        elementwise_mul(reduce_sum(smooth_l1(location, enc_tgt), dim=1),
                        reshape(loc_w, [loc_w.shape[0]])))
    # conf loss with hard negative mining
    lab_tgt, _w = target_assign(gt_label, match,
                                mismatch_value=background_label)
    conf_all = softmax_with_cross_entropy(
        confidence, cast(lab_tgt, "int32"))
    neg, upd = mine_hard_examples(transpose(conf_all, [1, 0]),
                                  reshape(match, [1, match.shape[0]]),
                                  neg_pos_ratio=neg_pos_ratio)
    pos_mask = cast(greater_equal(match, fill_constant([], "int32", 0)),
                    "float32")
    sel_neg = cast(greater_equal(reshape(neg, [match.shape[0]]),
                                 fill_constant([], "int32", 0)), "float32")
    conf_w = elementwise_add(pos_mask, sel_neg)
    conf_l = reduce_sum(elementwise_mul(reshape(conf_all,
                                                [match.shape[0]]), conf_w))
    return elementwise_add(scale(loc_l, scale=loc_loss_weight),
                           scale(conf_l, scale=conf_loss_weight))


def Print(input, message=None, summarize=20, first_n=-1):
    """debug print op (reference: fluid/layers/control_flow.py Print);
    prints at execution, passes the value through."""
    out = _tmp(input.shape, input.dtype, "print")
    _block().append_op("print", inputs={"X": [input]},
                       outputs={"Out": [out]},
                       attrs={"message": message or "", 
                              "summarize": summarize})
    return out


# --------------------------------------------------------------------------
# LoD-machinery functional equivalents (reference: control_flow.py /
# lod_rank_table_op.cc etc.). Padded batches store lengths separately, so
# these become plain tensor ops on [B] length vectors.
# --------------------------------------------------------------------------

def max_sequence_len(lens):
    return reduce_max(lens, dim=0)


def lod_rank_table(lens, level=0):
    """sequence indices sorted by length desc (reference lod_rank_table;
    used to re-bucket batches for DynamicRNN)."""
    return _simple_call("lod_rank_table", {"X": [lens]},
                        out_shape=lens.shape, out_dtype="int32")


def reorder_lod_tensor_by_rank(x, rank_table):
    return gather(x, rank_table)


def split_lod_tensor(input, mask):
    """rows where mask → (true_branch, false_branch) copies; padded-batch
    equivalent of the reference's row split (both outputs stay [B,...],
    with non-selected rows zeroed)."""
    m = cast(mask, "float32")
    mt = reshape(m, [input.shape[0]] + [1] * (len(input.shape) - 1))
    t = elementwise_mul(input, expand(mt, [1] + list(input.shape[1:])))
    inv = elementwise_sub(fill_constant([1], "float32", 1.0), m)
    it = reshape(inv, [input.shape[0]] + [1] * (len(input.shape) - 1))
    f = elementwise_mul(input, expand(it, [1] + list(input.shape[1:])))
    return t, f


def where_select(cond, x, y):
    """elementwise select (rows of x where cond else y) — NaN-safe, unlike
    arithmetic blends: the unselected branch's NaN/Inf must not leak
    (reference splits rows so the other branch never sees them)."""
    out = _tmp(x.shape, x.dtype, "where")
    _block().append_op("where", inputs={"Cond": [cond], "X": [x],
                                        "Y": [y]},
                       outputs={"Out": [out]})
    return out


def merge_lod_tensor(in_true, in_false, mask):
    """rows from in_true where mask else in_false (reference
    merge_lod_tensor_op)."""
    m = cast(mask, "bool")
    mt = reshape(m, [in_true.shape[0]] + [1] * (len(in_true.shape) - 1))
    return where_select(mt, in_true, in_false)


def shrink_memory(x, i, table):
    """reference shrink_rnn_memory drops finished rows mid-scan; masked
    padded batches keep static shapes, so this is the identity."""
    return x


def lod_tensor_to_array(x, table=None):
    """[B,T,...] → time-major [T,B,...] steps array (reference
    lod_tensor_to_array feeds DynamicRNN). Arrays here are dense
    time-major tensors, so this is one transpose; array_read(arr, i)
    yields step i."""
    perm = [1, 0] + list(range(2, len(x.shape)))
    return transpose(x, perm)


def array_to_lod_tensor(arr, table=None):
    """inverse of lod_tensor_to_array: [T,B,...] steps → [B,T,...]
    (padded batches carry no LoD to restore — one transpose)."""
    perm = [1, 0] + list(range(2, len(arr.shape)))
    return transpose(arr, perm)


# distributed program rewrite ops: the JAX package runs one program
# sharded over a mesh instead (``Executor(mesh=)``), ROADMAP.md section 1,
# item 14 in the port
def Send(*a, **k):
    raise NotImplementedError(
        "fluid Send/Recv pserver path is replaced by SPMD execution of one "
        "program over a mesh, which is not ported to paddle_tpu_torch yet "
        "(ROADMAP.md section 1, item 14)")


ListenAndServ = Send


def im2sequence(input, filter_size=1, stride=1, padding=0):
    """NCHW image → patch-sequence rows (reference: layers im2sequence)."""
    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size, filter_size]
    s = stride if isinstance(stride, (list, tuple)) else [stride, stride]
    p = list(padding) if isinstance(padding, (list, tuple)) \
        else [padding, padding]
    if len(p) == 2:
        p = [p[0], p[1], p[0], p[1]]     # reference: up,left,down,right
    b, c, h, w = input.shape
    oh = (h + p[0] + p[2] - k[0]) // s[0] + 1
    ow = (w + p[1] + p[3] - k[1]) // s[1] + 1
    return _simple_call("im2sequence", {"X": [input]},
                        {"kernels": list(k), "strides": list(s),
                         "paddings": list(p)},
                        out_shape=(b, oh * ow, c * k[0] * k[1]))


def spp(input, pyramid_height=3, pool_type="max"):
    b, c = input.shape[0], input.shape[1]
    n = sum(4 ** lv for lv in range(pyramid_height))
    return _simple_call("spp", {"X": [input]},
                        {"pyramid_height": pyramid_height,
                         "pooling_type": pool_type},
                        out_shape=(b, c * n))


def max_pool2d_with_index(input, pool_size, pool_stride=None):
    k = pool_size if isinstance(pool_size, (list, tuple)) \
        else [pool_size, pool_size]
    s = (pool_stride if isinstance(pool_stride, (list, tuple))
         else [pool_stride, pool_stride]) if pool_stride else k
    b, c, h, w = input.shape
    oh = (h - k[0]) // s[0] + 1
    ow = (w - k[1]) // s[1] + 1
    out = _tmp((b, c, oh, ow), input.dtype, "maxpool_idx")
    mask = _tmp((b, c, oh, ow), "int32", "maxpool_mask")
    _block().append_op("max_pool2d_with_index", inputs={"X": [input]},
                       outputs={"Out": [out], "Mask": [mask]},
                       attrs={"ksize": list(k), "strides": list(s)})
    return out, mask


def unpool(input, indices, unpool_size):
    u = unpool_size if isinstance(unpool_size, (list, tuple)) \
        else [unpool_size, unpool_size]
    b, c = input.shape[0], input.shape[1]
    return _simple_call("unpool", {"X": [input], "Indices": [indices]},
                        {"unpool_size": list(u)},
                        out_shape=(b, c, u[0], u[1]))


def positive_negative_pair(score, label, query_id):
    outs = {}
    vars_ = []
    for nme in ("PositivePair", "NegativePair", "NeutralPair"):
        v = _tmp((1,), "float32", nme.lower())
        outs[nme] = [v]
        vars_.append(v)
    _block().append_op("positive_negative_pair",
                       inputs={"Score": [score], "Label": [label],
                               "QueryID": [query_id]},
                       outputs=outs)
    return tuple(vars_)


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    """ROI max pooling (reference: roi_pool_op.cc / layers/nn.py roi_pool).
    input [B,H,W,C] NHWC, rois [R,5] = (batch_idx, x1,y1,x2,y2)."""
    r = rois.shape[0]
    c = input.shape[-1]
    out = _tmp((r, pooled_height, pooled_width, c), input.dtype, "roi_pool")
    am = _tmp((r, pooled_height, pooled_width, c), "int32", "roi_argmax")
    _block().append_op("roi_pool", inputs={"X": [input], "ROIs": [rois]},
                       outputs={"Out": [out], "Argmax": [am]},
                       attrs={"pooled_height": pooled_height,
                              "pooled_width": pooled_width,
                              "spatial_scale": spatial_scale})
    return out


def detection_map(detect_res, label, class_num, overlap_threshold=0.5,
                  ap_version="11point"):
    """single-batch mAP (reference: detection_map_op.cc)."""
    return _simple_call("detection_map",
                        {"DetectRes": [detect_res], "Label": [label]},
                        {"overlap_threshold": overlap_threshold,
                         "ap_type": ap_version, "class_num": class_num},
                        out_shape=(1,), out_dtype="float32")


def shrink_memory(x, i, table_or_lens):
    """freeze finished rows at dynamic-RNN step i (reference:
    shrink_rnn_memory_op.cc; see the op docstring for the static-shape
    mask design). table_or_lens: the [B] sequence-length vector."""
    return _simple_call("shrink_rnn_memory",
                        {"X": [x], "Lens": [table_or_lens], "I": [i]},
                        out_shape=x.shape)


def lod_tensor_to_array(x, table=None):
    """[B,T,...] -> time-major [T,B,...] step array (reference:
    lod_tensor_to_array_op.cc; the rank table argument is accepted for
    API parity and unused — padded batch rows ride along)."""
    shape = (x.shape[1], x.shape[0]) + tuple(x.shape[2:])
    return _simple_call("lod_tensor_to_array", {"X": [x]},
                        out_shape=shape)


def array_to_lod_tensor(x, table=None):
    """inverse of lod_tensor_to_array (array_to_lod_tensor_op.cc)."""
    shape = (x.shape[1], x.shape[0]) + tuple(x.shape[2:])
    return _simple_call("array_to_lod_tensor", {"X": [x]},
                        out_shape=shape)


def split_selected_rows(ids, values, height_sections):
    """route sparse rows to height sections (reference:
    split_selected_rows_op.cc; (ids, values) is the repo's static
    SelectedRows stand-in: ids [N] row indices, values [N, ...]).
    Returns ([ids_k], [values_k])."""
    n = 1
    for d in ids.shape:
        n *= d
    if values.shape[0] != n:
        raise ValueError(
            f"split_selected_rows: values rows {values.shape[0]} != ids "
            f"count {n}")
    id_vars = [_tmp((n,), "int32", "split_rows_ids")
               for _ in height_sections]
    val_vars = [_tmp(values.shape, values.dtype, "split_rows_vals")
                for _ in height_sections]
    _block().append_op("split_selected_rows",
                       inputs={"Ids": [ids], "Values": [values]},
                       outputs={"OutIds": id_vars, "OutValues": val_vars},
                       attrs={"height_sections": list(height_sections)})
    return id_vars, val_vars
