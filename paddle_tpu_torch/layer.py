"""The layer DSL: the user-facing graph construction functions the ported
layers need (counterpart of ``paddle_tpu/layer.py``).

Each function returns a ``LayerOutput``; ``Topology(cost)`` recovers the
graph by walking parents.  Same arguments, attributes and default names as
the JAX package, so both write byte-equal JSON for the same config, and
each ported entry also answers to its legacy ``*_layer`` name.  The rest
of the catalog (detection, CRF/CTC, the misc math layers) comes with
later slices.
"""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch import pooling as pool_mod
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.core.ir import LayerOutput
from paddle_tpu_torch.data_type import DataKind, InputType, SeqType
from paddle_tpu_torch.layers.rnn_group import (GeneratedInput, StaticInput,
                                               SubsequenceInput, beam_search,
                                               memory, recurrent_group)

__all__ = [
    "data", "fc", "embedding", "dropout", "concat", "addto", "mixed",
    "full_matrix_projection", "trans_full_matrix_projection",
    "identity_projection", "dotmul_projection", "table_projection",
    "scaling_projection", "slice_projection", "conv_projection",
    "conv_operator", "dotmul_operator",
    "slice", "layer_norm", "data_norm",
    "pooling", "first_seq", "last_seq", "expand", "seq_concat",
    "seq_reshape", "context_projection", "seq_slice", "kmax_seq_score",
    "seq_softmax", "seq_scale", "seq_dot", "sub_seq", "sub_nested_seq",
    "recurrent", "lstmemory", "grumemory", "bigru", "mdlstmemory",
    "recurrent_group",
    "memory", "beam_search", "StaticInput", "GeneratedInput",
    "SubsequenceInput", "gru_step_layer", "lstm_step_layer",
    "classification_cost", "lm_head_cost", "cross_entropy_cost",
    "square_error_cost", "mse_cost", "rank_cost", "hinge_cost",
    "log_loss", "multi_binary_label_cross_entropy_cost", "smooth_l1_cost",
    "huber_classification_cost", "sum_cost", "nce_cost", "hsigmoid",
    "lambda_cost", "huber_regression_cost", "cross_entropy_with_selfnorm",
    "BeamInput", "cross_entropy_over_beam",
    "cos_sim", "dot_prod", "scaling", "slope_intercept", "interpolation",
    "bilinear_tensor_product", "trans", "reshape", "activation",
    "row_l2_norm",
    "position_embedding", "bahdanau_attention", "multi_head_attention",
    "img_conv", "img_pool", "global_pool", "batch_norm", "img_cmrnorm",
    "img_conv_transpose", "maxout", "bilinear_interp", "pad", "crop", "spp",
    "img_conv3d", "img_conv3d_transpose", "img_pool3d",
]


def _norm_inputs(input) -> list:
    if isinstance(input, LayerOutput):
        return [input]
    return list(input)


def _attrs_from(param_attr: Optional[ParamAttr], bias_attr, layer_attr,
                extra: dict) -> dict:
    attrs = dict(extra)
    if isinstance(param_attr, ParamAttr):
        if param_attr.initializer is not None:
            attrs["param_initializer"] = param_attr.initializer
        attrs["param_lr"] = param_attr.learning_rate
        attrs["param_l2"] = param_attr.l2_rate
        attrs["param_static"] = param_attr.is_static
        if param_attr.sparse_update:
            attrs["param_sparse"] = True
    if bias_attr is False:
        attrs["bias"] = False
    elif isinstance(bias_attr, ParamAttr):
        attrs["bias"] = True
        if bias_attr.initializer is not None:
            attrs["bias_initializer"] = bias_attr.initializer
        attrs["bias_lr"] = bias_attr.learning_rate
    if isinstance(layer_attr, ExtraAttr) and layer_attr.drop_rate > 0:
        attrs["drop_rate"] = layer_attr.drop_rate
    return attrs


def data(name: str, type: InputType, height=None, width=None):
    """Declare a feed slot (reference: data_layer).  Image data (height and
    width) is stored NHWC."""
    if type.kind in (DataKind.SPARSE_BINARY, DataKind.SPARSE_FLOAT) \
            and type.seq_type != SeqType.NO_SEQUENCE:
        raise ValueError(
            "sparse *sequence* inputs are not supported on the feed path; "
            "feed per-step sparse features as an integer_value_sequence "
            "of ids plus a dense value sequence instead")
    if height and width:
        c = type.dim // (height * width)
        shape = (height, width, c)
    elif type.kind == DataKind.INDEX:
        shape = ()
    else:
        shape = (type.dim,)
    return LayerOutput(
        "data", [],
        {"shape": list(shape),
         "seq_type": type.seq_type,
         "max_len": type.max_len,
         "sub_max": getattr(type, "sub_max", 0),
         "is_index": type.kind == DataKind.INDEX,
         "sparse_kind": (type.kind if type.kind in
                         (DataKind.SPARSE_BINARY, DataKind.SPARSE_FLOAT)
                         else None),
         "nnz": type.nnz,
         "dim": type.dim},
        name=name, size=type.dim)


def fc(input, size: int, act=None, name=None, param_attr=None,
       bias_attr=None, layer_attr=None, share_from=None):
    """share_from: name of another fc layer whose weights to reuse."""
    inputs = _norm_inputs(input)
    attrs = _attrs_from(param_attr, bias_attr, layer_attr,
                        {"size": size, "act": act_mod.resolve(act),
                         "share_from": share_from})
    out = LayerOutput("fc", inputs, attrs, name=name, size=size)
    if attrs.get("drop_rate"):
        out = dropout(out, attrs["drop_rate"])
    return out


def embedding(input, size: int, vocab_size: Optional[int] = None,
              name=None, param_attr=None, share_from: Optional[str] = None):
    """share_from: name of another embedding layer whose table to reuse."""
    inputs = _norm_inputs(input)
    vocab = vocab_size or inputs[0].size
    attrs = _attrs_from(param_attr, False, None,
                        {"size": size, "vocab_size": vocab,
                         "share_from": share_from})
    return LayerOutput("embedding", inputs, attrs, name=name, size=size)


def dropout(input, rate: float = 0.5, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("dropout", inputs, {"rate": rate}, name=name,
                       size=inputs[0].size)


def concat(input, act=None, axis: int = -1, name=None):
    """concat along a per-sample axis (the feature axis by default)."""
    inputs = _norm_inputs(input)
    return LayerOutput("concat", inputs,
                       {"act": act_mod.resolve(act), "axis": axis},
                       name=name,
                       size=sum(i.size or 0 for i in inputs) or None)


def addto(input, act=None, bias_attr=False, name=None):
    inputs = _norm_inputs(input)
    attrs = _attrs_from(None, bias_attr, None, {"act": act_mod.resolve(act)})
    return LayerOutput("addto", inputs, attrs, name=name,
                       size=inputs[0].size)


# -------------------------------------------------------- mixed/projections
def full_matrix_projection(input, size=0, param_attr=None):
    return ({"type": "full_matrix"}, input)


def trans_full_matrix_projection(input, size=0, param_attr=None):
    return ({"type": "trans_full_matrix"}, input)


def identity_projection(input, offset=None, size=None):
    if offset is not None:
        return ({"type": "slice", "start": offset,
                 "end": offset + (size or input.size)}, input)
    return ({"type": "identity"}, input)


def dotmul_projection(input, param_attr=None):
    return ({"type": "dotmul"}, input)


def scaling_projection(input, param_attr=None):
    return ({"type": "scaling"}, input)


def table_projection(input, size=0, vocab_size=None, param_attr=None):
    return ({"type": "table", "vocab_size": vocab_size or input.size}, input)


def slice_projection(input, slices):
    (start, end), = slices
    return ({"type": "slice", "start": start, "end": end}, input)


def conv_projection(input, filter_size, num_filters, stride=1, padding=0,
                    groups=1, param_attr=None, trans=False):
    """convolution as a mixed-layer projection (``trans``: the transposed
    conv); the output is the flattened NHWC feature map."""
    return ({"type": "conv_trans" if trans else "conv",
             "filter_size": filter_size,
             "num_filters": num_filters, "stride": stride,
             "padding": padding, "groups": groups}, input)


def conv_operator(img, filter, filter_size, num_filters, num_channels=None,
                  stride=1, padding=0):
    """per-sample convolution whose weights come from another layer (its
    row is the (num_filters, channels * kh * kw) weight); num_channels is
    read from the image layer when it can be."""
    if num_channels is None:
        shape = img.attrs.get("shape")
        if img.attrs.get("num_filters"):
            num_channels = img.attrs["num_filters"]
        elif shape and len(shape) == 3:
            num_channels = shape[-1]          # NHWC data layer
        else:
            raise ValueError(
                "conv_operator: pass num_channels explicitly (cannot infer "
                f"it from input layer {img.name!r})")
    return ({"type": "conv_op", "filter_size": filter_size,
             "num_filters": num_filters, "num_channels": num_channels,
             "stride": stride, "padding": padding}, (img, filter))


def dotmul_operator(a, b, scale=1.0):
    """elementwise a * b into the mixed sum."""
    return ({"type": "dotmul_op", "scale": scale}, (a, b))


def mixed(size: int, input, act=None, bias_attr=False, name=None):
    """mixed_layer: the sum of projections and operators (operators take
    two inputs each)."""
    projs, inputs = [], []
    for proj, inp in input:
        projs.append(proj)
        inputs.extend(inp if isinstance(inp, tuple) else (inp,))
    attrs = _attrs_from(None, bias_attr, None,
                        {"size": size, "act": act_mod.resolve(act),
                         "projections": projs})
    return LayerOutput("mixed", inputs, attrs, name=name, size=size)


def layer_norm(input, epsilon=1e-5, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("layer_norm", inputs, {"epsilon": epsilon},
                       name=name, size=inputs[0].size)


def slice(input, start, end, name=None):
    """features [start, end) of the last axis."""
    return LayerOutput("slice", _norm_inputs(input),
                       {"start": start, "end": end}, name=name,
                       size=end - start)


def data_norm(input, data_norm_strategy="z-score", name=None):
    """normalise features by precomputed statistics held in one static
    (5, size) parameter ``<name>.stats`` (z-score | min-max |
    decimal-scaling)."""
    inputs = _norm_inputs(input)
    return LayerOutput("data_norm", inputs,
                       {"data_norm_strategy": data_norm_strategy},
                       name=name, size=inputs[0].size)


# -------------------------------------------------------------------- image
def img_conv(input, filter_size, num_filters, stride=1, padding=0, groups=1,
             dilation=1, act=None, bias_attr=None, param_attr=None,
             name=None, num_channels=None):
    """2-D convolution over NHWC images with an HWIO kernel."""
    inputs = _norm_inputs(input)
    attrs = _attrs_from(param_attr, bias_attr, None, {
        "filter_size": filter_size, "num_filters": num_filters,
        "stride": stride, "padding": padding, "groups": groups,
        "dilation": dilation, "act": act_mod.resolve(act)})
    return LayerOutput("conv", inputs, attrs, name=name, size=num_filters)


def img_conv_transpose(input, filter_size, num_filters, stride=1, padding=0,
                       act=None, bias_attr=None, param_attr=None, name=None):
    """Transposed 2-D convolution over NHWC images (HWIO kernel)."""
    inputs = _norm_inputs(input)
    attrs = _attrs_from(param_attr, bias_attr, None, {
        "filter_size": filter_size, "num_filters": num_filters,
        "stride": stride, "padding": padding, "act": act_mod.resolve(act)})
    return LayerOutput("conv_transpose", inputs, attrs, name=name,
                       size=num_filters)


def img_pool(input, pool_size, stride=None, padding=0, pool_type=None,
             ceil_mode=True, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("pool", inputs, {
        "pool_size": pool_size, "stride": stride or pool_size,
        "padding": padding, "pool_type": pool_mod.resolve(pool_type),
        "ceil_mode": ceil_mode}, name=name, size=inputs[0].size)


def global_pool(input, pool_type="avg", name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("global_pool", inputs, {"pool_type": pool_type},
                       name=name, size=inputs[0].size)


def batch_norm(input, act=None, epsilon=1e-5, moving_average_fraction=0.9,
               use_global_stats=None, name=None, param_attr=None):
    inputs = _norm_inputs(input)
    return LayerOutput("batch_norm", inputs, {
        "act": act_mod.resolve(act), "epsilon": epsilon,
        "moving_average_fraction": moving_average_fraction,
        "use_global_stats": use_global_stats}, name=name,
        size=inputs[0].size)


def img_cmrnorm(input, size=5, scale=0.0001, power=0.75, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("img_cmrnorm", inputs, {
        "size": size, "alpha": scale, "beta": power}, name=name,
        size=inputs[0].size)


def maxout(input, groups, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("maxout", inputs, {"groups": groups}, name=name)


def bilinear_interp(input, out_size_x, out_size_y, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("bilinear_interp", inputs, {
        "out_size_x": out_size_x, "out_size_y": out_size_y}, name=name)


def pad(input, pad_c=(0, 0), pad_h=(0, 0), pad_w=(0, 0), name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("pad", inputs, {
        "pad_c": list(pad_c), "pad_h": list(pad_h), "pad_w": list(pad_w)},
        name=name)


def crop(input, crop_h, crop_w, offset=(0, 0), name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("crop", inputs, {
        "crop_h": crop_h, "crop_w": crop_w, "offset": list(offset)},
        name=name)


def spp(input, pyramid_height=3, pool_type="max", name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("spp", inputs, {
        "pyramid_height": pyramid_height, "pool_type": pool_type}, name=name)


def img_conv3d(input, filter_size, num_filters, stride=1, padding=0,
               act=None, bias_attr=True, name=None):
    """3-D convolution over NDHWC volumes (DHWIO kernel)."""
    return LayerOutput("conv3d", [input], {
        "filter_size": filter_size, "num_filters": num_filters,
        "stride": stride, "padding": padding,
        "act": act_mod.resolve(act), "bias": bias_attr is not False},
        name=name)


def img_conv3d_transpose(input, filter_size, num_filters, stride=1,
                         padding=0, act=None, bias_attr=True, name=None):
    """3-D transposed convolution (reference: DeConv3DLayer.cpp)."""
    return LayerOutput("deconv3d", [input], {
        "filter_size": filter_size, "num_filters": num_filters,
        "stride": stride, "padding": padding,
        "act": act_mod.resolve(act), "bias": bias_attr is not False},
        name=name)


def img_pool3d(input, pool_size, stride=None, pool_type="max", name=None):
    return LayerOutput("pool3d", [input], {
        "pool_size": pool_size, "stride": stride or pool_size,
        "pool_type": pool_type}, name=name)


# ----------------------------------------------------------------- sequence
def pooling(input, pooling_type=None, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("seq_pool", inputs,
                       {"pool_type": pool_mod.resolve(pooling_type)},
                       name=name, size=inputs[0].size)


def first_seq(input, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("first_seq", inputs, {}, name=name,
                       size=inputs[0].size)


def last_seq(input, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("last_seq", inputs, {}, name=name,
                       size=inputs[0].size)


def expand(input, expand_as, name=None):
    return LayerOutput("expand", [input, expand_as], {}, name=name,
                       size=input.size)


def seq_concat(a, b, name=None):
    return LayerOutput("seq_concat", [a, b], {}, name=name, size=a.size)


def seq_reshape(input, reshape_size, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("seq_reshape", inputs,
                       {"reshape_size": reshape_size}, name=name,
                       size=reshape_size)


def context_projection(input, context_len, context_start=None,
                       trainable_padding=False, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("context_projection", inputs, {
        "context_len": context_len,
        "context_start": (context_start if context_start is not None
                          else -(context_len // 2)),
        "trainable_padding": trainable_padding}, name=name,
        size=(inputs[0].size or 0) * context_len or None)


def seq_softmax(input, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("seq_softmax", inputs, {}, name=name,
                       size=inputs[0].size)


def seq_scale(weight, input, name=None):
    return LayerOutput("seq_scale", [weight, input], {}, name=name,
                       size=input.size)


def seq_dot(a, b, name=None):
    return LayerOutput("seq_dot", [a, b], {}, name=name, size=1)


def seq_slice(input, start, end, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("seq_slice", inputs, {"start": start, "end": end},
                       name=name, size=inputs[0].size)


def sub_seq(input, offsets, sizes, name=None):
    """Per-sample sub-sequence slice (reference sub_seq_layer)."""
    return LayerOutput("sub_seq", [input, offsets, sizes], {}, name=name,
                       size=input.size)


def sub_nested_seq(input, scores, k, name=None):
    """Keep the top-k timesteps by per-step SCORES, in time order
    (reference sub_nested_seq_layer; pass raw scores, not kmax
    indices)."""
    return LayerOutput("sub_nested_seq", [input, scores],
                       {"k": k}, name=name, size=input.size)


def kmax_seq_score(input, beam_size=1, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("kmax_seq_score", inputs, {"beam_size": beam_size},
                       name=name)


# ---------------------------------------------------------------- recurrent
def recurrent(input, act="tanh", reverse=False, bias_attr=None, name=None):
    inputs = _norm_inputs(input)
    attrs = _attrs_from(None, bias_attr, None,
                        {"act": act_mod.resolve(act), "reverse": reverse})
    return LayerOutput("recurrent", inputs, attrs, name=name,
                       size=inputs[0].size)


def lstmemory(input, reverse=False, act="tanh", gate_act="sigmoid",
              peephole=True, bias_attr=None, name=None):
    """input must be the 4h-wide gate projection (reference: lstmemory).
    ``peephole=False`` with the default activations is the cell the CUDA
    step kernel takes (h % 128 == 0)."""
    inputs = _norm_inputs(input)
    attrs = _attrs_from(None, bias_attr, None, {
        "act": act_mod.resolve(act), "gate_act": act_mod.resolve(gate_act),
        "reverse": reverse, "peephole": peephole})
    return LayerOutput("lstmemory", inputs, attrs, name=name,
                       size=(inputs[0].size or 0) // 4 or None)


def grumemory(input, reverse=False, act="tanh", gate_act="sigmoid",
              bias_attr=None, name=None):
    """input must be the 3h-wide gate projection (reference: grumemory)."""
    inputs = _norm_inputs(input)
    attrs = _attrs_from(None, bias_attr, None, {
        "act": act_mod.resolve(act), "gate_act": act_mod.resolve(gate_act),
        "reverse": reverse})
    return LayerOutput("grumemory", inputs, attrs, name=name,
                       size=(inputs[0].size or 0) // 3 or None)


def bigru(fwd_proj, bwd_proj, act="tanh", gate_act="sigmoid", name=None):
    """fused bidirectional GRU over two 3h gate projections: one loop
    advances both directions (layers/recurrent.py BiGruMemoryLayer)."""
    size = 2 * ((fwd_proj.size or 0) // 3)
    return LayerOutput("bigru", [fwd_proj, bwd_proj],
                       {"act": act_mod.resolve(act),
                        "gate_act": act_mod.resolve(gate_act)},
                       name=name, size=size or None)


def mdlstmemory(input, directions=None, grid_dims=None,
                act="sigmoid", gate_act="sigmoid", state_act="sigmoid",
                name=None):
    """Multi-dimensional LSTM over a D-dim grid; input must be the
    size*(3+D)-wide gate projection (reference: config_parser.py
    MDLstmLayer).  ``grid_dims`` pins the static grid shape (its product
    the input's max seq len); ``directions`` gives the walk's direction
    per grid dim (default: all forward, the rank from grid_dims; 1-D over
    the sequence when neither is given)."""
    inputs = _norm_inputs(input)
    if directions is None:
        directions = (True,) * (len(grid_dims) if grid_dims is not None
                                else 1)
    directions = tuple(bool(d) for d in directions)
    if grid_dims is not None and len(grid_dims) != len(directions):
        raise ValueError(
            f"mdlstmemory: grid_dims rank {len(grid_dims)} != "
            f"len(directions) {len(directions)}")
    if grid_dims is None and len(directions) > 1:
        raise ValueError(
            "mdlstmemory: multi-dim directions require grid_dims")
    width = inputs[0].size or 0
    if width and width % (3 + len(directions)) != 0:
        raise ValueError(
            f"mdlstmemory: input size {width} not divisible by "
            f"3+len(directions)={3 + len(directions)}")
    attrs = {"directions": directions,
             "act": act_mod.resolve(act),
             "gate_act": act_mod.resolve(gate_act),
             "state_act": act_mod.resolve(state_act)}
    if grid_dims is not None:
        attrs["grid_dims"] = tuple(int(d) for d in grid_dims)
    return LayerOutput("mdlstmemory", inputs, attrs, name=name,
                       size=width // (3 + len(directions)) or None)


def gru_step_layer(input, output_mem, size=None, act="tanh",
                   gate_act="sigmoid", bias_attr=None, name=None):
    """One GRU step inside a recurrent_group step function: ``input`` is
    the 3h gate projection, ``output_mem`` the memory() of this layer's
    output (reference: gru_step_layer)."""
    attrs = _attrs_from(None, bias_attr, None, {
        "act": act_mod.resolve(act), "gate_act": act_mod.resolve(gate_act)})
    size = size or (input.size or 0) // 3 or None
    return LayerOutput("gru_step", [input, output_mem], attrs, name=name,
                       size=size)


def lstm_step_layer(input, state_mem, size=None, act="tanh",
                    gate_act="sigmoid", state_act=None, bias_attr=None,
                    name=None):
    """One LSTM step on a combined [h|c] state memory of width 2h;
    ``input`` is the 4h gate projection.  ``size`` (and LayerOutput.size)
    is h, the reference convention, though the tensor is the 2h combined
    state."""
    attrs = _attrs_from(None, bias_attr, None, {
        "act": act_mod.resolve(act), "gate_act": act_mod.resolve(gate_act),
        "state_act": act_mod.resolve(state_act) if state_act else None})
    size = size or (input.size or 0) // 4 or None
    return LayerOutput("lstm_step", [input, state_mem], attrs, name=name,
                       size=size)


# -------------------------------------------------------------------- costs
def lm_head_cost(input, label, vocab_size, weight=None, chunk=8192,
                 name=None):
    """Fused vocabulary projection + softmax CE, chunked so the [N, vocab]
    logits are never kept (``ops/chunked_ce.py``).  Owns the head weights
    (fc naming): expose the logits for generation with
    ``fc(..., share_from=<this name>)``."""
    inputs = [input, label] + ([weight] if weight is not None else [])
    return LayerOutput("lm_head_cost", inputs,
                       {"vocab_size": vocab_size, "chunk": chunk},
                       name=name, size=1)


def classification_cost(input, label, weight=None, name=None):
    """softmax cross-entropy on logits; if the input layer ends in a
    softmax activation (the reference idiom) it takes the prob-space form
    so both idioms train identically."""
    inputs = [input, label] + ([weight] if weight is not None else [])
    is_prob = input.attrs.get("act") == "softmax"
    return LayerOutput("classification_cost", inputs,
                       {"input_is_prob": is_prob}, name=name)


def cross_entropy_cost(input, label, soft_label=False, name=None):
    return LayerOutput("cross_entropy", [input, label],
                       {"soft_label": soft_label}, name=name)


def square_error_cost(input, label, name=None):
    return LayerOutput("mse_cost", [input, label], {}, name=name)


mse_cost = square_error_cost


def rank_cost(left, right, label, weight=None, name=None):
    inputs = [left, right, label] + ([weight] if weight is not None else [])
    return LayerOutput("rank_cost", inputs, {}, name=name)


def hinge_cost(input, label, name=None):
    return LayerOutput("hinge_cost", [input, label], {}, name=name)


def log_loss(input, label, name=None):
    return LayerOutput("log_loss", [input, label], {}, name=name)


def multi_binary_label_cross_entropy_cost(input, label, name=None):
    return LayerOutput("multi_binary_label_cross_entropy", [input, label],
                       {}, name=name)


def smooth_l1_cost(input, label, name=None):
    return LayerOutput("smooth_l1_cost", [input, label], {}, name=name)


def huber_classification_cost(input, label, name=None):
    return LayerOutput("huber_classification_cost", [input, label], {},
                       name=name)


def sum_cost(input, name=None):
    return LayerOutput("sum_cost", _norm_inputs(input), {}, name=name)


def nce_cost(input, label, num_classes, num_neg_samples=10, name=None):
    return LayerOutput("nce_cost", [input, label], {
        "num_classes": num_classes, "num_neg_samples": num_neg_samples},
        name=name)


def hsigmoid(input, label, num_classes, name=None):
    return LayerOutput("hsigmoid_cost", [input, label],
                       {"num_classes": num_classes}, name=name)


def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, name=None):
    """LambdaRank listwise cost over one query's documents a sequence."""
    return LayerOutput("lambda_cost", [input, score],
                       {"NDCG_num": NDCG_num, "max_sort_size": max_sort_size},
                       name=name)


def huber_regression_cost(input, label, delta=1.0, name=None):
    return LayerOutput("huber_regression_cost", [input, label],
                       {"delta": delta}, name=name)


def cross_entropy_with_selfnorm(input, label, softmax_selfnorm_alpha=0.1,
                                name=None):
    is_prob = input.attrs.get("act") == "softmax"
    return LayerOutput("cross_entropy_with_selfnorm", [input, label],
                       {"softmax_selfnorm_alpha": softmax_selfnorm_alpha,
                        "input_is_prob": is_prob}, name=name)


class BeamInput:
    """One beam-expansion step for cross_entropy_over_beam (reference:
    BeamInput(candidate_scores, selected_candidates, gold))."""

    def __init__(self, candidate_scores, selected_candidates, gold):
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold


def cross_entropy_over_beam(input, name=None):
    """Beam-training cost over E expansion steps; ``input`` is a list of
    BeamInput (see layers/cost.py CrossEntropyOverBeamCost)."""
    flat = []
    for b in input:
        flat += [b.candidate_scores, b.selected_candidates, b.gold]
    return LayerOutput("cross_entropy_over_beam", flat,
                       {"expansions": len(input)}, name=name)


# -------------------------------------------------------------- misc math
def cos_sim(a, b, scale=1.0, name=None):
    return LayerOutput("cos_sim", [a, b], {"scale": scale}, name=name, size=1)


def dot_prod(a, b, name=None):
    return LayerOutput("dot_prod", [a, b], {}, name=name, size=1)


def scaling(weight, input, name=None):
    return LayerOutput("scaling", [weight, input], {}, name=name,
                       size=input.size)


def slope_intercept(input, slope=1.0, intercept=0.0, name=None):
    return LayerOutput("slope_intercept", _norm_inputs(input),
                       {"slope": slope, "intercept": intercept}, name=name,
                       size=input.size)


def interpolation(weight, x, y, name=None):
    return LayerOutput("interpolation", [weight, x, y], {}, name=name,
                       size=x.size)


def bilinear_tensor_product(x, y, size, name=None):
    return LayerOutput("bilinear_tensor_product", [x, y], {"size": size},
                       name=name, size=size)


def trans(input, name=None):
    return LayerOutput("trans", _norm_inputs(input), {}, name=name)


def reshape(input, shape, name=None):
    return LayerOutput("reshape", _norm_inputs(input),
                       {"shape": list(shape)}, name=name)


def activation(input, act, name=None):
    return LayerOutput("activation", _norm_inputs(input),
                       {"act": act_mod.resolve(act)}, name=name,
                       size=input.size)


def row_l2_norm(input, name=None):
    return LayerOutput("row_l2_norm", _norm_inputs(input), {}, name=name,
                       size=input.size)


def bahdanau_attention(encoded_sequence, encoded_proj, decoder_state,
                       name=None):
    """Fused additive-attention step (simple_attention's math in one
    layer with a recompute backward - see layers/attention.py)."""
    return LayerOutput(
        "bahdanau_attention",
        [encoded_sequence, encoded_proj, decoder_state], {},
        name=name, size=encoded_sequence.size)


def position_embedding(input, max_len, size=None, name=None):
    """Learnable absolute position embeddings for a sequence input."""
    return LayerOutput("position_embedding", [input],
                       {"max_len": max_len, "size": size}, name=name,
                       size=size or input.size)


def multi_head_attention(query, key=None, value=None, *, size, num_heads,
                         causal=False, context_parallel=False, name=None):
    """Fused multi-head attention (the flash kernels on the card)."""
    key = key if key is not None else query
    value = value if value is not None else key
    return LayerOutput("multi_head_attention", [query, key, value], {
        "size": size, "num_heads": num_heads, "causal": causal,
        "context_parallel": context_parallel}, name=name, size=size)


# reference aliases (trainer_config_helpers spelling)
gru_step_naive_layer = gru_step_layer
gru_step_naive = gru_step_layer
nce = nce_cost
cross_entropy = cross_entropy_cost
regression_cost = square_error_cost
multi_binary_label_cross_entropy = multi_binary_label_cross_entropy_cost
huber_cost = huber_classification_cost

# the legacy ``*_layer`` names of the ported entries (the JAX package's
# table, less the entries not ported)
_LEGACY = {
    "fc": "fc_layer", "data": "data_layer", "embedding": "embedding_layer",
    "img_conv": "img_conv_layer", "img_pool": "img_pool_layer",
    "batch_norm": "batch_norm_layer", "addto": "addto_layer",
    "concat": "concat_layer", "dropout": "dropout_layer",
    "mixed": "mixed_layer", "pooling": "pooling_layer",
    "expand": "expand_layer", "seq_reshape": "seq_reshape_layer",
    "seq_concat": "seq_concat_layer", "seq_slice": "seq_slice_layer",
    "sub_seq": "sub_seq_layer", "sub_nested_seq": "sub_nested_seq_layer",
    "kmax_seq_score": "kmax_seq_score_layer",
    "interpolation": "interpolation_layer", "scaling": "scaling_layer",
    "slope_intercept": "slope_intercept_layer", "cos_sim": "cos_sim",
    "trans": "trans_layer", "dot_prod": "dot_prod_layer",
    "recurrent": "recurrent_layer", "img_cmrnorm": "img_cmrnorm_layer",
    "nce_cost": "nce_layer", "hsigmoid": "hsigmoid_layer",
    "row_l2_norm": "row_l2_norm_layer",
    "first_seq": "first_seq_layer", "last_seq": "last_seq_layer",
    "img_conv3d": "img_conv3d_layer", "img_pool3d": "img_pool3d_layer",
    "bilinear_interp": "bilinear_interp_layer", "pad": "pad_layer",
    "crop": "crop_layer", "maxout": "maxout_layer", "spp": "spp_layer",
}
for _new, _old in _LEGACY.items():
    globals().setdefault(_old, globals()[_new])
del _new, _old
