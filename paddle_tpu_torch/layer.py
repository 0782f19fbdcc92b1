"""The layer DSL: the user-facing graph construction functions the ported
layers need (counterpart of ``paddle_tpu/layer.py``).

Each function returns a ``LayerOutput``; ``Topology(cost)`` recovers the
graph by walking parents.  Same arguments, attributes and default names as
the JAX package, so both write byte-equal JSON for the same config.  The
rest of the catalog comes with later slices.
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
    "data", "fc", "embedding", "concat", "addto", "slice", "layer_norm",
    "first_seq", "last_seq",
    "recurrent", "lstmemory", "grumemory", "bigru", "recurrent_group",
    "memory", "beam_search", "StaticInput", "GeneratedInput",
    "SubsequenceInput", "gru_step_layer", "lstm_step_layer",
    "classification_cost", "sum_cost",
    "position_embedding", "bahdanau_attention", "multi_head_attention",
    "img_conv", "img_pool", "global_pool", "batch_norm", "img_cmrnorm",
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
    if attrs.get("drop_rate"):
        raise NotImplementedError("dropout is not ported to "
                                  "paddle_tpu_torch yet")
    return LayerOutput("fc", inputs, attrs, name=name, size=size)


def embedding(input, size: int, vocab_size: Optional[int] = None,
              name=None, param_attr=None, share_from: Optional[str] = None):
    """share_from: name of another embedding layer whose table to reuse."""
    inputs = _norm_inputs(input)
    vocab = vocab_size or inputs[0].size
    attrs = _attrs_from(param_attr, False, None,
                        {"size": size, "vocab_size": vocab,
                         "share_from": share_from})
    return LayerOutput("embedding", inputs, attrs, name=name, size=size)


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


def layer_norm(input, epsilon=1e-5, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("layer_norm", inputs, {"epsilon": epsilon},
                       name=name, size=inputs[0].size)


def slice(input, start, end, name=None):
    """features [start, end) of the last axis."""
    return LayerOutput("slice", _norm_inputs(input),
                       {"start": start, "end": end}, name=name,
                       size=end - start)


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


# ----------------------------------------------------------------- sequence
def first_seq(input, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("first_seq", inputs, {}, name=name,
                       size=inputs[0].size)


def last_seq(input, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("last_seq", inputs, {}, name=name,
                       size=inputs[0].size)


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
def classification_cost(input, label, weight=None, name=None):
    """softmax cross-entropy on logits; if the input layer ends in a
    softmax activation (the reference idiom) it takes the prob-space form
    so both idioms train identically."""
    inputs = [input, label] + ([weight] if weight is not None else [])
    is_prob = input.attrs.get("act") == "softmax"
    return LayerOutput("classification_cost", inputs,
                       {"input_is_prob": is_prob}, name=name)


def sum_cost(input, name=None):
    return LayerOutput("sum_cost", _norm_inputs(input), {}, name=name)


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
