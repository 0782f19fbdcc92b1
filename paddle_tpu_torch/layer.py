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
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.core.ir import LayerOutput
from paddle_tpu_torch.data_type import DataKind, InputType, SeqType

__all__ = [
    "data", "fc", "embedding", "addto", "layer_norm",
    "classification_cost", "position_embedding", "multi_head_attention",
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


def addto(input, act=None, bias_attr=False, name=None):
    inputs = _norm_inputs(input)
    attrs = _attrs_from(None, bias_attr, None, {"act": act_mod.resolve(act)})
    return LayerOutput("addto", inputs, attrs, name=name,
                       size=inputs[0].size)


def layer_norm(input, epsilon=1e-5, name=None):
    inputs = _norm_inputs(input)
    return LayerOutput("layer_norm", inputs, {"epsilon": epsilon},
                       name=name, size=inputs[0].size)


def classification_cost(input, label, weight=None, name=None):
    """softmax cross-entropy on logits; if the input layer ends in a
    softmax activation (the reference idiom) it takes the prob-space form
    so both idioms train identically."""
    inputs = [input, label] + ([weight] if weight is not None else [])
    is_prob = input.attrs.get("act") == "softmax"
    return LayerOutput("classification_cost", inputs,
                       {"input_is_prob": is_prob}, name=name)


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
