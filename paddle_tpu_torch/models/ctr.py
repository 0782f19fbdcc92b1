"""Wide & deep CTR model, the sparse-table flagship (counterpart of
``paddle_tpu/models/ctr.py``; reference: the v2 CTR demo and the
SparseRemoteParameterUpdater path it ran, trainer/
RemoteParameterUpdater.h:265).

The wide part is a width-1 embedding a field (a sparse weight a feature),
the deep part the fields' embeddings concatenated into an MLP, so the
whole model is gathers and no one-hot is made.  ``sparse_update=True``
puts every table on the SelectedRows path: the step's gradient is one
row a lookup, and the optimizer updates the touched rows only."""

from __future__ import annotations

import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer


def build(field_vocab_sizes=(1000, 1000, 100), emb_dim: int = 16,
          deep_layers=(64, 32), sparse_update: bool = False):
    """CTR over categorical fields. Feeds: f0..fN int ids + click label.
    Returns (cost, prediction).

    sparse_update=True is the production setting for 10M+-row
    vocabularies: no [V, D] gradient is made."""
    attr = (paddle.attr.ParamAttr(sparse_update=True, initializer="normal")
            if sparse_update else None)
    ids = [layer.data(f"f{i}", paddle.data_type.integer_value(v))
           for i, v in enumerate(field_vocab_sizes)]
    lbl = layer.data("click", paddle.data_type.integer_value(2))

    # wide: sum of per-field scalar weights (sparse LR)
    wide_parts = [layer.embedding(x, size=1, name=f"wide{i}",
                                  param_attr=attr)
                  for i, x in enumerate(ids)]
    wide = layer.addto(wide_parts, act=None, name="wide_sum")

    # deep: concat field embeddings -> MLP
    embs = [layer.embedding(x, size=emb_dim, name=f"emb{i}",
                            param_attr=attr)
            for i, x in enumerate(ids)]
    deep = layer.concat(embs, name="deep_in")
    for j, width in enumerate(deep_layers):
        deep = layer.fc(deep, size=width, act="relu", name=f"deep{j}")
    deep_out = layer.fc(deep, size=1, act=None, name="deep_out")

    logit = layer.addto([wide, deep_out], act=None, name="logit")
    pred = layer.activation(logit, "sigmoid", name="ctr_prob")
    cost = layer.log_loss(pred, lbl, name="cost")
    return cost, pred
