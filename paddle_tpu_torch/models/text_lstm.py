"""LSTM text classifier (counterpart of ``paddle_tpu/models/text_lstm.py``;
reference: benchmark/paddle/rnn/rnn.py): embedding, stacked
``networks.simple_lstm``, a max pool over time, an fc to the classes.

``simple_lstm``'s ``lstmemory`` keeps its peephole on, so on the card its
steps run the plain PyTorch step, not the CUDA LSTM step kernel (the
kernel takes only the peephole-free cell, as the JAX package's Pallas
route does).
"""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer, networks


def build(vocab_size: int = 10000, emb_dim: int = 128, hidden: int = 512,
          num_layers: int = 2, num_classes: int = 2, max_len: int = 128):
    words = layer.data(
        "words", data_type.integer_value_sequence(vocab_size,
                                                  max_len=max_len))
    lbl = layer.data("label", data_type.integer_value(num_classes))
    x = layer.embedding(words, size=emb_dim, vocab_size=vocab_size,
                        name="emb")
    for i in range(num_layers):
        x = networks.simple_lstm(x, hidden, name=f"lstm{i+1}")
    pooled = layer.pooling(x, pooling_type="max", name="pool")
    pred = layer.fc(pooled, size=num_classes, act=None, name="prediction")
    cost = layer.classification_cost(pred, lbl, name="cost")
    return cost, pred
