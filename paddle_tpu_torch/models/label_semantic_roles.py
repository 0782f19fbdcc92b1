"""Semantic role labelling (counterpart of
``paddle_tpu/models/label_semantic_roles.py``; book ch. 07, reference:
v2/fluid/tests/book/test_label_semantic_roles.py): word, predicate and
mark embeddings, a tanh fc, ``depth`` levels of a forward and a reversed
LSTM, and a linear-chain CRF over the tag sequence with Viterbi decoding
sharing its transitions.

Every LSTM is the standard cell (no peephole, sigmoid gates, tanh, a
bias), so at ``hidden % 128 == 0`` each of the 2 * ``depth`` LSTMs takes
the CUDA step kernel on the card, one launch a step (the book's width,
hidden 128, is 4 x 128 gate columns); at the default 64 they run the
plain step.
"""

from __future__ import annotations

import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer
from paddle_tpu_torch.dataset import conll05


def build(word_dim: int = 32, hidden: int = 64, depth: int = 2,
          max_len: int = 40, word_vocab: int = None,
          pred_vocab: int = None, num_labels: int = None):
    word_vocab = word_vocab or conll05.WORD_VOCAB
    pred_vocab = pred_vocab or conll05.PRED_VOCAB
    num_labels = num_labels or conll05.LABEL_COUNT

    seq = paddle.data_type.integer_value_sequence
    word = layer.data("word", seq(word_vocab, max_len=max_len))
    predicate = layer.data("verb", seq(pred_vocab, max_len=max_len))
    mark = layer.data("mark", seq(2, max_len=max_len))
    target = layer.data("target", seq(num_labels, max_len=max_len))

    feats = layer.concat([
        layer.embedding(word, size=word_dim),
        layer.embedding(predicate, size=word_dim),
        layer.embedding(mark, size=8),
    ])
    x = layer.fc(feats, size=hidden, act="tanh")
    for i in range(depth):
        fwd = layer.lstmemory(
            layer.fc(x, size=4 * hidden, act=None, bias_attr=False),
            peephole=False, name=f"lstm_f{i}")
        bwd = layer.lstmemory(
            layer.fc(x, size=4 * hidden, act=None, bias_attr=False),
            peephole=False, reverse=True, name=f"lstm_b{i}")
        x = layer.concat([fwd, bwd])
    emission = layer.fc(x, size=num_labels, act=None, name="emission")
    cost = layer.crf(emission, target, name="crf")
    decoded = layer.crf_decoding(emission, param_layer="crf",
                                 name="decoded")
    return cost, decoded
