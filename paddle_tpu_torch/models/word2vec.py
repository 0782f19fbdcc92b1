"""N-gram word2vec (counterpart of ``paddle_tpu/models/word2vec.py``; book
ch. 04, reference: v2/fluid/tests/book/test_word2vec.py): N - 1 context
embeddings of one shared table, a tanh fc, and a softmax over the vocab,
or the hierarchical sigmoid with ``use_hsigmoid``.
"""

from __future__ import annotations

import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer


def build(vocab_size: int = 2000, emb_dim: int = 32, hidden: int = 64,
          window: int = 5, use_hsigmoid: bool = False):
    """window N: N - 1 context words predict the Nth. Feeds: w0 ..
    w{N-2}, next_word."""
    ctx = [layer.data(f"w{i}", paddle.data_type.integer_value(vocab_size))
           for i in range(window - 1)]
    nxt = layer.data("next_word",
                     paddle.data_type.integer_value(vocab_size))
    embs = [layer.embedding(ctx[0], size=emb_dim, name="shared_emb")]
    embs += [layer.embedding(w, size=emb_dim, share_from="shared_emb")
             for w in ctx[1:]]
    h = layer.fc(layer.concat(embs), size=hidden, act="tanh")
    if use_hsigmoid:
        cost = layer.hsigmoid(h, nxt, num_classes=vocab_size, name="cost")
        return cost, h
    pred = layer.fc(h, size=vocab_size, act=None, name="prediction")
    cost = layer.classification_cost(pred, nxt, name="cost")
    return cost, pred
