"""The Fluid programs the port is held to: fit_a_line, recognize_digits,
Adam with L2 decay and global-norm clipping, and the five book chapters
of ``tests/test_fluid_book.py`` (image classification with conv and batch
norm, sentiment with dynamic_lstm, word2vec with nce, semantic roles with
linear_chain_crf, machine translation's beam decode), each written for
the fluid module it is given (``paddle_tpu.fluid`` or
``paddle_tpu_torch.fluid``) and importing neither.  Each function returns
(fetch list, feeds(i)): the first fetch is the loss (the decoded ids for
machine translation, which does not train), and ``feeds(i)`` step i's
seeded batch.  ``test_torch_fluid.py`` runs them against the JAX package;
``chip_smoke.py`` runs them on the card against the CPU."""

import numpy as np

STEPS = 5


def _fit_a_line(fl):
    L = fl.layers
    x = L.data(name="x", shape=[13])
    y = L.data(name="y", shape=[1])
    cost = L.mean(L.square_error_cost(input=L.fc(input=x, size=1), label=y))
    fl.optimizer.SGDOptimizer(learning_rate=0.05).minimize(cost)
    rng = np.random.RandomState(0)
    w = rng.rand(13, 1).astype(np.float32)
    xs = [rng.rand(16, 13).astype(np.float32) for _ in range(STEPS)]
    return [cost], lambda i: {"x": xs[i], "y": xs[i] @ w}


def _recognize_digits(fl):
    L = fl.layers
    img = L.data(name="img", shape=[784])
    label = L.data(name="label", shape=[1], dtype="int64")
    logits = L.fc(input=L.fc(input=img, size=32, act="relu"), size=10)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    acc = L.accuracy(input=L.softmax(logits), label=label)
    fl.optimizer.MomentumOptimizer(learning_rate=0.1,
                                   momentum=0.9).minimize(loss)
    rng = np.random.RandomState(0)
    xs = [rng.rand(32, 784).astype(np.float32) * 0.1 for _ in range(STEPS)]
    return [loss, acc], lambda i: {
        "img": xs[i],
        "label": np.argmax(xs[i][:, :10], 1).reshape(-1, 1).astype(np.int64)}


def _adam_decay_clip(fl):
    L = fl.layers
    x = L.data(name="x", shape=[8])
    y = L.data(name="y", shape=[1])
    cost = L.mean(L.square_error_cost(L.fc(input=x, size=1), y))
    fl.optimizer.AdamOptimizer(
        learning_rate=0.05, regularization=fl.regularizer.L2Decay(1e-4),
        global_clip=fl.clip.GradientClipByGlobalNorm(1.0)).minimize(cost)
    rng = np.random.RandomState(1)
    xs = [rng.rand(8, 8).astype(np.float32) for _ in range(STEPS)]
    return [cost], lambda i: {"x": xs[i],
                              "y": xs[i].sum(1, keepdims=True)}


def _image_classification(fl):
    L = fl.layers
    img = L.data(name="pixel", shape=[3, 16, 16])
    label = L.data(name="label", shape=[1], dtype="int64")
    t = L.conv2d(img, num_filters=8, filter_size=3, padding=1, act="relu")
    t = L.batch_norm(t)
    t = L.pool2d(t, pool_size=2, pool_stride=2)
    t = L.conv2d(t, num_filters=16, filter_size=3, padding=1, act="relu")
    t = L.pool2d(t, pool_size=2, pool_stride=2)
    logits = L.fc(t, size=10)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    fl.optimizer.AdamOptimizer(learning_rate=5e-3).minimize(loss)
    rng = np.random.RandomState(0)
    xv = rng.rand(16, 3, 16, 16).astype(np.float32)
    yv = (xv.mean(axis=(1, 2, 3)) * 20 % 10).astype(np.int64)[:, None]
    return [loss, logits], lambda i: {"pixel": xv, "label": yv}


def _sentiment_lstm(fl):
    L = fl.layers
    V, T, H = 120, 12, 16
    words = L.data(name="words", shape=[T], dtype="int64")
    mask = L.data(name="mask", shape=[T])
    label = L.data(name="label", shape=[1], dtype="int64")
    gates = L.fc(L.embedding(words, size=[V, 24]), size=4 * H,
                 num_flatten_dims=2)
    h, _ = L.dynamic_lstm(gates, size=H, mask=mask)
    logits = L.fc(L.sequence_pool(h, "last"), size=2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    fl.optimizer.AdamOptimizer(learning_rate=5e-3).minimize(loss)
    rng = np.random.RandomState(1)
    wv = rng.randint(0, V, (16, T)).astype(np.int64)
    mv = np.ones((16, T), np.float32)
    mv[3, 9:] = 0.0                     # one padded row
    yv = (wv[:, 0] % 2).astype(np.int64)[:, None]
    return [loss], lambda i: {"words": wv, "mask": mv, "label": yv}


def _word2vec_nce(fl):
    L = fl.layers
    V, E = 80, 16
    w1 = L.data(name="w1", shape=[1], dtype="int64")
    w2 = L.data(name="w2", shape=[1], dtype="int64")
    nxt = L.data(name="nxt", shape=[1], dtype="int64")
    ctx = L.concat([L.reshape(L.embedding(w1, size=[V, E]), [-1, E]),
                    L.reshape(L.embedding(w2, size=[V, E]), [-1, E])],
                   axis=1)
    hid = L.fc(ctx, size=32, act="tanh")
    sm = L.mean(L.softmax_with_cross_entropy(L.fc(hid, size=V), nxt))
    nce = L.mean(L.nce(hid, nxt, num_total_classes=V, num_neg_samples=8))
    loss = L.elementwise_add(sm, nce)
    fl.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    rng = np.random.RandomState(2)
    w1v = rng.randint(0, V, (32, 1)).astype(np.int64)
    w2v = rng.randint(0, V, (32, 1)).astype(np.int64)
    nv = ((w1v + w2v) % V).astype(np.int64)
    return [loss, nce], lambda i: {"w1": w1v, "w2": w2v, "nxt": nv}


def _label_semantic_roles(fl):
    L = fl.layers
    V, T, C = 60, 8, 5
    words = L.data(name="words", shape=[T], dtype="int64")
    target = L.data(name="target", shape=[T], dtype="int64")
    lens = L.data(name="lens", shape=[], dtype="int64")
    emission = L.fc(L.embedding(words, size=[V, 12]), size=C,
                    num_flatten_dims=2)
    ll = L.linear_chain_crf(emission, target, length=lens)
    loss = L.scale(L.mean(ll), scale=-1.0)
    decoded = L.crf_decoding(emission, transition=ll.transition_param,
                             length=lens)
    fl.optimizer.AdamOptimizer(learning_rate=2e-2).minimize(loss)
    rng = np.random.RandomState(3)
    wv = rng.randint(0, V, (8, T)).astype(np.int64)
    lv = np.full((8,), T, np.int64)
    lv[2] = 5                           # one short sequence
    return [loss, decoded], lambda i: {"words": wv, "target": wv % C,
                                       "lens": lv}


def _machine_translation(fl):
    L = fl.layers
    V, T, H, K = 40, 6, 12, 3
    src = L.data(name="src", shape=[T], dtype="int64")
    gates = L.fc(L.embedding(src, size=[V, 12]), size=3 * H,
                 num_flatten_dims=2)
    enc_last = L.sequence_pool(L.dynamic_gru(gates, size=H), "last")
    state = L.expand(L.reshape(enc_last, [-1, 1, H]), [1, K, 1])
    pre_ids = L.fill_constant_batch_size_like(src, [-1, K], "int64", 0)
    pre_sc = L.fill_constant_batch_size_like(src, [-1, K], "float32", 0.0)
    ids_l, par_l, sc_l = [], [], []
    for _ in range(4):
        probs = L.softmax(L.fc(state, size=V, num_flatten_dims=2))
        ids, sc, parent = L.beam_search(pre_ids, pre_sc, probs,
                                        beam_size=K, end_id=1)
        ids_l.append(ids)
        par_l.append(parent)
        sc_l.append(sc)
        pre_ids, pre_sc = ids, sc

    def stk(vs):
        return L.concat([L.reshape(v, [1, -1, K]) for v in vs], axis=0)

    sent, ssc = L.beam_search_decode(
        stk(ids_l), L.cast(stk([L.cast(p, "float32") for p in par_l]),
                           "int64"), stk(sc_l))
    rng = np.random.RandomState(4)
    sv = rng.randint(2, V, (5, T)).astype(np.int64)
    return [sent, ssc], lambda i: {"src": sv}


PROGRAMS = {
    "fit_a_line": _fit_a_line,
    "recognize_digits": _recognize_digits,
    "adam_decay_clip": _adam_decay_clip,
    "image_classification": _image_classification,
    "understand_sentiment": _sentiment_lstm,
    "word2vec": _word2vec_nce,
    "label_semantic_roles": _label_semantic_roles,
    "machine_translation": _machine_translation,
}
TRAINED = {n for n in PROGRAMS if n != "machine_translation"}


def build(fl, name):
    """(main, startup, fetch names, feeds(i)) of program ``name``, built
    in ``fl`` from fresh default programs and names."""
    fl.framework.reset_default_programs()
    fetch, feeds = PROGRAMS[name](fl)
    main = fl.default_main_program()
    startup = fl.default_startup_program()
    return main, startup, [v.name for v in fetch], feeds
