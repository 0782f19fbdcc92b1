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
``chip_smoke.py`` runs them on the card against the CPU.  Below them, the
translation model of the control-flow slice (``nmt_dynamic_rnn``) and
the programs of ``CF_PROGRAMS`` (each ``fn(fl) -> (fetch list, feeds
list)``), which the control-flow and catalog tests run against the JAX
package and ``chip_smoke.py``'s ``fluid_cf`` runs on the card against the
CPU."""

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


def nmt_dynamic_rnn(fl, vocab, emb, hidden, src_len, trg_len, batch,
                    seed=0, min_len=None):
    """The book's chapter 8 training program through Fluid's control flow
    (``test_fluid_book.py``'s encoder; a DynamicRNN decoder): embedding,
    fc(3 * hidden), dynamic_gru(hidden), the last step; then a DynamicRNN
    over the target embeddings with their lengths (``sequence_mask``),
    its memory booted from the encoder's last state, each step
    fc([x_t, prev], hidden, tanh) and fc(state, vocab, softmax);
    cross_entropy against the next words, mean, Adam(1e-3).  Written into
    ``fl``'s default programs; returns (loss, feeds(i)), step i's batch
    of synthetic ids from ``seed``, target lengths from ``min_len``
    (default trg_len // 2) to trg_len."""
    L = fl.layers
    src = L.data(name="src", shape=[src_len], dtype="int64")
    trg = L.data(name="trg", shape=[trg_len], dtype="int64")
    lens = L.data(name="trg_len", shape=[], dtype="int64")
    nxt = L.data(name="nxt", shape=[trg_len, 1], dtype="int64")
    gates = L.fc(L.embedding(src, size=[vocab, emb]), size=3 * hidden,
                 num_flatten_dims=2)
    enc_last = L.sequence_pool(L.dynamic_gru(gates, size=hidden), "last")
    trg_emb = L.embedding(trg, size=[vocab, emb])
    drnn = L.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(trg_emb, lens)
        prev = drnn.memory(init=enc_last)
        state = L.fc(input=[x_t, prev], size=hidden, act="tanh")
        drnn.update_memory(prev, state)
        drnn.output(L.fc(input=state, size=vocab, act="softmax"))
    loss = L.mean(L.cross_entropy(input=drnn(), label=nxt))
    fl.optimizer.Adam(learning_rate=1e-3).minimize(loss)

    def feeds(i):
        rng = np.random.RandomState(seed + i)
        return {"src": rng.randint(3, vocab, (batch, src_len)),
                "trg": rng.randint(3, vocab, (batch, trg_len)),
                "trg_len": rng.randint(min_len or trg_len // 2,
                                       trg_len + 1, batch),
                "nxt": rng.randint(3, vocab, (batch, trg_len, 1))}

    return loss, feeds


# --- control flow and the rest of the catalog (test_torch_fluid_control_flow.py,
# test_torch_fluid_ops_rest.py; chip_smoke.py holds them card against CPU)

def while_train(fl):
    """h := tanh(h W) while i < limit (an unbounded While, the limit a
    feed), loss mean(h * h), SGD(0.5) through the While's two-phase
    gradient: 3 steps."""
    L = fl.layers
    x = L.data(name="wx", shape=[4, 3], append_batch_size=False)
    limit = L.data(name="wlimit", shape=[1], append_batch_size=False)
    h = L.elementwise_add(x, L.fill_constant([4, 3], "float32", 0.0))
    i = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(i, limit)
    w = L.While(cond=cond)
    with w.block():
        L.assign(L.fc(input=h, size=3, act="tanh", bias_attr=False),
                 output=h)
        L.assign(L.elementwise_add(i, L.fill_constant([1], "float32", 1.0)),
                 output=i)
        L.less_than(i, limit, cond=cond)
    loss = L.mean(L.elementwise_mul(h, h))
    fl.optimizer.SGD(learning_rate=0.5).minimize(loss)
    xv = np.random.RandomState(1).rand(4, 3).astype(np.float32)
    return [loss], [{"wx": xv, "wlimit": np.array([n], np.float32)}
                    for n in (4.0, 3.0, 5.0)]


def ifelse(fl, nan_branch=False):
    L = fl.layers
    x = L.data(name="x", shape=[1 if nan_branch else 3])
    ie = L.IfElse(L.data(name="c", shape=[1]))
    with ie.true_block():
        ie.output(L.scale(ie.input(x), scale=0.0 if nan_branch else 2.0))
    with ie.false_block():
        ie.output(L.log(ie.input(x)) if nan_branch
                  else L.scale(ie.input(x), scale=-1.0))
    xv = (np.array([[-1.0], [2.0]], np.float32) if nan_branch
          else np.ones((2, 3), np.float32))
    return [ie()], [{"x": xv, "c": np.array([[1.0], [0.0]], np.float32)}]


def switch_default(fl):
    L = fl.layers
    step = L.data(name="st", shape=[1], append_batch_size=False)
    sw = L.Switch()
    with sw:
        with sw.case(L.less_than(step,
                                 L.fill_constant([1], "float32", 100.0))):
            sw.assign(None, L.fill_constant([1], "float32", 0.1))
        with sw.default():
            sw.assign(None, L.fill_constant([1], "float32", 0.01))
    lr = sw.resolve(L.fill_constant([1], "float32", 0.0))
    return [lr], [{"st": np.array([v], np.float32)} for v in (50.0, 500.0)]


def ssd(fl):
    L = fl.layers
    n_gt, n_prior, n_cls = 3, 8, 5
    loc = L.data(name="loc", shape=[n_prior, 4], append_batch_size=False)
    conf = L.data(name="conf", shape=[n_prior, n_cls],
                  append_batch_size=False)
    gt_box = L.data(name="gt_box", shape=[n_gt, 4], append_batch_size=False)
    gt_label = L.data(name="gt_label", shape=[n_gt], dtype="int32",
                      append_batch_size=False)
    prior = L.data(name="prior", shape=[n_prior, 4], append_batch_size=False)
    prior_var = L.data(name="prior_var", shape=[n_prior, 4],
                       append_batch_size=False)
    loss = L.ssd_loss(loc, conf, gt_box, gt_label, prior)
    det = L.detection_output(loc, L.transpose(L.softmax(conf), [1, 0]),
                             prior, prior_var, keep_top_k=10)
    rng = np.random.default_rng(0)
    return [loss, det], [{
        "loc": rng.standard_normal((n_prior, 4)).astype(np.float32) * 0.1,
        "conf": rng.standard_normal((n_prior, n_cls)).astype(np.float32),
        "gt_box": np.sort(rng.random((n_gt, 4), np.float32), axis=-1),
        "gt_label": rng.integers(1, n_cls, n_gt, dtype=np.int32),
        "prior": np.sort(rng.random((n_prior, 4), np.float32), axis=-1),
        "prior_var": np.full((n_prior, 4), 0.1, np.float32)}]


def ctc_edit(fl):
    L = fl.layers
    logits = L.data(name="lg", shape=[6, 5])
    loss = L.warpctc(logits, L.data(name="lb", shape=[2], dtype="int64"))
    aligned, alen = L.ctc_greedy_decoder(logits, blank=0)
    dist, n = L.edit_distance(
        L.data(name="h", shape=[4], dtype="int64"),
        L.data(name="r", shape=[5], dtype="int64"),
        input_length=L.data(name="hl", shape=[], dtype="int64"),
        label_length=L.data(name="rl", shape=[], dtype="int64"))
    rng = np.random.RandomState(0)
    return [loss, aligned, alen, dist, n], [{
        "lg": rng.randn(2, 6, 5).astype(np.float32),
        "lb": np.array([[1, 2], [3, 3]], np.int64),
        "h": np.array([[1, 2, 3, 0], [1, 1, 1, 1]], np.int64),
        "r": np.array([[1, 3, 3, 0, 0], [2, 2, 0, 0, 0]], np.int64),
        "hl": np.array([3, 4], np.int64), "rl": np.array([3, 2], np.int64)}]


#: the programs chip_smoke.py runs on the card against the CPU
CF_PROGRAMS = {"while_train": while_train, "ifelse": ifelse,
               "switch_default": switch_default, "ssd": ssd,
               "ctc_edit": ctc_edit}
