"""The golden layer configs that use only ported layers, and seeded feeds
for them.

Each config is ``fn(paddle, transformer) -> output(s)``, written against
the package passed in: ``paddle`` is ``paddle_tpu_torch`` or
``paddle_tpu`` and ``transformer`` that package's ``models.transformer``
(the fused-head LM's builder), so one function builds the port's graph or
the JAX package's without this module importing either
(``tests/test_golden_ir.py`` pins the JSON of these configs by name in
``tests/goldens/``).  ``feed(topology, batch, seed, padded)`` makes a
feed from the topology's data layers with numpy's seeded generator.  The
CPU tests hold each config's forward and gradients against the JAX
package, and ``chip_smoke.py`` runs each forward and backward on the card
against the same config on the CPU, both in the port.
"""

from __future__ import annotations

import numpy as np

CONFIGS = {}


def config(name, lm=False):
    """Register ``fn`` as CONFIGS[name]: ``fn(paddle, transformer)`` with
    ``lm``, else ``fn(paddle)``, which ignores the transformer."""
    def deco(fn):
        CONFIGS[name] = fn if lm else (
            lambda paddle, transformer: fn(paddle))
        return fn
    return deco


def _types(paddle):
    dt = paddle.data_type
    return (dt.dense_vector, dt.dense_vector_sequence, dt.integer_value,
            dt.integer_value_sequence)


@config("fused_head_lm_r4", lm=True)
def _(paddle, transformer):
    cost, logits = transformer.build(vocab_size=64, max_len=16, dim=32,
                                     num_heads=2, num_layers=1,
                                     fused_head=True)
    return [cost, logits]


@config("cost_layers")
def _(paddle):
    layer = paddle.layer
    dv, _, iv, _ = _types(paddle)
    x = layer.data("x", dv(10))
    lbl = layer.data("label", iv(5))
    lbl2 = layer.data("label2", iv(2))
    reg = layer.data("reg", dv(1))
    pred = layer.fc(x, size=5, act="softmax", name="pred")
    score = layer.fc(x, size=1, act="sigmoid", name="score")
    return [
        layer.classification_cost(pred, lbl, name="ce"),
        layer.cross_entropy_cost(pred, lbl, name="xent"),
        layer.square_error_cost(score, reg, name="mse"),
        layer.hinge_cost(score, lbl2, name="hinge"),
        layer.log_loss(score, lbl2, name="logloss"),
        layer.huber_regression_cost(score, reg, name="huber_r"),
        layer.huber_classification_cost(score, lbl2, name="huber_c"),
        layer.smooth_l1_cost(score, reg, name="sl1"),
    ]


@config("cost_layers_with_weight")
def _(paddle):
    layer = paddle.layer
    dv, _, iv, _ = _types(paddle)
    x = layer.data("x", dv(10))
    lbl = layer.data("label", iv(3))
    w = layer.data("w", dv(1))
    pred = layer.fc(x, size=3, act="softmax", name="pred")
    return layer.classification_cost(pred, lbl, weight=w, name="wce")


@config("smooth_l1")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    pred = layer.data("input", dv(300))
    lbl = layer.data("label", dv(300))
    return layer.smooth_l1_cost(pred, lbl, name="smooth")


@config("hsigmoid")
def _(paddle):
    layer = paddle.layer
    dv, _, iv, _ = _types(paddle)
    x = layer.data("x", dv(32))
    lbl = layer.data("label", iv(10))
    return layer.hsigmoid(x, lbl, num_classes=10, name="hs")


@config("sampling_costs")
def _(paddle):
    layer = paddle.layer
    dv, _, iv, _ = _types(paddle)
    x = layer.data("x", dv(10))
    lbl = layer.data("label", iv(100))
    h = layer.fc(x, size=16, act="tanh", name="h")
    nce = layer.nce_cost(h, lbl, num_classes=100, num_neg_samples=5,
                         name="nce")
    hs = layer.hsigmoid(h, lbl, num_classes=100, name="hsig")
    return [nce, hs]


@config("beam_cross_entropy")
def _(paddle):
    layer = paddle.layer
    dv, _, iv, _ = _types(paddle)
    ins = []
    for e in range(2):
        sc = layer.data(f"sc{e}", dv(6))
        sel = layer.data(f"sel{e}", dv(3))
        gold = layer.data(f"g{e}", iv(6))
        ins.append(layer.BeamInput(sc, sel, gold))
    return layer.cross_entropy_over_beam(ins, name="beam_ce")


@config("shared_fc")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    a = layer.data("a", dv(8))
    b = layer.data("b", dv(8))
    fa = layer.fc(a, size=4, act="tanh", name="tower")
    fb = layer.fc(b, size=4, act="tanh", share_from="tower", name="tower2")
    lbl = layer.data("l", dv(1))
    return layer.rank_cost(layer.fc(fa, size=1), layer.fc(fb, size=1),
                           lbl, name="rank")


@config("sequence_pooling")
def _(paddle):
    layer = paddle.layer
    dvs = _types(paddle)[1]
    x = layer.data("x", dvs(8, max_len=6))
    outs = [layer.pooling(x, pooling_type=t, name=f"pool_{t}")
            for t in ("max", "avg", "sum", "sqrt")]
    return layer.sum_cost(layer.concat(outs))


@config("last_first_seq")
def _(paddle):
    layer = paddle.layer
    dvs = _types(paddle)[1]
    x = layer.data("x", dvs(8, max_len=10))
    fs = layer.first_seq(x, name="first")
    ls = layer.last_seq(x, name="last")
    pool = layer.pooling(x, pooling_type="avg", name="avg")
    return layer.sum_cost(layer.concat([fs, ls, pool]))


@config("seq_ops")
def _(paddle):
    layer = paddle.layer
    dvs = _types(paddle)[1]
    x = layer.data("x", dvs(6, max_len=5))
    y = layer.data("y", dvs(6, max_len=4))
    cat = layer.seq_concat(x, y, name="cat")
    soft = layer.seq_softmax(layer.seq_dot(x, x, name="dot"), name="soft")
    resh = layer.seq_reshape(x, 12, name="resh")
    sl = layer.seq_slice(x, 1, 4, name="slice")
    ctxp = layer.context_projection(x, context_len=3, name="ctxp")
    parts = [layer.pooling(p, pooling_type="sum")
             for p in (cat, soft, resh, sl, ctxp)]
    return layer.sum_cost(layer.concat(parts))


@config("seq_concat_reshape")
def _(paddle):
    layer = paddle.layer
    dvs = _types(paddle)[1]
    a = layer.data("a", dvs(8, max_len=5))
    b = layer.data("b", dvs(8, max_len=4))
    cat = layer.seq_concat(a, b, name="cat")
    resh = layer.seq_reshape(a, 4, name="resh")
    return [layer.sum_cost(layer.last_seq(cat), name="c1"),
            layer.sum_cost(layer.last_seq(resh), name="c2")]


@config("seq_slice_layer")
def _(paddle):
    layer = paddle.layer
    dvs = _types(paddle)[1]
    x = layer.data("x", dvs(8, max_len=10))
    sl = layer.seq_slice(x, 2, 7, name="slice")
    return layer.sum_cost(layer.last_seq(sl))


@config("expand_layer")
def _(paddle):
    layer = paddle.layer
    dv, dvs, _, _ = _types(paddle)
    s = layer.data("scalar", dv(4))
    seq = layer.data("seq", dvs(4, max_len=5))
    ex = layer.expand(s, seq, name="expand")
    return layer.sum_cost(layer.last_seq(ex))


@config("kmax_seq_score_layer")
def _(paddle):
    layer = paddle.layer
    dvs = _types(paddle)[1]
    x = layer.data("scores", dvs(1, max_len=8))
    k = layer.kmax_seq_score(x, beam_size=3, name="kmax")
    return layer.sum_cost(k)


@config("attention_transformer")
def _(paddle):
    layer = paddle.layer
    dvs = _types(paddle)[1]
    x = layer.data("x", dvs(16, max_len=12))
    att = layer.multi_head_attention(x, size=16, num_heads=4, causal=True,
                                     name="mha")
    ln = layer.layer_norm(layer.addto([x, att], name="res"), name="ln")
    pe = layer.position_embedding(ln, max_len=12, name="pos")
    return layer.sum_cost(layer.pooling(pe, pooling_type="sum"))


@config("projections")
def _(paddle):
    layer = paddle.layer
    dv, _, iv, _ = _types(paddle)
    x = layer.data("x", dv(10))
    y = layer.data("y", dv(16))
    ids = layer.data("ids", iv(50))
    m = layer.mixed(16, [
        layer.full_matrix_projection(x, size=16),
        layer.trans_full_matrix_projection(
            layer.fc(y, size=16, name="pre"), size=16),
        layer.identity_projection(y),
        layer.dotmul_projection(y),
        layer.scaling_projection(y),
        layer.table_projection(ids, size=16, vocab_size=50),
        layer.slice_projection(y, [(0, 16)]),
    ], act="tanh", bias_attr=True, name="mix")
    return layer.sum_cost(m)


@config("operators")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    img = layer.data("image", dv(1 * 8 * 8), height=8, width=8)
    flt = layer.data("flt", dv(2 * 1 * 3 * 3))
    a = layer.data("a", dv(8))
    b = layer.data("b", dv(8))
    m = layer.mixed(None, [
        layer.conv_operator(img, flt, filter_size=3, num_filters=2,
                            padding=1)], name="convop")
    d = layer.mixed(8, [layer.dotmul_operator(a, b, scale=2.0)],
                    name="dotop")
    return [layer.sum_cost(layer.global_pool(m), name="c1"),
            layer.sum_cost(d, name="c2")]


@config("util_layers")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    a = layer.data("a", dv(10))
    b = layer.data("b", dv(10))
    s = layer.addto([a, b], act="relu", name="add")
    c = layer.concat([a, b], name="concat")
    m = layer.mixed(10, [layer.identity_projection(a)], name="ident")
    return layer.sum_cost(layer.concat([s, c, m]))


@config("dot_prod_layer")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    a = layer.data("a", dv(10))
    b = layer.data("b", dv(10))
    return layer.sum_cost(layer.dot_prod(a, b, name="dp"))


@config("row_l2_norm_layer")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    x = layer.data("input", dv(300))
    return layer.sum_cost(layer.row_l2_norm(x, name="rownorm"))


@config("sparse_embedding_ctr")
def _(paddle):
    layer = paddle.layer
    _, _, iv, ivs = _types(paddle)
    ids = layer.data("ids", ivs(100000, max_len=8))
    lbl = layer.data("y", iv(2))
    emb = layer.embedding(
        ids, size=16, vocab_size=100000, name="emb",
        param_attr=paddle.attr.ParamAttr(sparse_update=True))
    pooled = layer.pooling(emb, pooling_type="sum")
    return layer.classification_cost(
        layer.fc(pooled, size=2, act="softmax", name="out"), lbl)


# ------------------------------------- the recurrent slice's goldens
@config("multi_out_group_r4")
def _(paddle):
    layer = paddle.layer
    _, dvs, iv, _ = _types(paddle)
    h = 6
    x = layer.data("gx", dvs(3 * h, max_len=5))
    y = layer.data("gy", iv(3))

    def step(ipt):
        mem = layer.memory(name="g_s", size=h)
        st = layer.gru_step_layer(ipt, mem, name="g_s")
        p = layer.fc(st, size=3, act="tanh", name="g_p")
        return st, p

    s_out, p_out = layer.recurrent_group(step, x, name="ggrp")
    pred = layer.fc(layer.last_seq(layer.concat([s_out, p_out])), size=3,
                    name="gpred")
    return layer.classification_cost(pred, y, name="gcost")


def _shared_rnn(paddle, which):
    layer, networks = paddle.layer, paddle.networks
    _, _, iv, ivs = _types(paddle)
    a = layer.data("a", ivs(100, max_len=8))
    b = layer.data("b", ivs(100, max_len=8))
    if which == "gru":
        emb = paddle.attr.ParamAttr(name="shared_emb")
        ea = layer.embedding(a, 32, param_attr=emb, name="emb_a")
        eb = layer.embedding(b, 32, param_attr=emb, name="emb_b")
        r1 = networks.simple_gru(ea, size=16, name="gru_shared")
        r2 = networks.simple_gru(eb, size=16, name="gru_shared2")
    else:
        emb = paddle.attr.ParamAttr(name="shared_emb_l")
        ea = layer.embedding(a, 32, param_attr=emb, name="lemb_a")
        eb = layer.embedding(b, 32, param_attr=emb, name="lemb_b")
        r1 = networks.simple_lstm(ea, size=16, name="lstm_a")
        r2 = networks.simple_lstm(eb, size=16, name="lstm_b")
    feat = layer.concat([layer.last_seq(r1), layer.last_seq(r2)])
    return layer.classification_cost(
        layer.fc(feat, size=3, act="softmax", name="out"),
        layer.data("label", iv(3)))


@config("shared_gru")
def _(paddle):
    return _shared_rnn(paddle, "gru")


@config("shared_lstm")
def _(paddle):
    return _shared_rnn(paddle, "lstm")


@config("networks_seq")
def _(paddle):
    layer, networks = paddle.layer, paddle.networks
    _, _, iv, ivs = _types(paddle)
    words = layer.data("words", ivs(5000, max_len=20))
    emb = layer.embedding(words, size=32, name="emb")
    lstm = networks.simple_lstm(emb, size=32)
    gru = networks.simple_gru(emb, size=32)
    lbl = layer.data("label", iv(2))
    feat = layer.concat([layer.last_seq(lstm), layer.last_seq(gru)])
    return layer.classification_cost(
        layer.fc(feat, size=2, act="softmax", name="out"), lbl)


@config("nested_recurrent_group")
def _(paddle):
    layer = paddle.layer
    d = 4
    doc = layer.data("doc", paddle.data_type.dense_vector_sub_sequence(
        d, sub_max=3, max_len=6))

    def outer(sent):
        pooled = layer.pooling(sent, pooling_type="sum")
        acc = layer.memory(name="acc", size=d)
        return layer.addto([pooled, acc], act="linear", name="acc")

    grp = layer.recurrent_group(outer, layer.SubsequenceInput(doc),
                                name="outer_grp")
    return layer.sum_cost(layer.last_seq(grp))


@config("sub_nested_seq_select")
def _(paddle):
    layer = paddle.layer
    dvs = _types(paddle)[1]
    x = layer.data("x", dvs(4, max_len=5))
    scores = layer.data("scores", dvs(1, max_len=5))
    sel = layer.sub_nested_seq(x, scores, k=2, name="subsel")
    return layer.sum_cost(layer.last_seq(sel))


@config("mdlstm_datanorm_r5")
def _(paddle):
    layer = paddle.layer
    dv, dvs, _, _ = _types(paddle)
    x = layer.data("x", dv(6))
    dn = layer.data_norm(x, data_norm_strategy="min-max", name="dn")
    seq = layer.data("grid", dvs(15, max_len=6))
    md = layer.mdlstmemory(seq, directions=(True, False),
                           grid_dims=(2, 3), name="md")
    pooled = layer.pooling(md, pooling_type="sum")
    joint = layer.fc([dn, pooled], size=4, name="joint")
    return layer.sum_cost(joint)


def volume(paddle, name, shape):
    """A volume data layer (NDHWC per sample), as the goldens declare it."""
    dim = int(np.prod(shape))
    return paddle.layer.LayerOutput(
        "data", [], {"shape": list(shape), "seq_type": 0,
                     "is_index": False, "dim": dim}, name=name)


@config("img_trans_layers")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    img = layer.data("image", dv(2 * 8 * 8), height=8, width=8)
    ct = layer.img_conv_transpose(img, filter_size=2, num_filters=4,
                                  stride=2, name="deconv")
    mo = layer.maxout(ct, groups=2, name="maxout")
    bi = layer.bilinear_interp(mo, 8, 8, name="interp")
    cr = layer.crop(bi, 6, 6, offset=(1, 1), name="crop")
    pd = layer.pad(cr, pad_h=(1, 1), pad_w=(1, 1), name="pad")
    return layer.sum_cost(layer.global_pool(pd, name="gp"))


@config("bilinear_interp")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    img = layer.data("image", dv(2 * 8 * 8), height=8, width=8)
    c = layer.img_conv(img, filter_size=3, num_filters=4, padding=1,
                       name="conv")
    bi = layer.bilinear_interp(c, 16, 16, name="interp")
    return layer.sum_cost(layer.global_pool(bi))


@config("crop_layer")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    img = layer.data("image", dv(2 * 8 * 8), height=8, width=8)
    cr = layer.crop(img, 6, 6, offset=(1, 1), name="crop")
    return layer.sum_cost(layer.global_pool(cr))


@config("maxout_layer")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    img = layer.data("image", dv(4 * 8 * 8), height=8, width=8)
    c = layer.img_conv(img, filter_size=3, num_filters=8, padding=1,
                       name="conv")
    mo = layer.maxout(c, groups=2, name="maxout")
    return layer.sum_cost(layer.global_pool(mo))


@config("pad_layer")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    img = layer.data("image", dv(2 * 6 * 6), height=6, width=6)
    pd = layer.pad(img, pad_h=(1, 2), pad_w=(3, 4), pad_c=(2, 1),
                   name="pad")
    return layer.sum_cost(layer.global_pool(pd))


@config("spp_layer")
def _(paddle):
    layer = paddle.layer
    dv = _types(paddle)[0]
    img = layer.data("image", dv(1 * 8 * 8), height=8, width=8)
    s = layer.spp(img, pyramid_height=2, pool_type="max", name="spp")
    return layer.sum_cost(s)


@config("conv3d_layer")
def _(paddle):
    layer = paddle.layer
    vol = volume(paddle, "vol", (4, 4, 4, 1))
    c = layer.img_conv3d(vol, filter_size=3, num_filters=2, padding=1,
                         act="relu", name="conv3d")
    return layer.sum_cost(c)


@config("deconv3d_layer")
def _(paddle):
    layer = paddle.layer
    vol = volume(paddle, "vol", (2, 2, 2, 2))
    d = layer.img_conv3d_transpose(vol, filter_size=2, num_filters=2,
                                   stride=2, act="relu", name="deconv3d")
    return layer.sum_cost(d)


@config("pooling3d_layer")
def _(paddle):
    layer = paddle.layer
    vol = volume(paddle, "vol", (4, 4, 4, 2))
    p = layer.img_pool3d(vol, pool_size=2, pool_type="avg", name="pool3d")
    return layer.sum_cost(p)


@config("batch_norm_3d")
def _(paddle):
    layer = paddle.layer
    vol = volume(paddle, "vol", (4, 4, 4, 2))
    c = layer.img_conv3d(vol, filter_size=3, num_filters=4, act=None,
                         name="c3d")
    bn = layer.batch_norm(c, act="relu", name="bn3d")
    return layer.sum_cost(bn)


@config("networks_vgg")
def _(paddle):
    layer = paddle.layer
    dv, _, iv, _ = _types(paddle)
    img = layer.data("image", dv(3 * 32 * 32), height=32, width=32)
    net = paddle.networks.img_conv_group(
        input=img, conv_num_filter=[16, 16], conv_filter_size=3,
        conv_act="relu", pool_size=2, pool_stride=2,
        conv_with_batchnorm=True)
    lbl = layer.data("label", iv(10))
    return layer.classification_cost(
        layer.fc(net, size=10, act="softmax", name="out"), lbl)


# configs whose outputs only pin the JSON: "operators" pools a flattened
# [B, 128] map with global_pool, which wants an image (both packages
# refuse it); its two operators run in the CPU tests' own configs
PROTO_ONLY = frozenset({"operators"})

# configs whose forward runs in train mode, their batch norms on the
# batch's statistics (the 3-D one on the plain statistics in both
# packages); the others run in eval mode
TRAIN = frozenset({"batch_norm_3d", "networks_vgg"})


def _beam_feed(rng, batch):
    """beam_cross_entropy: 2 parents x 3 candidates, selected indices in
    [-1, 6) (one dead slot), gold in [0, 6)."""
    out = {}
    for e in range(2):
        out[f"sc{e}"] = rng.standard_normal((batch, 6)).astype(np.float32)
        sel = np.stack([rng.permutation(6)[:3] for _ in range(batch)])
        sel[0, -1] = -1
        out[f"sel{e}"] = sel.astype(np.float32)
        out[f"g{e}"] = rng.randint(0, 6, batch).astype(np.int32)
    # the first row's gold stays on the beam, the second's falls off
    out["g0"][0] = int(out["sel0"][0, 0])
    out["g1"][0] = int(out["sel1"][0, 1])
    return out


def _seq_ops_feed(rng, batch):
    """seq_ops reshapes x's [T, 6] steps into rows of 12, which needs an
    even T in both packages (the declared max_len is 5): x is fed at T 4."""
    out = {"x": rng.standard_normal((batch, 4, 6)).astype(np.float32),
           "y": rng.standard_normal((batch, 4, 6)).astype(np.float32)}
    out["x@len"] = np.array([4] + [2, 4, 1, 3] * batch, np.int32)[:batch]
    out["y@len"] = np.array([3] + [4, 1, 2] * batch, np.int32)[:batch]
    return out


def _nested_feed(rng, batch):
    """nested_recurrent_group: documents of up to 3 sentences of up to 6
    words, 4 wide; ragged at both levels, a padded sentence of 0 words
    after each short document's last."""
    outer = rng.randint(1, 4, batch)
    outer[0] = 3
    sub = rng.randint(1, 7, (batch, 3))
    sub[np.arange(3)[None, :] >= outer[:, None]] = 0
    return {"doc": rng.standard_normal((batch, 3, 6, 4)).astype(np.float32),
            "doc@len": outer.astype(np.int32),
            "doc@sublen": sub.astype(np.int32)}


FEEDS = {"beam_cross_entropy": _beam_feed, "seq_ops": _seq_ops_feed,
         "nested_recurrent_group": _nested_feed}


def feed(topology, batch: int = 4, seed: int = 0, padded: bool = False,
         name: str = None) -> dict:
    """A seeded feed for every data layer of ``topology``: ints below the
    layer's dim for index data, standard normals for dense data, each
    sequence at its max_len, with ``<name>@len`` lengths in [1, max_len]
    (the first row full) when ``padded``; ``name`` picks a config's own
    feed from FEEDS."""
    rng = np.random.RandomState(seed)
    if name in FEEDS:
        return FEEDS[name](rng, batch)
    out = {}
    for spec in topology.specs:
        if spec.kind != "data":
            continue
        a = spec.attrs
        seq = a.get("seq_type", 0) == 1
        lead = (batch, a["max_len"]) if seq else (batch,)
        if a.get("is_index"):
            out[spec.name] = rng.randint(0, a["dim"], lead).astype(np.int32)
        else:
            out[spec.name] = rng.standard_normal(
                lead + tuple(a["shape"])).astype(np.float32)
        if seq and padded:
            lens = rng.randint(1, a["max_len"] + 1, batch)
            lens[0] = a["max_len"]
            out[spec.name + "@len"] = lens.astype(np.int32)
    return out
