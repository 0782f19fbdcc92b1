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


# configs whose outputs only pin the JSON: "operators" pools a flattened
# [B, 128] map with global_pool, which wants an image (both packages
# refuse it); its two operators run in the CPU tests' own configs
PROTO_ONLY = frozenset({"operators"})


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


FEEDS = {"beam_cross_entropy": _beam_feed, "seq_ops": _seq_ops_feed}


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
