"""The models of the ``networks`` helpers of item 11b, each written for
the package it is given (``paddle_tpu`` or ``paddle_tpu_torch``) and
importing neither: ``CONFIGS[name](paddle)`` returns the model's cost, and
``feed(topo, padded, batch, seed)`` seeded numpy feeds.  The CPU tests
hold the port against the JAX package with them
(``test_torch_networks_rest.py``); ``chip_smoke.py`` runs them on the card
against the CPU."""

import numpy as np


def _mha(paddle):
    L, dt = paddle.layer, paddle.data_type
    q = L.data("q", dt.dense_vector_sequence(8, max_len=5))
    kv = L.data("kv", dt.dense_vector_sequence(8, max_len=6))
    att = paddle.networks.multi_head_attention(q, kv, kv, head_num=2,
                                               name="mha")
    return L.sum_cost(L.pooling(att, pooling_type="sum"))


def _dot_attention(paddle):
    L, dt = paddle.layer, paddle.data_type
    enc = L.data("enc", dt.dense_vector_sequence(6, max_len=5))
    att = L.data("att", dt.dense_vector_sequence(4, max_len=5))
    state = L.fc(L.data("s", dt.dense_vector(3)), size=6, act="tanh")
    ctx = paddle.networks.dot_product_attention(enc, att, state, name="dpa")
    return L.sum_cost(ctx)


def _lstmemory_unit(paddle):
    L, dt = paddle.layer, paddle.data_type
    x = L.data("x", dt.dense_vector_sequence(6, max_len=5))

    def step(inp):
        return paddle.networks.lstmemory_unit(inp, size=4, name="lu")

    out = L.recurrent_group(step=step, input=x, name="lu_rg")
    return L.sum_cost(L.last_seq(out))


def _lstmemory_group(paddle):
    L, dt = paddle.layer, paddle.data_type
    x = L.data("x", dt.dense_vector_sequence(6, max_len=5))
    out = paddle.networks.lstmemory_group(x, size=4, reverse=True,
                                          name="lg")
    return L.sum_cost(L.pooling(out, pooling_type="sum"))


def _gru_unit(paddle):
    L, dt = paddle.layer, paddle.data_type
    x = L.data("x", dt.dense_vector_sequence(6, max_len=5))
    proj = L.fc(x, size=12, act=None, bias_attr=False, name="gproj")
    boot = L.fc(L.data("b", dt.dense_vector(3)), size=4, act="tanh",
                name="boot")

    def step(inp):
        return paddle.networks.gru_unit(inp, size=4, memory_boot=boot,
                                        name="gu")

    out = L.recurrent_group(step=step, input=proj, name="gu_rg")
    return L.sum_cost(L.last_seq(out))


def _gru_group(paddle):
    L, dt = paddle.layer, paddle.data_type
    x = L.data("x", dt.dense_vector_sequence(6, max_len=5))
    proj = L.fc(x, size=12, act=None, bias_attr=False, name="gproj")
    out = paddle.networks.gru_group(proj, size=4, reverse=True, name="gg")
    return L.sum_cost(L.pooling(out, pooling_type="avg"))


def _simple_gru2(paddle):
    L, dt = paddle.layer, paddle.data_type
    x = L.data("x", dt.dense_vector_sequence(6, max_len=5))
    out = paddle.networks.simple_gru2(x, size=4)
    return L.sum_cost(L.last_seq(out))


def _sequence_conv_pool(paddle):
    L, dt = paddle.layer, paddle.data_type
    w = L.data("w", dt.integer_value_sequence(20, max_len=6))
    emb = L.embedding(w, size=6)
    a = paddle.networks.sequence_conv_pool(emb, context_len=3,
                                           hidden_size=5, fc_act="tanh",
                                           name="scp")
    b = paddle.networks.text_conv_pool(emb, context_len=2, hidden_size=3,
                                       pool_type="avg", name="tcp")
    return L.sum_cost(L.concat([a, b]))


CONFIGS = {
    "multi_head_attention": _mha,
    "dot_product_attention": _dot_attention,
    "lstmemory_unit": _lstmemory_unit,
    "lstmemory_group": _lstmemory_group,
    "gru_unit": _gru_unit,
    "gru_group": _gru_group,
    "simple_gru2": _simple_gru2,
    "sequence_conv_pool": _sequence_conv_pool,
}


def feed(topo, padded, batch=3, seed=3):
    """Seeded numpy feeds for every data layer of ``topo`` (padded: rows
    of full, full - 2 and 1 steps, repeated)."""
    rng = np.random.RandomState(seed)
    out = {}
    for spec in topo.specs:
        if spec.kind != "data":
            continue
        a = spec.attrs
        seq = a.get("seq_type", 0) != 0
        t = a.get("max_len") or 5
        shape = (batch, t) if seq else (batch,)
        if a.get("is_index"):
            out[spec.name] = rng.randint(0, a["dim"], shape).astype(
                np.int32)
        else:
            out[spec.name] = rng.randn(*shape, a["dim"]).astype(np.float32)
        if seq and padded:
            out[spec.name + "@len"] = np.resize(
                np.array([t, t - 2, 1], np.int32), batch)
    return out
