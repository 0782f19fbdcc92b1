"""The long-tail layers of ``layers/misc.py`` in the PyTorch port against
the JAX package on the CPU: each layer's output and every parameter and
input gradient from the same weights and the same seeded numpy feed
(tolerance 1e-5 absolute and relative, as ``test_torch_layer_parity``).
Beside them: ``sampling_id``'s draws follow the input distribution (the
two packages cannot draw the same numbers), ``print`` prints and passes
its input through, ``selective_fc`` under softmax gives zeros for an empty
selection, and ``get_output`` of an lstm_step.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import torch_layer_configs as layer_configs
from test_torch_layer_parity import assert_parity, both


def _dv(paddle):
    return paddle.data_type.dense_vector


def _image(paddle, name, c, h, w):
    return paddle.layer.data(name, _dv(paddle)(c * h * w), height=h,
                             width=w)


def _power(p):
    l = p.layer
    w = l.data("w", _dv(p)(1))
    a = l.data("a", _dv(p)(6))
    return l.sum_cost(l.power(w, a, name="pow"))


def _norms(p):
    l = p.layer
    x = l.data("x", _dv(p)(8))
    img = _image(p, "img", 3, 4, 5)
    return [l.sum_cost(l.sum_to_one_norm(l.activation(x, act="exp"),
                                         name="s2one")),
            l.sum_cost(l.global_pool(l.cross_channel_norm(img, name="ccn")),
                       name="c2")]


def _products(p):
    l = p.layer
    a = l.data("a", _dv(p)(5))
    b = l.data("b", _dv(p)(4))
    c = l.data("c", _dv(p)(5))
    wts = l.data("wts", _dv(p)(3))
    vecs = l.data("vecs", _dv(p)(12))
    return l.sum_cost(l.concat([
        l.out_prod(a, b, name="outer"), l.l2_distance(a, c, name="l2"),
        l.linear_comb(wts, vecs, size=4, name="lcomb"),
        l.convex_comb(wts, vecs, size=4, name="ccomb"),
        l.eltmul(a, c, name="mul"),
        l.tensor(a, b, size=3, act="tanh", name="tensor"),
        l.tensor(a, b, size=2, bias_attr=False, name="tensor_nb"),
        l.conv_shift(a, l.fc(b, size=3, name="kern"), name="cshift"),
        l.factorization_machine(a, factor_size=3, name="fm")]))


def _select(p):
    l = p.layer
    dv, iv = _dv(p), p.data_type.integer_value
    idx = l.data("index", iv(3))
    a, b, c = (l.data(n, dv(4)) for n in ("a", "b", "c"))
    x = l.data("x", dv(6))
    sel = l.data("sel", dv(5))
    outs = [l.multiplex(idx, a, b, c, name="mux"),
            l.repeat(x, 3, name="rep_row"),
            l.repeat(x, 2, as_row_vector=False, name="rep_col"),
            l.scale_shift(x, name="ss"),
            l.scale_shift(x, bias_attr=False, name="ss_nb"),
            l.prelu(x, name="prelu_all"),
            l.prelu(x, partial_sum_mode="channel", name="prelu_ch"),
            l.clip(x, -0.5, 0.7, name="clip"),
            l.selective_fc(x, sel, size=5, act="softmax", name="sfc_soft"),
            l.selective_fc(x, sel, size=5, act="tanh", name="sfc_tanh"),
            l.gated_unit(x, size=4, act="relu", name="gated")]
    return [l.sum_cost(o, name=f"c_{o.name}") for o in outs] + [
        l.maxid(x, name="maxid"), l.eos(idx, eos_id=2, name="eos")]


def _shapes(p):
    l = p.layer
    img = _image(p, "img", 2, 4, 3)
    x = l.data("x", _dv(p)(12))
    rot = l.rotate(img, name="rot")
    sw = l.switch_order(img, reshape_axis=[3, 1, 2], name="sw")
    ssr = l.scale_sub_region(img, l.data("ind", _dv(p)(6)), value=3.0,
                             name="ssr")
    return [l.sum_cost(l.fc(rot, size=3, name="f_rot"), name="c_rot"),
            l.sum_cost(l.fc(sw, size=3, name="f_sw"), name="c_sw"),
            l.sum_cost(l.fc(ssr, size=3, name="f_ssr"), name="c_ssr"),
            l.sum_cost(l.fc(l.resize(x, 4, name="rs"), size=2, name="f_rs"),
                       name="c_rs")]


def _seq(p):
    l = p.layer
    x = l.data("x", p.data_type.dense_vector_sequence(5, max_len=6))
    img = _image(p, "img", 2, 6, 8)
    rc = l.row_conv(x, context_len=3, name="rowconv")
    be = l.block_expand(img, block_x=2, block_y=3, stride_x=2, stride_y=3,
                        name="bexp")
    be2 = l.block_expand(img, block_x=3, block_y=2, stride_x=1, stride_y=2,
                         name="bexp_overlap")
    return [l.sum_cost(l.pooling(rc, pooling_type="sum"), name="c_rc"),
            l.sum_cost(l.fc(l.pooling(be, pooling_type="max"), size=3,
                            name="f_be"), name="c_be"),
            l.sum_cost(l.last_seq(be2), name="c_be2")]


def _ind_feed(rng, b):
    a = rng.randint(1, 5, (b, 2, 2))
    a.sort(-1)
    ind = np.zeros((b, 6), np.float32)
    ind[:, :4] = a.reshape(b, 4)
    return ind


CONFIGS = {"power": _power, "norms": _norms, "products": _products,
           "select": _select, "shapes": _shapes, "seq": _seq}


def _feed(name, ttopo, padded):
    fd = layer_configs.feed(ttopo, batch=4, seed=13, padded=padded)
    rng = np.random.RandomState(17)
    if name == "power":
        fd["a"] = np.abs(fd["a"]) + 0.1
    if name == "norms":
        fd["img"] = np.abs(fd["img"])
    if name == "select":
        sel = (rng.rand(4, 5) > 0.4).astype(np.float32)
        sel[1] = 0.0                      # an empty selection
        fd["sel"] = sel
        fd["index"] = np.array([2, 0, 1, 2], np.int32)
    if name == "shapes":
        fd["ind"] = _ind_feed(rng, 4)
    return fd


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_misc_layers_match_jax(name, padded):
    ttopo, jtopo, values = both(CONFIGS[name])
    assert_parity(ttopo, jtopo, values, _feed(name, ttopo, padded))


def test_selective_fc_softmax_of_an_empty_selection_is_zero():
    """Under softmax the selected columns sum to 1, the others are 0, and
    a row that selects nothing is all 0 (not NaN)."""
    def cfg(paddle):
        l = paddle.layer
        return l.selective_fc(l.data("x", _dv(paddle)(6)),
                              l.data("sel", _dv(paddle)(5)), size=5,
                              act="softmax", name="sfc")

    ttopo, _, values = both(cfg)
    fd = _feed("select", ttopo, False)
    params = pt.parameters.from_numpy(ttopo, values, device="cpu").values
    out = ttopo.forward(params, {}, fd, device="cpu")[0]["sfc"].numpy()
    sel = fd["sel"]
    assert (out[sel == 0] == 0).all() and (out[1] == 0).all()
    np.testing.assert_allclose(out[sel.sum(1) > 0].sum(1), 1.0, rtol=1e-6)


def test_sampling_id_draws_follow_the_distribution():
    """Draws of the port's Gumbel-max sampler from its generator: each
    row's frequencies within 0.02 of its probabilities over 20000 draws,
    and the same generator seed gives the same draws."""
    pt.init(seed=0, device="cpu")
    probs = torch.tensor([[0.1, 0.6, 0.3, 0.0],
                          [0.25, 0.25, 0.25, 0.25]]).repeat(10000, 1)
    lyr = pt.layer.data("p", pt.data_type.dense_vector(4))
    topo = pt.Topology(pt.layer.sampling_id(lyr, name="sid"))
    draws = [topo.forward({}, {}, {"p": probs}, device="cpu",
                          generator=torch.Generator().manual_seed(s))[0]
             ["sid"] for s in (5, 5, 6)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    ids = draws[0].numpy()
    for row, p in ((0, [0.1, 0.6, 0.3, 0.0]), (1, [0.25] * 4)):
        freq = np.bincount(ids[row::2], minlength=4) / 10000
        np.testing.assert_allclose(freq, p, atol=0.02)
    with pytest.raises(ValueError, match="rng"):
        topo.forward({}, {}, {"p": probs}, device="cpu")


def test_print_layer_prints_and_passes_through(capsys):
    pt.init(seed=0, device="cpu")
    x = pt.layer.data("x", pt.data_type.dense_vector(3))
    topo = pt.Topology(pt.layer.printer(x, format="x={}", name="pr"))
    out, _ = topo.forward({}, {}, {"x": np.ones((2, 3), np.float32)},
                          device="cpu")
    assert torch.equal(out["pr"], torch.ones(2, 3))
    assert "x=[[1. 1. 1.]" in capsys.readouterr().out


def test_get_output_of_an_lstm_step_matches_jax():
    def cfg(paddle):
        l = paddle.layer
        x = l.data("x", _dv(paddle)(16))
        mem = l.data("mem", _dv(paddle)(8))      # [h | c]
        step = l.lstm_step_layer(x, mem, size=4, name="step")
        return [l.sum_cost(l.get_output(step, "state", name="h")),
                l.sum_cost(l.get_output(step, "cell", name="c"))]

    ttopo, jtopo, values = both(cfg)
    assert_parity(ttopo, jtopo, values,
                  layer_configs.feed(ttopo, batch=3, seed=2))
    with pytest.raises(ValueError, match="unsupported"):
        pt.layer.get_output(pt.layer.data("y", _dv(pt)(2)), "state")
