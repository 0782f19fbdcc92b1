"""Sparse (ids + values) inputs in the PyTorch port: ``DataFeeder``'s
fixed-nnz packing and the ``fc`` over a sparse input, against the JAX
package on the CPU; the port's counterpart of ``tests/test_sparse_input.py``.

Feeds come from numpy; both packages start from the JAX package's weights,
carried across as numpy.  Tolerances: the feeder's arrays equal; the fc's
output and gradients within 1e-5 of the JAX package's and of the dense
product on the densified vectors (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.data_feeder import DataFeeder as JaxFeeder
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.data_feeder import DataFeeder

TOL = dict(rtol=1e-5, atol=1e-5)
DIM, SIZE, NNZ, B = 40, 6, 5, 3


def _fc_model(paddle):
    layer, dt = paddle.layer, paddle.data_type
    xb = layer.data("xb", dt.sparse_binary_vector(DIM, nnz=NNZ))
    xf = layer.data("xf", dt.sparse_float_vector(DIM, nnz=NNZ))
    xd = layer.data("xd", dt.dense_vector(4))
    out = layer.fc([xb, xf, xd], size=SIZE, act="tanh", name="fc")
    return out, layer.sum_cost(out)


def _both():
    reset_jax_names()
    reset_port_names()
    pj.init(seed=5)
    pt.init(seed=5, device="cpu")
    jout, jcost = _fc_model(pj)
    tout, tcost = _fc_model(pt)
    jtopo = pj.Topology(jcost, extra_inputs=[jout],
                        collect_evaluators=False)
    ttopo = pt.Topology(tcost, extra_inputs=[tout])
    jparams = pj.parameters.create(jtopo)
    values = {l: {p: np.asarray(v) for p, v in ps.items()}
              for l, ps in jparams.values.items()}
    return jtopo, ttopo, values


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    ids_b = rng.randint(0, DIM, (B, NNZ)).astype(np.int32)
    ids_f = rng.randint(0, DIM, (B, NNZ)).astype(np.int32)
    return {"xb@ids": ids_b, "xb@vals": np.ones((B, NNZ), np.float32),
            "xf@ids": ids_f, "xf@vals": rng.randn(B, NNZ).astype(np.float32),
            "xd": rng.randn(B, 4).astype(np.float32)}


def test_sparse_fc_matches_jax_and_the_dense_product():
    """The fc over a binary and a float sparse input and a dense one: its
    output against the JAX package's and against the dense product on
    the densified vectors, and the gradients of every weight against the
    JAX package's, within 1e-5."""
    import jax

    jtopo, ttopo, values = _both()
    feed = _feed()

    def jloss(params):
        outs, _ = jtopo.forward(params, {}, feed, outputs=["fc"])
        return outs["fc"].sum(), outs["fc"]

    (_, jfc), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {l: {p: jax.numpy.asarray(v) for p, v in ps.items()}
         for l, ps in values.items()})
    params = pt.parameters.from_numpy(ttopo, values).values
    for ps in params.values():
        for t in ps.values():
            t.requires_grad_(True)
    outs, _ = ttopo.forward(params, {}, feed, outputs=["fc"])
    tfc = outs["fc"]
    tfc.sum().backward()
    np.testing.assert_allclose(tfc.detach().numpy(), np.asarray(jfc), **TOL)
    for l, ps in params.items():
        for p, t in ps.items():
            np.testing.assert_allclose(t.grad.numpy(),
                                       np.asarray(jgrads[l][p]),
                                       err_msg=f"{l}.{p}", **TOL)
    w = values["fc"]
    dense_b = np.zeros((B, DIM), np.float32)
    dense_f = np.zeros((B, DIM), np.float32)
    for r in range(B):
        for j in range(NNZ):
            dense_b[r, feed["xb@ids"][r, j]] += 1.0
            dense_f[r, feed["xf@ids"][r, j]] += feed["xf@vals"][r, j]
    want = np.tanh(dense_b @ w["w0"] + dense_f @ w["w1"]
                   + feed["xd"] @ w["w2"] + w["b"])
    np.testing.assert_allclose(tfc.detach().numpy(), want, **TOL)


SAMPLES = [
    ([3, 7, 3], [(1, 0.5), (39, -2.0)], [0.1, 0.2, 0.3, 0.4]),
    ([], [(0, 2.0)], [1.0, 0.0, -1.0, 0.5]),
    ([5], [], [0.0, 0.0, 0.0, 0.0]),
]


def test_feeder_arrays_equal_jax():
    """Binary id lists and (id, value) pairs pack to the JAX package's
    arrays: ids, values (1 for a binary id, 0 in a padding slot) and the
    dense column."""
    jtopo, ttopo, _ = _both()
    feeding = {"xb": 0, "xf": 1, "xd": 2}
    jfeed = JaxFeeder(jtopo, feeding).feed(SAMPLES)
    tfeed = DataFeeder(ttopo, feeding).feed(SAMPLES)
    assert sorted(tfeed) == sorted(jfeed)
    for k, v in jfeed.items():
        assert tfeed[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tfeed[k], v, err_msg=k)
    assert tfeed["xf@vals"][1][1] == 0.0          # a padding slot


def test_unset_nnz_rounds_up_to_a_power_of_two():
    """An input declared with nnz=0 packs to the batch's longest sample
    rounded up to a power of two, as the JAX feeder does."""
    reset_jax_names()
    reset_port_names()
    pj.init(seed=5)
    pt.init(seed=5, device="cpu")
    feeds = []
    for paddle, feeder in ((pj, JaxFeeder), (pt, DataFeeder)):
        x = paddle.layer.data("x", paddle.data_type.sparse_binary_vector(
            20, nnz=0))
        cost = paddle.layer.sum_cost(paddle.layer.fc(x, size=2, name="f"))
        topo = (pj.Topology(cost, collect_evaluators=False) if paddle is pj
                else pt.Topology(cost))
        feeds.append(feeder(topo, {"x": 0}).feed([([1, 2, 3, 4, 5],),
                                                  ([6],)]))
    for k in ("x@ids", "x@vals"):
        assert feeds[1][k].shape == (2, 8)
        np.testing.assert_array_equal(feeds[1][k], feeds[0][k])


def test_sparse_fc_trains_through_the_feeder():
    """Sparse logistic regression through the feeder's packing and
    ``SGD.train`` (Adam): the per-batch costs of 4 passes within 1e-5 of
    the JAX package's, and falling."""
    rng = np.random.RandomState(1)
    samples = []
    for _ in range(64):
        y = int(rng.randint(0, 2))
        lo, hi = (0, 5000) if y else (5000, 10000)
        samples.append(([int(v) for v in rng.randint(lo, hi, 6)], y))
    reader = lambda: iter(samples)   # noqa: E731
    costs = []
    for paddle in (pj, pt):
        reset_jax_names()
        reset_port_names()
        pj.init(seed=5)
        pt.init(seed=5, device="cpu")
        x = paddle.layer.data("x", paddle.data_type.sparse_binary_vector(
            10000, nnz=8))
        lbl = paddle.layer.data("y", paddle.data_type.integer_value(2))
        pred = paddle.layer.fc(x, size=2, act="softmax", name="out")
        cost = paddle.layer.classification_cost(pred, lbl)
        if paddle is pj:
            topo = pj.Topology(cost, collect_evaluators=False)
            params = pj.parameters.create(topo)
            values = {l: {p: np.asarray(v) for p, v in ps.items()}
                      for l, ps in params.values.items()}
        else:
            topo = pt.Topology(cost)
            params = pt.parameters.from_numpy(topo, values)
        tr = paddle.trainer.SGD(topo, params,
                                paddle.optimizer.Adam(learning_rate=0.05))
        out = []
        tr.train(paddle.batch(reader, 16), num_passes=4,
                 event_handler=lambda e, out=out: out.append(e.cost)
                 if isinstance(e, paddle.event.EndIteration) else None)
        costs.append(out)
    np.testing.assert_allclose(costs[1], costs[0], **TOL)
    assert costs[1][-1] < costs[1][0] * 0.5


def test_sparse_guards():
    """Loud failures: sparse sequences, a sample longer than nnz, a
    consumer other than fc; an out-of-range id (too large, or negative)
    contributes zero."""
    reset_port_names()
    pt.init(seed=5, device="cpu")
    layer, dt = pt.layer, pt.data_type
    with pytest.raises(ValueError, match="sparse .sequence."):
        layer.data("s", dt.sparse_binary_vector_sequence(10, nnz=2))
    x = layer.data("x", dt.sparse_binary_vector(10, nnz=2))
    with pytest.raises(ValueError, match="cannot consume the sparse"):
        pt.Topology(layer.sum_cost(layer.addto([x])))
    cost = layer.sum_cost(layer.fc(x, size=2, bias_attr=False, name="f"))
    topo = pt.Topology(cost)
    with pytest.raises(ValueError, match="> nnz"):
        DataFeeder(topo, {"x": 0}).feed([([1, 2, 3],)])
    params = pt.parameters.create(topo)
    w = params.values["f"]["w0"].numpy()
    for bad in (99, -1):
        outs, _ = topo.forward(params.values, {}, {
            "x@ids": np.asarray([[bad, 1]], np.int32),
            "x@vals": np.ones((1, 2), np.float32)}, outputs=["f"])
        np.testing.assert_allclose(outs["f"].numpy(), w[1:2], rtol=1e-6)
    assert torch.isfinite(outs["f"]).all()
