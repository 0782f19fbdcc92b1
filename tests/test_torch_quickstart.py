"""The README quickstart on the PyTorch port against the JAX package on the
CPU: the synthetic MNIST readers (``paddle_tpu_torch/dataset``), the
quickstart's training (``paddle.batch``, ``trainer.SGD`` with Momentum),
``paddle.infer`` (``paddle_tpu_torch/inference.py``) and the
``mnist_mlp`` golden.

The port starts from the JAX package's weights, carried across as numpy.
Tolerances: the readers' samples equal; the quickstart's per-batch costs
over its 3 passes within 1e-5 (absolute) of the JAX package's (float32
products in another order); ``infer``'s probabilities within 1e-5; the
golden's JSON byte for byte.
"""

import os

import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_mnist_equals_jax(split):
    """Every sample of the synthetic readers: image bits and label."""
    j = list(getattr(pj.dataset.mnist, split)(synthetic=True)())
    t = list(getattr(pt.dataset.mnist, split)(synthetic=True)())
    assert len(t) == len(j) == (8192 if split == "train" else 1024)
    for (ti, tl), (ji, jl) in zip(t, j):
        assert tl == jl
        assert ti.dtype == ji.dtype and np.array_equal(ti, ji)


def _quickstart(paddle, values=None):
    """The README's quick start, word for word but the package; the
    port's weights are ``values``.  Returns (per-batch costs, prediction
    layer, parameters, the starting weights as numpy)."""
    from_numpy = values is not None
    layer = paddle.layer
    if paddle is pt:
        paddle.init(seed=0, device="cpu")
    else:
        paddle.init(seed=0)
    img = layer.data("image", paddle.data_type.dense_vector(784))
    lbl = layer.data("label", paddle.data_type.integer_value(10))
    pred = layer.fc(layer.fc(img, size=128, act="relu"), size=10,
                    act="softmax")
    cost = layer.classification_cost(pred, lbl)

    topo = paddle.Topology(cost)
    params = (paddle.parameters.from_numpy(topo, values) if from_numpy
              else paddle.parameters.create(topo))
    start = {l: {p: np.array(v) for p, v in ps.items()}
             for l, ps in params.values.items()}
    trainer = paddle.trainer.SGD(topo, params,
                                 paddle.optimizer.Momentum(learning_rate=0.1,
                                                           momentum=0.9))
    reader = paddle.batch(paddle.dataset.mnist.train(synthetic=True), 64)
    costs = []
    trainer.train(reader, num_passes=3, event_handler=lambda e: costs.append(
        e.cost) if isinstance(e, paddle.event.EndIteration) else None)
    return costs, pred, params, start


def test_quickstart_trains_as_jax_does():
    """The quickstart's 384 batch costs (3 passes of 128) within 1e-5 of
    the JAX package's, falling; then ``paddle.infer`` on the synthetic
    test set within 1e-5 of the JAX ``infer``."""
    reset_jax_names()
    reset_port_names()
    jcosts, jpred, jparams, values = _quickstart(pj)
    tcosts, tpred, tparams, _ = _quickstart(pt, values)
    assert len(tcosts) == len(jcosts) == 384
    np.testing.assert_allclose(tcosts, jcosts, rtol=0, atol=1e-5)
    assert np.mean(tcosts[-16:]) < 0.5 * np.mean(tcosts[:16])

    test = [(x,) for x, _ in pt.dataset.mnist.test(synthetic=True)()]
    jprob = pj.infer(output_layer=jpred, parameters=jparams, input=test)
    tprob = pt.infer(output_layer=tpred, parameters=tparams, input=test)
    assert tprob.shape == jprob.shape == (1024, 10)
    np.testing.assert_allclose(tprob, np.asarray(jprob), rtol=0, atol=1e-5)
    labels = [y for _, y in pt.dataset.mnist.test(synthetic=True)()]
    assert (tprob.argmax(1) == np.asarray(labels)).mean() > 0.9


def test_inference_pads_the_last_batch():
    """``Inference.infer`` in batches of 96 over 200 samples (the last
    batch padded by its last sample and sliced back) equals one batch of
    200 within 1e-6, and a bucket set pads as ``bucket_rows`` says;
    ``compile_cache_dir`` is refused."""
    from paddle_tpu_torch.inference import Inference, bucket_rows

    reset_port_names()
    pt.init(seed=0, device="cpu")
    layer = pt.layer
    img = layer.data("image", pt.data_type.dense_vector(784))
    pred = layer.fc(img, size=10, act="softmax", name="p")
    params = pt.parameters.create(pt.Topology(pred))
    data = [(x,) for x, _ in pt.dataset.mnist.test(synthetic=True, n=200)()]
    inf = Inference(pred, params, device="cpu")
    whole = inf.infer(data)
    np.testing.assert_allclose(inf.infer(data, batch_size=96), whole,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        inf.infer(data, batch_size=128, bucket_batch=[8, 64, 256]), whole,
        rtol=0, atol=1e-6)
    assert bucket_rows(72, [8, 64, 256]) == 256
    assert bucket_rows(300, [8, 64, 256]) == 300
    with pytest.raises(NotImplementedError, match="item 13b"):
        Inference(pred, params, compile_cache_dir="/nonexistent")


def test_mnist_mlp_golden_and_model_are_the_jax_packages():
    """The ``mnist_mlp`` golden config (the book's MLP with a softmax
    head) in the port writes the pinned JSON byte for byte, and
    ``models.mlp.build`` the JAX package's ``mlp.build`` JSON."""
    from paddle_tpu.models import mlp as jmlp
    from paddle_tpu_torch.models import mlp as tmlp

    reset_port_names()
    pt.init(seed=0, device="cpu")
    layer, dt = pt.layer, pt.data_type
    img = layer.data("image", dt.dense_vector(784))
    lbl = layer.data("label", dt.integer_value(10))
    h = layer.fc(img, size=128, act="relu", name="hidden1")
    h = layer.fc(h, size=64, act="relu", name="hidden2")
    pred = layer.fc(h, size=10, act="softmax", name="prediction")
    topo = pt.Topology(layer.classification_cost(pred, lbl, name="cost"))
    with open(os.path.join(GOLDEN_DIR, "mnist_mlp.json")) as f:
        assert topo.proto() + "\n" == f.read()
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    jtopo = pj.Topology(jmlp.build()[0], collect_evaluators=False)
    assert pt.Topology(tmlp.build()[0]).proto() == jtopo.proto()
