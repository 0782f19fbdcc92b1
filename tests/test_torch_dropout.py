"""Dropout and the random stream of the PyTorch port on the CPU.

Torch cannot replay JAX's random streams, so dropout is held by its
statistics: the kept share within 5 standard deviations of 1 - rate (on
200,000 draws: 0.0051 at rate 0.3), every kept element exactly x / (1 -
rate) and every other exactly 0, the gradient the same mask and scale,
and the identity at eval (the very tensor).  ``fc(layer_attr=
ExtraAttr(drop_rate=))`` builds the JAX package's graph.  The layers
draw from the generator the forward is given, and from nothing else: a
train-mode dropout or NCE with none raises, one seed gives one stream,
and the trainer's generator lies on its device and advances every step
(an eager chunk of k steps draws k different masks; on the card a
captured chunk registers it with its graph, which ``chip_smoke.py``
shows draws new masks each replay).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names


def _dropout_topo(rate, width=500):
    reset_port_names()
    pt.init(seed=0, device="cpu")
    x = pt.layer.data("x", pt.data_type.dense_vector(width))
    return pt.Topology(pt.layer.dropout(x, rate=rate, name="drop"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keeps_the_share_and_scales_by_one_over_keep(dtype):
    rate = 0.3
    topo = _dropout_topo(rate)
    x = (torch.rand(400, 500, generator=torch.Generator().manual_seed(1))
         + 0.5).to(dtype).requires_grad_(True)
    outs, _ = topo.forward({}, {}, {"x": x}, train=True, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    y = outs["drop"]
    kept = y != 0
    share = kept.float().mean().item()
    sd = (rate * (1 - rate) / x.numel()) ** 0.5
    assert abs(share - (1 - rate)) <= 5 * sd
    assert y.dtype == dtype
    assert torch.equal(y[kept], (x / (1 - rate))[kept])
    y.float().sum().backward()
    want = kept.to(dtype) * torch.tensor(1 / (1 - rate), dtype=dtype)
    assert torch.equal(x.grad, (torch.ones_like(x) / (1 - rate)) * kept)
    assert torch.allclose(x.grad.float(), want.float(), rtol=2 ** -8)


def test_dropout_is_the_identity_at_eval_and_at_rate_zero():
    x = torch.randn(4, 500)
    outs, _ = _dropout_topo(0.5).forward({}, {}, {"x": x}, device="cpu")
    assert outs["drop"] is x
    outs, _ = _dropout_topo(0.0).forward(
        {}, {}, {"x": x}, train=True, device="cpu")
    assert outs["drop"] is x


def test_one_seed_one_stream_and_no_generator_raises():
    topo = _dropout_topo(0.5)
    x = torch.ones(8, 500)

    def draw(seed):
        return topo.forward({}, {}, {"x": x}, train=True, device="cpu",
                            generator=torch.Generator().manual_seed(seed)
                            )[0]["drop"]

    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))
    with pytest.raises(ValueError, match="rng"):
        topo.forward({}, {}, {"x": x}, train=True, device="cpu")


def test_fc_drop_rate_builds_the_jax_graph():
    graphs = []
    for paddle, reset in ((pt, reset_port_names), (pj, reset_jax_names)):
        reset()
        x = paddle.layer.data("x", paddle.data_type.dense_vector(8))
        h = paddle.layer.fc(x, size=4, name="h",
                            layer_attr=paddle.attr.ExtraAttr(drop_rate=0.25))
        assert h.kind == "dropout" and h.parents[0].name == "h"
        graphs.append(h)
    assert pt.Topology(graphs[0]).proto() == pj.Topology(
        graphs[1], collect_evaluators=False).proto()
    assert pt.layer.dropout_layer is pt.layer.dropout


def _mlp_trainer(seed=0, rate=0.5):
    reset_port_names()
    pt.init(seed=seed, device="cpu")
    layer = pt.layer
    x = layer.data("x", pt.data_type.dense_vector(16))
    y = layer.data("y", pt.data_type.integer_value(4))
    h = layer.dropout(layer.fc(x, size=32, act="relu", name="h"),
                      rate=rate, name="drop")
    cost = layer.classification_cost(layer.fc(h, size=4, name="o"), y)
    topo = pt.Topology(cost)
    params = pt.parameters.create(topo, device="cpu")
    return pt.trainer.SGD(topo, params, pt.optimizer.Momentum(
        learning_rate=0.0))


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(6, 16).astype(np.float32),
            "y": rng.randint(0, 4, 6).astype(np.int32)}


def test_the_trainers_generator_advances_every_step():
    """At learning rate 0 only the masks change the loss: the steps of a
    k-step chunk, and of the per-step loop, each draw their own, and two
    trainers from one seed draw the same ones."""
    tr = _mlp_trainer()
    assert tr._generator.device.type == "cpu"
    feed = _feed()
    feeds = {k: np.stack([v] * 3) for k, v in feed.items()}
    chunk = tr._chunk(feeds, 3)
    losses = chunk(feeds).tolist()
    assert len(set(losses)) == 3
    again = _mlp_trainer()._chunk(feeds, 3)(feeds).tolist()
    assert again == losses
    step = [float(tr._step(feed)) for _ in range(2)]
    assert len(set(step + losses)) == 5


def test_nce_draws_from_the_forward_generator():
    reset_port_names()
    pt.init(seed=0, device="cpu")
    layer = pt.layer
    x = layer.data("x", pt.data_type.dense_vector(6))
    y = layer.data("y", pt.data_type.integer_value(50))
    topo = pt.Topology(layer.nce_cost(x, y, num_classes=50,
                                      num_neg_samples=4, name="nce"))
    params = pt.parameters.create(topo, device="cpu").values
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(5, 6).astype(np.float32),
            "y": rng.randint(0, 50, 5).astype(np.int32)}

    def loss(gen):
        return float(topo.forward(params, {}, feed, train=True,
                                  generator=gen, device="cpu")[0]["nce"])

    g = torch.Generator().manual_seed(9)
    first, second = loss(g), loss(g)
    assert first != second
    assert loss(torch.Generator().manual_seed(9)) == first
    with pytest.raises(ValueError, match="rng"):
        loss(None)
