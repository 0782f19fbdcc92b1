"""``SGD(check_nan_inf=True)`` in the PyTorch port against the JAX
package on the CPU: a NaN planted in a feed raises FloatingPointError
with the JAX package's message, naming the same tensors (the loss and
every ``{layer}.{param}@GRAD``; under loss scaling the loss alone).

The model: two dense inputs through fc layers into one fc head and a
classification cost; inputs from a numpy seed.  A clean run with the
check is bit for bit the run without it.
"""

import io

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names


@pytest.fixture(autouse=True)
def _restore_options():
    """The precision policy persists across ``init`` calls: put the
    options back after each test."""
    saved = dict(tconfig._options)
    yield
    tconfig._options.clear()
    tconfig._options.update(saved)
    pj.init(seed=0, precision="fp32")


def _topo(paddle):
    layer, dt = paddle.layer, paddle.data_type
    a = layer.fc(layer.data("a", dt.dense_vector(4)), size=6, act="tanh",
                 name="fa")
    b = layer.fc(layer.data("b", dt.dense_vector(3)), size=6, act="tanh",
                 name="fb")
    out = layer.fc(layer.concat([a, b], name="ab"), size=2, name="out")
    cost = layer.classification_cost(
        out, layer.data("y", dt.integer_value(2)), name="cost")
    if paddle is pj:
        return pj.Topology(cost, collect_evaluators=False)
    return pt.Topology(cost)


def _trainers(precision, check=True):
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0, precision=precision)
    pt.init(seed=0, device="cpu", precision=precision)
    ttopo, jtopo = _topo(pt), _topo(pj)
    jparams = pj.parameters.create(jtopo)
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    tparams = pt.parameters.create(ttopo)
    tparams.from_tar(buf)
    return (pt.trainer.SGD(ttopo, tparams, pt.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9), check_nan_inf=check),
            pj.trainer.SGD(jtopo, jparams, pj.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9), check_nan_inf=check))


def _feeds(poison=None):
    out = []
    for i in range(3):
        rng = np.random.RandomState(i)
        f = {"a": rng.randn(5, 4).astype(np.float32),
             "b": rng.randn(5, 3).astype(np.float32),
             "y": rng.randint(0, 2, 5).astype(np.int32)}
        if poison is not None and i == 1:
            f[poison][2, 1] = np.nan
        out.append(f)
    return out


def _raised(tr, feeds, **kw):
    with pytest.raises(FloatingPointError) as ei:
        tr.train(lambda: iter(feeds), event_handler=lambda e: None, **kw)
    return str(ei.value)


@pytest.mark.parametrize("precision,names", [
    ("fp32", ["fa.b@GRAD", "fa.w0@GRAD", "fb.b@GRAD", "fb.w0@GRAD",
              "loss", "out.b@GRAD", "out.w0@GRAD"]),
    ("mixed", ["loss"])])
@pytest.mark.parametrize("k", [None, 2])
def test_planted_nan_names_the_jax_tensors(precision, names, k):
    ttr, jtr = _trainers(precision)
    want = _raised(jtr, _feeds("b"))
    got = _raised(ttr, _feeds("b"), steps_per_dispatch=k)
    assert got == want
    assert got.endswith(" in: " + ", ".join(names))
    assert "pass 0 batch 1" in got
    assert ttr.step_capture_count == 0


def test_clean_run_with_the_check_is_bit_equal():
    runs = []
    for check in (False, True):
        ttr, _ = _trainers("fp32", check)
        costs = []
        ttr.train(lambda: iter(_feeds()), num_passes=2,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, pt.event.EndIteration) else None)
        runs.append((costs, [t.clone() for t in ttr._state_tensors()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_without_the_check_nans_train_on():
    ttr, _ = _trainers("fp32", check=False)
    costs = []
    ttr.train(lambda: iter(_feeds("a")),
              event_handler=lambda e: costs.append(e.cost)
              if isinstance(e, pt.event.EndIteration) else None)
    assert len(costs) == 3 and not np.isfinite(costs[1])
