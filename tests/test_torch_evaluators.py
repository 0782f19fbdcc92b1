"""The evaluators of the PyTorch port (``paddle_tpu_torch/evaluator.py``:
ClassificationError, Auc, PrecisionRecall, Sum, ColumnSum and
``EvalAccumulator``) against the JAX package's on the CPU, and the
metrics ``SGD.train`` and ``SGD.test`` report.

Inputs come from numpy's seeded generator.  Tolerances: error rates,
precision / recall / F1 and AUC within 1e-12 (their statistics are counts,
exact in float32, and the finish is float64 on both sides); Sum and
ColumnSum within 1e-6 relative (float32 sums in another order); the
metrics of a 2-pass run from the same weights within 1e-6.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names

B, T, C = 16, 5, 4


def _init():
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")


def _declare(paddle, case):
    """The case's data layers and its evaluator, in ``paddle``."""
    layer, dt, ev = paddle.layer, paddle.data_type, paddle.evaluator
    seq = case.startswith("seq")
    pred = layer.data("pred", dt.dense_vector_sequence(C) if seq
                      else dt.dense_vector(C if case != "auc_sigmoid" else 1))
    label = layer.data("label", dt.integer_value_sequence(C) if seq
                       else dt.integer_value(C))
    weight = layer.data("weight", dt.dense_vector(1))
    make = {
        "error": lambda: ev.classification_error(pred, label, name="m"),
        "error_top3": lambda: ev.classification_error(pred, label, name="m",
                                                      top_k=3),
        "seq_error": lambda: ev.classification_error(pred, label, name="m"),
        "auc_softmax": lambda: ev.auc(pred, label, name="m"),
        "auc_sigmoid": lambda: ev.auc(pred, label, name="m"),
        "auc_weighted": lambda: ev.auc(pred, label, name="m",
                                       weight=weight),
        "precision_recall": lambda: ev.precision_recall(pred, label,
                                                        name="m"),
        "precision_recall_pos": lambda: ev.precision_recall(
            pred, label, name="m", positive_label=2),
        "seq_precision_recall": lambda: ev.precision_recall(pred, label,
                                                            name="m"),
        "sum": lambda: ev.sum(pred, name="m"),
        "seq_sum": lambda: ev.sum(pred, name="m"),
        "column_sum": lambda: ev.column_sum(pred, name="m"),
    }
    return make[case]()


def _batch(case, seed):
    rng = np.random.RandomState(seed)
    if case.startswith("seq"):
        pred = rng.rand(B, T, C).astype(np.float32)
        label = rng.randint(0, C, (B, T)).astype(np.int32)
        feed = {"label@len": rng.randint(1, T + 1, B).astype(np.int32),
                "pred@len": rng.randint(1, T + 1, B).astype(np.int32)}
    else:
        width = 1 if case == "auc_sigmoid" else C
        if case.startswith("auc"):
            width = 1 if case == "auc_sigmoid" else 2
        pred = rng.rand(B, width).astype(np.float32)
        if case.startswith("auc") and width == 2:
            pred[:, 0] = 1 - pred[:, 1]
        label = rng.randint(0, 2 if case.startswith("auc") else C,
                            B).astype(np.int32)
        feed = {}
    values = {"pred": pred, "label": label,
              "weight": rng.rand(B, 1).astype(np.float32)}
    return values, feed


CASES = ["error", "error_top3", "seq_error", "auc_softmax", "auc_sigmoid",
         "auc_weighted", "precision_recall", "precision_recall_pos",
         "seq_precision_recall", "sum", "seq_sum", "column_sum"]


@pytest.mark.parametrize("case", CASES)
def test_stats_and_finish_match_jax(case):
    """Three batches through each package's evaluator and accumulator:
    each batch's statistics and the pass's metrics as the JAX package's."""
    import jax.numpy as jnp

    _init()
    jev, tev = _declare(pj, case), _declare(pt, case)
    jacc = pj.evaluator.EvalAccumulator([jev])
    tacc = pt.evaluator.EvalAccumulator([tev])
    exact = not case.endswith("sum")
    for seed in range(3):
        values, feed = _batch(case, seed)
        js = jev.stats({k: jnp.asarray(v) for k, v in values.items()}, feed)
        ts = tev.stats({k: torch.from_numpy(v) for k, v in values.items()},
                       feed)
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=0 if exact else 1e-6, atol=0)
        jacc.update({"m": js})
        tacc.update({"m": ts})
    jr, tr = jacc.results(), tacc.results()
    assert sorted(tr) == sorted(jr)
    for k in jr:
        np.testing.assert_allclose(np.asarray(tr[k], np.float64),
                                   np.asarray(jr[k], np.float64),
                                   rtol=0 if exact else 1e-6,
                                   atol=1e-12 if exact else 0, err_msg=k)


def test_registry_attaches_to_topologies():
    """A declared evaluator attaches to every Topology over its layers and
    pulls its label layer in; ``collect_evaluators=False`` leaves it out;
    ``init`` clears the registry."""
    _init()
    layer, dt = pt.layer, pt.data_type
    x = layer.data("x", dt.dense_vector(3))
    pred = layer.fc(x, size=2, act="softmax", name="p")
    lbl = layer.data("y", dt.integer_value(2))
    ev = pt.evaluator.classification_error(pred, lbl, name="err")
    assert pt.Topology(pred).evaluators == [ev]
    assert "y" in pt.Topology(pred).input_names
    assert pt.Topology(pred, collect_evaluators=False).evaluators == []
    pt.init(seed=0, device="cpu")
    assert pt.Topology(pred).evaluators == []
    with pytest.raises(NotImplementedError, match="item 11"):
        pt.evaluator.chunk(pred, lbl)


def _model(paddle):
    layer, dt = paddle.layer, paddle.data_type
    x = layer.data("x", dt.dense_vector(8))
    lbl = layer.data("y", dt.integer_value(2))
    h = layer.fc(x, size=16, act="tanh", name="h")
    pred = layer.fc(h, size=2, act="softmax", name="pred")
    cost = layer.classification_cost(pred, lbl, name="cost")
    ev = paddle.evaluator
    ev.classification_error(pred, lbl, name="err")
    ev.auc(pred, lbl, name="auc")
    ev.precision_recall(pred, lbl, name="pr")
    ev.sum(h, name="hsum")
    ev.column_sum(pred, name="colsum")
    return cost


def _samples(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        y = int(rng.randint(0, 2))
        out.append(((rng.randn(8) + (0.8 if y else -0.8)).astype(
            np.float32), y))
    return out


@pytest.mark.parametrize("k", [1, 2])
def test_train_and_test_metrics_match_jax(k):
    """2 passes of Momentum over 6 batches, and ``test`` after them: the
    EndPass and TestResult metrics of every evaluator within 1e-6 of the
    JAX package's; at ``steps_per_dispatch=2`` the port's chunk returns
    the statistics of its steps, the same metrics."""
    _init()
    costs = {}
    metrics = {}
    train = _samples(96, 0)
    test = _samples(48, 1)
    for paddle in (pj, pt):
        cost = _model(paddle)
        topo = paddle.Topology(cost)
        if paddle is pj:
            params = pj.parameters.create(topo)
            values = {l: {p: np.asarray(v) for p, v in ps.items()}
                      for l, ps in params.values.items()}
        else:
            params = pt.parameters.from_numpy(topo, values)
        tr = paddle.trainer.SGD(topo, params, paddle.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9))
        ends, out = [], []

        def handler(e, paddle=paddle, ends=ends, out=out):
            if isinstance(e, paddle.event.EndPass):
                ends.append(e.metrics)
            elif isinstance(e, paddle.event.EndIteration):
                out.append(e.cost)
        kw = {"steps_per_dispatch": k} if paddle is pt else {}
        tr.train(paddle.batch(lambda: iter(train), 16), num_passes=2,
                 event_handler=handler, **kw)
        res = tr.test(paddle.batch(lambda: iter(test), 16))
        metrics[paddle.__name__] = ends + [res.metrics]
        costs[paddle.__name__] = out + [res.cost]
    np.testing.assert_allclose(costs["paddle_tpu_torch"],
                               costs["paddle_tpu"], rtol=1e-5, atol=1e-6)
    for got, want in zip(metrics["paddle_tpu_torch"], metrics["paddle_tpu"]):
        assert sorted(got) == sorted(want)
        assert {"err", "auc", "pr.precision", "hsum", "colsum"} <= set(got)
        for name in want:
            np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                       np.asarray(want[name], np.float64),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    assert metrics["paddle_tpu_torch"][-1]["auc"] > 0.8
