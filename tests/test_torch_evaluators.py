"""The evaluators of the PyTorch port (``paddle_tpu_torch/evaluator.py``:
ClassificationError, Auc, PrecisionRecall, PnPair, Sum, ColumnSum,
RankAuc, SeqClassificationError, the printers and ``EvalAccumulator``)
against the JAX package's on the CPU, the metrics ``SGD.train`` and
``SGD.test`` report, and the gradient probes that feed GradientPrinter
(``Topology.forward(grad_probes=)``) against the JAX cotangent.

Inputs come from numpy's seeded generator.  Tolerances: error rates,
precision / recall / F1 and AUC within 1e-12 (their statistics are counts,
exact in float32, and the finish is float64 on both sides); Sum and
ColumnSum within 1e-6 relative (float32 sums in another order); the
metrics of a 2-pass run from the same weights within 1e-6; PnPair's and
RankAuc's counts exactly (weighted pairs within 1e-6 relative), the
printers' text equal; the probed cotangents within 1e-6.
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
    # every factory of the JAX module is ported: none is refused
    assert sorted(pt.evaluator.__all__) == sorted(
        set(pj.evaluator.__all__) | {"EvalAccumulator"})
    assert isinstance(pt.evaluator.pnpair(pred, lbl, lbl),
                      pt.evaluator.PnPair)


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


# ------------------------------------------------ the rest of the module
def _declare_rest(paddle, case, tmp_path):
    layer, dt, ev = paddle.layer, paddle.data_type, paddle.evaluator
    seqv, seqi = dt.dense_vector_sequence, dt.integer_value_sequence
    if case in ("pnpair", "pnpair_weighted"):
        score = layer.data("score", dt.dense_vector(1))
        label = layer.data("label", dt.dense_vector(1))
        qid = layer.data("qid", dt.integer_value(4))
        w = (layer.data("w", dt.dense_vector(1))
             if case == "pnpair_weighted" else None)
        return ev.pnpair(score, label, qid, name="m", weight=w)
    if case in ("rank_auc", "rank_auc_pv"):
        score = layer.data("score", seqv(1))
        click = layer.data("click", seqv(1))
        pv = layer.data("pv", seqv(1)) if case == "rank_auc_pv" else None
        return ev.rank_auc(score, click, pv=pv, name="m")
    if case == "seq_classification_error":
        return ev.seq_classification_error(layer.data("pred", seqv(C)),
                                           layer.data("label", seqi(C)),
                                           name="m")
    if case == "value_printer":
        return ev.value_printer(layer.data("pred", dt.dense_vector(C)),
                                name="m")
    if case == "maxid_printer":
        return ev.maxid_printer(layer.data("pred", seqv(C)), name="m",
                                num_results=2)
    if case == "maxframe_printer":
        return ev.maxframe_printer(layer.data("pred", seqv(1)), name="m",
                                   num_results=2)
    if case == "seqtext_printer":
        d = tmp_path / "dict.txt"
        d.write_text("".join(f"w{i}\n" for i in range(C)))
        return ev.seqtext_printer(
            layer.data("ids", seqi(C + 2)), dict_file=str(d),
            result_file=str(tmp_path / f"{paddle.__name__}.txt"), name="m")
    if case == "classification_error_printer":
        return ev.classification_error_printer(
            layer.data("pred", dt.dense_vector(C)),
            layer.data("label", dt.integer_value(C)), name="m")
    raise KeyError(case)


def _batch_rest(case, seed):
    rng = np.random.RandomState(seed)
    lens = {f"{k}@len": rng.randint(1, T + 1, B).astype(np.int32)
            for k in ("score", "click", "pv", "pred", "label", "ids")}
    values = {
        # ties in the scores: PnPair's and RankAuc's tie branches count
        "score": np.round(rng.rand(B, T if case.startswith("rank")
                                   else 1, 1), 1).astype(np.float32),
        "label": (rng.randint(0, 3, (B, 1)).astype(np.float32)
                  if case.startswith("pnpair")
                  else rng.randint(0, C, (B, T) if case.startswith("seq")
                                   else B).astype(np.int32)),
        "qid": rng.randint(0, 4, B).astype(np.int32),
        "w": rng.rand(B, 1).astype(np.float32),
        "click": rng.randint(0, 2, (B, T, 1)).astype(np.float32),
        "pv": rng.randint(1, 3, (B, T, 1)).astype(np.float32),
        "pred": rng.rand(*((B, T, 1) if case == "maxframe_printer"
                           else (B, T, C) if case in (
                               "seq_classification_error", "maxid_printer")
                           else (B, C))).astype(np.float32),
        "ids": rng.randint(0, C + 2, (B, T)).astype(np.int32),
    }
    if case.startswith("rank"):
        values["click"] = np.minimum(values["click"], values["pv"])
    elif not case.startswith("pnpair"):
        values["score"] = values["score"][:, 0]
    return values, lens


REST = ["pnpair", "pnpair_weighted", "rank_auc", "rank_auc_pv",
        "seq_classification_error", "value_printer", "maxid_printer",
        "maxframe_printer", "seqtext_printer",
        "classification_error_printer"]


@pytest.mark.parametrize("case", REST)
def test_rest_stats_finish_and_text_match_jax(case, tmp_path, capsys):
    """Three batches through each package's evaluator: the statistics,
    the pass's metrics and the printed (or written) text as the JAX
    package's."""
    import jax.numpy as jnp

    # weighted pairs sum float32 weights in another order
    rtol = 1e-6 if case == "pnpair_weighted" else 0
    _init()
    jev, tev = (_declare_rest(pj, case, tmp_path),
                _declare_rest(pt, case, tmp_path))
    jacc = pj.evaluator.EvalAccumulator([jev])
    tacc = pt.evaluator.EvalAccumulator([tev])
    for seed in range(3):
        values, feed = _batch_rest(case, seed)
        js = jev.stats({k: jnp.asarray(v) for k, v in values.items()}, feed)
        ts = tev.stats({k: torch.from_numpy(v) for k, v in values.items()},
                       feed)
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=0)
        jacc.update({"m": js})
        tacc.update({"m": ts})
    capsys.readouterr()
    jr = jacc.results()
    jtext = capsys.readouterr().out
    tr = tacc.results()
    ttext = capsys.readouterr().out
    assert sorted(tr) == sorted(jr)
    for k in jr:
        np.testing.assert_allclose(tr[k], jr[k], rtol=rtol, err_msg=k)
    assert ttext == jtext
    if case == "seqtext_printer":
        assert ((tmp_path / "paddle_tpu_torch.txt").read_text()
                == (tmp_path / "paddle_tpu.txt").read_text())
        assert "w0" in (tmp_path / "paddle_tpu.txt").read_text()
    elif case.startswith(("pnpair", "rank")) or case.startswith("seq_c"):
        assert list(jr.values())[0] > 0
    else:
        assert ttext.startswith("[m] ")


def _probe_model(paddle):
    layer, dt = paddle.layer, paddle.data_type
    x = layer.data("x", dt.dense_vector(6))
    lbl = layer.data("y", dt.integer_value(3))
    h = layer.fc(x, size=5, act="tanh", name="h")
    pred = layer.fc(h, size=3, act="softmax", name="pred")
    paddle.evaluator.gradient_printer(h, name="gh")
    paddle.evaluator.gradient_printer(x, name="gx")
    return layer.classification_cost(pred, lbl, name="cost")


def test_grad_probes_match_the_jax_cotangent(capsys):
    """d cost / d h and d cost / d x: the port's probes
    (``Topology.forward(grad_probes=)``, autograd) against the JAX
    package's (its zero probes, ``jax.grad``) from the same weights; the
    trainer hands them to GradientPrinter as "<layer>@grad"."""
    import jax
    import jax.numpy as jnp

    _init()
    jtopo = pj.Topology(_probe_model(pj))
    jparams = pj.parameters.create(jtopo)
    values = {l: {p: np.asarray(v) for p, v in ps.items()}
              for l, ps in jparams.values.items()}
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(4, 6).astype(np.float32),
            "y": rng.randint(0, 3, 4).astype(np.int32)}

    def cost(gp):
        outs, _ = jtopo.forward(jparams.values, jtopo.create_state(), feed,
                                train=True, grad_probes=gp)
        return outs["cost"]

    want = jax.grad(cost)({"h": jnp.zeros((4, 5)), "x": jnp.zeros((4, 6))})

    ttopo = pt.Topology(_probe_model(pt))
    params = pt.parameters.from_numpy(ttopo, values, device="cpu")
    probes = {"h": None, "x": None}
    outs, _ = ttopo.forward(params.values, ttopo.create_state(device="cpu"),
                            feed, train=True, device="cpu",
                            grad_probes=probes)
    got = torch.autograd.grad(outs["cost"], [probes["h"], probes["x"]])
    for g, k in zip(got, ("h", "x")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)

    trainer = pt.trainer.SGD(ttopo, params, pt.optimizer.Momentum(
        learning_rate=0.0))
    grads = trainer._grads(feed, None)
    for k in ("h", "x"):
        np.testing.assert_allclose(grads.outs[k + "@grad"].numpy(),
                                   np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    trainer.train(lambda: iter([[(feed["x"][i], int(feed["y"][i]))
                                 for i in range(4)]]), num_passes=1)
    out = capsys.readouterr().out
    assert "[gh] grad:" in out and "[gx] grad:" in out
    assert "no backward ran" not in out
