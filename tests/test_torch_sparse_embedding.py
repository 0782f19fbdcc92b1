"""SelectedRows training in the PyTorch port (``paddle_tpu_torch``:
``sparse_update`` embedding tables, ``optimizer._segment_rows`` and
``sparse_leaf_update``, the trainer's probes) against the JAX package and
against the port's own dense path, on the CPU; the port's counterpart of
``tests/test_sparse_embedding.py``.

The model: an ids sequence (max_len 4) through an embedding, sum pooling,
an fc softmax head and a classification cost; the weights are the JAX
package's, carried into the port as numpy; the feeds come from numpy.
Tolerances, each stated where it is used: sparse against dense in the
port 1e-6 on the touched rows (float32 sums in another order) and the
untouched rows bit for bit their start; port against JAX after 3 steps,
parameters and every slot within 1e-5 x max(1, max |ref|).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.optimizer import _segment_rows

VOCAB, DIM = 50, 6
FEED = {
    # duplicate ids inside a sample and across samples on purpose
    "ids": np.asarray([[3, 7, 3, 1], [7, 7, 2, 5]], np.int32),
    "ids@len": np.asarray([4, 3], np.int32),
    "y": np.asarray([1, 0], np.int32),
}
TOUCHED = [1, 2, 3, 5, 7]


def _ctr_model(paddle, vocab, dim, sparse):
    layer = paddle.layer
    ids = layer.data("ids", paddle.data_type.integer_value_sequence(
        vocab, max_len=4))
    lbl = layer.data("y", paddle.data_type.integer_value(2))
    attr = paddle.attr.ParamAttr(sparse_update=sparse, initializer="normal")
    emb = layer.embedding(ids, size=dim, vocab_size=vocab, param_attr=attr,
                          name="emb")
    pooled = layer.pooling(emb, pooling_type="sum")
    pred = layer.fc(pooled, size=2, act="softmax", name="out_fc")
    return layer.classification_cost(pred, lbl)


def _start(vocab=VOCAB, dim=DIM):
    """The JAX package's seeded weights as a numpy tree."""
    reset_jax_names()
    pj.init(seed=3)
    topo = pj.Topology(_ctr_model(pj, vocab, dim, True),
                       collect_evaluators=False)
    params = pj.parameters.create(topo)
    return {l: {p: np.array(v) for p, v in ps.items()}
            for l, ps in params.values.items()}


@pytest.fixture(autouse=True)
def _restore_options():
    """The precision policy persists across ``init`` calls: put the
    options back after each test."""
    saved = dict(tconfig._options)
    yield
    tconfig._options.clear()
    tconfig._options.update(saved)
    pj.init(seed=0, precision="fp32")


def _port_trainer(sparse, opt, values, vocab=VOCAB, dim=DIM, **kw):
    reset_port_names()
    pt.init(seed=3, device="cpu",
            **{k: v for k, v in kw.items() if k != "check_nan_inf"})
    topo = pt.Topology(_ctr_model(pt, vocab, dim, sparse))
    return pt.trainer.SGD(topo, pt.parameters.from_numpy(topo, values),
                          opt, check_nan_inf=kw.get("check_nan_inf", False))


def _port_steps(sparse, opt, values, feeds=(FEED,)):
    tr = _port_trainer(sparse, opt, values)
    for feed in feeds:
        tr._step(feed)
    return tr


def _jax_trainer(opt, values, check_nan_inf=False):
    import jax.numpy as jnp

    reset_jax_names()
    pj.init(seed=3)
    topo = pj.Topology(_ctr_model(pj, VOCAB, DIM, True),
                       collect_evaluators=False)
    params = pj.parameters.create(topo)
    params.values = {l: {p: jnp.asarray(values[l][p]) for p in ps}
                     for l, ps in params.values.items()}
    return pj.trainer.SGD(topo, params, opt, check_nan_inf=check_nan_inf)


def _jax_steps(opt, values, feeds):
    """The JAX package's sparse steps over ``feeds``: (params, state)."""
    import jax

    tr = _jax_trainer(opt, values)
    step = tr._build_step()
    t, o, m = tr._trainable, tr._opt_state, tr.model_state
    for i, feed in enumerate(feeds):
        t, o, m, _, _ = step(t, o, m, feed, jax.random.PRNGKey(i))
    return t, o


SGD_CASES = {
    "sgd": lambda m: m.SGD(learning_rate=0.5),
    "sgd_l2": lambda m: m.SGD(
        learning_rate=0.5, regularization=m.L2Regularization(rate=1e-3)),
    # the global clip must see the segment-summed rows (FEED's duplicate
    # ids would otherwise shrink the norm it computes)
    "sgd_clip": lambda m: m.SGD(learning_rate=0.5,
                                gradient_clipping_threshold=0.05),
}


@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_sparse_matches_dense_sgd(case):
    """Under SGD the sparse path is the dense update on the touched rows
    (within 1e-6: the rows' sums are taken in another order); the rows it
    did not touch keep their start bit for bit."""
    values = _start()
    td = _port_steps(False, SGD_CASES[case](pt.optimizer), values,
                     [FEED] * 2)
    ts = _port_steps(True, SGD_CASES[case](pt.optimizer), values,
                     [FEED] * 2)
    wd = td._trainable["emb"]["w"].numpy()
    ws = ts._trainable["emb"]["w"].numpy()
    np.testing.assert_allclose(ws[TOUCHED], wd[TOUCHED], rtol=0, atol=1e-6)
    untouched = [i for i in range(VOCAB) if i not in TOUCHED]
    np.testing.assert_array_equal(ws[untouched],
                                  values["emb"]["w"][untouched])
    np.testing.assert_allclose(ts._trainable["out_fc"]["w0"].numpy(),
                               td._trainable["out_fc"]["w0"].numpy(),
                               rtol=0, atol=1e-6)


def test_sparse_adam_touches_only_seen_rows():
    """Lazy sparse Adam: the untouched rows and their moments stay as they
    started, bit for bit; the touched rows take a real Adam step."""
    values = _start()
    tr = _port_steps(True, pt.optimizer.Adam(learning_rate=0.1), values)
    w0, w1 = values["emb"]["w"], tr._trainable["emb"]["w"].numpy()
    untouched = [i for i in range(VOCAB) if i not in TOUCHED]
    # row 5 is looked up only in the padding of the second sample
    moved = [1, 2, 3, 7]
    assert np.abs(w1[moved] - w0[moved]).min() > 1e-4
    np.testing.assert_array_equal(w1[untouched], w0[untouched])
    slots = tr._opt_state["slots"]["emb"]["w"]
    for name in ("momentum", "second_momentum"):
        assert not slots[name].numpy()[untouched].any()
        assert slots[name].numpy()[TOUCHED].any()
    assert tr._trainable["emb"]["w"].grad is None


def test_duplicate_ids_segment_sum():
    """A row looked up k times takes the sum of its k gradient rows once,
    not k updates: the dense step's row within 1e-6."""
    feed = {"ids": np.asarray([[4, 4, 4, 4]], np.int32),
            "ids@len": np.asarray([4], np.int32),
            "y": np.asarray([1], np.int32)}
    values = _start()
    td = _port_steps(False, pt.optimizer.SGD(learning_rate=0.5), values,
                     [feed])
    ts = _port_steps(True, pt.optimizer.SGD(learning_rate=0.5), values,
                     [feed])
    np.testing.assert_allclose(ts._trainable["emb"]["w"].numpy()[4],
                               td._trainable["emb"]["w"].numpy()[4],
                               rtol=0, atol=1e-6)


def test_segment_rows_is_a_fixed_size_unique_and_sum():
    """``_segment_rows`` against numpy: the sorted unique ids padded with
    V, each id's rows summed (within 1e-6: the scan's order), zeros in the
    padded slots; the same bits at a second call."""
    rng = np.random.RandomState(0)
    v, n = 40, 97
    ids = rng.randint(0, v, n)
    rows = rng.randn(n, 3).astype(np.float32)
    p = torch.zeros(v, 3)
    uids, seg = _segment_rows(p, torch.from_numpy(ids),
                              torch.from_numpy(rows))
    uniq = np.unique(ids)
    assert uids.shape == (n,) and seg.shape == (n, 3)
    np.testing.assert_array_equal(uids.numpy()[:len(uniq)], uniq)
    assert (uids.numpy()[len(uniq):] == v).all()
    want = np.stack([rows[ids == u].sum(0) for u in uniq])
    np.testing.assert_allclose(seg.numpy()[:len(uniq)], want, rtol=0,
                               atol=1e-6)
    assert not seg.numpy()[len(uniq):].any()
    again = _segment_rows(p, torch.from_numpy(ids), torch.from_numpy(rows))
    assert torch.equal(again[1], seg) and torch.equal(again[0], uids)


RULES = {
    "sgd": lambda m, kw: m.SGD(learning_rate=0.2, **kw),
    "momentum": lambda m, kw: m.Momentum(learning_rate=0.2, momentum=0.9,
                                         **kw),
    "adagrad": lambda m, kw: m.Adagrad(learning_rate=0.1, **kw),
    "decayed_adagrad": lambda m, kw: m.DecayedAdagrad(learning_rate=0.1,
                                                      rho=0.9, **kw),
    "adadelta": lambda m, kw: m.AdaDelta(learning_rate=1.0, rho=0.9, **kw),
    "rmsprop": lambda m, kw: m.RMSProp(learning_rate=0.01, rho=0.9,
                                       momentum=0.5, **kw),
    "adam": lambda m, kw: m.Adam(learning_rate=0.05, **kw),
    "adamax": lambda m, kw: m.Adamax(learning_rate=0.05, **kw),
    "ftrl": lambda m, kw: m.Ftrl(learning_rate=0.1, l1=0.01, l2=0.02, **kw),
}
EXTRAS = {
    "plain": lambda m: {},
    # l2 on the touched rows, the global clip over the summed rows, a
    # schedule and a model average over every parameter
    "l2_clip_average": lambda m: dict(
        regularization=m.L2Regularization(1e-3),
        gradient_clipping_threshold=0.05,
        learning_rate_schedule="poly", learning_rate_decay_a=0.5,
        learning_rate_decay_b=0.75,
        model_average=m.ModelAverage(average_window=0.5)),
}


def _held(got, ref, what):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(got) - ref).max()) if ref.size else 0.0
    assert err <= 1e-5 * scale, f"{what}: {err} > 1e-5 x {scale}"


@pytest.mark.parametrize("extra", sorted(EXTRAS))
@pytest.mark.parametrize("rule", sorted(RULES))
def test_sparse_training_matches_jax(rule, extra):
    """3 sparse steps of each rule, from the same weights on the same
    feeds: every parameter and slot (and the average) within 1e-5 x
    max(1, max |ref|) of the JAX package's."""
    values = _start()
    feeds = [FEED, {**FEED, "ids": (FEED["ids"] * 7 + 3) % VOCAB},
             {**FEED, "ids": np.asarray([[49, 0, 49, 1], [2, 49, 2, 2]],
                                        np.int32)}]
    jt, jo = _jax_steps(RULES[rule](pj.optimizer,
                                    EXTRAS[extra](pj.optimizer)),
                        values, feeds)
    ttr = _port_steps(True, RULES[rule](pt.optimizer,
                                        EXTRAS[extra](pt.optimizer)),
                      values, feeds)
    to = ttr._opt_state
    assert int(to["t"]) == int(jo["t"]) == 3
    for l, ps in ttr._trainable.items():
        for p, t in ps.items():
            _held(t.numpy(), jt[l][p], f"{l}.{p}")
            slots = to["slots"][l][p]
            assert sorted(slots) == sorted(jo["slots"][l][p])
            for k, s in slots.items():
                _held(s.numpy(), jo["slots"][l][p][k], f"{l}.{p}.{k}")
            if "avg" in jo:
                _held(to["avg"][l][p].numpy(), jo["avg"][l][p],
                      f"avg {l}.{p}")


@pytest.mark.parametrize("last_row", ["touched", "untouched"])
def test_padded_slots_write_nothing(last_row):
    """Duplicates leave padded slots (id V) in the unique; they must not
    land on row V - 1: touched, it takes exactly the JAX package's Adam
    step (1e-5 x max(1, max |ref|)); untouched, it and its slots keep
    their start bit for bit."""
    ids = [[4, 4, 4, 4], [4, 9, 9, 4]]
    if last_row == "touched":
        ids[1][1] = VOCAB - 1
    feed = {"ids": np.asarray(ids, np.int32),
            "ids@len": np.asarray([4, 4], np.int32),
            "y": np.asarray([1, 0], np.int32)}
    values = _start()
    jt, jo = _jax_steps(pj.optimizer.Adam(learning_rate=0.1), values,
                        [feed] * 2)
    tr = _port_steps(True, pt.optimizer.Adam(learning_rate=0.1), values,
                     [feed] * 2)
    w = tr._trainable["emb"]["w"].numpy()
    _held(w, jt["emb"]["w"], "emb.w")
    slots = tr._opt_state["slots"]["emb"]["w"]
    for k, s in slots.items():
        _held(s.numpy(), jo["slots"]["emb"]["w"][k], f"slot {k}")
    last = VOCAB - 1
    if last_row == "untouched":
        np.testing.assert_array_equal(w[last], values["emb"]["w"][last])
        for s in slots.values():
            assert not s.numpy()[last].any()
    else:
        assert np.abs(w[last] - values["emb"]["w"][last]).min() > 1e-3


def test_topology_guards():
    """The three loud refusals: a table another embedding shares, ids
    that do not come straight from a data layer, a table that is not
    trainable."""
    reset_port_names()
    pt.init(seed=3, device="cpu")
    layer, dt = pt.layer, pt.data_type
    ids = layer.data("ids", dt.integer_value_sequence(VOCAB, max_len=4))
    sparse = pt.attr.ParamAttr(sparse_update=True)
    emb = layer.embedding(ids, size=DIM, vocab_size=VOCAB, name="emb",
                          param_attr=sparse)
    tied = layer.embedding(ids, size=DIM, vocab_size=VOCAB, name="tied",
                           share_from="emb")
    cost = layer.sum_cost(layer.pooling(layer.addto([emb, tied]),
                                        pooling_type="sum"))
    with pytest.raises(ValueError, match="tied lookups on a sparse table"):
        pt.Topology(cost).sparse_embeddings()

    reset_port_names()
    seq = layer.data("seq", dt.integer_value_sequence(VOCAB, max_len=4))
    shifted = layer.slope_intercept(seq, slope=1.0, intercept=1.0)
    emb = layer.embedding(shifted, size=DIM, vocab_size=VOCAB + 2,
                          name="emb", param_attr=sparse)
    cost = layer.sum_cost(layer.pooling(emb, pooling_type="sum"))
    with pytest.raises(ValueError, match="straight from a data layer"):
        pt.Topology(cost).sparse_embeddings()

    reset_port_names()
    ids = layer.data("ids", dt.integer_value_sequence(VOCAB, max_len=4))
    frozen = pt.attr.ParamAttr(sparse_update=True, is_static=True)
    emb = layer.embedding(ids, size=DIM, vocab_size=VOCAB, name="emb",
                          param_attr=frozen)
    topo = pt.Topology(layer.classification_cost(
        layer.fc(layer.pooling(emb, pooling_type="sum"), size=2,
                 act="softmax"),
        layer.data("y", dt.integer_value(2))))
    with pytest.raises(ValueError, match="not trainable"):
        pt.trainer.SGD(topo, pt.parameters.create(topo),
                       pt.optimizer.SGD(learning_rate=0.1))


class _Shapes(TorchDispatchMode):
    """Records every op's output tensors: (op, shape, storage pointer)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else [out]
        for o in outs:
            if isinstance(o, torch.Tensor):
                self.seen.append((str(func), tuple(o.shape),
                                  o.untyped_storage().data_ptr()))
        return out


@pytest.mark.parametrize("sparse", [True, False])
def test_big_vocab_step_makes_no_table_sized_tensor(sparse):
    """A 1,000,000-row table: a sparse SGD step gives the table no
    ``.grad`` and no op of the step makes a [V, D] tensor that is not the
    table itself (written in place); the dense step, the control, makes
    its [V, D] gradient."""
    vocab, dim = 1_000_000, 32
    reset_port_names()
    pt.init(seed=3, device="cpu")
    topo = pt.Topology(_ctr_model(pt, vocab, dim, sparse))
    tr = pt.trainer.SGD(topo, pt.parameters.create(topo),
                        pt.optimizer.SGD(learning_rate=0.1))
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, vocab, (4, 4)).astype(np.int32),
            "ids@len": np.full(4, 4, np.int32),
            "y": rng.randint(0, 2, 4).astype(np.int32)}
    table = tr._trainable["emb"]["w"]
    own = {table.untyped_storage().data_ptr()}
    with _Shapes() as rec:
        tr._step(feed)
    big = [(op, shape) for op, shape, ptr in rec.seen
           if shape and shape[0] == vocab and ptr not in own]
    assert table.grad is None
    if sparse:
        assert not big, big
    else:
        assert big


@pytest.mark.parametrize("k", [None, 2])
def test_check_nan_inf_names_the_sparse_table(k):
    """A NaN planted in the head's weights: the port raises the JAX
    package's message, which names the sparse table's rows
    (``emb.w@GRAD``) beside the loss and the dense gradients."""
    values = _start()
    values["out_fc"]["w0"][0, 0] = np.nan
    messages = []
    for tr in (_jax_trainer(pj.optimizer.SGD(learning_rate=0.5), values,
                            check_nan_inf=True),
               _port_trainer(True, pt.optimizer.SGD(learning_rate=0.5),
                             values, check_nan_inf=True)):
        kw = {} if tr.__module__.startswith("paddle_tpu.") else {
            "steps_per_dispatch": k}
        with pytest.raises(FloatingPointError) as ei:
            tr.train(lambda: iter([FEED] * 2), event_handler=lambda e: None,
                     **kw)
        messages.append(str(ei.value))
    assert messages[1] == messages[0]
    assert messages[1].endswith(" in: emb.w@GRAD, loss, out_fc.b@GRAD, "
                                "out_fc.w0@GRAD")


def test_mixed_unscales_the_probes_and_skips_an_overflow(monkeypatch):
    """Under ``mixed`` the probes' gradients come back divided by the loss
    scale (a power of two): 2 steps equal the ``bf16`` policy's within
    1e-6.  A probe gradient that overflows (planted: the backward's last
    result, the probe's, made inf) skips the step though the loss and the
    dense gradients are finite: the table, its slots and the step counter
    stay bit for bit, and the scale backs off."""
    values = _start()

    def run(policy, **kw):
        tr = _port_trainer(True, pt.optimizer.Adam(learning_rate=0.1),
                           values, precision=policy, **kw)
        for feed in (FEED, FEED):
            tr._step(feed)
        return tr

    plain, scaled = run("bf16"), run("mixed", loss_scale_init=2.0 ** 10)
    n = len(plain._state_tensors())
    for a, b in zip(plain._state_tensors(), scaled._state_tensors()[:n]):
        np.testing.assert_allclose(b.double().numpy(), a.double().numpy(),
                                   rtol=0, atol=1e-6)
    assert np.abs(scaled._trainable["emb"]["w"].numpy()
                  - values["emb"]["w"]).max() > 1e-3

    real = torch.autograd.grad

    def poisoned(outputs, inputs, **kw):
        grads = list(real(outputs, inputs, **kw))
        grads[-1] = torch.full_like(grads[-1], float("inf"))
        return grads

    monkeypatch.setattr(torch.autograd, "grad", poisoned)
    over = run("mixed", loss_scale_init=2.0 ** 10)
    np.testing.assert_array_equal(over._trainable["emb"]["w"].numpy(),
                                  values["emb"]["w"])
    np.testing.assert_array_equal(over._trainable["out_fc"]["w0"].numpy(),
                                  values["out_fc"]["w0"])
    for slot in over._opt_state["slots"]["emb"]["w"].values():
        assert not slot.numpy().any()
    ls = over._opt_state["loss_scale"]
    assert int(over._opt_state["t"]) == 0 and int(ls["skipped"]) == 2
    assert float(ls["scale"]) == 2.0 ** 8
