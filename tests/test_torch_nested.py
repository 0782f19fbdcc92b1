"""The rest of the recurrent slice in the PyTorch port against the JAX
package on the CPU: nested groups (``SubsequenceInput`` over a
``seq_type`` 2 data layer, an inner group inside the outer step), batch
norm's running state inside a group, ``rnn_group_remat``, ``sub_seq`` and
``sub_nested_seq``, ``mdlstmemory``, ``models/text_lstm.py`` and the
synthetic imdb / wmt14 / wmt16 readers.

From the same weights (the JAX package's draw, biases random) and seeded
numpy feeds: outputs and every parameter and float-feed gradient within
1e-5 absolute and relative (float32 sums in another order); the group
under remat equals the plain group bit for bit.
"""

import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.models import text_lstm as jtext_lstm
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.models import text_lstm as ttext_lstm

TOL = dict(atol=1e-5, rtol=1e-5)


def _build(config):
    """(JAX topology, port topology, the JAX package's parameters with
    random biases, as numpy) of ``config(package)``."""
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")
    jtopo = pj.Topology(config(pj), collect_evaluators=False)
    ttopo = pt.Topology(config(pt))
    assert ttopo.proto() == jtopo.proto()
    rng = np.random.default_rng(5)
    values = {l: {p: (np.asarray(v) if v.ndim == 2 else
                      rng.standard_normal(v.shape).astype(np.float32) * 0.3)
                  for p, v in ps.items()}
              for l, ps in pj.parameters.create(jtopo).values.items()}
    return jtopo, ttopo, values


def _compare(config, feed, outs, train=True):
    """Outputs ``outs`` and the gradients of sum(output * cotangent) with
    respect to every parameter and float feed, port against JAX; returns
    the port's outputs."""
    import jax

    jtopo, ttopo, values = _build(config)
    state = ttopo.create_state(device="cpu")
    jstate = jtopo.create_state()
    jouts, _ = jtopo.forward(values, jstate, feed, train=train, outputs=outs)
    rng = np.random.default_rng(9)
    cots = {n: rng.standard_normal(np.asarray(jouts[n]).shape).astype(
        np.float32) for n in outs}
    fkeys = [k for k, v in feed.items()
             if np.asarray(v).dtype == np.float32 and "@" not in k]

    def jloss(vals, fvals):
        o, _ = jtopo.forward(vals, jstate, {**feed, **fvals}, train=train,
                             outputs=outs)
        return sum((o[n] * cots[n]).sum() for n in outs)

    jp, jf = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        values, {k: feed[k] for k in fkeys})
    params = {l: {p: torch.from_numpy(v.copy()).requires_grad_(True)
                  for p, v in ps.items()} for l, ps in values.items()}
    tfeed = {k: (torch.from_numpy(np.asarray(v).copy()).requires_grad_(True)
                 if k in fkeys else v) for k, v in feed.items()}
    touts, _ = ttopo.forward(params, state, tfeed, train=train, outputs=outs,
                             device="cpu")
    leaves = [(l, p, t) for l, ps in params.items() for p, t in ps.items()]
    grads = torch.autograd.grad(
        sum((touts[n] * torch.from_numpy(cots[n])).sum() for n in outs),
        [t for *_, t in leaves] + [tfeed[k] for k in fkeys],
        allow_unused=True)
    for n in outs:
        np.testing.assert_allclose(touts[n].detach().numpy(),
                                   np.asarray(jouts[n]), err_msg=n, **TOL)
    for (l, p, _), g in zip(leaves, grads):
        want = np.asarray(jp[l][p])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, err_msg=f"{l}.{p}", **TOL)
    for k, g in zip(fkeys, grads[len(leaves):]):
        want = np.asarray(jf[k])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, err_msg=f"d{k}", **TOL)
    return {n: touts[n].detach().numpy() for n in outs}


def _dvss(paddle, d, sub_max, max_len):
    return paddle.data_type.dense_vector_sub_sequence(d, sub_max=sub_max,
                                                      max_len=max_len)


# -------------------------------------------------------- nested groups
def _sum_acc(paddle):
    layer = paddle.layer
    nested = layer.data("doc", _dvss(paddle, 3, 4, 5))

    def outer_step(sent):                       # sent: an inner sequence
        pooled = layer.pooling(sent, pooling_type="sum")
        acc = layer.memory(name="acc", size=3)
        return layer.addto([pooled, acc], act="linear", name="acc")

    return [layer.recurrent_group(outer_step, layer.SubsequenceInput(nested),
                                  name="docsum")]


def _inner_group(paddle):
    layer = paddle.layer
    nested = layer.data("doc", _dvss(paddle, 4, 3, 4))

    def outer_step(sent):
        def inner_step(word):
            m = layer.memory(name="wacc", size=4)
            return layer.addto([word, m], act="linear", name="wacc")

        return layer.last_seq(layer.recurrent_group(inner_step, sent,
                                                    name="wrnn"))

    return [layer.recurrent_group(outer_step, layer.SubsequenceInput(nested),
                                  name="docs")]


def _fc_in_step(paddle):
    layer = paddle.layer
    nested = layer.data("doc", _dvss(paddle, 3, 3, 3))

    def outer_step(sent):
        pooled = layer.pooling(sent, pooling_type="avg")
        h = layer.fc(pooled, size=3, act="tanh", name="proj")
        acc = layer.memory(name="acc2", size=3)
        return layer.addto([h, acc], act="linear", name="acc2")

    grp = layer.recurrent_group(outer_step, layer.SubsequenceInput(nested),
                                name="g")
    return [layer.sum_cost(layer.last_seq(grp), name="cost")]


def _doc_feed(shape, outer, sub, seed):
    return {"doc": np.random.RandomState(seed).randn(*shape).astype(
        np.float32), "doc@len": np.asarray(outer, np.int32),
        "doc@sublen": np.asarray(sub, np.int32)}


def test_nested_group_matches_flat_oracle_and_jax():
    """tests/test_nested_rnn.py: the outer group over sentences, an inner
    sum pool a sentence, a running accumulator; a numpy double loop and
    the JAX package, outputs and gradients."""
    feed = _doc_feed((2, 4, 5, 3), [4, 2], [[5, 3, 1, 2], [4, 5, 0, 0]], 0)
    got = _compare(_sum_acc, feed, ["docsum"])["docsum"]
    x, sub = feed["doc"], feed["doc@sublen"]
    for b in range(2):
        acc = np.zeros(3, np.float32)
        for s in range(feed["doc@len"][b]):
            acc = acc + x[b, s, :sub[b, s]].sum(axis=0)
            np.testing.assert_allclose(got[b, s], acc, **TOL)
    # an outer pad step freezes the last real value
    np.testing.assert_allclose(got[1, 3], got[1, 1], **TOL)


def test_nested_group_with_inner_recurrent_group():
    """A word-level group inside the sentence-level step: each sentence's
    last real inner step is its prefix sum; no @sublen feeds full inner
    sequences."""
    feed = _doc_feed((2, 3, 4, 4), [3, 2], [[4, 2, 3], [1, 4, 0]], 1)
    got = _compare(_inner_group, feed, ["docs"])["docs"]
    for b in range(2):
        for s in range(feed["doc@len"][b]):
            np.testing.assert_allclose(
                got[b, s], feed["doc"][b, s, :feed["doc@sublen"][b, s]]
                .sum(axis=0), **TOL)
    del feed["doc@sublen"]
    got = _compare(_inner_group, feed, ["docs"])["docs"]
    np.testing.assert_allclose(got[0, 0], feed["doc"][0, 0].sum(0), **TOL)


def test_nested_group_gradients_flow():
    """An fc inside the outer step, an avg pool over padded inner
    sequences (an outer pad step's inner length 0 included): the loss and
    every gradient equal the JAX package's, and the fc's are nonzero."""
    feed = _doc_feed((2, 3, 3, 3), [3, 2], [[3, 1, 2], [2, 3, 0]], 2)
    _compare(_fc_in_step, feed, ["cost"])
    _, ttopo, values = _build(_fc_in_step)
    params = {l: {p: torch.from_numpy(v.copy()).requires_grad_(True)
                  for p, v in ps.items()} for l, ps in values.items()}
    outs, _ = ttopo.forward(params, {}, feed, train=True, device="cpu")
    outs["cost"].backward()
    assert params["g"]["proj::w0"].grad.abs().sum() > 0


def test_subsequence_input_checks():
    """SubsequenceInput wraps a nested DATA layer only, and beam_search
    refuses it, with the JAX package's errors."""
    reset_port_names()
    layer = pt.layer
    flat = layer.data("x", pt.data_type.dense_vector_sequence(3, max_len=4))
    with pytest.raises(ValueError, match="nested-sequence DATA"):
        layer.recurrent_group(lambda s: s, layer.SubsequenceInput(flat))
    doc = layer.data("doc", _dvss(pt, 3, 2, 4))
    with pytest.raises(ValueError, match="not valid in beam_search"):
        layer.beam_search(lambda s, g: g, [layer.SubsequenceInput(doc),
                                           layer.GeneratedInput(
                                               5, embedding_size=3)],
                          bos_id=0, eos_id=1)


# ---------------------------------------------- running state in a group
def _bn_group(paddle):
    layer = paddle.layer
    x = layer.data("bx", paddle.data_type.dense_vector_sequence(4,
                                                                max_len=3))

    def step(ipt):
        return layer.batch_norm(ipt, act=None, name="bn_in_grp",
                                moving_average_fraction=0.9)

    return [layer.recurrent_group(step, x, name="bgrp")]


def test_group_batch_norm_state_matches_jax():
    """tests/test_recurrent_group.py: batch norm inside a step; its moving
    statistics ride the loop and come back as the group's state (the EMA
    of each step's batch statistics in order), train and eval outputs
    equal the JAX package's; a ragged @len raises the JAX ValueError."""
    jtopo, ttopo, values = _build(_bn_group)
    xs = np.random.RandomState(2).randn(6, 3, 4).astype(np.float32)
    tstate = ttopo.create_state(device="cpu")
    assert "bn_in_grp::moving_mean" in tstate["bgrp"]
    tparams = pt.parameters.from_numpy(ttopo, values, device="cpu").values
    touts, tnew = ttopo.forward(tparams, tstate, {"bx": xs}, train=True,
                                device="cpu")
    jouts, jnew = jtopo.forward(values, jtopo.create_state(), {"bx": xs},
                                train=True)
    np.testing.assert_allclose(touts["bgrp"].detach().numpy(),
                               np.asarray(jouts["bgrp"]), **TOL)
    mean, var = np.zeros(4, np.float32), np.ones(4, np.float32)
    for t in range(3):
        mean = 0.9 * mean + 0.1 * xs[:, t].mean(0)
        var = 0.9 * var + 0.1 * xs[:, t].var(0)
    for key, want in (("moving_mean", mean), ("moving_var", var)):
        got = tnew["bgrp"][f"bn_in_grp::{key}"].numpy()
        np.testing.assert_allclose(got, np.asarray(
            jnew["bgrp"][f"bn_in_grp::{key}"]), **TOL)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    tev, _ = ttopo.forward(tparams, tnew, {"bx": xs}, device="cpu")
    jev, _ = jtopo.forward(values, jnew, {"bx": xs})
    np.testing.assert_allclose(tev["bgrp"].numpy(), np.asarray(jev["bgrp"]),
                               **TOL)
    with pytest.raises(ValueError, match="full-length sequences"):
        ttopo.forward(tparams, tstate, {"bx": xs, "bx@len": [3, 2, 3, 3, 1,
                                                             3]},
                      train=True, device="cpu")


# ------------------------------------------------------- rnn_group_remat
def _remat_group(paddle, dropout):
    layer = paddle.layer
    x = layer.data("x", paddle.data_type.dense_vector_sequence(5, max_len=6))
    lbl = layer.data("y", paddle.data_type.integer_value(3))

    def step(ipt):
        mem = layer.memory(name="s", size=6)
        if dropout:
            ipt = layer.dropout(ipt, 0.3, name="drop")
        proj = layer.fc([ipt, mem], 18, act=None, bias_attr=False,
                        name="gates")
        return layer.gru_step_layer(proj, mem, name="s")

    grp = layer.recurrent_group(step, x, name="grp")
    pred = layer.fc(layer.last_seq(grp), 3, act="softmax", name="pred")
    return layer.classification_cost(pred, lbl, name="cost")


@pytest.mark.parametrize("dropout", [False, True])
def test_rnn_group_remat_is_bit_equal(dropout, monkeypatch):
    """Under ``rnn_group_remat`` each step runs under a checkpoint and the
    backward recomputes it: the loss and every gradient equal the plain
    group's bit for bit, a dropout in the step drawing the same masks
    again (the generator set back to its state before the step)."""
    reset_port_names()
    pt.init(seed=0, device="cpu")
    topo = pt.Topology(_remat_group(pt, dropout))
    base = pt.parameters.create(topo, device="cpu").values
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(4, 6, 5).astype(np.float32),
            "x@len": np.array([6, 2, 5, 1], np.int32),
            "y": rng.randint(0, 3, 4).astype(np.int32)}
    runs = []
    for remat in (False, True):
        monkeypatch.setitem(tconfig._options, "rnn_group_remat", remat)
        params = {l: {p: t.clone().requires_grad_(True)
                      for p, t in ps.items()} for l, ps in base.items()}
        outs, _ = topo.forward(params, {}, feed, train=True, device="cpu",
                               generator=torch.Generator().manual_seed(4))
        leaves = [t for ps in params.values() for t in ps.values()]
        runs.append((outs["cost"], torch.autograd.grad(outs["cost"],
                                                       leaves)))
    (loss_a, grads_a), (loss_b, grads_b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))
    assert any(g.abs().sum() > 0 for g in grads_b)


# ----------------------------------------------- sub_seq, sub_nested_seq
def test_sub_seq_slices_and_masks():
    """tests/test_subseq_misc2.py: rows 1 and 2 summed; then a padded
    batch with a negative offset (clamped to 0) and a slice past the true
    end, outputs and gradients against JAX."""
    def config(paddle):
        layer, dt = paddle.layer, paddle.data_type
        seq = layer.data("s", dt.dense_vector_sequence(2, max_len=5))
        off = layer.data("off", dt.dense_vector(1))
        size = layer.data("size", dt.dense_vector(1))
        sub = layer.sub_seq(seq, off, size, name="sub")
        return [layer.pooling(sub, pooling_type="sum", name="pooled"), sub]

    got = _compare(config, {
        "s": np.arange(10, dtype=np.float32).reshape(1, 5, 2),
        "s@len": np.array([5], np.int32), "off": np.array([[1.]], np.float32),
        "size": np.array([[2.]], np.float32)}, ["pooled"])
    np.testing.assert_allclose(got["pooled"], [[6., 8.]])
    feed = {"s": np.random.RandomState(4).randn(3, 5, 2).astype(np.float32),
            "s@len": np.array([5, 3, 4], np.int32),
            "off": np.array([[-2.], [2.], [1.]], np.float32),
            "size": np.array([[3.], [4.], [2.]], np.float32)}
    got = _compare(config, feed, ["pooled", "sub"])
    np.testing.assert_allclose(got["sub"][1, 1:], 0.0)      # past the end


def test_sub_nested_seq_keeps_topk_in_time_order():
    """tests/test_subseq_misc2.py's case, then padded scores (which never
    compete) and a tie (the lower step first), against JAX."""
    def config(paddle):
        layer, dvs = paddle.layer, paddle.data_type.dense_vector_sequence
        seq = layer.data("s", dvs(1, max_len=5))
        scores = layer.data("sc", dvs(1, max_len=5))
        sel = layer.sub_nested_seq(seq, scores, k=2, name="sel")
        return [sel, layer.pooling(sel, pooling_type="sum", name="pooled")]

    got = _compare(config, {
        "s": np.asarray([[[10.], [20.], [30.], [40.], [50.]]], np.float32),
        "s@len": [5], "sc": np.asarray([[[0.1], [0.9], [0.2], [0.8], [0.0]]],
                                       np.float32), "sc@len": [5]}, ["sel"])
    np.testing.assert_allclose(got["sel"][0, :, 0], [20., 40.])
    sc = np.asarray([[[0.1], [0.5], [0.5], [0.2], [9.0]],
                     [[0.3], [0.1], [7.0], [8.0], [9.0]]], np.float32)
    got = _compare(config, {
        "s": np.arange(10, dtype=np.float32).reshape(2, 5, 1) * 10,
        "s@len": [5, 2], "sc": sc, "sc@len": [4, 2]}, ["sel", "pooled"])
    np.testing.assert_allclose(got["sel"][:, :, 0], [[10., 20.], [50., 60.]])


# --------------------------------------------------------- mdlstmemory
def _np_mdlstm(x, w, b, dims, directions, lens=None):
    """tests/test_mdlstm_datanorm.py's independent walker: lexicographic
    traversal of the direction-transformed coordinates, each cell as
    MDLstmLayer::forwardGate2OutputSequence computes it (all-sigmoid)."""
    B, T, _ = x.shape
    D = len(dims)
    s = x.shape[-1] // (3 + D)
    lb, cig = b[:(3 + D) * s], b[(3 + D) * s:(4 + D) * s]
    cfg = b[(4 + D) * s:(4 + 2 * D) * s].reshape(D, s)
    cog = b[(4 + 2 * D) * s:]

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    def flat(c):
        f = 0
        for d in range(D):
            f = f * dims[d] + c[d]
        return f

    out = np.zeros((B, T, s))
    state = np.zeros((B, T, s))
    for tc in itertools.product(*[range(d) for d in dims]):
        c = tuple(tc[d] if directions[d] else dims[d] - 1 - tc[d]
                  for d in range(D))
        n = flat(c)
        g = x[:, n] + lb
        pres = []
        for d in range(D):
            pc = list(c)
            pc[d] += -1 if directions[d] else 1
            pres.append(flat(tuple(pc)) if 0 <= pc[d] < dims[d] else None)
        for p in pres:
            if p is not None:
                g = g + out[:, p] @ w
        inode, ig = g[:, :s], g[:, s:2 * s]
        fg = g[:, 2 * s:(2 + D) * s].reshape(B, D, s).copy()
        og = g[:, (2 + D) * s:]
        for d, p in enumerate(pres):
            if p is not None:
                ig = ig + state[:, p] * cig
                fg[:, d] = fg[:, d] + state[:, p] * cfg[d]
        ig, fg, inode = sig(ig), sig(fg), sig(inode)
        st = inode * ig
        for d, p in enumerate(pres):
            if p is not None:
                st = st + fg[:, d] * state[:, p]
        state[:, n] = st
        out[:, n] = sig(st) * sig(og + st * cog)
        if lens is not None:
            absent = np.asarray(lens) <= n
            state[absent, n] = 0.0
            out[absent, n] = 0.0
    return out


def _md(directions, dims, s=3):
    def config(paddle):
        layer = paddle.layer
        x = layer.data("x", paddle.data_type.dense_vector_sequence(
            (3 + len(directions)) * s, max_len=int(np.prod(dims))))
        md = layer.mdlstmemory(x, directions=directions,
                               grid_dims=dims if len(dims) > 1 else None,
                               name="md")
        return [md, layer.sum_cost(layer.pooling(md, pooling_type="sum"),
                                   name="cost")]
    return config


def _md_feed(dims, width, lens, seed):
    t = int(np.prod(dims))
    return {"x": np.random.RandomState(seed).randn(2, t, width).astype(
        np.float32) * 0.5, "x@len": np.asarray(lens, np.int32)}


@pytest.mark.parametrize("directions",
                         list(itertools.product([True, False], repeat=2)))
def test_mdlstm_matches_walker_and_jax(directions):
    """Each direction pair on a 2 x 3 grid: outputs against the walker and
    the JAX package, gradients against JAX's."""
    feed = _md_feed((2, 3), 15, [6, 6], 0)
    got = _compare(_md(directions, (2, 3)), feed, ["md"])["md"]
    _, ttopo, values = _build(_md(directions, (2, 3)))
    want = _np_mdlstm(feed["x"], values["md"]["w"], values["md"]["b"],
                      (2, 3), directions)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_mdlstm_ragged_cells_are_boundary():
    """Padded cells write zero output and state and are a boundary to
    their neighbours; reversed dims walk them first."""
    directions = (True, False)
    feed = _md_feed((2, 3), 15, [6, 4], 7)
    got = _compare(_md(directions, (2, 3)), feed, ["md", "cost"])["md"]
    _, _, values = _build(_md(directions, (2, 3)))
    want = _np_mdlstm(feed["x"], values["md"]["w"], values["md"]["b"],
                      (2, 3), directions, lens=feed["x@len"])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.all(got[1, 4:] == 0.0)


def test_mdlstm_1d():
    """D = 1: a peephole quasi-LSTM over the sequence."""
    feed = _md_feed((5,), 16, [5, 3], 1)
    got = _compare(_md((True,), (5,), s=4), feed, ["md"])["md"]
    _, _, values = _build(_md((True,), (5,), s=4))
    want = _np_mdlstm(feed["x"], values["md"]["w"], values["md"]["b"],
                      (5,), (True,), lens=feed["x@len"])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_mdlstm_shape_validation():
    """A length that is not the grid's size, and the DSL's own checks."""
    _, ttopo, values = _build(_md((True, True), (2, 3)))
    params = pt.parameters.from_numpy(ttopo, values, device="cpu").values
    with pytest.raises(ValueError, match="prod\\(grid_dims\\)"):
        ttopo.forward(params, {}, _md_feed((5,), 15, [5, 5], 3),
                      outputs=["md"], device="cpu")
    x = pt.layer.data("y", pt.data_type.dense_vector_sequence(15, max_len=6))
    with pytest.raises(ValueError, match="require grid_dims"):
        pt.layer.mdlstmemory(x, directions=(True, False))
    with pytest.raises(ValueError, match="rank"):
        pt.layer.mdlstmemory(x, directions=(True,), grid_dims=(2, 3))
    with pytest.raises(ValueError, match="not divisible"):
        pt.layer.mdlstmemory(pt.layer.data(
            "z", pt.data_type.dense_vector_sequence(14, max_len=6)),
            grid_dims=(2, 3))


# ---------------------------------------------------------- text_lstm
def test_text_lstm_tiny_matches_jax():
    """tests/test_models.py's tiny text_lstm (two peephole LSTMs, a max
    pool): the cost, the prediction and every gradient."""
    def config(paddle):
        mod = jtext_lstm if paddle is pj else ttext_lstm
        return list(mod.build(vocab_size=100, emb_dim=16, hidden=32,
                              num_layers=2, num_classes=2, max_len=12))

    rng = np.random.RandomState(0)
    got = _compare(config, {
        "words": rng.randint(0, 100, size=(3, 12)).astype(np.int32),
        "words@len": np.array([5, 12, 8], np.int32),
        "label": np.array([0, 1, 0], np.int32)}, ["cost", "prediction"])
    assert got["prediction"].shape == (3, 2)


# ------------------------------------------------------------ datasets
@pytest.mark.parametrize("name", ["imdb", "wmt14", "wmt16"])
def test_synthetic_datasets_equal_jax(name):
    """The synthetic streams, sample for sample the JAX package's; the
    dictionaries equal; without synthetic data they raise."""
    import importlib

    jmod = importlib.import_module(f"paddle_tpu.dataset.{name}")
    tmod = getattr(pt.dataset, name)
    for split in ("train", "test"):
        want = list(getattr(jmod, split)(n=40)())
        assert list(getattr(tmod, split)(n=40)()) == want
        assert len(want) == 40
    if name == "imdb":
        assert tmod.word_dict() == jmod.word_dict()
    if name == "wmt16":
        assert tmod.get_dict("de", 50) == jmod.get_dict("de", 50)
        assert tmod.validation is tmod.test
    with pytest.raises(RuntimeError, match="synthetic=True"):
        tmod.train(synthetic=False)
