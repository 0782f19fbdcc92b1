"""The recurrent slice of the PyTorch port (paddle_tpu_torch: the LSTM and
GRU steps of ops/fused_rnn.py, the recurrent layers, bahdanau_step,
recurrent_group) against the JAX package on the CPU.

Inputs come from a numpy seed and go through both packages; weights cross
through ``parameters.from_numpy``.  Tolerances: 1e-5 for values and
gradients (float32 sums taken in another order), stated per test where it
differs.  On the CPU the port's step functions take their plain versions;
the layers' kernel-route branches are driven here by declaring the CPU
"the card" (``recurrent._on_card``), so their loop and mask plumbing is
held against the JAX package too, with the plain step in the kernel's
place.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.ops import bahdanau as jbahdanau
from paddle_tpu.ops import fused_rnn as jrnn
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.layers import recurrent as trecurrent
from paddle_tpu_torch.ops import bahdanau as tbahdanau
from paddle_tpu_torch.ops import fused_rnn as trnn

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ------------------------------------------------------------ step functions
def _step_args(kind, b, h, seed):
    rng = np.random.default_rng(seed)
    n = 4 if kind == "lstm" else 3
    args = [rng.standard_normal((b, n * h)), rng.standard_normal((b, h))]
    if kind == "lstm":
        args += [rng.standard_normal((b, h)),
                 rng.standard_normal((h, 4 * h)) * 0.2]
    else:
        args += [rng.standard_normal((h, 2 * h)) * 0.2,
                 rng.standard_normal((h, h)) * 0.2]
    args += [rng.standard_normal((n * h,)),
             (rng.random((b, 1)) > 0.3)]
    return [np.asarray(a, np.float32) for a in args]


@pytest.mark.parametrize("jax_impl", ["interpret", "xla"])
@pytest.mark.parametrize("kind,b,h", [("lstm", 12, 16), ("lstm", 5, 8),
                                      ("gru", 12, 16), ("gru", 5, 8)])
def test_step_matches_jax(kind, b, h, jax_impl):
    """The port's plain step (the kernel's reference) against the JAX
    package's Pallas kernel in interpret mode and its XLA oracle: values
    and the gradients of every input but the mask, under a cotangent on
    each output; masks hold zeros and B is not a multiple of 8."""
    import jax

    args = _step_args(kind, b, h, seed=b + h)
    m = args[-1]
    jstep = jrnn.lstm_step if kind == "lstm" else jrnn.gru_step
    tstep = trnn.lstm_step if kind == "lstm" else trnn.gru_step
    kw = {"block_b": 8} if jax_impl == "interpret" else {}
    n_out = 2 if kind == "lstm" else 1
    cots = [np.random.default_rng(7).standard_normal((b, h)).astype(
        np.float32) for _ in range(n_out)]

    def jloss(*xs):
        outs = jstep(*xs, m, impl=jax_impl, **kw)
        outs = outs if n_out == 2 else (outs,)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    (_, jouts), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(*args[:-1])
    leaves = [_t(a).requires_grad_(True) for a in args[:-1]]
    touts = tstep(*leaves, _t(m))
    touts = touts if n_out == 2 else (touts,)
    tgrads = torch.autograd.grad(
        sum((o * _t(c)).sum() for o, c in zip(touts, cots)), leaves)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)
    for j, t in zip(jgrads, tgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    # masked rows keep the old state exactly
    dead = m[:, 0] == 0
    assert dead.any()
    np.testing.assert_array_equal(touts[0].detach().numpy()[dead],
                                  args[1][dead])


def test_step_wrappers_refuse_what_the_kernel_cannot_take():
    """The kernel route raises on a CPU tensor, and the launch wrappers
    check dtype and shape before anything is built."""
    x, h, c, w, b, m = (_t(a) for a in _step_args("lstm", 4, 8, 0))
    with pytest.raises(ValueError, match="CUDA"):
        trnn.lstm_step(x, h, c, w, b, m, impl="cuda")
    with pytest.raises(TypeError, match="float32"):
        trnn.lstm_step_cuda(x.double(), h, c, w, b, m)
    with pytest.raises(ValueError, match="shape"):
        trnn.lstm_step_cuda(x, h, c, w[:, :8], b, m)
    xg, hg, wg, wc, bg, mg = (_t(a) for a in _step_args("gru", 4, 8, 0))
    with pytest.raises(ValueError, match="contiguous"):
        trnn.gru_step_cuda(xg, hg, wg, wc.t(), bg, mg)
    assert trnn.lstm_step_cuda.launches == trnn.gru_step_cuda.launches == 0


# ----------------------------------------------------------------- layers
def _values(jtopo, seed):
    """The JAX package's parameters with random biases too (zeros would
    hide a bias bug), as numpy."""
    rng = np.random.default_rng(seed)
    params = pj.parameters.create(jtopo)
    return {l: {p: (np.asarray(v) if v.ndim == 2 else
                    rng.standard_normal(v.shape).astype(np.float32) * 0.3)
                for p, v in ps.items()} for l, ps in params.values.items()}


def _compare(config, feed, out_names, seed=0):
    """Build ``config(package)`` in both packages (each returns its output
    layers), then hold the port against the JAX package from the same
    weights: each output, and the gradient of sum(output * cotangent)
    over them with respect to every parameter."""
    import jax

    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")
    jtopo = pj.Topology(config(pj), collect_evaluators=False)
    ttopo = pt.Topology(config(pt))
    assert ttopo.proto() == jtopo.proto()
    values = _values(jtopo, seed)
    tparams = pt.parameters.from_numpy(ttopo, values, device="cpu")
    rng = np.random.default_rng(seed + 1)
    jouts, _ = jtopo.forward(values, {}, feed, outputs=out_names)
    cots = {n: rng.standard_normal(np.asarray(jouts[n]).shape).astype(
        np.float32) for n in out_names}

    def jloss(v):
        outs, _ = jtopo.forward(v, {}, feed, train=True, outputs=out_names)
        return sum((outs[n] * cots[n]).sum() for n in out_names)

    jgrads = jax.grad(jloss)(values)
    leaves = {l: {p: t.requires_grad_(True) for p, t in ps.items()}
              for l, ps in tparams.values.items()}
    touts, _ = ttopo.forward(leaves, {}, feed, train=True, outputs=out_names,
                             device="cpu")
    flat = [(l, p, t) for l, ps in leaves.items() for p, t in ps.items()]
    tgrads = torch.autograd.grad(
        sum((touts[n] * _t(cots[n])).sum() for n in out_names),
        [t for _, _, t in flat])
    for n in out_names:
        np.testing.assert_allclose(touts[n].detach().numpy(),
                                   np.asarray(jouts[n]), **TOL, err_msg=n)
    assert {(l, p) for l, p, _ in flat} == {
        (l, p) for l, ps in jgrads.items() for p in ps}
    for (l, p, _), g in zip(flat, tgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[l][p]),
                                   **TOL, err_msg=f"{l}.{p}")


def _seq_feed(b, t, d, lens, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, t, d)).astype(np.float32),
            "x@len": np.asarray(lens, np.int32)}


LENS = [6, 3, 1, 5, 6]


def _layer_config(kind, **kw):
    def config(paddle):
        layer, dt = paddle.layer, paddle.data_type
        x = layer.data("x", dt.dense_vector_sequence(kw["width"],
                                                     max_len=6))
        if kind == "recurrent":
            return [layer.recurrent(x, act="tanh", reverse=kw["reverse"],
                                    name="out")]
        if kind == "lstmemory":
            return [layer.lstmemory(x, reverse=kw["reverse"],
                                    peephole=kw["peephole"], name="out")]
        if kind == "grumemory":
            return [layer.grumemory(x, reverse=kw["reverse"], name="out")]
        if kind == "bigru":
            return [paddle.networks.bidirectional_gru(
                x, kw["width"] // 3, fused=True, name="out")]
        raise ValueError(kind)
    return config


LAYER_CASES = {
    "recurrent": ("recurrent", dict(width=8, reverse=False)),
    "recurrent_reverse": ("recurrent", dict(width=8, reverse=True)),
    "lstmemory_peephole": ("lstmemory", dict(width=32, reverse=False,
                                             peephole=True)),
    "lstmemory_peephole_reverse": ("lstmemory", dict(
        width=32, reverse=True, peephole=True)),
    "lstmemory_no_peephole": ("lstmemory", dict(width=32, reverse=False,
                                                peephole=False)),
    "grumemory_reverse": ("grumemory", dict(width=24, reverse=True)),
    "grumemory": ("grumemory", dict(width=24, reverse=False)),
    "bigru": ("bigru", dict(width=24)),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_recurrent_layer_matches_jax(case):
    """Each recurrent layer on a padded feed (one length-1 row): outputs
    and every parameter gradient at 1e-5."""
    kind, kw = LAYER_CASES[case]
    _compare(_layer_config(kind, **kw), _seq_feed(5, 6, kw["width"], LENS),
             ["out"])


KERNEL_ROUTE_CASES = {
    "lstmemory": ("lstmemory", dict(width=512, reverse=False,
                                    peephole=False)),
    "lstmemory_reverse": ("lstmemory", dict(width=512, reverse=True,
                                            peephole=False)),
    "grumemory_reverse": ("grumemory", dict(width=384, reverse=True)),
    "bigru": ("bigru", dict(width=384)),
}


@pytest.mark.parametrize("case", sorted(KERNEL_ROUTE_CASES))
def test_kernel_route_branch_matches_jax(case, monkeypatch):
    """h = 128: the layers take their kernel-route branch (the CPU
    declared the card, the step functions then run their plain versions
    in the kernel's place), held against the JAX package, whose CPU
    backend takes its plain step.  The branch's own plumbing - the time
    loop, the [B, 1] masks, the bigru's reversed walk - is what is held."""
    calls = []
    monkeypatch.setattr(trecurrent, "_on_card", lambda x: True)
    for name in ("lstm_step", "gru_step"):
        fn = getattr(trnn, name)
        monkeypatch.setattr(trnn, name, lambda *a, _f=fn, **k: (
            calls.append(1), _f(*a, **k))[1])
    kind, kw = KERNEL_ROUTE_CASES[case]
    _compare(_layer_config(kind, **kw), _seq_feed(3, 6, kw["width"],
                                                  [6, 1, 4]), ["out"])
    # one step call a timestep (two for the bigru), forward only
    assert len(calls) == 6 * (2 if kind == "bigru" else 1)


def test_use_fused_rnn_off_takes_the_plain_step(monkeypatch):
    """``init(use_fused_rnn=False)`` keeps a kernel-eligible layer on its
    plain step even on the card; ``scan_unroll`` (a JAX-package option)
    is accepted and changes nothing."""
    from paddle_tpu_torch.core import config

    monkeypatch.setattr(trecurrent, "_on_card", lambda x: True)
    # recorded so that teardown restores them: init's options persist
    monkeypatch.setitem(config._options, "use_fused_rnn", True)
    monkeypatch.setitem(config._options, "scan_unroll", 1)
    pt.init(seed=0, device="cpu", use_fused_rnn=False, scan_unroll=2)
    monkeypatch.setattr(trnn, "gru_step", None)     # calling it would fail
    _compare(_layer_config("grumemory", width=384, reverse=False),
             _seq_feed(2, 6, 384, [6, 2]), ["out"])


def _step_layer_config(kind):
    def config(paddle):
        layer, dt = paddle.layer, paddle.data_type
        h = 8
        x = layer.data("xs", dt.dense_vector((4 if kind == "lstm" else 3)
                                             * h))
        s = layer.data("st", dt.dense_vector((2 if kind == "lstm" else 1)
                                             * h))
        if kind == "lstm":
            return [layer.lstm_step_layer(x, s, size=h, name="out")]
        return [layer.gru_step_layer(x, s, size=h, name="out")]
    return config


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_step_layers_match_jax(kind):
    rng = np.random.default_rng(3)
    n, w = (4, 2) if kind == "lstm" else (3, 1)
    feed = {"xs": rng.standard_normal((5, n * 8)).astype(np.float32),
            "st": rng.standard_normal((5, w * 8)).astype(np.float32)}
    _compare(_step_layer_config(kind), feed, ["out"])


# --------------------------------------------------------------- bahdanau
def test_bahdanau_step_matches_jax():
    """Forward and every gradient from the reference's custom vjp, with an
    all-pad row (its context and gradients are zero)."""
    import jax

    rng = np.random.default_rng(4)
    b, te, de, hp, hs = 4, 6, 5, 7, 3
    args = [rng.standard_normal(s).astype(np.float32) for s in
            ((b, te, de), (b, te, hp), (b, hs), (hs, hp), (hp,))]
    mask = (np.arange(te)[None] < np.array([6, 2, 0, 1])[:, None]).astype(
        np.float32)
    cot = rng.standard_normal((b, de)).astype(np.float32)

    def jloss(*xs):
        out = jbahdanau.bahdanau_step(*xs, jax.numpy.asarray(mask))
        return (out * cot).sum(), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
            *map(jax.numpy.asarray, args))
    leaves = [_t(a).requires_grad_(True) for a in args]
    tout = tbahdanau.bahdanau_step(*leaves, _t(mask))
    tgrads = torch.autograd.grad((tout * _t(cot)).sum(), leaves)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)
    assert not tout[2].any()
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


# --------------------------------------------------------- recurrent_group
def _group_config(which):
    def config(paddle):
        layer, dt = paddle.layer, paddle.data_type
        h = 6
        x = layer.data("x", dt.dense_vector_sequence(3 * h, max_len=6))
        if which == "golden_step":
            def step(ipt):
                mem = layer.memory(name="s", size=h)
                return layer.gru_step_layer(ipt, mem, name="s")
            return [layer.recurrent_group(step, x, name="out")]
        if which == "reverse_boot_static":
            st = layer.data("st", dt.dense_vector(h))
            boot = layer.fc(st, h, act="tanh", name="boot")

            def step(ipt, ctx):
                mem = layer.memory(name="s", size=h, boot_layer=boot)
                g = layer.fc([ipt, ctx], 3 * h, bias_attr=False,
                             name="gates")
                return layer.gru_step_layer(g, mem, name="s")
            return [layer.recurrent_group(
                step, [x, layer.StaticInput(st)], reverse=True, name="out")]
        # two outputs: col_slice views of one group
        def step(ipt):
            mem = layer.memory(name="s", size=h)
            s = layer.gru_step_layer(ipt, mem, name="s")
            return s, layer.fc(s, 4, act="tanh", name="proj")
        return layer.recurrent_group(step, x, name="out")
    return config


@pytest.mark.parametrize("which,outs", [
    ("golden_step", ["out"]), ("reverse_boot_static", ["out"]),
    ("multi_output", ["out@out0", "out@out1"])])
def test_recurrent_group_matches_jax(which, outs):
    """recurrent_group on a padded feed: the ``recurrent_group`` golden's
    step, a reversed group with a boot layer and a static input, and a
    two-output group; outputs and parameter gradients at 1e-5."""
    feed = _seq_feed(5, 6, 18, LENS)
    feed["st"] = np.random.default_rng(9).standard_normal((5, 6)).astype(
        np.float32)
    _compare(_group_config(which), feed, outs)


def test_group_parameter_names_are_flat():
    reset_port_names()
    pt.init(seed=0, device="cpu")
    topo = pt.Topology(_group_config("reverse_boot_static")(pt))
    params = pt.parameters.create(topo, device="cpu")
    assert sorted(k for k in params.keys() if k.startswith("out.")) == [
        "out.gates::w0", "out.gates::w1", "out.s::b", "out.s::w_c",
        "out.s::w_g"]


# ----------------------------------------------------------------- goldens
def _golden_configs(paddle):
    layer, dt, networks = paddle.layer, paddle.data_type, paddle.networks
    dvs = dt.dense_vector_sequence

    def simple_rnn_layers():
        x = layer.data("x", dvs(12, max_len=6))
        r = layer.recurrent(x, act="tanh", name="rnn")
        g = layer.grumemory(layer.fc(x, size=12, name="gproj"), name="gru")
        lst = layer.lstmemory(layer.fc(x, size=16, name="lproj"),
                              name="lstm")
        parts = [layer.last_seq(p) for p in (r, g, lst)]
        return layer.sum_cost(layer.concat(parts))

    def recurrent_group():
        h = 6
        x = layer.data("x", dvs(3 * h, max_len=5))

        def step(ipt):
            mem = layer.memory(name="s", size=h)
            return layer.gru_step_layer(ipt, mem, name="s")

        grp = layer.recurrent_group(step, x, name="grp")
        return layer.sum_cost(layer.last_seq(grp))

    def bi_grumemory():
        x = layer.data("x", dvs(24, max_len=6))
        bi = networks.bidirectional_gru(x, size=8, name="bigru")
        return layer.sum_cost(layer.last_seq(bi))

    def grumemory_layer():
        x = layer.data("x", dvs(36, max_len=5))
        g = layer.grumemory(x, name="gru", reverse=True)
        return layer.sum_cost(layer.last_seq(g))

    def lstmemory_layer():
        x = layer.data("x", dvs(48, max_len=5))
        m = layer.lstmemory(x, name="lstm", reverse=True)
        return layer.sum_cost(layer.last_seq(m))

    def fused_bahdanau_r4():
        te, de, hs = 6, 4, 5
        enc = layer.data("benc", dvs(de, max_len=te))
        st = layer.data("bst", dt.dense_vector(hs))
        proj = layer.fc(enc, size=hs, act=None, bias_attr=False,
                        name="bproj")
        ctx_out = layer.bahdanau_attention(enc, proj, st, name="batt")
        return layer.sum_cost(layer.fc(ctx_out, size=2, name="bout"),
                              name="bcost")

    return {f.__name__: f for f in (
        simple_rnn_layers, recurrent_group, bi_grumemory, grumemory_layer,
        lstmemory_layer, fused_bahdanau_r4)}


@pytest.mark.parametrize("name", sorted(_golden_configs(pt)))
def test_recurrent_golden_proto_is_byte_equal(name):
    """tests/test_golden_ir.py's configs of these layers, built by the
    port, write the golden JSON byte for byte."""
    import os

    reset_port_names()
    pt.init(seed=0, device="cpu")
    text = pt.Topology(_golden_configs(pt)[name]()).proto() + "\n"
    path = os.path.join(os.path.dirname(__file__), "goldens", f"{name}.json")
    with open(path) as f:
        assert text == f.read()
