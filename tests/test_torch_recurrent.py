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

    (_, jouts), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True))(*args[:-1])
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

    jgrads = jax.jit(jax.grad(jloss))(values)
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

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True))(
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

    def generator_beam_search():
        # its ids and scores against the JAX package:
        # tests/test_torch_generation.py
        enc = layer.data("enc", dt.dense_vector(8))

        def step(emb):
            mem = layer.memory(name="h", size=8, boot_layer=enc)
            nxt = layer.fc([emb, mem], 8, act="tanh", name="h",
                           bias_attr=False)
            return layer.fc(nxt, 30, act="softmax", name="probs",
                            bias_attr=False)

        return layer.beam_search(
            step, [layer.GeneratedInput(size=30, embedding_size=6)],
            bos_id=0, eos_id=1, beam_size=3, max_length=10, name="gen")

    return {f.__name__: f for f in (
        simple_rnn_layers, recurrent_group, bi_grumemory, grumemory_layer,
        lstmemory_layer, fused_bahdanau_r4, generator_beam_search)}


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


# ------------------------------------------------------- bf16 step kernels
def _bf16(a, dt=torch.bfloat16):
    """A float32 array rounded to bf16 (or ``dt``), as float32 numpy."""
    return torch.from_numpy(a).to(dt).float().numpy()


# (x dtype, mask dtype): the bf16 instances under their own ids, the
# float16 ones after them
STEP_DTYPES = [pytest.param("bfloat16", "float32", id="float32"),
               pytest.param("bfloat16", "bfloat16", id="bfloat16"),
               pytest.param("float16", "float32", id="f16-float32"),
               pytest.param("float16", "float16", id="f16-float16")]


@pytest.mark.parametrize("x_dtype,m_dtype", STEP_DTYPES)
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_bf16_step_matches_pallas_interpret(kind, x_dtype, m_dtype):
    """Every (x, mask) dtype combination the kernels have a bf16 or
    float16 instance for (``fused_rnn.KERNEL_DTYPES``, the combinations
    the JAX package reaches: see the next test): x bf16 (float16), h, c,
    the weights and the bias float32, the mask float32 or in x's dtype.
    The port's plain step against ``_lstm_pallas`` / ``_gru_pallas`` under
    the interpreter (which upcast every operand): h' and c' float32 in
    both within 1e-5, the gradients in their operands' dtypes (dx in x's)
    within 1e-5 and one ulp of x's dtype of max(1, max |g|) for dx."""
    import jax
    import jax.numpy as jnp

    xdt = getattr(torch, x_dtype)
    args = _step_args(kind, 12, 16, seed=3)
    args[0] = _bf16(args[0], xdt)
    m = args[-1]
    jdt = getattr(jnp, m_dtype)
    tdt = getattr(torch, m_dtype)
    assert (xdt, tdt) in trnn.KERNEL_DTYPES
    jstep = jrnn.lstm_step if kind == "lstm" else jrnn.gru_step
    tstep = trnn.lstm_step if kind == "lstm" else trnn.gru_step
    n_out = 2 if kind == "lstm" else 1
    cots = [np.random.default_rng(7).standard_normal((12, 16)).astype(
        np.float32) for _ in range(n_out)]
    jargs = [jnp.asarray(args[0], x_dtype)] + [jnp.asarray(a) for a in
                                               args[1:-1]]

    def jloss(*xs):
        outs = jstep(*xs, jnp.asarray(m, jdt), impl="interpret", block_b=8)
        outs = outs if n_out == 2 else (outs,)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    (_, jouts), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True))(*jargs)
    leaves = ([torch.from_numpy(args[0]).to(xdt).requires_grad_(True)]
              + [_t(a).requires_grad_(True) for a in args[1:-1]])
    touts = tstep(*leaves, _t(m).to(tdt))
    touts = touts if n_out == 2 else (touts,)
    tgrads = torch.autograd.grad(
        sum((o * _t(c)).sum() for o, c in zip(touts, cots)), leaves)
    for j, t in zip(jouts, touts):
        assert t.dtype == torch.float32 and j.dtype == jnp.float32
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)
    for i, (j, t) in enumerate(zip(jgrads, tgrads)):
        assert str(t.dtype) == "torch." + str(j.dtype)
        want = np.asarray(j.astype(jnp.float32))
        ulp = 2.0 ** -8 if xdt == torch.bfloat16 else 2.0 ** -11
        tol = ulp * max(1.0, np.abs(want).max()) if i == 0 else 1e-5
        np.testing.assert_allclose(t.float().numpy(), want, atol=tol,
                                   rtol=1e-5)
    dead = m[:, 0] == 0
    np.testing.assert_array_equal(touts[0].detach().numpy()[dead],
                                  args[1][dead])


def _record_step_dtypes(monkeypatch):
    """Route the JAX package's recurrent layers to its step functions
    (declaring its backend the TPU) and record each call's operand
    dtypes; and record the port's kernel-route calls the same way
    (declaring the CPU the card).  Both run the plain step."""
    from paddle_tpu.core import config as jcfg

    seen = {"jax": set(), "port": set()}

    def recorder(pkg, kind, fn, **fixed):
        def rec(*a, **kw):
            seen[pkg].add((kind,) + tuple(
                str(x.dtype).removeprefix("torch.") for x in a))
            return fn(*a, **{**kw, **fixed})
        return rec

    monkeypatch.setattr(jcfg, "is_tpu_backend", lambda: True)
    for kind in ("lstm", "gru"):
        monkeypatch.setattr(jrnn, f"{kind}_step", recorder(
            "jax", kind, getattr(jrnn, f"{kind}_step"), impl="xla"))
        monkeypatch.setattr(trnn, f"{kind}_step", recorder(
            "port", kind, getattr(trnn, f"{kind}_step")))
    monkeypatch.setattr(trecurrent, "_on_card", lambda x: True)
    return seen


def _recorded_models(paddle):
    """The NMT model (kernel-wide encoder), the LSTM route (two
    lstmemory(peephole=False) layers) and a grumemory, h 128, in either
    package."""
    from paddle_tpu.models import seq2seq as jseq2seq
    from paddle_tpu_torch.models import seq2seq as tseq2seq

    seq2seq = tseq2seq if paddle is pt else jseq2seq
    layer = paddle.layer
    nmt = seq2seq.build(50, 40, emb_dim=16, enc_dim=128, dec_dim=32,
                        max_src_len=6, max_trg_len=6)
    words = layer.data("data", paddle.data_type.integer_value_sequence(
        50, max_len=5))
    net = layer.embedding(words, size=8, vocab_size=50)
    for _ in range(2):
        net = layer.lstmemory(layer.fc(net, size=4 * 128, act=None,
                                       bias_attr=False), peephole=False)
    lab = layer.data("label", paddle.data_type.integer_value(2))
    lstm = layer.classification_cost(layer.fc(layer.last_seq(net), size=2),
                                     lab)
    gru = layer.sum_cost(layer.last_seq(layer.grumemory(
        layer.fc(layer.embedding(words, size=8, vocab_size=50), size=384,
                 act=None))))
    return [nmt, lstm, gru]


@pytest.mark.parametrize("precision", ["bf16", "mixed", "fp16"])
def test_bf16_step_dtypes_are_the_kernel_instances(precision, monkeypatch):
    """Which operand dtypes reach the step kernels under ``precision``:
    the JAX NMT model, the LSTM route and a grumemory, with and without
    ``@len`` feeds, each run forward and backward with a recording hook
    on the step's inputs.  The combinations found are exactly the
    kernels' instances (``fused_rnn.KERNEL_DTYPES``: x bf16, or float16
    under ``fp16``, the mask float32 with ``@len`` or in x's dtype
    without, everything else float32), and the port's layers reach
    exactly the same ones."""
    import jax

    from paddle_tpu_torch.core import config as tconfig

    seen = _record_step_dtypes(monkeypatch)
    rng = np.random.RandomState(0)
    nmt_feed = {
        "source_words": rng.randint(0, 50, (4, 6)).astype(np.int32),
        "target_words": rng.randint(0, 40, (4, 6)).astype(np.int32),
        "target_next_words": rng.randint(0, 40, (4, 6)).astype(np.int32)}
    seq_feed = {"data": rng.randint(0, 50, (3, 5)).astype(np.int32),
                "label": np.array([0, 1, 1], np.int32)}
    lens = {"source_words@len": np.array([6, 1, 4, 5], np.int32),
            "target_words@len": np.array([3, 6, 1, 5], np.int32),
            "target_next_words@len": np.array([3, 6, 1, 5], np.int32),
            "data@len": np.array([5, 2, 4], np.int32)}
    saved = dict(tconfig._options)
    try:
        for paddle in (pj, pt):
            reset_jax_names()
            reset_port_names()
            if paddle is pj:
                pj.init(seed=0, precision=precision)
            else:
                pt.init(seed=0, device="cpu", precision=precision)
            for cost, feed in zip(_recorded_models(paddle),
                                  (nmt_feed, seq_feed, seq_feed)):
                if paddle is pj:
                    topo = pj.Topology(cost, collect_evaluators=False)
                else:
                    topo = pt.Topology(cost)
                values = (pj.parameters.create(topo) if paddle is pj else
                          pt.parameters.create(topo, device="cpu")).values
                for with_lens in (True, False):
                    f = dict(feed, **{k: v for k, v in lens.items()
                                      if with_lens and k.split("@")[0]
                                      in feed})
                    if paddle is pj:
                        # traced, not run: the dtypes reach the step
                        # functions at trace time (no value is compared)
                        jax.eval_shape(jax.grad(lambda v: topo.forward(
                            v, {}, f, train=True)[0][topo.output_names[0]]),
                            values)
                    else:
                        tr = pt.trainer.SGD(
                            topo, pt.parameters.from_numpy(
                                topo, {l: {p: t.numpy() for p, t in
                                           ps.items()}
                                       for l, ps in values.items()},
                                device="cpu"), pt.optimizer.Adam())
                        tr.forward_backward(f)
    finally:
        pj.init(seed=0, precision="fp32")
        tconfig._options.clear()
        tconfig._options.update(saved)
    want = set()
    x_want = torch.float16 if precision == "fp16" else torch.bfloat16
    for kind in ("lstm", "gru"):
        for x_dt, m_dt in trnn.KERNEL_DTYPES:
            if x_dt != x_want:
                continue
            rest = ["float32"] * 4          # h (c), the weights, b
            want.add((kind, str(x_dt).removeprefix("torch."), *rest,
                      str(m_dt).removeprefix("torch.")))
    assert seen["jax"] == want, sorted(seen["jax"])
    assert seen["port"] == want, sorted(seen["port"])


def test_bf16_bahdanau_step_matches_jax():
    """On the operands the attention layer casts to bf16 (enc, enc_proj,
    state, w_dp, v; the mask float32): the context bf16 in both, and each
    gradient in its operand's dtype, values within one bf16 ulp of
    max(1, max |ref|) (read: bit-equal)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    b, te, de, hp, hs = 4, 6, 5, 7, 3
    args = [_bf16(rng.standard_normal(s).astype(np.float32)) for s in
            ((b, te, de), (b, te, hp), (b, hs), (hs, hp), (hp,))]
    mask = (np.arange(te)[None] < np.array([6, 2, 0, 1])[:, None]).astype(
        np.float32)
    cot = _bf16(rng.standard_normal((b, de)).astype(np.float32))

    def jloss(*xs):
        out = jbahdanau.bahdanau_step(*xs, jnp.asarray(mask))
        return (out.astype(jnp.float32) * cot).sum(), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True))(
            *(jnp.asarray(a, jnp.bfloat16) for a in args))
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
              for a in args]
    tout = tbahdanau.bahdanau_step(*leaves, _t(mask))
    tgrads = torch.autograd.grad((tout.float() * _t(cot)).sum(), leaves)
    assert tout.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    for t, j in [(tout, jout)] + list(zip(tgrads, jgrads)):
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        want = np.asarray(j.astype(jnp.float32))
        np.testing.assert_allclose(
            t.detach().float().numpy(), want, rtol=0,
            atol=2.0 ** -8 * max(1.0, np.abs(want).max()))
