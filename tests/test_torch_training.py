"""The training slice of the PyTorch port (paddle_tpu_torch: the layer DSL,
Topology, parameters, optimizers, trainer.SGD, the CLI train verb) against
the JAX package on the CPU.

The LM is small (vocab 50, dim 32, 2 heads of 16, 2 layers, T 12, batch
3); inputs come from a numpy seed; the JAX package runs its fp32 policy.
Weights cross between the packages through ``Parameters.to_tar`` /
``from_tar``.  Tolerances: 1e-5 for forward, loss and gradients (float32
sums taken in another order), 1e-6 for one optimizer update, 1e-5
relative for a 3-step loss trajectory.
"""

import functools
import io
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
import torch_layer_configs as layer_configs
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.models import transformer as tt

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(vocab_size=50, max_len=12, dim=32, num_heads=2, num_layers=2)
BENCH = dict(vocab_size=32000, max_len=4096, dim=512, num_heads=4,
             num_layers=8)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _init_both(seed=0):
    reset_jax_names()
    reset_port_names()
    pj.init(seed=seed)
    pt.init(seed=seed, device="cpu")


def _lm_both(**kw):
    """The LM built in both packages: (port topology, JAX topology), both
    with the logits as an extra output."""
    _init_both()
    ct, lt = tt.build(**kw)
    cj, lj = jt.build(**kw)
    return (pt.Topology(ct, extra_inputs=[lt]),
            pj.Topology(cj, extra_inputs=[lj], collect_evaluators=False))


def _cross(jparams, ttopo):
    """The JAX package's parameters, carried into the port through a tar."""
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    tparams = pt.parameters.create(ttopo, device="cpu")
    tparams.from_tar(buf)
    return tparams


def _feed(padded: bool, seed: int = 0):
    rng = np.random.RandomState(seed)
    feed = {"tokens": rng.randint(0, 50, (3, 12)).astype(np.int32),
            "targets": rng.randint(0, 50, (3, 12)).astype(np.int32)}
    if padded:
        feed["tokens@len"] = np.array([12, 7, 3], np.int32)
    return feed


# ------------------------------------------------------------------ the IR
@pytest.mark.parametrize("widths", ["small", "bench"])
def test_transformer_proto_is_byte_equal(widths):
    ttopo, jtopo = _lm_both(**(SMALL if widths == "small" else BENCH))
    assert ttopo.proto() == jtopo.proto()


def _mnist_mlp(paddle):
    """tests/test_golden_ir.py's mnist_mlp config, in either package."""
    layer, dt = paddle.layer, paddle.data_type
    img = layer.data("image", dt.dense_vector(784))
    lbl = layer.data("label", dt.integer_value(10))
    h = layer.fc(img, size=128, act="relu", name="hidden1")
    h = layer.fc(h, size=64, act="relu", name="hidden2")
    pred = layer.fc(h, size=10, act="softmax", name="prediction")
    return layer.classification_cost(pred, lbl, name="cost")


def _fc_variants(paddle):
    """tests/test_golden_ir.py's fc_variants config, in either package."""
    layer = paddle.layer
    x = layer.data("x", paddle.data_type.dense_vector(100))
    f1 = layer.fc(x, size=32, act="tanh", bias_attr=False, name="no_bias")
    f2 = layer.fc(f1, size=16, act="relu",
                  param_attr=paddle.attr.ParamAttr(initializer="xavier"),
                  name="with_attr")
    return layer.sum_cost(f2)


# the goldens whose configs use only ported layers: the two above and
# those of tests/torch_layer_configs.py (the v2 costs, sequence layers,
# mixed and the fused-head LM, given the port's LM builder)
GOLDEN_CONFIGS = {"mnist_mlp": _mnist_mlp, "fc_variants": _fc_variants,
                  **{name: functools.partial(fn, transformer=tt)
                     for name, fn in layer_configs.CONFIGS.items()}}


@pytest.mark.parametrize("name", sorted(GOLDEN_CONFIGS))
def test_golden_proto_is_byte_equal(name):
    _init_both()
    text = pt.Topology(GOLDEN_CONFIGS[name](pt)).proto() + "\n"
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        assert text == f.read()


# ------------------------------------------------- forward and gradients
@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_forward_loss_and_grads_match_jax(padded):
    """From the same weights: logits, loss and every parameter gradient.
    The padded feed carries tokens@len, which sends kv_lens through the
    attention and weights the loss by the mask."""
    import jax

    ttopo, jtopo = _lm_both(**SMALL)
    jparams = pj.parameters.create(jtopo)
    tparams = _cross(jparams, ttopo)
    feed = _feed(padded)

    def jloss(values):
        outs, _ = jtopo.forward(values, {}, feed, train=True,
                                outputs=["cost", "logits"])
        return outs["cost"], outs["logits"]

    (jcost, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams.values)
    tr = pt.trainer.SGD(ttopo, tparams, pt.optimizer.Adam())
    tcost, tgrads = tr.forward_backward(feed)
    with torch.no_grad():
        touts, _ = ttopo.forward(tparams.values, {}, feed,
                                 outputs=["logits"], device="cpu")
    np.testing.assert_allclose(touts["logits"].numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(float(tcost), float(jcost), **TOL)
    assert sorted(tgrads) == sorted(jgrads)
    for lname, ps in tgrads.items():
        assert sorted(ps) == sorted(jgrads[lname])
        for pname, g in ps.items():
            np.testing.assert_allclose(
                g.numpy(), np.asarray(jgrads[lname][pname]), atol=1e-5,
                rtol=0, err_msg=f"{lname}.{pname}")


def test_parameters_cross_both_ways():
    """A tar the port writes loads into the JAX package, and
    ``parameters.from_numpy`` takes the JAX package's value tree."""
    ttopo, jtopo = _lm_both(**SMALL)
    tparams = pt.parameters.create(ttopo, device="cpu")
    buf = io.BytesIO()
    tparams.to_tar(buf)
    buf.seek(0)
    jparams = pj.parameters.create(jtopo)
    jparams.from_tar(buf)
    for key in tparams.keys():
        np.testing.assert_array_equal(jparams[key], tparams[key])
    back = pt.parameters.from_numpy(ttopo, jparams.values, device="cpu")
    assert sorted(back.keys()) == sorted(tparams.keys())
    for key in back.keys():
        np.testing.assert_array_equal(back[key], tparams[key])
    assert back.meta == tparams.meta
    with pytest.raises(ValueError, match="shape"):
        bad = {l: dict(ps) for l, ps in jparams.values.items()}
        bad["logits"]["b"] = np.zeros(7, np.float32)
        pt.parameters.from_numpy(ttopo, bad, device="cpu")


# --------------------------------------------------------------- optimizers
OPTIMIZERS = {
    "adam": lambda m: m.Adam(learning_rate=1e-2),
    "momentum": lambda m: m.Momentum(learning_rate=0.1, momentum=0.9),
    "nesterov_l2_clip": lambda m: m.Momentum(
        learning_rate=0.05, momentum=0.9, nesterov=True,
        regularization=m.L2Regularization(1e-3),
        gradient_clipping_threshold=1.0),
    "sgd_poly_schedule": lambda m: m.Momentum(
        learning_rate=0.1, learning_rate_schedule="poly",
        learning_rate_decay_a=0.5, learning_rate_decay_b=0.75),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    """Three updates from the same parameters, gradients and state
    (per-parameter learning-rate scale and clip included): parameters and
    slots agree at 1e-6, Adam's bias correction with them."""
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    shapes = {"a": {"w": (5, 4), "b": (4,)}, "c": {"w": (3, 3)}}
    values = {l: {p: rng.randn(*s).astype(np.float32)
                  for p, s in ps.items()} for l, ps in shapes.items()}
    meta = {"a": {"w": {"learning_rate": 0.5}, "b": {"clip": 0.3}},
            "c": {"w": {}}}
    jopt, topt = OPTIMIZERS[name](pj.optimizer), OPTIMIZERS[name](
        pt.optimizer)
    jparams = {l: {p: jnp.asarray(v) for p, v in ps.items()}
               for l, ps in values.items()}
    tparams = {l: {p: torch.from_numpy(v.copy()) for p, v in ps.items()}
               for l, ps in values.items()}
    jstate, tstate = jopt.init_state(jparams), topt.init_state(tparams)
    for _ in range(3):
        grads = {l: {p: rng.randn(*s).astype(np.float32)
                     for p, s in ps.items()} for l, ps in shapes.items()}
        jparams, jstate = jopt.update(
            jparams, {l: {p: jnp.asarray(g) for p, g in ps.items()}
                      for l, ps in grads.items()}, jstate, meta)
        tparams, tstate = topt.update(
            tparams, {l: {p: torch.from_numpy(g) for p, g in ps.items()}
                      for l, ps in grads.items()}, tstate, meta)
    assert tstate["t"] == int(jstate["t"]) == 3
    for l, ps in tparams.items():
        for p, t in ps.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[l][p]),
                                       atol=1e-6, rtol=1e-6)
            for slot, s in tstate["slots"][l][p].items():
                np.testing.assert_allclose(
                    s.numpy(), np.asarray(jstate["slots"][l][p][slot]),
                    atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------ trainer
def _samples():
    """Three variable-length samples (padded to max_len by the feeder,
    which also writes tokens@len and targets@len)."""
    rng = np.random.RandomState(5)
    for n in (12, 9, 5):
        toks = rng.randint(0, 50, n).tolist()
        yield toks, toks[1:] + [0]


def _events(log):
    def handler(e):
        rec = [type(e).__name__, getattr(e, "pass_id", None),
               getattr(e, "batch_id", None)]
        if type(e).__name__ == "EndIteration":
            rec.append(e.cost)
        log.append(rec)
    return handler


def test_sgd_train_matches_jax_trajectory():
    """Three Momentum steps of ``SGD.train`` through the DataFeeder: the
    same events in the same order, and losses within 1e-5 relative."""
    ttopo, jtopo = _lm_both(**SMALL)
    jparams = pj.parameters.create(jtopo)
    tparams = _cross(jparams, ttopo)
    reader = lambda: iter([list(_samples())] * 3)   # noqa: E731
    feeding = {"tokens": 0, "targets": 1}
    jlog, tlog = [], []
    pj.trainer.SGD(jtopo, jparams, pj.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9)).train(
            reader, event_handler=_events(jlog), feeding=feeding)
    tr = pt.trainer.SGD(ttopo, tparams, pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9))
    tr.train(reader, event_handler=_events(tlog), feeding=feeding)
    assert [r[:3] for r in tlog] == [r[:3] for r in jlog]
    jl = [r[3] for r in jlog if len(r) == 4]
    tl = [r[3] for r in tlog if len(r) == 4]
    assert len(tl) == 3 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    # the trained values are the Parameters' own, and test() reads them
    for key in tparams.keys():
        np.testing.assert_allclose(tparams[key], jparams[key], atol=1e-5)
    cost = tr.test(lambda: iter([list(_samples())]),
                   feeding=feeding).cost
    assert cost < tl[0]


def _greedy_reforward(topo, values, prompt, max_new):
    """Greedy decoding through the training graph, re-running the whole
    forward per token (the oracle of the cached decoders)."""
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(max_new):
            feed = {"tokens": np.array([toks]), "targets": np.array([toks])}
            outs, _ = topo.forward(values, {}, feed, outputs=["logits"],
                                   device="cpu")
            toks.append(int(torch.argmax(outs["logits"][0, -1])))
    return toks[len(prompt):]


def test_lm_learns_and_its_parameters_serve():
    """Counterpart of tests/test_transformer.py's learned-pattern test: the
    port LM learns constant-per-row sequences, and its trained Parameters
    serve the same greedy stream through the port's PagedDecoder (no
    numpy round trip) as a re-forward of the training graph."""
    from paddle_tpu_torch.models.transformer import (PagedDecoder,
                                                     params_from_jax)

    _init_both()
    vocab, T = 16, 12
    cost, logits = tt.build(vocab_size=vocab, max_len=T, dim=32,
                            num_heads=2, num_layers=2)
    topo = pt.Topology(cost, extra_inputs=[logits])
    params = pt.parameters.create(topo)
    tr = pt.trainer.SGD(topo, params, pt.optimizer.Adam(learning_rate=5e-3))
    rng = np.random.RandomState(0)

    def reader():
        for _ in range(15):
            vals = rng.randint(2, vocab, (16, 1)).astype(np.int32)
            toks = np.repeat(vals, T, axis=1)
            yield {"tokens": toks, "targets": toks.copy()}

    tr.train(reader, num_passes=4, event_handler=lambda e: None)
    model = params_from_jax(params, num_heads=2)
    # the decoder shares the trained tensors
    assert (model.p["logits"]["w0"].data_ptr()
            == params.values["logits"]["w0"].data_ptr())
    dec = PagedDecoder(model, max_slots=2, block_size=4, device="cpu")
    for const in (5, 9):
        prompt = [const] * 3
        stream = [dec.prefill(0, prompt)]
        for pos in range(3, 6):
            stream.append(int(dec.step(1, [stream[-1]], [pos])[0]))
        dec.release_sequence(0)
        assert stream == [const] * 4
        assert stream == _greedy_reforward(topo, params.values, prompt, 4)


# ---------------------------------------------------------------------- CLI
CLI_CONFIG = '''
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch.models import transformer

paddle.init(seed=0)
cost, _ = transformer.build(vocab_size=20, max_len=8, dim=16, num_heads=2,
                            num_layers=1)
optimizer = paddle.optimizer.Adam(learning_rate=1e-2)
feeding = {"tokens": 0, "targets": 1}


def _samples():
    rng = np.random.RandomState(0)
    for _ in range(4):
        toks = rng.randint(0, 20, 8).tolist()
        yield toks, toks


train_reader = paddle.batch(_samples, 2)
'''


def test_cli_train_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``train --device cpu`` runs a 2-step config; an unported flag
    raises."""
    from paddle_tpu_torch import cli

    monkeypatch.setitem(tconfig._options, "device", None)
    monkeypatch.setitem(tconfig._options, "log_period", 100)
    path = tmp_path / "lm_cfg.py"
    path.write_text(CLI_CONFIG)
    reset_port_names()
    cli.main(["train", "--config", str(path), "--num_passes", "1",
              "--log_period", "1", "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("Pass 0, Batch")]
    assert len(lines) == 2
    costs = [float(l.rsplit(" ", 1)[1]) for l in lines]
    assert all(np.isfinite(costs))
    with pytest.raises(NotImplementedError, match="--save_dir"):
        cli.main(["train", "--config", str(path), "--device", "cpu",
                  "--save_dir", str(tmp_path)])


# ------------------------------------------------------ what is refused
def test_unported_options_raise_rather_than_fall_through(monkeypatch):
    ttopo, _ = _lm_both(**SMALL)
    params = pt.parameters.create(ttopo, device="cpu")
    # the precision policy is ported: only a name it does not know raises
    with pytest.raises(ValueError, match="unknown precision"):
        pt.init(precision="int8")
    with pytest.raises(NotImplementedError, match="context_parallel"):
        tt.build(context_parallel=True)
    with pytest.raises(NotImplementedError, match="mesh"):
        pt.trainer.SGD(ttopo, params, pt.optimizer.Adam(), mesh=object())
    tr = pt.trainer.SGD(ttopo, params, pt.optimizer.Adam())
    with pytest.raises(NotImplementedError, match="checkpoint_config"):
        tr.train(lambda: iter(()), checkpoint_config=object())
    # a ring-attention layer refuses to run on one device
    reset_port_names()
    x = pt.layer.data("x", pt.data_type.dense_vector_sequence(8, 4))
    att = pt.layer.multi_head_attention(x, size=8, num_heads=2,
                                        context_parallel=True)
    topo = pt.Topology(att)
    vals = pt.parameters.create(topo, device="cpu").values
    with pytest.raises(NotImplementedError, match="ring attention"):
        topo.forward(vals, {}, {"x": np.zeros((1, 4, 8), np.float32)},
                     device="cpu")
    # entry points run on the card unless told otherwise: none here
    if not torch.cuda.is_available():
        monkeypatch.setitem(tconfig._options, "device", None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.init(seed=0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.parameters.create(ttopo)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttopo.forward(params.values, {}, _feed(False))
