"""The rest of the port's optimizer family (``paddle_tpu_torch/
optimizer.py``: Adagrad, DecayedAdagrad, AdaDelta, RMSProp with and
without momentum, Adamax, Ftrl, the l1 / l2 regularizers, ModelAverage,
the legacy names and ``settings()``) against the JAX package on the CPU.

Five updates from the same parameters and gradients, with l1 and l2
decay, a per-parameter clip and learning-rate scale and a learning-rate
schedule: parameters and every slot within 1e-6 absolute and relative
(float32 arithmetic in another order), the step counter equal, and with
a ModelAverage the average and its count too.  Every update is in place
on the device step counter: the same tensors come back, and a step the
loss scale skips (``finite`` false) leaves parameters, slots, counter and
average bit for bit.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True)
def _restore_options():
    """``settings(batch_size=)`` writes a global option in the JAX
    package (the port's sets none)."""
    from paddle_tpu.core import config as jconfig
    from paddle_tpu_torch.core import config as tconfig

    saved = [(m, dict(m._options)) for m in (jconfig, tconfig)]
    yield
    for mod, opts in saved:
        mod._options.clear()
        mod._options.update(opts)
    jconfig._policy_cache = None

OPTIMIZERS = {
    "adagrad": lambda m: m.Adagrad(learning_rate=0.05),
    "decayed_adagrad": lambda m: m.DecayedAdagrad(learning_rate=0.05,
                                                  rho=0.9),
    "adadelta": lambda m: m.AdaDelta(learning_rate=1.0, rho=0.9),
    "rmsprop": lambda m: m.RMSProp(learning_rate=0.01, rho=0.9),
    "rmsprop_momentum": lambda m: m.RMSProp(learning_rate=0.01, rho=0.9,
                                            momentum=0.8),
    "adamax": lambda m: m.Adamax(learning_rate=0.02),
    "ftrl": lambda m: m.Ftrl(learning_rate=0.1, l1=0.01, l2=0.02),
    "ftrl_no_l1": lambda m: m.Ftrl(learning_rate=0.1, lr_power=-0.6),
}
# the base options every rule is also run with
EXTRAS = {
    "plain": lambda m: {},
    "l1_l2_schedule": lambda m: dict(
        regularization=m.L2Regularization(1e-3),
        learning_rate_schedule="poly", learning_rate_decay_a=0.5,
        learning_rate_decay_b=0.75),
    "l1_clip_average": lambda m: dict(
        regularization=m.L1Regularization(2e-3),
        gradient_clipping_threshold=1.5,
        model_average=m.ModelAverage(average_window=0.5)),
}
SHAPES = {"a": {"w": (5, 4), "b": (4,)}, "c": {"w": (3, 3)}}
META = {"a": {"w": {"learning_rate": 0.5, "l2": 1e-2},
              "b": {"clip": 0.3}},
        "c": {"w": {"l1": 1e-2}}}


def _make(name, extra, mod):
    opt = OPTIMIZERS[name](mod)
    kw = EXTRAS[extra](mod)
    # the rule's own constructor arguments, then the base options
    base = type(opt)(**{**_ctor_args(opt, mod), **kw})
    return base


def _ctor_args(opt, mod):
    """The arguments ``OPTIMIZERS`` gave the rule, read back."""
    args = {"learning_rate": opt.hp["learning_rate"]}
    for attr, key in (("eps", "epsilon"), ("rho", "rho"),
                      ("mom", "momentum"), ("b1", "beta1"),
                      ("b2", "beta2"), ("ftrl_l1", "l1"),
                      ("ftrl_l2", "l2"), ("lr_power", "lr_power")):
        if hasattr(opt, attr):
            args[key] = getattr(opt, attr)
    return args


@pytest.mark.parametrize("extra", sorted(EXTRAS))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_match_jax(name, extra):
    import jax.numpy as jnp

    rng = np.random.RandomState(sorted(OPTIMIZERS).index(name))
    values = {l: {p: rng.randn(*s).astype(np.float32)
                  for p, s in ps.items()} for l, ps in SHAPES.items()}
    jopt, topt = _make(name, extra, pj.optimizer), _make(name, extra,
                                                          pt.optimizer)
    jparams = {l: {p: jnp.asarray(v) for p, v in ps.items()}
               for l, ps in values.items()}
    tparams = {l: {p: torch.from_numpy(v.copy()) for p, v in ps.items()}
               for l, ps in values.items()}
    jstate, tstate = jopt.init_state(jparams), topt.init_state(tparams)
    ids = {id(t) for ps in tparams.values() for t in ps.values()}
    for _ in range(5):
        grads = {l: {p: rng.randn(*s).astype(np.float32)
                     for p, s in ps.items()} for l, ps in SHAPES.items()}
        jparams, jstate = jopt.update(
            jparams, {l: {p: jnp.asarray(g) for p, g in ps.items()}
                      for l, ps in grads.items()}, jstate, META)
        tparams, tstate = topt.update(
            tparams, {l: {p: torch.from_numpy(g) for p, g in ps.items()}
                      for l, ps in grads.items()}, tstate, META)
    assert {id(t) for ps in tparams.values() for t in ps.values()} == ids
    assert int(tstate["t"]) == int(jstate["t"]) == 5
    assert sorted(tstate) == sorted(jstate)
    for l, ps in tparams.items():
        for p, t in ps.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[l][p]),
                                       err_msg=f"{l}.{p}", **TOL)
            assert sorted(tstate["slots"][l][p]) == sorted(
                jstate["slots"][l][p])
            for slot, s in tstate["slots"][l][p].items():
                np.testing.assert_allclose(
                    s.numpy(), np.asarray(jstate["slots"][l][p][slot]),
                    err_msg=f"{l}.{p}.{slot}", **TOL)
            if "avg" in jstate:
                np.testing.assert_allclose(
                    tstate["avg"][l][p].numpy(),
                    np.asarray(jstate["avg"][l][p]), err_msg=f"avg {l}.{p}",
                    **TOL)
    if "avg" in jstate:
        assert float(tstate["avg_n"]) == float(jstate["avg_n"]) == 5.0


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_a_skipped_step_changes_nothing(name):
    """``finite`` false (the mixed policy's overflow): parameters, slots,
    counter and average stay bit for bit."""
    opt = type(OPTIMIZERS[name](pt.optimizer))(
        **_ctor_args(OPTIMIZERS[name](pt.optimizer), pt.optimizer),
        model_average=pt.optimizer.ModelAverage())
    rng = np.random.RandomState(1)
    params = {"a": {"w": torch.from_numpy(rng.randn(4, 3).astype(
        np.float32))}}
    state = opt.init_state(params)
    grads = {"a": {"w": torch.from_numpy(rng.randn(4, 3).astype(
        np.float32))}}
    opt.update(params, grads, state)
    before = [t.clone() for t in [params["a"]["w"]]
              + opt.state_tensors(state)]
    opt.update(params, grads, state, finite=torch.tensor(False))
    after = [params["a"]["w"]] + opt.state_tensors(state)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    opt.update(params, grads, state, finite=torch.tensor(True))
    assert int(state["t"]) == 2 and float(state["avg_n"]) == 2.0


def test_legacy_names_and_settings_match_jax():
    for name in ("MomentumOptimizer", "AdamOptimizer", "AdamaxOptimizer",
                 "AdaGradOptimizer", "DecayedAdaGradOptimizer",
                 "AdaDeltaOptimizer", "RMSPropOptimizer",
                 "BaseSGDOptimizer", "BaseRegularization"):
        assert getattr(pt.optimizer, name).__name__ == getattr(
            pj.optimizer, name).__name__
    for mod in (pj.optimizer, pt.optimizer):
        opt = mod.settings(
            batch_size=16, learning_rate=0.3,
            learning_rate_schedule="exp", learning_rate_decay_a=0.5,
            learning_rate_decay_b=10.0,
            learning_method=mod.AdaGradOptimizer(),
            regularization=mod.L2Regularization(1e-4),
            model_average=mod.ModelAverage(0.5),
            gradient_clipping_threshold=2.0)
        assert type(opt).__name__ == "Adagrad"
        assert (opt.hp["learning_rate"], opt.l2, opt.l1,
                opt.global_clip) == (0.3, 1e-4, 0.0, 2.0)
        assert float(opt.lr_fn(10.0)) == pytest.approx(0.15)
        assert opt.model_average.average_window == 0.5
    assert type(pt.optimizer.settings(learning_rate=0.1)).__name__ == \
        "Momentum"
    # the port takes batch_size and keeps no option that nothing reads
    from paddle_tpu_torch.core import config as tconfig
    assert "legacy_batch_size" not in tconfig._options


def test_trainer_carries_the_average_and_captures_it(monkeypatch):
    """``SGD`` with a ModelAverage keeps ``avg`` in its optimizer state and
    lists every average tensor among the tensors a step updates (what a
    captured chunk restores after its warm-up step)."""
    pt.init(seed=0, device="cpu")
    layer = pt.layer
    x = layer.data("x", pt.data_type.dense_vector(4))
    y = layer.data("y", pt.data_type.integer_value(3))
    cost = layer.classification_cost(layer.fc(x, size=3, name="o"), y)
    topo = pt.Topology(cost)
    params = pt.parameters.create(topo, device="cpu")
    tr = pt.trainer.SGD(topo, params, pt.optimizer.RMSProp(
        learning_rate=0.1, momentum=0.5,
        model_average=pt.optimizer.ModelAverage()))
    listed = {id(t) for t in tr._state_tensors()}
    avg = tr._opt_state["avg"]
    assert {id(avg["o"]["w0"]), id(avg["o"]["b"]),
            id(tr._opt_state["avg_n"])} <= listed
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(5, 4).astype(np.float32),
            "y": rng.randint(0, 3, 5).astype(np.int32)}
    w0 = params.values["o"]["w0"].clone()
    tr._step(feed)
    tr._step(feed)
    w2 = params.values["o"]["w0"]
    assert float(tr._opt_state["avg_n"]) == 2.0
    # avg after two steps is the mean of the two updated weights, which
    # is not the start
    assert not torch.equal(avg["o"]["w0"], w0)
    assert not torch.equal(avg["o"]["w0"], w2)
