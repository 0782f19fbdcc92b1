"""The image models of the PyTorch port (``models/vgg.py``,
``alexnet.py``, ``googlenet.py``) against the JAX package on the CPU, at
the JAX package's own test sizes (``tests/test_models.py``: VGG-11 at 32
px, AlexNet at 67, GoogLeNet at 64), 10 classes, batch 2.

Weights cross through ``parameters.from_numpy`` (seeded numpy values,
batch-norm scales and biases random too, so they matter); the IR JSON is
byte-equal; the training step's loss and every gradient are held within
1e-5 absolute and relative (VGG's layer by layer, ``_held_by_layer`` says
why).  Torch cannot replay JAX's random streams, so both
packages' dropouts take one mask: ``jax.random.bernoulli`` and
``torch.rand`` are replaced for the test by the same seeded uniform draw
of each shape (both dropouts keep where u < 1 - rate).  VGG also runs
under ``fused_bn_impl="pallas"``: the port's plain statistics (the
kernels' yardstick on the CPU) against the JAX package's Pallas kernels in
interpret mode, the moving statistics too, and 3 Momentum steps through
``SGD.train``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core import config as jconfig
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.models import alexnet as jalexnet
from paddle_tpu.models import googlenet as jgooglenet
from paddle_tpu.models import vgg as jvgg
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.models import alexnet as talexnet
from paddle_tpu_torch.models import googlenet as tgooglenet
from paddle_tpu_torch.models import vgg as tvgg

TOL = dict(atol=1e-5, rtol=1e-5)
CLASSES = 10
MODELS = {
    "vgg11": (jvgg, tvgg, dict(depth=11, image_size=32, fc_dim=64), 32),
    "alexnet": (jalexnet, talexnet, dict(image_size=67), 67),
    "googlenet": (jgooglenet, tgooglenet, dict(image_size=64), 64),
}


@pytest.fixture(autouse=True)
def _default_options():
    yield
    for config in (jconfig, tconfig):
        config.set_option("fused_bn_impl", None)


def _uniform(shape):
    """The one seeded draw both packages' dropouts take for ``shape``."""
    return np.random.RandomState(int(np.prod(shape)) % 2 ** 31).rand(
        *shape).astype(np.float32)


@pytest.fixture
def one_dropout_mask(monkeypatch):
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: (
        jnp.asarray(_uniform(tuple(shape)) < p)))

    def rand(*size, generator=None, device=None, **kw):
        shape = size[0] if len(size) == 1 and not isinstance(
            size[0], int) else size
        return torch.from_numpy(_uniform(tuple(shape))).to(device)

    monkeypatch.setattr(torch, "rand", rand)


def _values(topo, seed=3):
    """A seeded numpy parameter tree: He-normal conv kernels, N(0,
    1/fan_in) fc weights, batch-norm scales 1 + N(0, 0.2^2) and biases N(0,
    0.2^2), so every parameter matters."""
    rng = np.random.default_rng(seed)
    vals = {}
    for spec in topo.specs:
        for p in topo.param_specs[spec.name]:
            if p.is_state:
                continue
            shape = tuple(p.shape)
            std = ((2.0 / np.prod(shape[:-1])) ** 0.5 if len(shape) == 4
                   else shape[0] ** -0.5 if len(shape) == 2 else 0.2)
            v = rng.standard_normal(shape, dtype=np.float32) * std
            vals.setdefault(spec.name, {})[p.name] = v + (
                p.name == "scale")
    return vals


def _build(name, impl=None):
    jmod, tmod, kw, _ = MODELS[name]
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0, fused_bn_impl="interpret" if impl else None)
    pt.init(seed=0, device="cpu", fused_bn_impl=impl)
    jcost, _ = jmod.build(num_classes=CLASSES, **kw)
    tcost, _ = tmod.build(num_classes=CLASSES, **kw)
    jtopo = pj.Topology(jcost, collect_evaluators=False)
    ttopo = pt.Topology(tcost)
    assert ttopo.proto() == jtopo.proto()
    return jtopo, ttopo, _values(ttopo)


def _rows(n, size, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(size * size * 3).astype(np.float32),
             int(rng.randint(CLASSES))) for _ in range(n)]


def _feed(rows, size):
    return {"image": np.stack([r[0] for r in rows]).reshape(
        len(rows), size, size, 3),
            "label": np.asarray([r[1] for r in rows], np.int32)}


def _jax_step(jtopo, values, feed):
    def loss(v):
        outs, new = jtopo.forward(v, jtopo.create_state(), feed, train=True,
                                  rng=jax.random.PRNGKey(0))
        return outs["cost"], new

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(values)


def _held(jtopo, ttopo, values, feed):
    (jc, jstate), jg = _jax_step(jtopo, values, feed)
    tr = pt.trainer.SGD(ttopo, pt.parameters.from_numpy(ttopo, values,
                                                        device="cpu"),
                        pt.optimizer.Momentum(learning_rate=0.01,
                                              momentum=0.9))
    tc, tg = tr.forward_backward(feed)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    assert sorted(tg) == sorted(jg)
    for l, ps in tg.items():
        for n, g in ps.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[l][n]),
                                       err_msg=f"{l}.{n}", **TOL)
    assert sorted(tr.model_state) == sorted(jstate)
    for l, ks in jstate.items():
        for k, v in ks.items():
            np.testing.assert_allclose(tr.model_state[l][k].numpy(),
                                       np.asarray(v), err_msg=f"{l}.{k}",
                                       **TOL)


def _held_by_layer(jtopo, ttopo, values, feed):
    """VGG's first training step, each layer on the JAX package's own
    inputs: its output, moving statistics and, under one seeded cotangent,
    the gradients of its parameters and float inputs within TOL; then the
    loss and the moving statistics end to end.

    End to end, every relu batch norm's fold that lies within a float32
    rounding of 0 can be kept by one package and dropped by the other
    (the statistics are sums in another order); the gradient there then
    differs by its whole cotangent, and the difference flows back through
    every layer below (read: 8e-3 of max(1, max |g|) at conv1_1 from one
    such output at batch 2, a different count run to run).  So the
    gradients are held layer by layer, where such outputs (at most 1e-4 of
    a layer's, each within TOL of 0) take a zero cotangent.  A layer's
    gradient under a unit cotangent sums thousands of terms (conv1_1's
    weights: entries of 30 and more), so each tensor is held within 1e-5
    of max(1, max |ref|), as ``tests/test_torch_resnet.py`` holds
    ResNet-50 layer by layer."""
    from paddle_tpu.core.registry import ApplyContext as JaxContext
    from paddle_tpu.core.registry import get_layer_def as jax_layer_def
    from paddle_tpu_torch.core.registry import ApplyContext, get_layer_def

    names = [s.name for s in jtopo.specs if s.kind != "data"]
    state0 = jtopo.create_state()
    jouts, jstate = jax.jit(lambda v: jtopo.forward(
        v, state0, feed, train=True, outputs=names,
        rng=jax.random.PRNGKey(0)))(values)
    jouts = dict(jouts, **feed)
    params = pt.parameters.from_numpy(ttopo, values, device="cpu").values
    state = ttopo.create_state(device="cpu")
    rng = np.random.default_rng(7)

    def check(what, got, ref):
        ref = np.asarray(ref)
        err = np.abs(got.detach().numpy() - ref).max() / max(
            1.0, np.abs(ref).max())
        assert err <= 1e-5, f"{what}: {err}"

    for spec in ttopo.specs:
        if spec.kind == "data":
            continue
        diff = [i for i, n in enumerate(spec.inputs)
                if np.asarray(jouts[n]).dtype == np.float32]

        def jlayer(p, xs, spec=spec, diff=diff):
            ctx = JaxContext(train=True, rng=jax.random.PRNGKey(0))
            ctx.state_in, ctx._cur_layer = state0, spec.name
            ins = [jouts[n] for n in spec.inputs]
            for i, x in zip(diff, xs):
                ins[i] = x
            return jax_layer_def(spec.kind).apply(spec.attrs, p, ins, ctx)

        # the layer jitted: its forward and backward one compile each
        jy, vjp = jax.vjp(jax.jit(jlayer), values.get(spec.name, {}),
                          [jouts[spec.inputs[i]] for i in diff])
        ctx = ApplyContext(train=True, device=torch.device("cpu"),
                           generator=torch.Generator())
        ctx.state_in, ctx._cur_layer = state, spec.name
        ins = [torch.from_numpy(np.array(jouts[n])) for n in spec.inputs]
        for i in diff:
            ins[i].requires_grad_(True)
        if spec.kind == "classification_cost":
            ins[1] = ins[1].long()
        tp = {k: v.detach().requires_grad_(True)
              for k, v in params.get(spec.name, {}).items()}
        ty = get_layer_def(spec.kind).apply(spec.attrs, tp, ins, ctx)
        check(f"{spec.name} output", ty, jy)
        for k, v in ctx.state_out.get(spec.name, {}).items():
            check(f"{spec.name}.{k}", v, jstate[spec.name][k])
        cot = rng.standard_normal(np.shape(jy)).astype(np.float32)
        flip = (ty.detach().numpy() > 0) != (np.asarray(jy) > 0)
        assert flip.sum() <= max(1, 1e-4 * flip.size), spec.name
        cot[flip] = 0.0
        jgp, jgx = vjp(jnp.asarray(cot))
        grads = torch.autograd.grad(
            ty, list(tp.values()) + [ins[i] for i in diff],
            torch.from_numpy(cot))
        for k, g in zip(tp, grads):
            check(f"{spec.name} d{k}", g, jgp[k])
        for g, r in zip(grads[len(tp):], jgx):
            check(f"{spec.name} dinput", g, r)
    (jc, jstate), _ = _jax_step(jtopo, values, feed)
    tr = pt.trainer.SGD(ttopo, pt.parameters.from_numpy(ttopo, values,
                                                        device="cpu"),
                        pt.optimizer.Momentum(learning_rate=0.01,
                                              momentum=0.9))
    tc, _ = tr.forward_backward(feed)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    for l, ks in jstate.items():
        for k, v in ks.items():
            np.testing.assert_allclose(tr.model_state[l][k].numpy(),
                                       np.asarray(v), err_msg=f"{l}.{k}",
                                       **TOL)


@pytest.mark.parametrize("name", ["alexnet", "googlenet"])
def test_image_model_loss_and_grads_match_jax(name, one_dropout_mask):
    """No batch norm: the loss and every gradient end to end."""
    jtopo, ttopo, values = _build(name)
    size = MODELS[name][3]
    _held(jtopo, ttopo, values, _feed(_rows(2, size, 1), size))


@pytest.mark.parametrize("impl", [None, "pallas"], ids=["xla", "pallas"])
def test_vgg_matches_jax_layer_by_layer(impl, one_dropout_mask):
    """VGG-11 with its eight relu batch norms on the plain statistics,
    and under ``fused_bn_impl="pallas"`` on the statistic passes' plain
    versions against the JAX package's kernels in interpret mode."""
    jtopo, ttopo, values = _build("vgg11", impl=impl)
    assert sum(s.kind == "batch_norm" for s in ttopo.specs) == 8
    _held_by_layer(jtopo, ttopo, values, _feed(_rows(2, 32, 1), 32))


def test_vgg_kernel_route_trains_as_the_jax_package(one_dropout_mask):
    """3 Momentum(0.001, 0.9) steps of ``SGD.train`` under
    ``fused_bn_impl="pallas"`` through the DataFeeder (flat image rows
    reshaped to NHWC), the JAX package's kernels in interpret mode: the
    losses within 1e-4 relative.  The first step's gradients differ where
    a relu batch norm's fold rounds to the other side of 0
    (``_held_by_layer``), and the later losses carry it: read 1.3e-6,
    1.1e-6 and 2.6e-5 (the JAX package's own two routes, which sum in one
    order, 0, 3.1e-7 and 7.0e-7)."""
    jtopo, ttopo, values = _build("vgg11", impl="pallas")
    rows = _rows(2, 32, 2)
    jparams = pj.parameters.Parameters(
        {l: {p: jnp.asarray(v) for p, v in ps.items()}
         for l, ps in values.items()},
        {l: {p: {"learning_rate": 1.0, "is_static": False, "l1": 0.0,
                 "l2": 0.0, "clip": 0.0, "sparse_update": False}
             for p in ps} for l, ps in values.items()})
    opt = dict(learning_rate=0.001, momentum=0.9)
    jtr = pj.trainer.SGD(jtopo, jparams, pj.optimizer.Momentum(**opt))
    ttr = pt.trainer.SGD(ttopo, pt.parameters.from_numpy(
        ttopo, values, device="cpu"), pt.optimizer.Momentum(**opt))
    losses = {}
    for tag, tr, event in (("jax", jtr, pj.event), ("port", ttr, pt.event)):
        losses[tag] = []
        tr.train(lambda: iter([rows] * 3), feeding={"image": 0, "label": 1},
                 event_handler=lambda e, out=losses[tag], ev=event: (
                     out.append(e.cost) if isinstance(e, ev.EndIteration)
                     else None))
    assert len(losses["port"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4,
                               atol=0)
