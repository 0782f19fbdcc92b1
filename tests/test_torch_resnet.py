"""ResNet training through the PyTorch port (``models/resnet.py`` with the
fused conv + BN path) against the JAX package on the CPU.

A file of its own, so that ``--dist loadfile`` puts its JAX compiles on a
worker of their own.  Weights cross through ``parameters.from_numpy``;
the JAX package runs its Pallas statistic kernels in interpret mode
(``fused_bn_impl="interpret"``, its "xla" conv + statistic oracle), the
port the same graph under ``fused_bn_impl="pallas"`` (on the CPU: the
plain versions).  Tolerances: 1e-5 for the small net's loss, gradients,
moving statistics and Momentum trajectory; ResNet-50's are stated (and
explained) in its test.
"""

import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core import config as jconfig
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.models import resnet as tresnet

TOL = dict(atol=1e-5, rtol=1e-5)
FEEDING = {"image": 0, "label": 1}


@pytest.fixture(autouse=True)
def _default_options():
    """Options persist across ``init`` calls in a process: put the ones
    these tests set back to their defaults in both packages."""
    yield
    for config in (jconfig, tconfig):
        config.set_option("fused_bn_impl", None)
        config.set_option("fuse_conv_bn", False)


def _init(fuse):
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0, fuse_conv_bn=fuse, fused_bn_impl="interpret")
    pt.init(seed=0, device="cpu", fuse_conv_bn=fuse, fused_bn_impl="pallas")


def _small(paddle, resnet):
    """16 px, widths 4 and 8: a stem conv_bn, an identity-free stride-1
    block and a stride-2 block with its projection."""
    layer = paddle.layer
    img = layer.data("image", paddle.data_type.dense_vector(3 * 16 * 16),
                     height=16, width=16)
    lbl = layer.data("label", paddle.data_type.integer_value(5))
    x = resnet.conv_bn(img, 4, 3, name="stem")
    x = resnet.bottleneck(x, 4, 1, "b1", shortcut_proj=True)
    x = resnet.bottleneck(x, 8, 2, "b2", shortcut_proj=True)
    x = layer.global_pool(x, pool_type="avg", name="gap")
    pred = layer.fc(x, size=5, name="pred")
    return layer.classification_cost(pred, lbl, name="cost")


def _values(jtopo, seed):
    """The JAX package's parameters with random vectors (BN scale and bias
    too), as numpy."""
    rng = np.random.default_rng(seed)
    return {l: {p: (np.asarray(v) if v.ndim != 1 else np.asarray(v)
                    + rng.standard_normal(v.shape).astype(np.float32) * 0.2)
                for p, v in ps.items()}
            for l, ps in pj.parameters.create(jtopo).values.items()}


def _rows(n, size, classes, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(size * size * 3).astype(np.float32),
             int(rng.randint(classes))) for _ in range(n)]


def _feed(rows, size):
    return {"image": np.stack([r[0] for r in rows]).reshape(
                len(rows), size, size, 3),
            "label": np.asarray([r[1] for r in rows], np.int32)}


def _jax_loss_and_grads(jtopo, values, feed):
    import jax

    def loss(v):
        outs, new = jtopo.forward(v, jtopo.create_state(), feed, train=True)
        return outs["cost"], new

    return jax.value_and_grad(loss, has_aux=True)(values)


FUSIONS = [False, True, "all"]


@pytest.mark.parametrize("fuse", FUSIONS)
def test_small_resnet_loss_grads_and_state_match_jax(fuse):
    """From one set of weights: the IR JSON, the first loss, every
    gradient and the new moving statistics of a small bottleneck net."""
    _init(fuse)
    jtopo = pj.Topology(_small(pj, jresnet), collect_evaluators=False)
    ttopo = pt.Topology(_small(pt, tresnet))
    assert ttopo.proto() == jtopo.proto()
    kinds = {s.kind for s in ttopo.specs}
    assert ("conv_bn" in kinds) == bool(fuse)
    values = _values(jtopo, 1)
    feed = _feed(_rows(4, 16, 5, 0), 16)
    (jc, jstate), jg = _jax_loss_and_grads(jtopo, values, feed)
    tr = pt.trainer.SGD(ttopo, pt.parameters.from_numpy(ttopo, values,
                                                        device="cpu"),
                        pt.optimizer.Momentum(learning_rate=0.1,
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


@pytest.mark.parametrize("fuse", [False, "all"])
def test_small_resnet_momentum_trajectory_matches_jax(fuse):
    """``SGD.train`` with Momentum(0.1, 0.9) through the DataFeeder (flat
    image rows reshaped to NHWC): the moving statistics after 2 steps,
    then 3 steps' losses (1e-5 relative), the trained parameters and the
    final moving statistics; then ``SGD.test`` on the moving statistics
    gives the JAX package's eval cost."""
    _init(fuse)
    jtopo = pj.Topology(_small(pj, jresnet), collect_evaluators=False)
    ttopo = pt.Topology(_small(pt, tresnet))
    values = _values(jtopo, 2)
    rows = _rows(4, 16, 5, 3)
    jparams = pj.parameters.create(jtopo)
    for key in jparams.keys():
        layer, _, pname = key.rpartition(".")
        jparams[key] = values[layer][pname]
    tparams = pt.parameters.from_numpy(ttopo, values, device="cpu")
    opt = dict(learning_rate=0.1, momentum=0.9)
    jtr = pj.trainer.SGD(jtopo, jparams, pj.optimizer.Momentum(**opt))
    ttr = pt.trainer.SGD(ttopo, tparams, pt.optimizer.Momentum(**opt))
    jl, tl = [], []
    for steps in (2, 1):
        reader = lambda: iter([rows] * steps)       # noqa: E731
        jtr.train(reader, feeding=FEEDING, event_handler=lambda e: (
            jl.append(e.cost) if isinstance(e, pj.event.EndIteration)
            else None))
        ttr.train(reader, feeding=FEEDING, event_handler=lambda e: (
            tl.append(e.cost) if isinstance(e, pt.event.EndIteration)
            else None))
        for l, ks in jtr.model_state.items():
            for k, v in ks.items():
                np.testing.assert_allclose(
                    ttr.model_state[l][k].numpy(), np.asarray(v),
                    err_msg=f"after {len(tl)} steps: {l}.{k}", **TOL)
    assert len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    for key in tparams.keys():
        np.testing.assert_allclose(tparams[key], jparams[key],
                                   err_msg=key, **TOL)
    test_rows = _rows(3, 16, 5, 4)
    jt = jtr.test(lambda: iter([test_rows]), feeding=FEEDING)
    tt = ttr.test(lambda: iter([test_rows]), feeding=FEEDING)
    np.testing.assert_allclose(tt.cost, jt.cost, rtol=1e-5)


def test_resnet50_first_step_matches_jax():
    """ResNet-50 at the JAX package's own test size (image 32, 10 classes,
    batch 4) under ``fuse_conv_bn="all"``: the conv_bn layers are 1x1 and
    3x3 (46 of them), and every layer of the training step matches.

    At this size res5's batch norms normalise over 4 rows (batch 4 at 1x1
    pixels), where E[x^2] - mean^2 cancels, so float32 rounding grows ~10x
    a res5 layer: the JAX package's own two routes, its kernels
    (interpret) and its "xla" oracles, give first losses 4e-4 apart and
    gradients 0.3 of max(1, max |g|) apart.  So each layer is held on its
    own, fed the JAX package's inputs and a random cotangent: its output,
    its moving statistics and the gradients of its parameters and inputs
    within 5e-5 of max(1, max |ref|) (the 4-row variance again: layers
    outside res5 agree within 1e-5).  End to end, the first loss lies
    within 1e-2 relative, as the two JAX routes and the port's own
    float32 convolutions (oneDNN on or off) spread it."""
    import jax
    import torch

    from paddle_tpu.core.registry import ApplyContext as JaxContext
    from paddle_tpu.core.registry import get_layer_def as jax_layer_def
    from paddle_tpu_torch.core.registry import ApplyContext, get_layer_def

    _init("all")
    jcost, _ = jresnet.build(depth=50, image_size=32, num_classes=10,
                             space_to_depth=True)
    tcost, _ = tresnet.build(depth=50, image_size=32, num_classes=10,
                             space_to_depth=True)
    jtopo = pj.Topology(jcost, collect_evaluators=False)
    ttopo = pt.Topology(tcost)
    assert ttopo.proto() == jtopo.proto()
    fused = [s for s in ttopo.specs if s.kind == "conv_bn"]
    assert {s.attrs.get("filter_size", 1) for s in fused} == {1, 3}
    assert len(fused) == 46       # 30 1x1 and 16 3x3
    values = _values(jtopo, 5)
    feed = _feed(_rows(4, 32, 10, 6), 32)
    names = [s.name for s in jtopo.specs if s.kind != "data"]
    state0 = jtopo.create_state()
    jouts, jstate = jtopo.forward(values, state0, feed, train=True,
                                  outputs=names)
    jouts = dict(jouts, **feed)
    params = pt.parameters.from_numpy(ttopo, values, device="cpu").values
    state = ttopo.create_state(device="cpu")
    rng = np.random.default_rng(7)

    def check(what, got, ref):
        ref = np.asarray(ref)
        err = (np.abs(got.detach().numpy() - ref).max()
               / max(1.0, np.abs(ref).max()))
        assert err <= 5e-5, f"{what}: {err}"

    for spec in ttopo.specs:
        if spec.kind == "data":
            continue
        # the layer's float inputs are differentiated (not the label)
        diff = [i for i, n in enumerate(spec.inputs)
                if np.asarray(jouts[n]).dtype == np.float32]
        jparams = values.get(spec.name, {})

        def jlayer(p, xs):
            ctx = JaxContext(train=True)
            ctx.state_in, ctx._cur_layer = state0, spec.name
            ins = [jouts[n] for n in spec.inputs]
            for i, x in zip(diff, xs):
                ins[i] = x
            return jax_layer_def(spec.kind).apply(spec.attrs, p, ins, ctx)

        jy, vjp = jax.vjp(jlayer, jparams,
                          [jouts[spec.inputs[i]] for i in diff])
        cot = rng.standard_normal(np.shape(jy)).astype(np.float32)
        jgp, jgx = vjp(cot)

        ctx = ApplyContext(train=True, device=torch.device("cpu"))
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
            check(f"{spec.name} {k}", v, jstate[spec.name][k])
        grads = torch.autograd.grad(
            ty, list(tp.values()) + [ins[i] for i in diff],
            torch.from_numpy(cot))
        for k, g in zip(tp, grads):
            check(f"{spec.name} d{k}", g, jgp[k])
        for g, r in zip(grads[len(tp):], jgx):
            check(f"{spec.name} d input", g, r)

    (jc, _), _ = _jax_loss_and_grads(jtopo, values, feed)
    tr = pt.trainer.SGD(ttopo, pt.parameters.from_numpy(ttopo, values,
                                                        device="cpu"),
                        pt.optimizer.Momentum(learning_rate=0.1,
                                              momentum=0.9))
    tc, tg = tr.forward_backward(feed)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-2)
    assert all(np.isfinite(g.numpy()).all()
               for ps in tg.values() for g in ps.values())
