"""ResNet training through the PyTorch port under the ``bf16`` and
``mixed`` precision policies against the JAX package on the CPU: a small
bottleneck net (an s2d stem with a relu batch norm, a stride-1 and a
stride-2 bottleneck) under each ``fuse_conv_bn`` setting, the operand
dtypes that reach kernels 7a to 9, the overflow skip under ``mixed``, and
``fp32`` bit-equal to no policy.  The kernels' plain versions and the
layers are in ``tests/test_torch_conv_bf16.py``.

Weights cross through ``parameters.from_numpy``; the JAX package runs its
Pallas kernels in interpret mode (``fused_bn_impl="interpret"``, and
``conv_bn_impl="interpret"`` on its conv_bn layers), the port the same
graph under ``fused_bn_impl="pallas"`` (on the CPU: the plain versions).

Tolerances, from readings on the CPU: the first-step gradients as
``tests/test_torch_precision.py`` holds the LM's, 2^-7 * max(1, max |g|)
elementwise and each leaf within 2^-4 of its own norm
(``GRAD_LEAF_RTOL``), the first loss within 2e-3 relative (``TRAJ_RTOL``)
and the moving statistics within 2^-7 of max(1, max |ref|); a 3-step
Momentum trajectory against the JAX package's jitted trainer within
twice the spread of the JAX package's own two routes (its kernels
interpreted against its "xla" oracles), step by step: at batch 4 and lr
0.1 the bf16 losses drift apart fast (the JAX routes: 3.6e-4, 1.3e-2,
1.6e-2 relative over 3 steps with every fusion on; the port against its
interpreted kernels: 3.3e-5, 5.3e-4, 2.6e-3).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core import config as jconfig
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.layers import conv as jconv
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops import conv_bn as jcb
from paddle_tpu.ops import fused_bn as jbn
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops import conv_bn as tcb
from paddle_tpu_torch.ops import fused_bn as tbn

GRAD_TOL = 2.0 ** -7
GRAD_LEAF_RTOL = 2.0 ** -4
TRAJ_RTOL = 2e-3
FEEDING = {"image": 0, "label": 1}


@pytest.fixture(autouse=True)
def _restore_options():
    """Every test leaves both packages' options (the policy and the conv
    slice's among them) as it found them."""
    topts, jopts = dict(tconfig._options), dict(jconfig._options)
    yield
    for mod, saved in ((tconfig, topts), (jconfig, jopts)):
        mod._options.clear()
        mod._options.update(saved)
    jconfig._policy_cache = None


# ------------------------------------------------------- the small net
def _small(paddle, resnet):
    """16 px, widths 4 and 8: an s2d stem (a conv and a relu batch norm,
    kernels 7a/7b under "pallas"), a stride-1 block and a stride-2 block
    with its projection."""
    layer = paddle.layer
    img = layer.data("image", paddle.data_type.dense_vector(3 * 16 * 16),
                     height=16, width=16)
    lbl = layer.data("label", paddle.data_type.integer_value(5))
    x = resnet.conv_bn(img, 4, 7, stride=2, padding=3, name="stem",
                       space_to_depth=True)
    x = resnet.bottleneck(x, 4, 1, "b1", shortcut_proj=True)
    x = resnet.bottleneck(x, 8, 2, "b2", shortcut_proj=True)
    x = layer.global_pool(x, pool_type="avg", name="gap")
    pred = layer.fc(x, size=5, name="pred")
    return layer.classification_cost(pred, lbl, name="cost")


def _init(fuse, precision):
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0, precision=precision, fuse_conv_bn=fuse,
            fused_bn_impl="interpret")
    pt.init(seed=0, device="cpu", precision=precision, fuse_conv_bn=fuse,
            fused_bn_impl="pallas")
    jtopo = pj.Topology(_small(pj, jresnet), collect_evaluators=False)
    ttopo = pt.Topology(_small(pt, tresnet))
    assert ttopo.proto() == jtopo.proto()
    for spec in jtopo.specs:
        if spec.kind == "conv_bn":
            # the JAX package's conv + statistic kernels, interpreted
            # (it picks "xla" off the TPU)
            spec.attrs["conv_bn_impl"] = "interpret"
    return jtopo, ttopo


def _values(jtopo, seed):
    rng = np.random.default_rng(seed)
    return {l: {p: (np.asarray(v) if v.ndim != 1 else np.asarray(v)
                    + rng.standard_normal(v.shape).astype(np.float32) * 0.2)
                for p, v in ps.items()}
            for l, ps in pj.parameters.create(jtopo).values.items()}


def _feed(n, seed):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(n, 16, 16, 3).astype(np.float32),
            "label": rng.randint(0, 5, n).astype(np.int32)}


def _rows(feed):
    return [(img.reshape(-1), int(lbl))
            for img, lbl in zip(feed["image"], feed["label"])]


FUSIONS = [False, True, "all"]


@pytest.mark.parametrize("precision", ["bf16", "mixed", "fp16"])
@pytest.mark.parametrize("fuse", FUSIONS)
def test_small_resnet_first_step_matches_jax(fuse, precision, monkeypatch):
    """From one set of weights under ``precision``: the first loss (2e-3
    relative), every gradient (float32 in both; the port's unscaled
    through the trainer's loss scale under ``mixed``) within 2^-7 of
    max(1, max |g|) and each leaf within 2^-4 of its own norm, and the new
    moving statistics, float32, within 2^-7 of max(1, max |ref|).  Under
    ``fp16`` the JAX package's batch-norm folds (``ops/fused_bn.py``'s and
    ``layers/conv.py``'s, the conv_bn path's) are evaluated as its jitted
    step evaluates them (``jax.jit``: one rounding of x * w + b, as its
    interpreted 7b kernel's mask and the port's folds take it; eagerly it
    rounds twice, and the gradients of the stem read 1.2x to 2.6x the
    limit from that alone); at bf16 the two evaluations are the same."""
    import jax

    if precision == "fp16":
        monkeypatch.setattr(jbn, "_fold", jax.jit(jbn._fold))
        monkeypatch.setattr(jconv, "_bn_fold",
                            jax.jit(jconv._bn_fold, static_argnums=5))

    jtopo, ttopo = _init(fuse, precision)
    values = _values(jtopo, 1)
    feed = _feed(4, 0)

    def loss(v):
        outs, new = jtopo.forward(v, jtopo.create_state(), feed, train=True)
        return outs["cost"], new

    # jitted: one compile, the JAX package's step as its trainer runs it
    (jc, jstate), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        values)
    tr = pt.trainer.SGD(ttopo, pt.parameters.from_numpy(ttopo, values,
                                                        device="cpu"),
                        pt.optimizer.Momentum(learning_rate=0.1,
                                              momentum=0.9))
    policy = tr._sync_precision_policy()
    scale = (tr._opt_state["loss_scale"]["scale"]
             if policy.loss_scaling else None)
    tc, tg = tr.forward_backward(feed, scale=scale)
    assert abs(float(tc) - float(jc)) <= TRAJ_RTOL * abs(float(jc))
    assert sorted(tg) == sorted(jg)
    for l, ps in tg.items():
        for n, g in ps.items():
            want = np.asarray(jg[l][n])
            assert g.dtype == torch.float32
            err = np.abs(g.numpy() - want).max()
            assert err <= GRAD_TOL * max(1.0, np.abs(want).max()), (l, n,
                                                                    err)
            dist = np.linalg.norm(g.numpy().astype(np.float64) - want)
            assert dist <= GRAD_LEAF_RTOL * np.linalg.norm(want), (
                l, n, dist / np.linalg.norm(want))
    assert sorted(tr.model_state) == sorted(jstate)
    for l, ks in jstate.items():
        for k, v in ks.items():
            got = tr.model_state[l][k]
            assert got.dtype == torch.float32
            err = np.abs(got.numpy() - np.asarray(v)).max()
            assert err <= GRAD_TOL * max(1.0, np.abs(v).max()), (l, k, err)


def _jax_trainer(jtopo, values, impl):
    """The JAX package's trainer from ``values`` with its statistic and
    conv + statistic kernels interpreted (``impl="interpret"``) or on its
    "xla" oracles."""
    jconfig.set_option("fused_bn_impl", impl)
    for spec in jtopo.specs:
        if spec.kind == "conv_bn":
            spec.attrs["conv_bn_impl"] = impl
    jparams = pj.parameters.create(jtopo)
    for key in jparams.keys():
        layer, _, pname = key.rpartition(".")
        jparams[key] = values[layer][pname]
    return pj.trainer.SGD(jtopo, jparams, pj.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9))


def _train3(paddle, trainer, rows):
    losses = []
    trainer.train(lambda: iter([rows] * 3), feeding=FEEDING,
                  event_handler=lambda e: losses.append(e.cost)
                  if isinstance(e, paddle.event.EndIteration) else None)
    return np.asarray(losses)


@pytest.mark.parametrize("fuse", [False, "all"])
def test_small_resnet_bf16_momentum_trajectory_matches_jax(fuse):
    """``SGD.train`` with Momentum(0.1, 0.9) under ``bf16`` through the
    DataFeeder: 3 steps' losses against the JAX package's trainer with its
    kernels interpreted, each within twice the JAX package's own spread
    at that step (the same trainer on its "xla" oracles); masters,
    Momentum slots and moving statistics float32 throughout, the moving
    statistics within 2^-7 of max(1, max |ref|); then ``SGD.test`` (the
    eval branch on the moving statistics) within 2e-3 of the JAX package's
    cost."""
    jtopo, ttopo = _init(fuse, "bf16")
    values = _values(jtopo, 2)
    rows = _rows(_feed(4, 3))
    jl_xla = _train3(pj, _jax_trainer(jtopo, values, "xla"), rows)
    jtr = _jax_trainer(jtopo, values, "interpret")
    jl = _train3(pj, jtr, rows)
    ttr = pt.trainer.SGD(ttopo, pt.parameters.from_numpy(
        ttopo, values, device="cpu"), pt.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9))
    tl = _train3(pt, ttr, rows)
    assert len(tl) == 3 and np.isfinite(tl).all()
    spread = np.abs(jl_xla / jl - 1)
    assert (np.abs(tl / jl - 1) <= 2 * spread).all(), (tl, jl, spread)
    for ps in ttr._trainable.values():
        assert all(v.dtype == torch.float32 for v in ps.values())
    for ps in ttr._opt_state["slots"].values():
        for ss in ps.values():
            assert all(s.dtype == torch.float32 for s in ss.values())
    for l, ks in jtr.model_state.items():
        for k, v in ks.items():
            got = ttr.model_state[l][k]
            assert got.dtype == torch.float32
            err = np.abs(got.numpy() - np.asarray(v)).max()
            assert err <= GRAD_TOL * max(1.0, np.abs(v).max()), (l, k, err)
    test_rows = _rows(_feed(3, 4))
    jt = jtr.test(lambda: iter([test_rows]), feeding=FEEDING)
    tt = ttr.test(lambda: iter([test_rows]), feeding=FEEDING)
    assert abs(tt.cost - jt.cost) <= TRAJ_RTOL * abs(jt.cost)


@pytest.mark.parametrize("fuse", FUSIONS)
def test_small_resnet_mixed_overflow_keeps_model_state(fuse):
    """Under ``mixed``, a batch with an inf pixel skips the step: the
    parameters, the Momentum slots and the moving statistics of every
    batch norm bit for bit as before it, the loss scale halved; the next
    clean step moves them again."""
    _, ttopo = _init(fuse, "mixed")
    tr = pt.trainer.SGD(ttopo, pt.parameters.create(ttopo, device="cpu"),
                        pt.optimizer.Momentum(learning_rate=0.1,
                                              momentum=0.9))
    feed = _feed(4, 5)
    tr._step(feed)                             # slots and state live
    before = {(l, p): v.detach().clone()
              for l, ps in tr._trainable.items() for p, v in ps.items()}
    slots = {(l, p, k): s.clone()
             for l, ps in tr._opt_state["slots"].items()
             for p, ss in ps.items() for k, s in ss.items()}
    state = {(l, k): v.clone() for l, ks in tr.model_state.items()
             for k, v in ks.items()}
    assert state and all(torch.isfinite(v).all() for v in state.values())
    scale = float(tr._opt_state["loss_scale"]["scale"])
    bad = dict(feed, image=feed["image"].copy())
    bad["image"][1, 3, 3, 0] = np.inf
    tr._step(bad)
    for (l, p), v in before.items():
        assert torch.equal(tr._trainable[l][p], v), (l, p)
    for (l, p, k), v in slots.items():
        assert torch.equal(tr._opt_state["slots"][l][p][k], v), (l, p, k)
    for (l, k), v in state.items():
        assert torch.equal(tr.model_state[l][k], v), (l, k)
    ls = tr._opt_state["loss_scale"]
    assert float(ls["scale"]) == scale * 0.5 and int(ls["skipped"]) == 1
    tr._step(feed)
    assert not all(torch.equal(tr.model_state[l][k], v)
                   for (l, k), v in state.items())


@pytest.mark.parametrize("fuse", FUSIONS)
def test_small_resnet_fp32_policy_bit_equal_to_no_policy(fuse):
    """``fp32`` is no policy at all on the conv slice: the same 2 Momentum
    steps with and without it give the same losses, parameters and moving
    statistics bit for bit."""
    runs = []
    for kw in ({}, {"precision": "fp32"}):
        reset_port_names()
        pt.init(seed=0, device="cpu", fuse_conv_bn=fuse,
                fused_bn_impl="pallas", **kw)
        topo = pt.Topology(_small(pt, tresnet))
        tr = pt.trainer.SGD(topo, pt.parameters.create(topo, device="cpu"),
                            pt.optimizer.Momentum(learning_rate=0.1,
                                                  momentum=0.9))
        losses = [float(tr._step(_feed(4, 6))) for _ in range(2)]
        runs.append((losses, tr))
        tconfig._options.pop("precision", None)
    (l0, a), (l1, b) = runs
    assert l0 == l1
    for l, ps in a._trainable.items():
        for p, v in ps.items():
            assert torch.equal(v, b._trainable[l][p]), (l, p)
    for l, ks in a.model_state.items():
        for k, v in ks.items():
            assert torch.equal(v, b.model_state[l][k]), (l, k)


# ------------------------------------------------ the kernels' instances
@pytest.mark.parametrize("precision", ["bf16", "mixed", "fp16"])
def test_conv_kernel_dtypes_are_the_kernel_instances(precision,
                                                     monkeypatch):
    """Which operand dtypes reach kernels 7a, 7b, 8 and 9 in a step of the
    small net under ``precision`` with every fusion on: a recording hook
    on the JAX package's kernel calls (its kernels interpreted) and on the
    port's plain kernel versions, forward and backward.  Both find exactly
    the bf16 instances (float16 ones under ``fp16``): x bf16 for 7a; dout
    and x bf16 with float32 per-channel w for 7b; x and w bf16 for 8 and
    9.  The kernels have an instance for float32, bf16 and float16."""
    import jax

    seen = {"jax": set(), "port": set()}

    def recorder(pkg, kind, fn, n):
        def rec(*a, **kw):
            seen[pkg].add((kind,) + tuple(
                str(x.dtype).removeprefix("torch.") for x in a[:n]))
            return fn(*a, **kw)
        return rec

    for pkg, mod, kind, name, n in (
            ("jax", jbn, "7a", "_fwd_stats", 1),
            ("jax", jbn, "7b", "_bwd_stats", 3),
            ("jax", jcb, "8", "matmul_stats_fwd", 2),
            ("jax", jcb, "9", "conv3x3_stats_fwd", 2),
            ("port", tbn, "7a", "_fwd_stats_ref", 1),
            ("port", tbn, "7b", "_bwd_stats_ref", 3),
            ("port", tcb, "8", "_matmul_stats_ref", 2),
            ("port", tcb, "9", "_conv3x3_stats_ref", 2)):
        monkeypatch.setattr(mod, name, recorder(pkg, kind,
                                                getattr(mod, name), n))
    jtopo, ttopo = _init("all", precision)
    values = _values(jtopo, 3)
    feed = _feed(2, 7)
    # traced, not run: the dtypes reach the kernel calls at trace time
    jax.eval_shape(jax.grad(lambda v: jtopo.forward(
        v, jtopo.create_state(), feed, train=True)[0]["cost"]), values)
    pt.trainer.SGD(ttopo, pt.parameters.from_numpy(ttopo, values,
                                                   device="cpu"),
                   pt.optimizer.Momentum()).forward_backward(feed)
    h = "float16" if precision == "fp16" else "bfloat16"
    want = {("7a", h), ("7b", h, h, "float32"), ("8", h, h), ("9", h, h)}
    assert seen["jax"] == want, sorted(seen["jax"])
    assert seen["port"] == want, sorted(seen["port"])
    assert set(tbn.KERNEL_DTYPES) == set(tcb.KERNEL_DTYPES) == {
        torch.float32, torch.bfloat16, torch.float16}
