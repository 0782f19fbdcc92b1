"""The conv slice of the PyTorch port (paddle_tpu_torch: the batch-norm
statistic passes of ops/fused_bn.py, the conv + statistic products of
ops/conv_bn.py, and the image layers of layers/conv.py) against the JAX
package on the CPU.

Inputs come from a numpy seed and go through both packages; weights and
running state cross through ``parameters.from_numpy`` and
``Topology.create_state(values=)``.  Tolerance: 1e-5 (absolute and
relative) for values, gradients and the moving statistics (float32 sums
taken in another order).  On the CPU the port's statistic and product
functions take their plain versions; the JAX package's Pallas kernels run
in interpret mode, and its "xla" oracles beside them.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core import config as jconfig
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.ops import conv_bn as jcb
from paddle_tpu.ops import fused_bn as jbn
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.ops import conv_bn as tcb
from paddle_tpu_torch.ops import fused_bn as tbn

TOL = dict(atol=1e-5, rtol=1e-5)
EPS = 1e-5


@pytest.fixture(autouse=True)
def _default_options():
    """Options persist across ``init`` calls in a process: put the ones
    these tests set back to their defaults in both packages."""
    yield
    for config in (jconfig, tconfig):
        config.set_option("fused_bn_impl", None)
        config.set_option("fuse_conv_bn", False)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _close(t, j, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               err_msg=msg, **TOL)


# ------------------------------------------------------- statistic passes
# rank 4 and rank 2, rows that no block size divides (133, as
# tests/test_fused_bn.py), and widths past one 32-channel block
STAT_SHAPES = [(4, 5, 5, 3), (133, 1, 1, 6), (133, 6), (37, 40),
               (2, 3, 7, 33)]


@pytest.mark.parametrize("shape", STAT_SHAPES)
def test_fwd_stats_match_jax_kernel(shape):
    """(mean, E[x^2]) of the port's plain statistics against the JAX
    package's Pallas kernel in interpret mode and its "xla" formulation."""
    import jax.numpy as jnp

    x = np.random.default_rng(len(shape) + shape[0]).standard_normal(
        shape).astype(np.float32) * 2 + 0.3
    jm, jm2 = jbn._fwd_stats(jnp.asarray(x), True)
    tm, tm2 = tbn._fwd_stats(_t(x), "pallas")
    _close(tm, jm)
    _close(tm2, jm2)
    red = tuple(range(x.ndim - 1))
    _close(tm, jnp.mean(x, axis=red))
    _close(tm2, jnp.mean(jnp.square(x), axis=red))


@pytest.mark.parametrize("act", ["linear", "relu"])
@pytest.mark.parametrize("shape", STAT_SHAPES)
def test_bwd_stats_match_jax_kernel(shape, act):
    """(sum dy, sum dy * xhat) of the port's plain pass against the JAX
    package's Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    rng = np.random.default_rng(shape[-1] + len(shape))
    c = shape[-1]
    x, dout = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(2))
    w, b, mean = (rng.standard_normal(c).astype(np.float32)
                  for _ in range(3))
    inv = (rng.random(c) + 0.5).astype(np.float32)
    j = jbn._bwd_stats(*(jnp.asarray(a) for a in (dout, x, w, b, mean,
                                                   inv)), act, True)
    t = tbn._bwd_stats(*(_t(a) for a in (dout, x, w, b, mean, inv)), act,
                       "pallas")
    _close(t[0], j[0])
    _close(t[1], j[1])


def test_bwd_stats_relu_mask_rounds_as_the_forward():
    """Where the fold x * w + b is exactly 0 (b = -fl(x * w) on chosen
    elements), relu drops the element in the backward as in the forward:
    the fold is two roundings, never one fused multiply-add."""
    rng = np.random.default_rng(5)
    p, c = 64, 8
    x = rng.standard_normal((p, c)).astype(np.float32)
    w = rng.standard_normal(c).astype(np.float32)
    rows = rng.integers(0, p, c)
    b = -(x[rows, np.arange(c)] * w).astype(np.float32)
    fold = (x * w).astype(np.float32) + b
    assert (fold[rows, np.arange(c)] == 0).all()
    dout = rng.standard_normal((p, c)).astype(np.float32)
    mean = np.zeros(c, np.float32)
    inv = np.ones(c, np.float32)
    sdy, sdyx = tbn.bwd_stats(*(_t(a) for a in (dout, x, w, b, mean, inv)),
                              True)
    keep = fold > 0
    np.testing.assert_allclose(sdy.numpy(), (dout * keep).sum(0),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sdyx.numpy(), (dout * keep * x).sum(0),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("jax_impl", ["interpret", "xla"])
@pytest.mark.parametrize("act", ["linear", "relu"])
@pytest.mark.parametrize("shape", [(4, 5, 5, 3), (133, 6), (3, 4, 5)])
def test_bn_act_train_matches_jax(shape, act, jax_impl):
    """bn_act_train's (y, mean, var) and the gradients of x, scale and bias
    under cotangents on all three outputs (the mean and var cotangents
    included), against the JAX package's custom vjp.  Rank 3 takes the
    plain route in both packages."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(len(shape))
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.3
    scale = (rng.random(c) + 0.5).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.2).astype(np.float32)
    cy = rng.standard_normal(shape).astype(np.float32)
    cm, cv = (rng.standard_normal(c).astype(np.float32) for _ in range(2))

    def jloss(*a):
        y, m, v = jbn.bn_act_train(*a, EPS, act, jax_impl)
        return (y * cy).sum() + (m * cm).sum() + (v * cv).sum(), (y, m, v)

    (_, jouts), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(a) for a in (x, scale, bias)))
    leaves = [_t(a, True) for a in (x, scale, bias)]
    y, m, v = tbn.bn_act_train(*leaves, EPS, act, "pallas")
    loss = (y * _t(cy)).sum() + (m * _t(cm)).sum() + (v * _t(cv)).sum()
    tgrads = torch.autograd.grad(loss, leaves)
    for t, j in zip((y, m, v) + tgrads, tuple(jouts) + tuple(jgrads)):
        _close(t, j)


def test_stat_wrappers_refuse_what_the_kernels_cannot_take():
    """The kernel route raises on a CPU tensor; the launch wrappers check
    dtype, shape and contiguity before anything is built; nothing was
    launched."""
    x = _t(np.ones((6, 4)))
    v = _t(np.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        tbn.fwd_stats(x, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tbn.bn_act_train(x, v, v, EPS, "relu", "cuda")
    with pytest.raises(TypeError, match="float32"):
        tbn.bn_fwd_stats_cuda(x.double())
    with pytest.raises(ValueError, match="shape"):
        tbn.bn_bwd_stats_cuda(x, x, v[:3], v, v, v, True)
    with pytest.raises(ValueError, match="contiguous"):
        tbn.bn_fwd_stats_cuda(x.t())
    with pytest.raises(ValueError, match="CUDA"):
        tcb.matmul_stats(x, _t(np.ones((4, 3))), "cuda")
    with pytest.raises(ValueError, match="shape"):
        tcb.conv3x3_stats_cuda(_t(np.ones((1, 4, 4, 3))),
                               _t(np.ones((1, 1, 3, 5))))
    with pytest.raises(TypeError, match="float32"):
        tcb.matmul_stats_cuda(x.double(), _t(np.ones((4, 3))))
    assert (tbn.bn_fwd_stats_cuda.launches == tbn.bn_bwd_stats_cuda.launches
            == tcb.matmul_stats_cuda.launches
            == tcb.conv3x3_stats_cuda.launches == 0)


@pytest.mark.parametrize("p,c", [(1, 1), (133, 6), (1605632, 64),
                                 (6272, 512), (10 ** 8, 3)])
def test_stat_slabs_cover_every_row_once(p, c):
    """The statistic kernels' grid: R slabs of ``slab`` rows cover [0, P)
    exactly (the last slab may be short, none is empty), at most 65535."""
    r, slab = tbn._slabs(p, c)
    assert 1 <= r <= 65535
    assert (r - 1) * slab < p <= r * slab


# -------------------------------------------------------- conv + statistics
@pytest.mark.parametrize("jax_impl", ["interpret", "xla"])
@pytest.mark.parametrize("p,ci,co", [(133, 6, 7), (64, 16, 24)])
def test_matmul_stats_matches_jax(p, ci, co, jax_impl):
    """(y, sum y, sum y^2) and the gradients of x and w under cotangents on
    all three outputs (the statistics' folded into dy), against the JAX
    package's custom vjp; ragged P and Co."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(p + ci)
    x = rng.standard_normal((p, ci)).astype(np.float32)
    w = (rng.standard_normal((ci, co)) * 0.4).astype(np.float32)
    cy = rng.standard_normal((p, co)).astype(np.float32)
    cs, css = (rng.standard_normal(co).astype(np.float32) * 0.1
               for _ in range(2))

    def jloss(x, w):
        y, s, ss = jcb.matmul_stats(x, w, jax_impl)
        return (y * cy).sum() + (s * cs).sum() + (ss * css).sum(), (y, s, ss)

    (_, jouts), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    leaves = [_t(x, True), _t(w, True)]
    y, s, ss = tcb.matmul_stats(*leaves, "pallas")
    loss = (y * _t(cy)).sum() + (s * _t(cs)).sum() + (ss * _t(css)).sum()
    tgrads = torch.autograd.grad(loss, leaves)
    for t, j in zip((y, s, ss) + tgrads, tuple(jouts) + tuple(jgrads)):
        _close(t, j)


@pytest.mark.parametrize("jax_impl", ["interpret", "xla"])
@pytest.mark.parametrize("shape,co", [((2, 8, 5, 6), 7),
                                      # one h-tile: H == the TPU's tile,
                                      # both halo rows masked
                                      ((1, 4, 4, 3), 4)])
def test_conv3x3_stats_matches_jax(shape, co, jax_impl):
    """The 3x3 stride-1 SAME conv with its statistics, and the gradients
    of x and w, against the JAX package."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(shape[1] + co)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], co)) * 0.3).astype(
        np.float32)
    cy = rng.standard_normal(shape[:-1] + (co,)).astype(np.float32)
    cs, css = (rng.standard_normal(co).astype(np.float32) * 0.1
               for _ in range(2))

    def jloss(x, w):
        y, s, ss = jcb.conv3x3_stats(x, w, jax_impl)
        return (y * cy).sum() + (s * cs).sum() + (ss * css).sum(), (y, s, ss)

    (_, jouts), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    leaves = [_t(x, True), _t(w, True)]
    y, s, ss = tcb.conv3x3_stats(*leaves, "pallas")
    loss = (y * _t(cy)).sum() + (s * _t(cs)).sum() + (ss * _t(css)).sum()
    tgrads = torch.autograd.grad(loss, leaves)
    for t, j in zip((y, s, ss) + tgrads, tuple(jouts) + tuple(jgrads)):
        _close(t, j)


# ------------------------------------------------------------------ layers
def _conv(p, x):
    return p.layer.img_conv(x, filter_size=3, num_filters=5, padding=1,
                            act="relu", name="l")


def _conv_dilated(p, x):
    return p.layer.img_conv(x, filter_size=3, num_filters=4, stride=2,
                            padding=2, dilation=2, name="l")


def _conv_s2d(p, x):
    out = p.layer.img_conv(x, filter_size=7, num_filters=6, stride=2,
                           padding=3, bias_attr=False, name="l")
    out.attrs["space_to_depth"] = True
    return out


def _pool(ptype, ceil, pad):
    def make(p, x):
        return p.layer.img_pool(x, pool_size=3, stride=2, padding=pad,
                                pool_type=ptype, ceil_mode=ceil, name="l")
    return make


def _global(ptype):
    def make(p, x):
        return p.layer.global_pool(x, pool_type=ptype, name="l")
    return make


def _bn(act):
    def make(p, x):
        return p.layer.batch_norm(x, act=act, name="l")
    return make


def _cmrnorm(p, x):
    return p.layer.img_cmrnorm(x, size=5, name="l")


def _conv_bn(fs, act, impl):
    def make(p, x):
        from paddle_tpu_torch.core.ir import LayerOutput as TL
        from paddle_tpu.core.ir import LayerOutput as JL
        cls = TL if p is pt else JL
        attrs = {"num_filters": 6, "act": act, "filter_size": fs}
        if impl:
            attrs["conv_bn_impl"] = impl
        return cls("conv_bn", [x], attrs, name="l", size=6)
    return make


LAYER_CASES = {
    "conv": (_conv, (8, 8, 3), True),
    "conv_stride2_dilated": (_conv_dilated, (9, 9, 3), True),
    "conv_s2d": (_conv_s2d, (16, 16, 3), True),
    "pool_max_ceil": (_pool("max", True, 1), (7, 7, 3), True),
    "pool_avg_ceil": (_pool("avg", True, 0), (8, 8, 3), True),
    "pool_max_floor": (_pool("max", False, 1), (8, 8, 3), True),
    "pool_avg_floor_pad": (_pool("avg", False, 1), (7, 7, 3), True),
    "global_avg": (_global("avg"), (5, 5, 4), True),
    "global_max": (_global("max"), (5, 5, 4), True),
    "bn_relu_train": (_bn("relu"), (4, 4, 6), True),
    # fused_bn_impl "pallas" in the port, "interpret" in the JAX package
    # (its Pallas kernels run on the CPU only in interpret mode)
    "bn_relu_train_pallas": (_bn("relu"), (4, 4, 6), True),
    "bn_linear_train_pallas": (_bn("linear"), (4, 4, 6), True),
    "bn_tanh_train": (_bn("tanh"), (4, 4, 6), True),
    "bn_relu_eval": (_bn("relu"), (4, 4, 6), False),
    "cmrnorm": (_cmrnorm, (4, 4, 7), True),
    "conv_bn_1x1_relu_train": (_conv_bn(1, "relu", None), (5, 5, 4), True),
    "conv_bn_1x1_linear_interpret": (_conv_bn(1, "linear", "interpret"),
                                     (5, 5, 4), True),
    "conv_bn_3x3_relu_train": (_conv_bn(3, "relu", None), (5, 6, 4), True),
    "conv_bn_3x3_interpret": (_conv_bn(3, "linear", "interpret"),
                              (4, 4, 3), True),
    "conv_bn_1x1_eval": (_conv_bn(1, "relu", None), (5, 5, 4), False),
    "conv_bn_3x3_eval": (_conv_bn(3, "relu", None), (5, 6, 4), False),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_image_layer_matches_jax(case):
    """One ported layer on a batch of 3 NHWC images, from the same
    parameters (vectors made random) and running state (moving statistics
    made random): its JSON, output, the gradients of every parameter and
    of the input under a random cotangent, and the new running state (the
    moving-statistics update in train mode)."""
    import jax
    import jax.numpy as jnp

    make, shape, train = LAYER_CASES[case]
    reset_jax_names()
    reset_port_names()
    pallas = case.endswith("_pallas")
    pj.init(seed=0, fused_bn_impl="interpret" if pallas else None)
    pt.init(seed=0, device="cpu", fused_bn_impl="pallas" if pallas else None)

    def graph(p):
        x = p.layer.data("x", p.data_type.dense_vector(int(np.prod(shape))),
                         height=shape[0], width=shape[1])
        return make(p, x)

    jout, tout = graph(pj), graph(pt)
    jt = pj.Topology(jout, collect_evaluators=False)
    tt = pt.Topology(tout)
    assert tt.proto() == jt.proto()
    rng = np.random.default_rng(len(case))
    values = {l: {p: (np.asarray(v) if v.ndim != 1 else
                      np.asarray(v) + rng.standard_normal(v.shape).astype(
                          np.float32) * 0.3)
                  for p, v in ps.items()}
              for l, ps in pj.parameters.create(jt).values.items()}
    state = {l: {"moving_mean": rng.standard_normal(
                     ps["moving_mean"].shape).astype(np.float32),
                 "moving_var": (rng.random(ps["moving_var"].shape) + 0.5)
                 .astype(np.float32)}
             for l, ps in jt.create_state().items()}
    x = rng.standard_normal((3,) + shape).astype(np.float32)
    cot = rng.standard_normal((3,) + tuple(jt.shapes["l"])).astype(
        np.float32)

    def jloss(v, x):
        outs, new = jt.forward(v, state, {"x": x}, train=train)
        return (outs["l"] * cot).sum(), (outs["l"], new)

    (_, (jy, jstate)), (jgv, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(values, jnp.asarray(x))

    params = pt.parameters.from_numpy(tt, values, device="cpu").values
    leaves = [(l, n, t.requires_grad_(True)) for l, ps in params.items()
              for n, t in ps.items()]
    xt = _t(x, True)
    outs, tstate = tt.forward(params, tt.create_state(device="cpu",
                                                      values=state),
                              {"x": xt}, train=train)
    _close(outs["l"], jy, "output")
    grads = torch.autograd.grad((outs["l"] * _t(cot)).sum(),
                                [t for _, _, t in leaves] + [xt])
    _close(grads[-1], jgx, "d input")
    for (l, n, _), g in zip(leaves, grads):
        _close(g, jgv[l][n], f"d {l}.{n}")
    assert sorted(tstate) == sorted(jstate)
    for l, ks in jstate.items():
        for k, v in ks.items():
            _close(tstate[l][k], v, f"state {l}.{k}")
            assert not tstate[l][k].requires_grad


# ----------------------------------------------------------------- goldens
def _golden_configs(paddle):
    layer, dv = paddle.layer, paddle.data_type.dense_vector

    def img_layers():
        img = layer.data("image", dv(3 * 16 * 16), height=16, width=16)
        c = layer.img_conv(img, filter_size=3, num_filters=8, padding=1,
                           act="relu", name="conv")
        bn = layer.batch_norm(c, act="relu", name="bn")
        p = layer.img_pool(bn, pool_size=2, stride=2, name="pool")
        n = layer.img_cmrnorm(p, size=5, name="norm")
        return layer.sum_cost(layer.fc(n, size=10, name="out"))

    def conv_bn_fused_r5():
        from paddle_tpu_torch.core.ir import LayerOutput
        img = layer.data("image", dv(8 * 6 * 6), height=6, width=6)
        f = LayerOutput("conv_bn", [img], {"num_filters": 12, "act": "relu"},
                        name="fused", size=12)
        return layer.sum_cost(layer.fc(f, size=4))

    return {f.__name__: f for f in (img_layers, conv_bn_fused_r5)}


@pytest.mark.parametrize("name", sorted(_golden_configs(pt)))
def test_conv_golden_proto_is_byte_equal(name):
    """tests/test_golden_ir.py's configs of these layers, built by the
    port, write the golden JSON byte for byte."""
    reset_port_names()
    pt.init(seed=0, device="cpu")
    text = pt.Topology(_golden_configs(pt)[name]()).proto() + "\n"
    path = os.path.join(os.path.dirname(__file__), "goldens", f"{name}.json")
    with open(path) as f:
        assert text == f.read()


def test_img_layers_golden_trains_a_step_like_jax():
    """The ``img_layers`` golden's graph: one forward/backward from the same
    weights gives the JAX package's cost and gradients, and the batch
    norm's moving statistics move as they do there."""
    import jax

    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")
    jt = pj.Topology(_golden_configs(pj)["img_layers"](),
                     collect_evaluators=False)
    tt = pt.Topology(_golden_configs(pt)["img_layers"]())
    values = {l: {p: np.asarray(v) for p, v in ps.items()}
              for l, ps in pj.parameters.create(jt).values.items()}
    feed = {"image": np.random.default_rng(3).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)}
    cost = jt.output_names[0]

    def jloss(v):
        outs, new = jt.forward(v, jt.create_state(), feed, train=True)
        return outs[cost], new

    (jc, jstate), jg = jax.value_and_grad(jloss, has_aux=True)(values)
    tr = pt.trainer.SGD(tt, pt.parameters.from_numpy(tt, values,
                                                     device="cpu"),
                        pt.optimizer.Momentum(learning_rate=0.1,
                                              momentum=0.9))
    tc, tg = tr.forward_backward(feed)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    for l, ps in tg.items():
        for n, g in ps.items():
            _close(g, jg[l][n], f"{l}.{n}")
    for k in ("moving_mean", "moving_var"):
        _close(tr.model_state["bn"][k], jstate["bn"][k], k)
