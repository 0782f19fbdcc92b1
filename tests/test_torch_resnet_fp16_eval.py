"""ResNet's eval branch (``SGD.test`` on the moving statistics) under the
``fp16`` policy, the PyTorch port against the JAX package on the CPU.

On the H100 the ResNet-50 ``fp16`` eval after 4 Momentum steps reads NaN.
These tests feed both packages the same weights and the same moving
statistics (numpy), some of a scale float16 cannot hold, and hold the two
``SGD.test`` costs to each other: the same where finite, NaN in both where
the fold overflows.  The batch-norm fold of the eval branch (and of
``conv_bn``'s train path) is held against the JAX package's jitted fold:
at float16 XLA's CPU backend contracts x * w + b into one float32
multiply-add rounded once, as it does for the train-mode fold
(``ops/fused_bn.py::_fold``), where the port's fold rounded twice.  The small bottleneck net and the
packages' setup are those of tests/test_torch_resnet_bf16.py.

Tolerance: the costs within 2^-20 relative where finite (the float32
loss's own rounding; readings: equal, or one float32 ulp apart after 4
training steps).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from paddle_tpu.layers import conv as jconv
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.layers import conv as tconv

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "_resnet_bf16_cases", os.path.join(HERE, "test_torch_resnet_bf16.py"))
rb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rb)

COST_RTOL = 2.0 ** -20


@pytest.fixture(autouse=True)
def _restore_options():
    """Both packages' options (the policy and the conv slice's) as they
    were found."""
    topts, jopts = dict(tconfig._options), dict(rb.jconfig._options)
    yield
    for mod, saved in ((tconfig, topts), (rb.jconfig, jopts)):
        mod._options.clear()
        mod._options.update(saved)
    rb.jconfig._policy_cache = None


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_bn_fold_is_the_jitted_jax_fold(dtype):
    """``layers/conv.py::_bn_fold`` against ``jax.jit`` of the JAX
    package's ``_bn_fold`` on the same x and float32 statistics,
    statistics past float16's range among them (means whose fold
    overflows float16, variances of 1e9 and 1e-9).  bf16: bit for bit.
    float16: the same infinities, and at most 1e-4 of the
    elements one ulp apart (readings: 2 of 262,144; XLA's fused float16
    multiply-add rounds a few near-ties otherwise than one float32
    multiply-add rounded to float16, and otherwise than float64 does),
    where the fold's earlier form, x * w rounded to float16 and then + b,
    puts 29% of them one ulp off (the JAX package's eager evaluation
    does the same).  The float32 fold is not compared here: XLA's jitted
    float32 rsqrt and multiply-add round otherwise than torch's in the last
    bits, and the float32 route is held within 1e-5 elsewhere."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    c = 64
    x = rng.randn(4096, c).astype(np.float32) * 3
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    mean = rng.randn(c).astype(np.float32)
    var = rng.uniform(0.1, 4.0, c).astype(np.float32)
    mean[:2] = [1e6, -1e6]
    var[2:4] = [1e9, 1e-9]
    jx = jnp.asarray(x, dtype)
    want = jax.jit(jconv._bn_fold, static_argnums=5)(
        jx, jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(mean),
        jnp.asarray(var), 1e-5)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    stats = [torch.from_numpy(a) for a in (scale, bias, mean, var)]
    got = tconv._bn_fold(tx, *stats, 1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    assert np.isinf(want).any()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    off = got != want
    assert off.mean() <= 1e-4, off.mean()
    ulp = np.spacing(np.abs(want[off]).astype(np.float16)).astype(np.float32)
    assert (np.abs(got[off] - want[off]) <= ulp).all()
    # the earlier form, two roundings at float16
    inv = torch.rsqrt(stats[3] + 1e-5)
    w = (stats[0] * inv).half()
    b = (stats[1] - stats[2] * stats[0] * inv).half()
    assert ((tx * w + b).float().numpy() != want).mean() > 0.2


def _stats(jtopo, kind, seed=7):
    """Moving statistics for every batch norm of the small net: means
    N(0, 0.5), variances U(0.5, 2), and per ``kind``: "fold_overflows" (4
    of the last projection's channels at mean -1e6, whose fold's bias is
    +inf at float16, and the cost NaN), "var_past_fp16" (two variances of
    the first block at 1e9, past float16's 65504; the fold keeps them
    float32), "activations_overflow" (the first block's first variances
    at 1e-9: x * w overflows float16)."""
    rng = np.random.default_rng(seed)
    state = {}
    for layer, ks in jtopo.create_state().items():
        c = ks["moving_mean"].shape[0]
        mean = rng.standard_normal(c).astype(np.float32) * 0.5
        var = rng.uniform(0.5, 2.0, c).astype(np.float32)
        if kind == "fold_overflows" and layer == "b2_proj_bn":
            mean[:4] = -1e6
        if kind == "var_past_fp16" and layer.startswith("b1"):
            var[:2] = 1e9
        if kind == "activations_overflow" and layer.startswith("b1_a"):
            var[:] = 1e-9
        state[layer] = {"moving_mean": mean, "moving_var": var}
    return state


def _both_test(jtr, ttr, state, rows):
    """Both trainers' ``SGD.test`` cost on ``rows`` with moving statistics
    ``state`` (numpy, set in both)."""
    import jax.numpy as jnp

    jtr.model_state = {l: {k: jnp.asarray(a) for k, a in d.items()}
                       for l, d in state.items()}
    ttr.model_state = {l: {k: torch.from_numpy(np.array(a))
                           for k, a in d.items()} for l, d in state.items()}
    return (jtr.test(lambda: iter([rows]), feeding=rb.FEEDING).cost,
            ttr.test(lambda: iter([rows]), feeding=rb.FEEDING).cost)


def _hold_costs(jc, tc, what):
    assert np.isfinite(jc) == np.isfinite(tc), (what, jc, tc)
    if np.isfinite(jc):
        assert abs(tc - jc) <= COST_RTOL * abs(jc), (what, jc, tc)
    else:
        assert np.isnan(jc) and np.isnan(tc), (what, jc, tc)


@pytest.mark.parametrize("kind", ["moderate", "fold_overflows",
                                  "var_past_fp16", "activations_overflow"])
@pytest.mark.parametrize("fuse", [False, "all"])
def test_small_resnet_fp16_eval_matches_jax(fuse, kind):
    """``SGD.test`` under ``fp16`` from the same weights and moving
    statistics (``_stats``): the port's cost is the JAX package's, NaN in
    both where the fold overflows float16."""
    jtopo, ttopo = rb._init(fuse, "fp16")
    values = rb._values(jtopo, 2)
    jtr = rb._jax_trainer(jtopo, values, "interpret")
    ttr = rb.pt.trainer.SGD(ttopo, rb.pt.parameters.from_numpy(
        ttopo, values, device="cpu"), rb.pt.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9))
    jc, tc = _both_test(jtr, ttr, _stats(jtopo, kind), rb._rows(
        rb._feed(3, 4)))
    _hold_costs(jc, tc, kind)
    assert np.isfinite(jc) == (kind != "fold_overflows")


@pytest.mark.parametrize("fuse", [False, "all"])
def test_small_resnet_fp16_eval_after_training_matches_jax(fuse):
    """The chip run's order at small size: the JAX package trains 4
    Momentum steps (0.1, 0.9) under ``fp16``, then both packages evaluate
    its parameters and moving statistics: the same cost."""
    jtopo, ttopo = rb._init(fuse, "fp16")
    values = rb._values(jtopo, 2)
    jtr = rb._jax_trainer(jtopo, values, "interpret")
    rows = rb._rows(rb._feed(8, 3))
    jtr.train(lambda: iter([rows] * 4), feeding=rb.FEEDING,
              event_handler=lambda e: None)
    trained = {l: {p: np.asarray(a) for p, a in ps.items()}
               for l, ps in jtr.parameters.values.items()}
    ttr = rb.pt.trainer.SGD(ttopo, rb.pt.parameters.from_numpy(
        ttopo, trained, device="cpu"), rb.pt.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9))
    state = {l: {k: np.asarray(a) for k, a in d.items()}
             for l, d in jtr.model_state.items()}
    jc, tc = _both_test(jtr, ttr, state, rb._rows(rb._feed(3, 4)))
    _hold_costs(jc, tc, "trained")
