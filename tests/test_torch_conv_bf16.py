"""Kernels 7a, 7b, 8 and 9 and the image layers of the PyTorch port under
the ``bf16`` precision policy against the JAX package on the CPU: the
statistic passes' and conv + statistic products' plain versions, the
relu mask at bf16, ``bn_act_train`` on both routes, and every image layer
ResNet uses.  The small bottleneck net is in
``tests/test_torch_resnet_bf16.py``.

Inputs come from numpy seeds and go through both packages; weights and
running state cross through ``parameters.from_numpy`` and
``Topology.create_state(values=)``.  On the CPU the port's statistic and
product functions take their plain versions; the JAX package's Pallas
kernels run in interpret mode, and its "xla" oracles beside them.

Tolerances, from readings on the CPU:
- bf16 values within one bf16 ulp of the JAX value, element by element
  (``_within_ulp``; read: bit-equal, a few elements one ulp apart where
  float32 sums taken in another order round the other way), float32
  statistics and sums within 1e-5 (absolute and relative);
- the relu mask bit-equal, also on activations planted where the fold in
  bf16 is exactly 0 and the float32 fold is not;
- a layer's bf16 output within 2^-8 * max(1, max |ref|) (average pooling
  2^-6: XLA adds a window's 9 bf16 values in bf16, rounding each add, where
  PyTorch sums in float32; read 2^-7), the input's gradient within 2^-7 *
  max(1, max |g|), each parameter's within 2^-4 of its own norm (the
  gradient of a float32 vector cast to bf16 and broadcast, a conv bias or
  an eval batch norm's scale, is a sum over the batch that XLA takes in
  bf16, rounding each add: 194 where the float32 sum of the same terms,
  the port's, rounds to 195; read 1.8e-2).
"""

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
BF16_ULP = 2.0 ** -8
GRAD_TOL = 2.0 ** -7
GRAD_LEAF_RTOL = 2.0 ** -4
EPS = 1e-5


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


def _bf16_np(a, dt="bfloat16"):
    """numpy float32 values rounded to bf16 (or ``dt``; as float32)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dt)).float().numpy()


def _jnp(a, dtype=None):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(a, np.float32)).astype(
        dtype or jnp.float32)


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        dtype).requires_grad_(grad)


def _np(j):
    """A JAX array (any dtype) as float32 numpy."""
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(j).astype(jnp.float32))


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _same_dtype(t, j, what=""):
    assert _dtype_name(t) == str(j.dtype), (what, t.dtype, j.dtype)


def _within_ulp(t, j, what=""):
    """Each element of bf16 (or float16) t within one ulp of its dtype of
    the JAX value (float16's ulp no finer than its subnormals', 2^-24)."""
    got, want = t.detach().float().numpy(), _np(j)
    bits, emin = {torch.bfloat16: (7, -126), torch.float16: (10, -14)}[
        t.dtype]
    ulp = 2.0 ** (np.maximum(np.floor(np.log2(np.maximum(np.abs(want),
                                                          1e-30))),
                             emin) - bits)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), (what, int(bad.sum()), got[bad][:5], want[bad][:5])


def _close(t, j, what=""):
    np.testing.assert_allclose(t.detach().float().numpy(), _np(j),
                               err_msg=what, **TOL)


# ------------------------------------------------------- statistic passes
# rank 4 and rank 2, rows that no block size divides (133), widths past
# one 32-channel block
STAT_SHAPES = [(4, 5, 5, 3), (133, 1, 1, 6), (133, 6), (37, 40),
               (2, 3, 7, 33)]


HALF = ["bfloat16", "float16"]


@pytest.mark.parametrize("dt", HALF)
@pytest.mark.parametrize("shape", STAT_SHAPES)
def test_bf16_fwd_stats_match_jax_kernel(shape, dt):
    """(mean, E[x^2]) of bf16 (and float16) x, float32, from the port's
    plain version of kernel 7a against the JAX package's kernel in
    interpret mode and its "xla" formulation."""
    import jax.numpy as jnp

    x = np.random.default_rng(len(shape) + shape[0]).standard_normal(
        shape).astype(np.float32) * 2 + 0.3
    xj = _jnp(x, dt)
    jm, jm2 = jbn._fwd_stats(xj, True)
    tm, tm2 = tbn._fwd_stats(_t(x, getattr(torch, dt)), "interpret")
    assert tm.dtype == tm2.dtype == torch.float32
    _close(tm, jm)
    _close(tm2, jm2)
    red = tuple(range(x.ndim - 1))
    _close(tm, jnp.mean(xj, axis=red, dtype=jnp.float32))
    _close(tm2, jnp.mean(jnp.square(xj.astype(jnp.float32)), axis=red))


def _bwd_inputs(shape, seed, dt="bfloat16"):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x, dout = (_bf16_np(rng.standard_normal(shape), dt) for _ in range(2))
    w, b, mean = (rng.standard_normal(c).astype(np.float32)
                  for _ in range(3))
    inv = (rng.random(c) + 0.5).astype(np.float32)
    return x, dout, w, b, mean, inv


@pytest.mark.parametrize("dt", HALF)
@pytest.mark.parametrize("act", ["linear", "relu"])
@pytest.mark.parametrize("shape", STAT_SHAPES)
def test_bf16_bwd_stats_match_jax_kernel(shape, act, dt):
    """(sum dy, sum dy * xhat) on bf16 (and float16) dout and x from the
    port's plain version of kernel 7b against the JAX package's kernel in
    interpret mode: float32, within 1e-5."""
    x, dout, w, b, mean, inv = _bwd_inputs(shape, shape[-1] + len(shape),
                                           dt)
    tdt = getattr(torch, dt)
    j = jbn._bwd_stats(_jnp(dout, dt), _jnp(x, dt),
                       *(_jnp(a) for a in (w, b, mean, inv)), act, True)
    t = tbn._bwd_stats(_t(dout, tdt), _t(x, tdt),
                       *(_t(a) for a in (w, b, mean, inv)), act,
                       "interpret")
    for got, want in zip(t, j):
        assert got.dtype == torch.float32
        _close(got, want)


def _boundary_case(shape, seed, dt="bfloat16"):
    """bf16 (or ``dt``) x, dout, float32 per-channel w, b, mean, inv, with
    one element a channel planted where the fold in that dtype (w and b
    cast to it, the product rounded, then the sum) is exactly 0 while the
    float32 fold x * w + b (w and b unrounded) is not.  dout is 1000
    there, so a mask that decides such an element otherwise misses by
    1000."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x2 = _bf16_np(rng.standard_normal(shape), dt).reshape(-1, c)
    w = rng.standard_normal(c).astype(np.float32)
    prod = x2 * _bf16_np(w, dt)                     # exact in float32
    prod16 = _bf16_np(prod, dt)
    rows = np.array([np.nonzero(prod[:, j] != prod16[:, j])[0][0]
                     for j in range(c)])
    cols = np.arange(c)
    b = -prod16[rows, cols]                         # values of dt
    dout2 = _bf16_np(rng.standard_normal(x2.shape), dt)
    dout2[rows, cols] = 1000.0
    inv = (rng.random(c) + 0.5).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32)
    return (x2.reshape(shape), dout2.reshape(shape), w, b, mean, inv,
            rows)


@pytest.mark.parametrize("dt", HALF)
@pytest.mark.parametrize("shape", [(4096, 40), (8, 9, 9, 24)])
def test_bf16_relu_mask_is_the_jax_fold_bit_for_bit(shape, dt):
    """The relu mask of the port's fold at bf16 (and float16) is the JAX
    package's, bit for bit, including activations planted at the
    boundary.  At bf16 XLA on the CPU rounds the fold after each op
    (eagerly, jitted and inside the interpreted kernel), as the port does,
    and the planted folds are exactly 0 while the float32 fold decides
    otherwise, so the check can tell the two apart.  At float16 the jitted
    fold (and the interpreted kernel's) is one float32 multiply-add
    rounded once, as the port's is, where the eager one rounds twice: the
    planted folds are the product's rounding residual (0 eagerly), and
    the float32 fold decides some of them otherwise.  The sums of kernel 7b's
    plain version equal the interpreted kernel's, dout of 1000 on each
    planted element."""
    import jax

    x, dout, w, b, mean, inv, rows = _boundary_case(shape, 11, dt)
    tdt = getattr(torch, dt)
    c = shape[-1]
    cols = np.arange(c)
    xj, wj, bj = _jnp(x, dt), _jnp(w), _jnp(b)
    mask_j = np.asarray(jbn._fold(xj, wj, bj) > 0)
    mask_jit = np.asarray(jax.jit(jbn._fold)(xj, wj, bj) > 0)
    fold16 = tbn._fold(_t(x, tdt), _t(w), _t(b))
    mask_t = (fold16 > 0).numpy()
    assert (mask_t == mask_jit).all()
    planted = fold16.float().numpy().reshape(-1, c)[rows, cols]
    fold32 = (x * w + b).reshape(-1, c)[rows, cols]
    assert (fold32 != 0).all()
    if dt == "bfloat16":
        assert (mask_t == mask_j).all() and (planted == 0).all()
        # the float32 fold keeps some planted elements: a mask taken on it
        # would be 1000 off
        assert (fold32 > 0).any()
    else:
        assert not (mask_t == mask_j).all()
        assert ((planted > 0) != (fold32 > 0)).any()
    j = jbn._bwd_stats(_jnp(dout, dt), xj, wj, bj, _jnp(mean),
                       _jnp(inv), "relu", True)
    t = tbn._bwd_stats(_t(dout, tdt), _t(x, tdt), _t(w), _t(b), _t(mean),
                       _t(inv), "relu", "interpret")
    for got, want in zip(t, j):
        _close(got, want)


@pytest.mark.parametrize("jax_impl", ["interpret", "xla"])
@pytest.mark.parametrize("act", ["linear", "relu"])
@pytest.mark.parametrize("shape", [(4, 5, 5, 3), (133, 6), (3, 4, 5)])
def test_bf16_bn_act_train_matches_jax(shape, act, jax_impl):
    """bn_act_train on bf16 x: (y, mean, var) and the gradients of x, scale
    and bias under cotangents on all three outputs, against the JAX
    package's custom vjp on the same route ("xla" both; the port's plain
    kernel arithmetic against JAX interpret): every dtype equal (y and dx
    bf16, mean and var float32, dscale and dbias the scale's), bf16 values
    within one bf16 ulp, float32 ones within 1e-5."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(len(shape) + 7)
    c = shape[-1]
    x = _bf16_np(rng.standard_normal(shape) * 2 + 0.3)
    scale = (rng.random(c) + 0.5).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.2).astype(np.float32)
    cy = _bf16_np(rng.standard_normal(shape))
    cm, cv = (rng.standard_normal(c).astype(np.float32) for _ in range(2))

    def jfn(x, s, b):
        return jbn.bn_act_train(x, s, b, EPS, act, jax_impl)

    jouts, vjp = jax.vjp(jfn, _jnp(x, jnp.bfloat16), _jnp(scale),
                         _jnp(bias))
    jgrads = vjp((_jnp(cy, jnp.bfloat16), _jnp(cm), _jnp(cv)))
    leaves = [_t(x, torch.bfloat16, True), _t(scale, grad=True),
              _t(bias, grad=True)]
    port_impl = "xla" if jax_impl == "xla" else "pallas"
    touts = tbn.bn_act_train(*leaves, EPS, act, port_impl)
    tgrads = torch.autograd.grad(
        touts, leaves, [_t(cy, torch.bfloat16), _t(cm), _t(cv)])
    names = ("y", "mean", "var", "dx", "dscale", "dbias")
    for name, t, j in zip(names, tuple(touts) + tgrads,
                          tuple(jouts) + tuple(jgrads)):
        _same_dtype(t, j, name)
        if t.dtype == torch.bfloat16:
            _within_ulp(t, j, name)
        else:
            _close(t, j, name)


# -------------------------------------------------------- conv + statistics
def _grads_and_outputs(jfn, tfn, x, w, cot_shape, seed, dt="bfloat16"):
    """Both packages' (y, s, ss) and (dx, dw) on bf16 (or ``dt``) x and w
    under cotangents on all three outputs."""
    import jax

    rng = np.random.default_rng(seed)
    co = cot_shape[-1]
    tdt = getattr(torch, dt)
    cy = _bf16_np(rng.standard_normal(cot_shape), dt)
    cs, css = (rng.standard_normal(co).astype(np.float32) * 0.1
               for _ in range(2))
    jouts, vjp = jax.vjp(jfn, _jnp(x, dt), _jnp(w, dt))
    jgrads = vjp((_jnp(cy, dt), _jnp(cs), _jnp(css)))
    leaves = [_t(x, tdt, True), _t(w, tdt, True)]
    touts = tfn(*leaves)
    tgrads = torch.autograd.grad(touts, leaves, [_t(cy, tdt), _t(cs),
                                                 _t(css)])
    return touts, tgrads, jouts, jgrads


def _hold_conv_stats(touts, tgrads, jouts, jgrads):
    """y, dx, dw bf16 (float16) within one ulp of their dtype; s, ss
    float32 within 1e-5, and taken from the unrounded y: closer to JAX
    than sums of the rounded y come."""
    for name, t, j in zip(("y", "s", "ss", "dx", "dw"),
                          tuple(touts) + tuple(tgrads),
                          tuple(jouts) + tuple(jgrads)):
        _same_dtype(t, j, name)
        if t.dtype in (torch.bfloat16, torch.float16):
            _within_ulp(t, j, name)
        else:
            _close(t, j, name)
    y = touts[0].detach().float()
    red = tuple(range(y.ndim - 1))
    rounded = (y * y).sum(dim=red).numpy()
    err = np.abs(touts[2].detach().numpy() - _np(jouts[2])).max()
    assert err < np.abs(rounded - _np(jouts[2])).max() / 10


@pytest.mark.parametrize("dt", HALF)
@pytest.mark.parametrize("jax_impl", ["interpret", "xla"])
@pytest.mark.parametrize("p,ci,co", [(133, 6, 7), (64, 16, 24),
                                     (200, 64, 40), (57, 5, 7)])
def test_bf16_matmul_stats_matches_jax(p, ci, co, jax_impl, dt):
    """Kernel 8's plain version at bf16 (and float16: x, w in that dtype;
    y too, the sums float32 of the unrounded y) and its backward (dy
    folded in float32, cast to x's dtype, products in it; dx, dw in it)
    against the JAX package's custom vjp; ragged P and Co."""
    rng = np.random.default_rng(p + ci)
    x = _bf16_np(rng.standard_normal((p, ci)), dt)
    w = _bf16_np(rng.standard_normal((ci, co)) * 0.4, dt)
    _hold_conv_stats(*_grads_and_outputs(
        lambda x, w: jcb.matmul_stats(x, w, jax_impl),
        lambda x, w: tcb.matmul_stats(x, w, "pallas"), x, w, (p, co), 3,
        dt))


@pytest.mark.parametrize("dt", HALF)
@pytest.mark.parametrize("jax_impl", ["interpret", "xla"])
@pytest.mark.parametrize("shape,co", [((2, 8, 5, 6), 7), ((1, 4, 4, 3), 4),
                                      ((2, 6, 7, 16), 12)])
def test_bf16_conv3x3_stats_matches_jax(shape, co, jax_impl, dt):
    """Kernel 9's plain version at bf16 (and float16: the conv of the
    upcast operands, statistics before y is rounded) and its backward
    (the conv's own transposes on operands of that dtype) against the JAX
    package."""
    rng = np.random.default_rng(shape[1] + co)
    x = _bf16_np(rng.standard_normal(shape) * 0.5, dt)
    w = _bf16_np(rng.standard_normal((3, 3, shape[-1], co)) * 0.3, dt)
    _hold_conv_stats(*_grads_and_outputs(
        lambda x, w: jcb.conv3x3_stats(x, w, jax_impl),
        lambda x, w: tcb.conv3x3_stats(x, w, "pallas"), x, w,
        shape[:-1] + (co,), 4, dt))


def _at_offset(shape, dtype, offset):
    """A tensor of ``shape`` starting ``offset`` elements into a fresh
    buffer (the allocator's buffers are at least 64-byte aligned)."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 16, dtype=dtype)
    assert buf.data_ptr() % 64 == 0
    return buf[offset:offset + n].view(shape)


# (Ci, Co, the operands' offset in elements, dtype, wide) -> the staging
# ``_vec`` chooses: for kernel 9's bf16 instance (wide) 2 = 16-byte copies,
# 1 = 8-byte, 0 = one element; for the other kernels 1 = 4-element
# vectors, 0 = scalar.  The bf16 rows with offset 0 are the kernel-9 shapes
# chip_smoke.py holds on the card: ResNet-50's four at batch 256
# ((256, 56, 56, 64) -> 64 to (256, 7, 7, 512) -> 512), and the ragged
# (3, 7, 9, 5, 7), (2, 13, 11, 64, 72) and (2, 9, 10, 36, 40).
COPY_WIDTHS = [
    ((64, 64, 0, torch.bfloat16, True), 2),
    ((128, 128, 0, torch.bfloat16, True), 2),
    ((256, 256, 0, torch.bfloat16, True), 2),
    ((512, 512, 0, torch.bfloat16, True), 2),
    ((5, 7, 0, torch.bfloat16, True), 0),
    ((64, 72, 0, torch.bfloat16, True), 2),
    ((36, 40, 0, torch.bfloat16, True), 1),
    ((64, 64, 4, torch.bfloat16, True), 1),     # 8-byte aligned only
    ((64, 64, 1, torch.bfloat16, True), 0),     # 2-byte aligned
    ((64, 60, 0, torch.bfloat16, True), 1),
    ((64, 64, 0, torch.bfloat16, False), 1),    # kernel 8 at bf16
    ((64, 64, 4, torch.bfloat16, False), 1),
    ((64, 64, 0, torch.float32, False), 1),     # the float32 instances
    ((64, 64, 2, torch.float32, False), 0),
    ((5, 7, 0, torch.float32, False), 0),
]


@pytest.mark.parametrize("case,want", COPY_WIDTHS,
                         ids=[f"ci{c[0]}-co{c[1]}-off{c[2]}-"
                              f"{str(c[3])[6:]}{'-wide' if c[4] else ''}"
                              for c, _ in COPY_WIDTHS])
def test_copy_width_by_channels_and_alignment(case, want):
    """The wrapper's staging choice (``_vec``) by Ci, Co and the operands'
    alignment: kernel 9's bf16 instance takes 16-byte copies where Ci and
    Co are multiples of 8 and x, w and y are 16-byte aligned, 8-byte
    copies where multiples of 4 and 8-byte aligned, else one element; the
    shapes the card's check runs reach each of the three."""
    ci, co, off, dtype, wide = case
    x = _at_offset((1, 2, 2, ci), dtype, off)
    w = _at_offset((3, 3, ci, co), dtype, off)
    y = _at_offset((1, 2, 2, co), dtype, off)
    assert tcb._vec(ci, co, x, w, y, wide=wide) == want


# kernel 8's bf16 instance (wide), x [P, Ci], w [Ci, Co], y [P, Co]:
# (Ci, Co, the operands' offset in elements) -> 2 = 16-byte copies, 1 =
# 8-byte, 0 = one element.  The offset-0 rows are the shapes chip_smoke.py
# holds on the card: ResNet-50's 1x1 convs at batch 256 (every Ci and Co a
# multiple of 64) and the ragged (1000, 37, 70), (4099, 64, 200) and
# (2000, 36, 100).
MATMUL_COPY_WIDTHS = [
    ((64, 256, 0), 2), ((256, 64, 0), 2), ((256, 128, 0), 2),
    ((512, 128, 0), 2), ((1024, 256, 0), 2), ((2048, 512, 0), 2),
    ((37, 70, 0), 0), ((64, 200, 0), 2), ((36, 100, 0), 1),
    ((64, 256, 4), 1),                          # 8-byte aligned only
    ((64, 256, 2), 0),                          # 4-byte aligned
    ((5, 7, 0), 0),
]


@pytest.mark.parametrize("case,want", MATMUL_COPY_WIDTHS,
                         ids=[f"ci{c[0]}-co{c[1]}-off{c[2]}"
                              for c, _ in MATMUL_COPY_WIDTHS])
def test_kernel8_bf16_copy_width(case, want):
    """Kernel 8's bf16 instance runs on the tensor cores with kernel 9's
    copies: ``matmul_stats_cuda`` asks ``_vec`` with ``wide``, which gives
    16-byte copies where Ci and Co are multiples of 8 and x, w and y are
    16-byte aligned, 8-byte where multiples of 4 and 8-byte aligned, else
    one element; the shapes the card's check runs reach all three."""
    ci, co, off = case
    x = _at_offset((3, ci), torch.bfloat16, off)
    w = _at_offset((ci, co), torch.bfloat16, off)
    y = _at_offset((3, co), torch.bfloat16, off)
    assert tcb._vec(ci, co, x, w, y, wide=True) == want


def test_resnet_breakdown_files_the_tensor_core_conv_kernels_as_kernels():
    """chip_smoke.py's ResNet step breakdown files each device activity
    under the first part whose keys its name holds: every kernel that
    conv_bn.cu, bn_stats.cu and stat_reduce.cuh launch under the kernels -
    the 16-bit and float32 tensor-core kernels 8 and 9 (whose names hold
    "conv") not under cuDNN's convs, the float32 kernels' W-plane pre-pass
    and stat_reduce's chunk pass not under the elementwise rest - as the
    statistic passes are."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kernels, convs = smoke._PARTS[0][0], smoke._PARTS[1][0]
    for name in (
            "void (anonymous namespace)::conv_mma_stats_kernel<1, 8>("
            "__nv_bfloat16 const*, __nv_bfloat16 const*, int, int, int, "
            "int, int, int, int, __nv_bfloat16*, float*, float*)",
            "void (anonymous namespace)::conv_mma_stats_kernel<9, 4>(...)",
            "void (anonymous namespace)::conv_tf32_stats_kernel<1, 4>("
            "float const*, float const*, int, int, int, int, int, int, int, "
            "int, float*, float*, float*)",
            "void (anonymous namespace)::conv_tf32_stats_kernel<9, 4>(...)",
            "void (anonymous namespace)::split_w_planes_kernel(float const*, "
            "int, int, int, int, float*, float*)",
            "void stat_reduce::(anonymous namespace)::chunk_kernel(float*, "
            "float*, int, int)",
            "void stat_reduce::(anonymous namespace)::finish_kernel(...)",
            "void (anonymous namespace)::bwd_partial_kernel<float, true>()"):
        assert smoke.part_of(name) == kernels, name
    assert smoke.part_of("sm90_xmma_fprop_implicit_gemm_bf16") == convs
    assert smoke.part_of("void at::native::elementwise_kernel<128, 4>") \
        == smoke._REST


# ------------------------------------------------------------------ layers
def _conv(p, x):
    return p.layer.img_conv(x, filter_size=3, num_filters=5, padding=1,
                            act="relu", name="l")


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


def _conv_bn(fs, act):
    def make(p, x):
        from paddle_tpu.core.ir import LayerOutput as JL
        from paddle_tpu_torch.core.ir import LayerOutput as TL
        cls = TL if p is pt else JL
        return cls("conv_bn", [x], {"num_filters": 6, "act": act,
                                    "filter_size": fs}, name="l", size=6)
    return make


def _conv_then(make_next):
    """A bias-free conv (so the next layer sees the conv's bf16 output),
    then the layer under test."""
    def make(p, x):
        c = p.layer.img_conv(x, filter_size=3, num_filters=6, padding=1,
                             bias_attr=False, name="c")
        return make_next(p, c)
    return make


# name: (graph, input shape, train)
LAYER_CASES = {
    "conv": (_conv, (8, 8, 3), True),
    "conv_s2d": (_conv_s2d, (16, 16, 3), True),
    "pool_max": (_conv_then(_pool("max", False, 1)), (7, 7, 3), True),
    # bf16 window sums: 2^-6 (the module docstring)
    "pool_avg": (_conv_then(_pool("avg", True, 0)), (8, 8, 3), True),
    "global_avg": (_conv_then(_global("avg")), (5, 5, 3), True),
    "global_max": (_conv_then(_global("max")), (5, 5, 3), True),
    "bn_relu_train": (_conv_then(_bn("relu")), (4, 4, 3), True),
    "bn_relu_train_pallas": (_conv_then(_bn("relu")), (4, 4, 3), True),
    "bn_linear_train": (_conv_then(_bn("linear")), (4, 4, 3), True),
    "bn_linear_train_pallas": (_conv_then(_bn("linear")), (4, 4, 3), True),
    "bn_relu_eval": (_conv_then(_bn("relu")), (4, 4, 3), False),
    "conv_bn_1x1_train": (_conv_bn(1, "relu"), (5, 5, 4), True),
    "conv_bn_3x3_train": (_conv_bn(3, "relu"), (5, 6, 4), True),
    "conv_bn_1x1_linear_train": (_conv_bn(1, "linear"), (5, 5, 4), True),
    "conv_bn_1x1_eval": (_conv_bn(1, "relu"), (5, 5, 4), False),
    "conv_bn_3x3_eval": (_conv_bn(3, "relu"), (5, 6, 4), False),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_bf16_image_layer_matches_jax(case):
    """One image layer under ``bf16`` on a batch of 3 NHWC images, from the
    same parameters and moving statistics: every layer's output dtype
    equal to the JAX package's (bf16 activations, float32 state), values
    within one bf16 ulp of max(1, max |ref|) (average pooling: 2^-6); the
    gradients (float32 in both) of the input within 2^-7 of max(1, max
    |g|), of each parameter within 2^-4 of its norm; the new moving
    statistics float32 within 1e-5.  "_pallas" cases run the JAX
    package's kernels interpreted and the port's plain kernel
    arithmetic."""
    import jax
    import jax.numpy as jnp

    make, shape, train = LAYER_CASES[case]
    reset_jax_names()
    reset_port_names()
    pallas = case.endswith("_pallas")
    pj.init(seed=0, precision="bf16",
            fused_bn_impl="interpret" if pallas else None)
    pt.init(seed=0, device="cpu", precision="bf16",
            fused_bn_impl="pallas" if pallas else None)

    def graph(p):
        x = p.layer.data("x", p.data_type.dense_vector(int(np.prod(shape))),
                         height=shape[0], width=shape[1])
        return make(p, x)

    jt = pj.Topology(graph(pj), collect_evaluators=False)
    tt = pt.Topology(graph(pt))
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
    names = [s.name for s in tt.specs if s.kind != "data"]
    jouts, _ = jt.forward(values, state, {"x": x}, train=train,
                          outputs=names)
    cot = rng.standard_normal(np.shape(jouts["l"])).astype(np.float32)

    def jloss(v, x):
        outs, new = jt.forward(v, state, {"x": x}, train=train)
        return (outs["l"].astype(jnp.float32) * cot).sum(), new

    (_, jstate), (jgv, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(values, jnp.asarray(x))

    params = pt.parameters.from_numpy(tt, values, device="cpu").values
    leaves = [(l, n, t.requires_grad_(True)) for l, ps in params.items()
              for n, t in ps.items()]
    xt = _t(x, grad=True)
    touts, tstate = tt.forward(params, tt.create_state(device="cpu",
                                                      values=state),
                               {"x": xt}, train=train, outputs=names)
    for n in names:
        t, j = touts[n], jouts[n]
        _same_dtype(t, j, n)
        want = _np(j)
        ulp = 4 * BF16_ULP if case == "pool_avg" else BF16_ULP
        tol = (ulp if t.dtype == torch.bfloat16 else 1e-5) * max(
            1.0, np.abs(want).max())
        assert np.abs(t.detach().float().numpy() - want).max() <= tol, n
    assert touts["l"].dtype == torch.bfloat16
    grads = torch.autograd.grad((touts["l"].float() * _t(cot)).sum(),
                                [t for _, _, t in leaves] + [xt])
    _same_dtype(grads[-1], jgx, "d input")
    err = np.abs(grads[-1].numpy() - _np(jgx)).max()
    assert err <= GRAD_TOL * max(1.0, np.abs(_np(jgx)).max()), err
    for (l, n, _), g in zip(leaves, grads):
        _same_dtype(g, jgv[l][n], f"d {l}.{n}")
        want = _np(jgv[l][n]).astype(np.float64)
        dist = np.linalg.norm(g.numpy() - want)
        assert dist <= GRAD_LEAF_RTOL * np.linalg.norm(want), (
            l, n, dist / np.linalg.norm(want))
    assert sorted(tstate) == sorted(jstate)
    for l, ks in jstate.items():
        for k, v in ks.items():
            _same_dtype(tstate[l][k], v, f"state {l}.{k}")
            _close(tstate[l][k], v, f"state {l}.{k}")
