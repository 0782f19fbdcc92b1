"""The arithmetic of kernels 8, 6 and 5 at float32 on the tensor cores
(split TF32, "3xTF32") on the CPU: ``_tf32x3_matmul_stats`` of
paddle_tpu_torch/ops/conv_bn.py (what ``conv_tf32_stats_kernel<1, W>`` of
``csrc/conv_bn.cu`` computes, the 1x1 conv with its statistics),
``_tf32x3_gru_step`` and ``_tf32x3_lstm_step`` of ops/fused_rnn.py (what
``gru_tf32_kernel`` and ``lstm_tf32_kernel`` of ``csrc/rnn_step.cu``
compute, the GRU and LSTM steps), each against the JAX package's Pallas
kernel under the interpreter and its plain route within a bound derived
below; the planted fault (one TF32 product, ``terms=1``) failing each
bound; the CPU routes of the wrappers, which stay on the plain versions;
the recurrent kernels' split of K and the LSTM's grid; the bounds at the
TF32 peak.

The bounds.  With u = 2^-22 (hi + lo is x within u |x|, and lo_a . lo_b
is within u |a||b|), each product a . b taken as lo_a . hi_b + hi_a .
lo_b + hi_a . hi_b is within E = 3u of |a||b| (the products of TF32 parts
are exact in float32), so a product A W is within E (|A| |W|),
elementwise.

Kernel 8.  y = x W: |y error| <= b_y = E (|x| |W|); the statistics,
summed from that y, |sum y error| <= sum_p b_y and |sum y^2 error| <=
sum_p (2 |y| b_y + b_y^2).

Kernel 6.  The gates' pre-activations g = x + h W_g + b move by at most
b_g = E (|h| |W_g|); z and r by a quarter of that (the sigmoid's slope is
at most 1/4); r h by |h| b_r.  The candidate's pre-activation moves by at
most b_c = b_rh |W_c| + E (|r h| + b_rh) |W_c| (the product of a moved
operand, taken as 3xTF32), c~ by as much (tanh's slope is at most 1); and
h' = h + z (c~ - h) by b_z |c~ - h| + (z + b_z) b_c.  A masked row is h
itself, bit for bit.

Kernel 5.  The pre-activations g = x + h W + b move by at most b_g = E
(|h| |W|); the gates i, f and o by a quarter of their columns' b_g (b_i,
b_f, b_o), the candidate c~ = tanh(.) by all of its (b_c~).  Then c' = f c
+ i c~ moves by at most b_c' = b_f |c| + b_i |c~| + (i + b_i) b_c~, and
h' = o tanh(c') by b_h' = b_o |tanh c'| + (o + b_o) b_c'.  A masked row is
h and c themselves, bit for bit.

Each is held with the float32 rounding of sums taken in another order on
either side, 1e-5 + 1e-5 |want| (as tests/test_torch_tf32_fwd.py), and
read as the largest |got - want| over that limit.  Readings:
``_tf32x3_matmul_stats`` at most 0.040 of its limit (y and both sums,
against both JAX routes), one TF32 product 24x to 97x on y;
``_tf32x3_gru_step`` at most 0.028 (every dtype pair, both JAX routes),
one TF32 product 17x to 34x; ``_tf32x3_lstm_step`` at most 0.058
(h' and c', every dtype pair and shape, both JAX routes), one TF32
product 16x to 41x.
"""

import importlib

import numpy as np
import pytest
import torch

from paddle_tpu.ops import conv_bn as jcb
from paddle_tpu_torch.ops import conv_bn as tcb
from paddle_tpu_torch.ops import fused_rnn as trnn

# the JAX package's ops/__init__ re-exports names over some of its modules
jrnn = importlib.import_module("paddle_tpu.ops.fused_rnn")

U = 2.0 ** -22                 # the split's unit
E = 3 * U                      # one product's relative error, 3xTF32
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _excess(got, want, bound) -> float:
    """The largest |got - want| over its limit: bound + 1e-5 + 1e-5
    |want|."""
    limit = bound + F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(want)
    return float((np.abs(got - want) / limit).max())


# ------------------------------------------------------------ kernel 8
# (P, Ci, Co): multiples of the kernel's copy width, ragged ones (one-float
# copies; Co past a 64-wide column tile), and ResNet-50's deepest K (2048,
# res5's reduce) at a narrow P
MM_SHAPES = [(40, 16, 24), (37, 13, 11), (130, 64, 72), (24, 2048, 16)]


def _mm_inputs(p, ci, co):
    rng = np.random.default_rng(p * 7 + ci + co)
    x = rng.standard_normal((p, ci)).astype(np.float32)
    w = (rng.standard_normal((ci, co)) * ci ** -0.5).astype(np.float32)
    return x, w


def _mm_bounds(x2, w2, y):
    """The module docstring's bounds, float64: y's [P, Co], sum y's and
    sum y^2's [Co]."""
    b_y = E * (x2.double().abs() @ w2.double().abs())
    yd = y.double().abs()
    return [b_y.numpy(), b_y.sum(dim=0).numpy(),
            (2 * yd * b_y + b_y ** 2).sum(dim=0).numpy()]


def _mm_excess(shape, jax_impl, terms=3):
    """Each of (y, sum y, sum y^2)'s excess over its bound against the JAX
    package's ``jax_impl`` route."""
    import jax.numpy as jnp

    x, w = _mm_inputs(*shape)
    if jax_impl == "interpret":
        want = jcb.matmul_stats_fwd(jnp.asarray(x), jnp.asarray(w),
                                    interpret=True)
    else:
        want = jcb.matmul_stats(jnp.asarray(x), jnp.asarray(w), "xla")
    x2, w2 = torch.from_numpy(x), torch.from_numpy(w)
    got = tcb._tf32x3_matmul_stats(x2, w2, terms=terms)
    assert all(g.dtype == torch.float32 for g in got)
    bounds = _mm_bounds(x2, w2, got[0])
    return [_excess(g.numpy(), np.asarray(wt), b)
            for g, wt, b in zip(got, want, bounds)]


@pytest.mark.parametrize("jax_impl", ["interpret", "xla"])
@pytest.mark.parametrize("shape", MM_SHAPES)
def test_tf32x3_matmul_stats_matches_jax(shape, jax_impl):
    """``_tf32x3_matmul_stats`` against the JAX package's
    ``matmul_stats_fwd`` under the Pallas interpreter and its "xla" route:
    y and both sums within the derived bounds."""
    for name, e in zip(("y", "sum y", "sum y^2"),
                       _mm_excess(shape, jax_impl)):
        assert e <= 1.0, (name, e)


@pytest.mark.parametrize("shape", MM_SHAPES)
def test_one_tf32_product_fails_the_matmul_bound(shape):
    """``terms=1`` (one TF32 product, hi . hi) fails y's derived bound
    against the Pallas interpreter on every shape."""
    assert _mm_excess(shape, "interpret", terms=1)[0] > 1.0


# ------------------------------------------------------------ kernel 6
# (B, H): B past the kernel's 128-row tile and not a multiple of 8, H not
# a multiple of the kernel's 32-deep slices or 64-wide tiles (one-float
# copies at 37)
GRU_SHAPES = [(12, 64), (133, 40), (5, 37)]
# (x dtype, mask dtype): every instance of kernels 6 and 5 (KERNEL_DTYPES)
STEP_DTYPES = [pytest.param(x, m, id=f"{x}-{m}") for x, m in (
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16"), ("float16", "float32"),
    ("float16", "float16"))]


def _gru_inputs(b, h, x_dtype="float32", m_dtype="float32"):
    """x_t (rounded to x_dtype, as float32 numpy), h, w_g, w_c, b and a
    mask with about 30% zeros, from a seed."""
    rng = np.random.default_rng(b * 31 + h)
    x = rng.standard_normal((b, 3 * h)).astype(np.float32)
    x = torch.from_numpy(x).to(getattr(torch, x_dtype)).float().numpy()
    args = [x, rng.standard_normal((b, h)),
            rng.standard_normal((h, 2 * h)) * h ** -0.5,
            rng.standard_normal((h, h)) * h ** -0.5,
            rng.standard_normal(3 * h) * 0.1,
            (rng.random((b, 1)) > 0.3)]
    return [np.asarray(a, np.float32) for a in args]


def _gru_torch(args, x_dtype, m_dtype):
    x, *rest, m = (torch.from_numpy(a) for a in args)
    return (x.to(getattr(torch, x_dtype)), *rest,
            m.to(getattr(torch, m_dtype)))


def _gru_bound(x, h, wg, wc, b, m):
    """The module docstring's bound on h', float64 [B, H]."""
    x, h, wg, wc, b = (t.double() for t in (x.float(), h, wg, wc, b))
    hd = h.shape[1]
    ab = lambda t: t.abs()                                  # noqa: E731
    g = x[:, :2 * hd] + h @ wg + b[:2 * hd]
    b_g = E * (ab(h) @ ab(wg))
    zr = torch.sigmoid(g)
    z, r = zr[:, :hd], zr[:, hd:]
    b_z, b_r = b_g[:, :hd] / 4, b_g[:, hd:] / 4
    rh = r * h
    b_rh = ab(h) * b_r
    b_c = b_rh @ ab(wc) + E * ((ab(rh) + b_rh) @ ab(wc))
    cand = torch.tanh(x[:, 2 * hd:] + rh @ wc + b[2 * hd:])
    bound = b_z * ab(cand - h) + (z + b_z) * b_c
    return torch.where(m.bool(), bound, torch.zeros_like(bound)).numpy()


def _gru_excess(shape, x_dtype, m_dtype, jax_impl, terms=3):
    """h''s excess over its bound against the JAX package's ``jax_impl``
    route (its Pallas GRU kernel under the interpreter, or its oracle
    ``_gru_step_ref``), and whether the masked rows are h bit for bit."""
    import jax.numpy as jnp

    args = _gru_inputs(*shape, x_dtype, m_dtype)
    jargs = ([jnp.asarray(args[0], x_dtype)]
             + [jnp.asarray(a) for a in args[1:-1]]
             + [jnp.asarray(args[-1], m_dtype)])
    if jax_impl == "interpret":
        want = jrnn._gru_pallas(*jargs, block_b=8, interpret=True)
    else:
        want = jrnn._gru_step_ref(*jargs)
    want = np.asarray(want)
    targs = _gru_torch(args, x_dtype, m_dtype)
    got = trnn._tf32x3_gru_step(*targs, terms=terms)
    assert got.dtype == torch.float32
    dead = args[-1][:, 0] == 0
    assert dead.any()
    masked_exact = np.array_equal(got.numpy()[dead], args[1][dead])
    return _excess(got.numpy(), want, _gru_bound(*targs)), masked_exact


@pytest.mark.parametrize("jax_impl", ["interpret", "ref"])
@pytest.mark.parametrize("x_dtype,m_dtype", STEP_DTYPES)
@pytest.mark.parametrize("shape", GRU_SHAPES)
def test_tf32x3_gru_step_matches_jax(shape, x_dtype, m_dtype, jax_impl):
    """``_tf32x3_gru_step`` against the JAX package's ``_gru_pallas``
    under the interpreter and ``_gru_step_ref``, at every (x, mask) dtype
    pair of the kernel's instances and at ragged B and H: h' within the
    derived bound, masked rows h bit for bit."""
    e, masked_exact = _gru_excess(shape, x_dtype, m_dtype, jax_impl)
    assert e <= 1.0, e
    assert masked_exact


@pytest.mark.parametrize("shape", GRU_SHAPES)
def test_one_tf32_product_fails_the_gru_bound(shape):
    """``terms=1`` (each product one TF32 product, hi . hi) fails h''s
    derived bound against the Pallas interpreter on every shape."""
    assert _gru_excess(shape, "float32", "float32", "interpret",
                       terms=1)[0] > 1.0


# ------------------------------------------------------------ kernel 5
# (B, H): B 8 at H 32, B past 8 and H a multiple of the kernel's 16-unit
# tiles, B and H ragged (one-float copies at 37), the route's H at B 16
LSTM_SHAPES = [(8, 32), (37, 128), (5, 37), (16, 512)]


def _lstm_inputs(b, h, x_dtype="float32", m_dtype="float32"):
    """x_t (rounded to x_dtype, as float32 numpy), h, c, w, b and a mask
    with about 30% zeros, from a seed."""
    rng = np.random.default_rng(b * 37 + h)
    x = rng.standard_normal((b, 4 * h)).astype(np.float32)
    x = torch.from_numpy(x).to(getattr(torch, x_dtype)).float().numpy()
    args = [x, rng.standard_normal((b, h)), rng.standard_normal((b, h)),
            rng.standard_normal((h, 4 * h)) * h ** -0.5,
            rng.standard_normal(4 * h) * 0.1,
            (rng.random((b, 1)) > 0.3)]
    return [np.asarray(a, np.float32) for a in args]


def _lstm_torch(args, x_dtype, m_dtype):
    x, *rest, m = (torch.from_numpy(a) for a in args)
    return (x.to(getattr(torch, x_dtype)), *rest,
            m.to(getattr(torch, m_dtype)))


def _lstm_bounds(x, h, c, w, b, m):
    """The module docstring's bounds on h' and c', float64 [B, H] each."""
    x, h, c, w, b = (t.double() for t in (x.float(), h, c, w, b))
    g = x + h @ w + b
    b_g = E * (h.abs() @ w.abs())
    (gi, gf, gc, go), (bi, bf, bc, bo) = g.chunk(4, -1), b_g.chunk(4, -1)
    i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
    bi, bf, bo = bi / 4, bf / 4, bo / 4
    cand = torch.tanh(gc)
    c_new = f * c + i * cand
    b_c = bf * c.abs() + bi * cand.abs() + (i + bi) * bc
    b_h = bo * torch.tanh(c_new).abs() + (o + bo) * b_c
    live = m.bool()
    return [torch.where(live, t, torch.zeros_like(t)).numpy()
            for t in (b_h, b_c)]


def _lstm_excess(shape, x_dtype, m_dtype, jax_impl, terms=3):
    """h''s and c''s excess over their bounds against the JAX package's
    ``jax_impl`` route (its Pallas LSTM kernel under the interpreter, or
    its oracle ``_lstm_step_ref``), and whether the masked rows are h and
    c bit for bit."""
    import jax.numpy as jnp

    args = _lstm_inputs(*shape, x_dtype, m_dtype)
    jargs = ([jnp.asarray(args[0], x_dtype)]
             + [jnp.asarray(a) for a in args[1:-1]]
             + [jnp.asarray(args[-1], m_dtype)])
    if jax_impl == "interpret":
        want = jrnn._lstm_pallas(*jargs, block_b=8, interpret=True)
    else:
        want = jrnn._lstm_step_ref(*jargs)
    targs = _lstm_torch(args, x_dtype, m_dtype)
    got = trnn._tf32x3_lstm_step(*targs, terms=terms)
    assert all(t.dtype == torch.float32 for t in got)
    dead = args[-1][:, 0] == 0
    assert dead.any()
    masked_exact = all(np.array_equal(g.numpy()[dead], s[dead])
                       for g, s in zip(got, (args[1], args[2])))
    return [_excess(g.numpy(), np.asarray(wt), bd) for g, wt, bd in
            zip(got, want, _lstm_bounds(*targs))], masked_exact


@pytest.mark.parametrize("jax_impl", ["interpret", "ref"])
@pytest.mark.parametrize("x_dtype,m_dtype", STEP_DTYPES)
@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_tf32x3_lstm_step_matches_jax(shape, x_dtype, m_dtype, jax_impl):
    """``_tf32x3_lstm_step`` against the JAX package's ``_lstm_pallas``
    under the interpreter and ``_lstm_step_ref``, at every (x, mask) dtype
    pair of the kernel's instances and at ragged B and H: h' and c' within
    the derived bounds, masked rows h and c bit for bit."""
    excess, masked_exact = _lstm_excess(shape, x_dtype, m_dtype, jax_impl)
    assert max(excess) <= 1.0, excess
    assert masked_exact


@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_one_tf32_product_fails_the_lstm_bound(shape):
    """``terms=1`` (the product one TF32 product, hi . hi) fails the
    derived bounds against the Pallas interpreter on every shape."""
    assert max(_lstm_excess(shape, "float32", "float32", "interpret",
                            terms=1)[0]) > 1.0


# ------------------------------------------------ routes, splits, bounds
def test_cpu_routes_keep_the_plain_versions(monkeypatch):
    """On CPU tensors ``matmul_stats``, ``conv1x1_stats``, ``gru_step``
    and ``lstm_step`` take the plain versions bit for bit and never reach
    a kernel wrapper or the 3xTF32 arithmetic."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU route reached a kernel's path")

    for mod, name in ((tcb, "matmul_stats_cuda"),
                      (tcb, "_tf32x3_matmul_stats"),
                      (trnn, "gru_step_cuda"), (trnn, "_tf32x3_gru_step"),
                      (trnn, "lstm_step_cuda"),
                      (trnn, "_tf32x3_lstm_step")):
        monkeypatch.setattr(mod, name, refuse)
    x, w = (torch.from_numpy(a) for a in _mm_inputs(33, 12, 20))
    for impl in (None, "pallas", "xla"):
        for a, b in zip(tcb.matmul_stats(x, w, impl),
                        tcb._matmul_stats_ref(x, w)):
            assert torch.equal(a, b)
    for a, b in zip(tcb.conv1x1_stats(x.reshape(3, 11, 1, 12),
                                      w.reshape(1, 1, 12, 20)),
                    tcb._matmul_stats_ref(x, w)):
        assert torch.equal(a.reshape(b.shape), b)
    args = _gru_torch(_gru_inputs(9, 24), "float32", "float32")
    for impl in (None, "torch"):
        assert torch.equal(trnn.gru_step(*args, impl=impl),
                           trnn._gru_step_ref(*args))
    args = _lstm_torch(_lstm_inputs(9, 24), "float32", "float32")
    for impl in (None, "torch"):
        for a, b in zip(trnn.lstm_step(*args, impl=impl),
                        trnn._lstm_step_ref(*args)):
            assert torch.equal(a, b)
    assert tcb.matmul_stats_cuda is refuse


@pytest.mark.parametrize("h", [512, 128, 7, 1024, 160, 37])
def test_gru_splits_take_whole_slices(h):
    """The recurrent kernels' split of K (``_splits``, the GRU's two
    launches and the LSTM's one): no split takes more than RNN_MAX_SLICES
    32-deep slices (the kernels' shared memory holds that much of a W
    panel), as few splits as that allows, and none is empty (the kernel
    gives each ceil(slices / splits) slices, the last the rest); at H 512,
    4 splits."""
    slices = -(-h // trnn.RNN_SLICE)
    splits = trnn._splits(h)
    per = -(-slices // splits)
    assert 1 <= per <= trnn.RNN_MAX_SLICES
    assert splits == -(-slices // trnn.RNN_MAX_SLICES)
    assert (splits - 1) * per < slices <= splits * per
    if h == 512:
        assert splits == 4


@pytest.mark.parametrize("b,h", [(128, 512), (256, 512), (5, 37),
                                 (133, 40), (8, 1024)])
def test_lstm_grid_covers_every_unit_once(b, h):
    """The LSTM kernel's grid (``_lstm_grid``): its tiles cover every
    (row, hidden unit) once, 128 rows by LSTM_UNITS units, each tile with
    the four gates' columns of its units (a tile's 4 LSTM_UNITS product
    columns: gate n // LSTM_UNITS of unit u0 + n % LSTM_UNITS), K as
    ``_splits``; at the route's B 128, H 512, 128 blocks, one wave of the
    H100's 132 SMs."""
    tiles, splits = trnn._lstm_grid(b, h)
    assert splits == trnn._splits(h)
    n_col = -(-h // trnn.LSTM_UNITS)
    assert tiles == -(-b // trnn.RNN_ROWS) * n_col
    seen = np.zeros((b, 4 * h), np.int64)
    for tile in range(tiles):
        m0 = tile // n_col * trnn.RNN_ROWS
        u0 = tile % n_col * trnn.LSTM_UNITS
        for n in range(4 * trnn.LSTM_UNITS):
            u = u0 + n % trnn.LSTM_UNITS
            if u < h:
                seen[m0:m0 + trnn.RNN_ROWS, n // trnn.LSTM_UNITS * h + u] += 1
    assert (seen == 1).all()
    if (b, h) == (128, 512):
        assert tiles * splits == 128


def test_bounds_at_the_tf32_peak():
    """The bounds of kernels 8, 6 and 5 at float32: three TF32 products at
    the 495 TFLOP/s dense TF32 peak (165 TFLOP/s of float32 work), beside
    the bytes at 3.35 TB/s.  Kernel 8 at ResNet-50's res2 expand
    ([401408, 64] x [64, 256], batch 128): 13.15 GFLOP, 0.080 ms of
    operations against 0.514 GB, 0.153 ms of bytes (y 0.411 GB of it):
    bound by bytes; one step's 30 launches (7 at res2, bound by bytes, and
    23 bound by operations) 2.815 ms, their operations alone 2.332 ms.
    Kernel 6 at B 256, H 512 with 180 live rows: 0.283 GFLOP (0.0017 ms as
    three TF32 products) against 5.77 MB (0.0017 ms): 0.0017 ms, bound by
    bytes; the FMA floor 0.0042.  Kernel 5 at B 128, H 512 with 89 live
    rows: 0.187 GFLOP (0.0011 ms as three TF32 products) against 6.30 MB
    (0.0019 ms): bound by bytes; the FMA floor 0.0028."""
    from paddle_tpu_torch.tools import timing

    assert timing.PEAK_TF32_FLOPS == 495e12
    p, ci, co = 128 * 56 * 56, 64, 256
    prod = 2.0 * p * ci * co
    nbytes = 4.0 * (p * ci + ci * co + p * co) + 8.0 * co
    assert prod == pytest.approx(13.15e9, rel=1e-3)
    assert nbytes == pytest.approx(0.514e9, rel=1e-3)
    assert 4.0 * p * co == pytest.approx(0.411e9, rel=1e-3)
    assert round(3 * prod / timing.PEAK_TF32_FLOPS * 1e3, 3) == 0.080
    ms, by = timing.bound(3 * prod, nbytes, timing.PEAK_TF32_FLOPS)
    assert (round(ms, 3), by) == (0.153, "bytes")
    # ResNet-50 v1's fused 1x1 stride-1 convs at batch 128: (hw, Ci, Co,
    # launches): each stage's reduce and expand convs, res2's first reduce
    # and its stride-1 projection
    step = ops = 0.0
    launches = 0
    for hw, c_in, c_out, n in ((56, 64, 64, 1), (56, 256, 64, 2),
                               (56, 64, 256, 4), (28, 512, 128, 3),
                               (28, 128, 512, 4), (14, 1024, 256, 5),
                               (14, 256, 1024, 6), (7, 2048, 512, 2),
                               (7, 512, 2048, 3)):
        p = 128 * hw * hw
        prod = 2.0 * p * c_in * c_out
        nbytes = 4.0 * (p * c_in + c_in * c_out + p * c_out) + 8.0 * c_out
        ms, by = timing.bound(3 * prod, nbytes, timing.PEAK_TF32_FLOPS)
        assert by == ("bytes" if hw == 56 else "operations")
        step += n * ms
        ops += n * 3 * prod / timing.PEAK_TF32_FLOPS * 1e3
        launches += n
    assert launches == 30
    assert (round(step, 3), round(ops, 3)) == (2.815, 2.332)
    b, h, live = 256, 512, 180
    flops = 2.0 * live * h * 3 * h
    nbytes = 4.0 * (b * 3 * h + 2 * b * h + 3 * h * h + 3 * h + b)
    assert flops == pytest.approx(0.283e9, rel=1e-3)
    assert nbytes == pytest.approx(5.77e6, rel=1e-3)
    ms, by = timing.bound(3 * flops, nbytes, timing.PEAK_TF32_FLOPS)
    assert (round(ms, 4), by) == (0.0017, "bytes")
    assert round(timing.bound(flops, nbytes)[0], 4) == 0.0042
    b, h, live = 128, 512, 89
    flops = 2.0 * live * h * 4 * h
    nbytes = 4.0 * (b * 4 * h + 4 * b * h + 4 * h * h + 4 * h + b)
    assert flops == pytest.approx(0.187e9, rel=2e-3)
    assert nbytes == pytest.approx(6.30e6, rel=1e-3)
    assert round(3 * flops / timing.PEAK_TF32_FLOPS * 1e3, 4) == 0.0011
    ms, by = timing.bound(3 * flops, nbytes, timing.PEAK_TF32_FLOPS)
    assert (round(ms, 4), by) == (0.0019, "bytes")
    assert round(timing.bound(flops, nbytes)[0], 4) == 0.0028
