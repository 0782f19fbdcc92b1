"""The float32 forward kernels' arithmetic on the tensor cores (split TF32,
"3xTF32") on the CPU: ``_tf32x3_fwd`` of paddle_tpu_torch/ops/
flash_attention.py (what ``flash_fwd_tf32_kernel`` of ``csrc/flash_fwd.cu``
computes, kernel 1) and ``_tf32x3_conv3x3_stats`` of ops/conv_bn.py (what
``conv3x3_tf32_stats_kernel`` of ``csrc/conv_bn.cu`` computes, kernel 9),
each against the JAX package's Pallas kernel under the interpreter (and,
for the conv, its "xla" route) within a bound derived below; the planted
fault (one TF32 product, ``terms=1``) failing each bound; the CPU routes
of both wrappers, which stay on the plain versions; the bounds at the
TF32 peak.

The bounds.  With u = 2^-22 (hi + lo is x within u |x|, and lo_a . lo_b
is within u |a||b|), each product a . b taken as lo_a . hi_b + hi_a .
lo_b + hi_a . hi_b is within E = 3u of |a||b| (the products of TF32 parts
are exact in float32).

Kernel 1.  Both sides scale q by scale * log2(e) in float32 first, so S
(log2 domain) is within E M_s of the exact scores, M_s = |q s| |K|^T.  A
row whose scores all move by at most Delta = E max_k M_s (over the keys it
sees) has each weight w_k = p_k / l move by at most w_k (2^(2 Delta) - 1),
its numerator and its normaliser each by a factor within 2^(+-Delta); P V
adds E sum_k w_k |v_k|.  So, elementwise,
  |O error| <= (2^(2 Delta) - 1 + E) sum_k w_k |v_k|,
  |LSE error| <= Delta ln 2,
plus the float32 rounding of sums taken in another order on either side,
1e-5 + 1e-5 |want| (the limit the float32 plain version is held to against
the same routes in tests/test_torch_flash_attention.py).

Kernel 9.  y = A W over the im2col patches, each of its 9 Ci products
within E |a||w|: |y error| <= E (|A| |W|), elementwise; the statistics,
summed from that y, |sum y error| <= sum_p |y error| and |sum y^2 error|
<= sum_p (2 |y| |y error| + |y error|^2), each plus the same float32
allowance.

Readings: ``_tf32x3_fwd`` at most 0.025 of its limit on O and 0.018 on
the LSE over the cases, one TF32 product 26x to 40x on O;
``_tf32x3_conv3x3_stats`` at most 0.065 (y and both sums, against both
JAX routes), one TF32 product 67x to 97x on y.
"""

import importlib

import numpy as np
import pytest
import torch

from paddle_tpu.ops import conv_bn as jcb
from paddle_tpu_torch.core.config import LOG2E, NEG_INF
from paddle_tpu_torch.ops import conv_bn as tcb
from paddle_tpu_torch.ops import flash_attention as tfa

# the JAX package's ops/__init__ re-exports the function under the module's
# name, so the module itself comes from importlib
jfa = importlib.import_module("paddle_tpu.ops.flash_attention")

U = 2.0 ** -22                 # the split's unit
E = 3 * U                      # one product's relative error, 3xTF32
F32_TOL = dict(atol=1e-5, rtol=1e-5)
B, H = 2, 2

# tests/test_torch_flash_attention.py's geometries at its head width (D 8),
# then the kernel's other head tile (D 64) and a head narrower than its
# tile (D 100): name -> (lq, lk, causal, kv_lens, q_offset, kv_offset, D)
FWD_CASES = {
    "causal": (24, 24, True, None, 0, 0, 8),
    "noncausal": (24, 24, False, None, 0, 0, 8),
    "kv_lens": (24, 24, True, [24, 13], 0, 0, 8),
    "kv_lens_noncausal": (16, 24, False, [9, 24], 0, 0, 8),
    "offset_chunk_longer_cache": (8, 40, True, None, 20, 0, 8),
    "q_and_kv_offset": (16, 24, True, None, 16, 8, 8),
    "fully_masked_rows": (8, 16, True, None, 0, 5, 8),
    "d64_kv_lens": (24, 40, True, [40, 17], 0, 0, 64),
    "d100_noncausal": (16, 36, False, [36, 11], 0, 0, 100),
}


def _fwd_inputs(case):
    lq, lk, *_, d = FWD_CASES[case]
    rng = np.random.RandomState(sorted(FWD_CASES).index(case))
    return (rng.randn(B, lq, H, d).astype(np.float32),
            rng.randn(B, lk, H, d).astype(np.float32),
            rng.randn(B, lk, H, d).astype(np.float32))


def _pallas_fwd(case, arrs):
    """O and LSE of the JAX package's Pallas forward (``_flash_fwd``)
    under the interpreter, at float32."""
    _, _, causal, lens, q_off, kv_off, _ = FWD_CASES[case]
    o, lse = jfa.flash_attention(*arrs, causal=causal, kv_lens=lens,
                                 q_offset=q_off, kv_offset=kv_off,
                                 return_lse=True, impl="interpret")
    return np.asarray(o), np.asarray(lse)


def _fwd_bound(q, k, v, kv_lens, *, causal, scale, q_offset, kv_offset):
    """The module docstring's bounds, float64: O's [B, Lq, H, D] and the
    LSE's [B, H, Lq]."""
    qs = (q.float() * (scale * LOG2E)).double()
    kd, vd = k.double(), v.double()
    mask = tfa._visible(q.shape[1], k.shape[1], kv_lens, causal, q_offset,
                        kv_offset, q.device)
    m_s = torch.einsum("bqhd,bkhd->bhqk", qs.abs(), kd.abs())
    delta = E * m_s.masked_fill(~mask, 0.0).amax(dim=-1)        # [B,H,Lq]
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kd).masked_fill(~mask, NEG_INF)
    w = torch.softmax(s * np.log(2.0), dim=-1).masked_fill(~mask, 0.0)
    wv = torch.einsum("bhqk,bkhd->bqhd", w, vd.abs())
    grow = (torch.exp2(2 * delta) - 1 + E).transpose(1, 2)[..., None]
    return (grow * wv).numpy(), (delta * np.log(2.0)).numpy()


def _excess(got, want, bound) -> float:
    """The largest |got - want| over its limit: bound + 1e-5 + 1e-5
    |want|."""
    limit = bound + F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(want)
    return float((np.abs(got - want) / limit).max())


def _fwd_excess(case, terms=3, block_k=32):
    """(O's, the LSE's) excess of ``_tf32x3_fwd`` over its bound against
    the Pallas interpreter; the LSE on the rows that see a key."""
    arrs = _fwd_inputs(case)
    want_o, want_l = _pallas_fwd(case, arrs)
    lq, lk, causal, lens, q_off, kv_off, d = FWD_CASES[case]
    q, k, v = (torch.from_numpy(a) for a in arrs)
    kv_lens = torch.as_tensor(lens or [lk] * B, dtype=torch.int32)
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=q_off,
              kv_offset=kv_off)
    o, lse = tfa._tf32x3_fwd(q, k, v, kv_lens, block_k=block_k, terms=terms,
                             **kw)
    assert o.dtype == lse.dtype == torch.float32
    b_o, b_l = _fwd_bound(q, k, v, kv_lens, **kw)
    live = want_l > -1e29
    assert (lse.numpy()[~live] < -1e29).all()
    return (_excess(o.numpy(), want_o, b_o),
            _excess(lse.numpy()[live], want_l[live], b_l[live]))


@pytest.mark.parametrize("block_k", [32, 8])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_tf32x3_forward_matches_pallas_interpret(case, block_k):
    """``_tf32x3_fwd`` against the JAX package's Pallas forward under the
    interpreter at float32 (causal, kv_lens, both offsets, rows that see
    no key, D 64, D 100): O and the LSE within the derived bounds, at the
    kernel's 32-key sub-tiles and at 8 (so that the running max and the
    rescale of earlier tiles run); rows that see no key give O = 0."""
    e_o, e_l = _fwd_excess(case, block_k=block_k)
    assert e_o <= 1.0 and e_l <= 1.0, (case, e_o, e_l)
    if case == "fully_masked_rows":
        q, k, v = (torch.from_numpy(a) for a in _fwd_inputs(case))
        o, _ = tfa._tf32x3_fwd(q, k, v, torch.full((B,), 16,
                                                   dtype=torch.int32),
                               causal=True, scale=8 ** -0.5, kv_offset=5)
        assert not o[:, :5].any()


@pytest.mark.parametrize("case", ["causal", "kv_lens", "q_and_kv_offset",
                                  "d64_kv_lens", "d100_noncausal"])
def test_one_tf32_product_fails_the_forward_bound(case):
    """The planted fault of the card's check: ``terms=1`` (both products
    one TF32 product, hi . hi) fails O's derived bound where the intact
    arithmetic holds it."""
    assert _fwd_excess(case)[0] <= 1.0
    assert _fwd_excess(case, terms=1)[0] > 1.0


# ------------------------------------------------------------ kernel 9
# small NHWC shapes, Ci and Co of 8 to 24, ragged among them (not
# multiples of 4: the kernel's one-float copies)
CONV_SHAPES = [((2, 8, 5, 8), 16), ((1, 6, 7, 12), 24), ((2, 4, 9, 13), 11),
               ((1, 7, 4, 24), 8)]


def _conv_inputs(shape, co):
    rng = np.random.default_rng(shape[1] * 31 + co)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], co)) * 0.3).astype(np.float32)
    return x, w


def _conv_bounds(x4, w4, y):
    """The module docstring's bounds, float64: y's [N, H, W, Co], sum y's
    and sum y^2's [Co]."""
    b_y = E * tcb.conv2d_nhwc(x4.double().abs(), w4.double().abs(),
                              padding=(1, 1))
    yd = y.double().abs()
    return [b_y.numpy(), b_y.sum(dim=(0, 1, 2)).numpy(),
            (2 * yd * b_y + b_y ** 2).sum(dim=(0, 1, 2)).numpy()]


def _conv_excess(shape, co, jax_impl, terms=3):
    """Each of (y, sum y, sum y^2)'s excess over its bound against the JAX
    package's ``jax_impl`` route."""
    import jax.numpy as jnp

    x, w = _conv_inputs(shape, co)
    if jax_impl == "interpret":
        want = jcb.conv3x3_stats_fwd(jnp.asarray(x), jnp.asarray(w),
                                     interpret=True)
    else:
        want = jcb.conv3x3_stats(jnp.asarray(x), jnp.asarray(w), "xla")
    x4, w4 = torch.from_numpy(x), torch.from_numpy(w)
    got = tcb._tf32x3_conv3x3_stats(x4, w4, terms=terms)
    bounds = _conv_bounds(x4, w4, got[0])
    return [_excess(g.numpy(), np.asarray(wt), b)
            for g, wt, b in zip(got, want, bounds)]


@pytest.mark.parametrize("jax_impl", ["interpret", "xla"])
@pytest.mark.parametrize("shape,co", CONV_SHAPES)
def test_tf32x3_conv3x3_matches_jax(shape, co, jax_impl):
    """``_tf32x3_conv3x3_stats`` against the JAX package's
    ``conv3x3_stats_fwd`` under the Pallas interpreter and its "xla"
    route: y and both sums within the derived bounds."""
    for name, e in zip(("y", "sum y", "sum y^2"),
                       _conv_excess(shape, co, jax_impl)):
        assert e <= 1.0, (name, e)


@pytest.mark.parametrize("shape,co", CONV_SHAPES)
def test_one_tf32_product_fails_the_conv_bound(shape, co):
    """``terms=1`` (one TF32 product, hi . hi) fails y's derived bound
    against the Pallas interpreter on every shape."""
    assert _conv_excess(shape, co, "interpret", terms=1)[0] > 1.0


# ------------------------------------------------ the routes and bounds
def test_cpu_routes_keep_the_plain_versions(monkeypatch):
    """On CPU tensors ``flash_attention`` and ``conv3x3_stats`` at float32
    take the plain versions bit for bit and never reach a kernel wrapper
    or the 3xTF32 arithmetic."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU route reached a kernel's path")

    for mod, name in ((tfa, "flash_fwd_cuda"), (tfa, "_tf32x3_fwd"),
                      (tcb, "conv3x3_stats_cuda"),
                      (tcb, "_tf32x3_conv3x3_stats")):
        monkeypatch.setattr(mod, name, refuse)
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(2, 20, 2, 8).astype(np.float32))
               for _ in range(3))
    got = tfa.flash_attention(q, k, v, causal=True, kv_lens=[20, 11],
                              return_lse=True)
    want = tfa._torch_attention(q, k, v, torch.tensor([20, 11],
                                                      dtype=torch.int32),
                                causal=True, scale=8 ** -0.5,
                                return_lse=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    x, w = (torch.from_numpy(a) for a in _conv_inputs((2, 5, 6, 9), 10))
    for a, b in zip(tcb.conv3x3_stats(x, w), tcb._conv3x3_stats_ref(x, w)):
        assert torch.equal(a, b)
    for impl in ("pallas", "xla"):
        for a, b in zip(tcb.conv3x3_stats(x, w, impl),
                        tcb._conv3x3_stats_ref(x, w)):
            assert torch.equal(a, b)


def test_bounds_at_the_tf32_peak():
    """The float32 kernels' bounds: three TF32 products at the 495 TFLOP/s
    dense TF32 peak (165 TFLOP/s of float32 work) beside the FMA floor at
    67.  Kernel 1 at the LM's training shape [8, 4096, 4, 128], causal:
    137.5 GFLOP, 0.833 ms (FMA floor 2.052); at the serving chunk of 2048
    rows over a 4096-key cache (B 1, 4 heads): 4.30 GFLOP, 0.026 ms.
    Kernel 9 at ResNet-50's res2 [128, 56, 56, 64] -> 64: 29.6 GFLOP,
    0.179 ms against 0.061 ms of bytes; one step's 16 launches (3, 4, 6, 3
    at res2 to res5, each 29.6 GFLOP): 2.870 ms.  All bound by
    operations."""
    from paddle_tpu_torch.tools import timing

    assert timing.PEAK_TF32_FLOPS == 495e12
    b, t, h, d = 8, 4096, 4, 128
    flops = 4.0 * d * b * h * t * (t + 1) // 2
    nbytes = 4.0 * (4 * b * t * h * d + b * h * t + b)
    assert flops == pytest.approx(137.5e9, rel=1e-3)
    assert timing.bound(3 * flops, nbytes, timing.PEAK_TF32_FLOPS) == (
        pytest.approx(0.833, abs=5e-4), "operations")
    assert round(timing.bound(flops, nbytes)[0], 3) == 2.052
    pairs = 2048 * 2049 // 2
    flops = 4.0 * d * h * pairs
    nbytes = 4.0 * (2 * 2048 * h * d + 2 * 2048 * h * d + h * 2048 + 1)
    assert flops == pytest.approx(4.30e9, rel=1e-3)
    ms, by = timing.bound(3 * flops, nbytes, timing.PEAK_TF32_FLOPS)
    assert (round(ms, 3), by) == (0.026, "operations")
    step = 0.0
    for hw, c, count in ((56, 64, 3), (28, 128, 4), (14, 256, 6),
                         (7, 512, 3)):
        p = 128 * hw * hw
        prod = 2.0 * p * 9 * c * c
        nbytes = 4.0 * (2 * p * c + 9 * c * c) + 8.0 * c
        assert prod == pytest.approx(29.6e9, rel=1e-3)
        ms, by = timing.bound(3 * prod, nbytes, timing.PEAK_TF32_FLOPS)
        assert by == "operations"
        if hw == 56:
            assert round(ms, 3) == 0.179
            assert round(nbytes / timing.PEAK_BYTES * 1e3, 3) == 0.061
        step += count * ms
    assert round(step, 3) == 2.870
