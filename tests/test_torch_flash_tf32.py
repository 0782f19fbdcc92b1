"""The float32 flash backward kernels' arithmetic (split TF32, "3xTF32":
``_tf32x3_bwd`` of paddle_tpu_torch/ops/flash_attention.py, what
``flash_bwd_{dkdv,dq}_tf32_kernel`` of ``csrc/flash_bwd.cu`` compute) on
the CPU: its TF32 rounding bit for bit against a numpy reference, its
split, its gradients against the JAX package's Pallas backward under the
interpreter within a bound derived below, the planted fault (one TF32
product) failing that bound and the card's row limit, the small LM on
the kernel route with the backward kernels stood in for by it, the
bounds at the TF32 peak, and the CPU route, which stays on the plain
version.

The bound.  With u = 2^-22 (hi + lo is x within u |x|, and lo_a . lo_b
is within u |a||b|), each product a . b taken as lo_a . hi_b + hi_a .
lo_b + hi_a . hi_b is within E = 3u of |a||b| (the products of TF32
parts are exact in float32).  So S is within E M_s of the exact scores,
M_s = |Q||K|^T, and dP within E M_dp, M_dp = |dO||V|^T; P = exp(S scale
- LSE) moves by at most P (exp(E scale M_s) - 1) =: dP_P; dS = P (dP -
delta) by at most dP_P |dP - delta| + P E M_dp =: dP_dS; then
  |dV error| <= sum_q (dP_P + E P) |dO|,
  |dQ error| <= scale sum_k (dP_dS + E |dS|) |K|,
  |dK error| <= scale sum_q (dP_dS + E |dS|) |Q|,
elementwise, plus the float32 rounding of sums taken in another order on
either side, 1e-5 + 1e-5 |want| (the limit the float32 plain version is
held to against the same JAX routes in tests/test_torch_flash_attention.py).
Readings: at most 0.093 of that limit over the GRAD_CASES geometries and
0.28 on the planted-fault case; one TF32 product (``terms=1``) 47x to
116x of it on that case's gradients.
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the gradient cases and the JAX routes of the float32 flash tests
flash_tests = _load("_flash_attention_cases",
                    os.path.join(HERE, "test_torch_flash_attention.py"))
GRAD_CASES = flash_tests.GRAD_CASES

U = 2.0 ** -22                 # the split's unit
E = 3 * U                      # one product's relative error, 3xTF32
F32_TOL = dict(atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ the rounding
def _rna_reference(x: np.ndarray) -> np.ndarray:
    """TF32 rounding worked out value by value in float64: the value's
    TF32 unit (2^(e - 10) for an exponent e, 2^-136 below float32's
    normal range), |x| / unit rounded half away from zero, times the
    unit, inf past the largest float32; inf, NaN (its bits as they were)
    and zeros as they are."""
    out = x.copy()
    with np.errstate(invalid="ignore"):          # signalling NaNs
        wide = x.astype(np.float64)
    for i, v in enumerate(wide):
        if not np.isfinite(v) or v == 0:
            continue
        _, e2 = np.frexp(abs(v))                 # |v| = m 2^e2, m in [.5, 1)
        unit = 2.0 ** (max(e2 - 1, -126) - 10)
        r = np.floor(abs(v) / unit + 0.5) * unit
        out[i] = (np.float32(np.copysign(r, v)) if r < 2.0 ** 128
                  else np.float32(np.copysign(np.inf, v)))
    return out


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_tf32_rounding_is_the_bit_level_reference():
    """``_tf32_rna`` (``cvt.rna.tf32.f32`` on the bit pattern) against
    ``_rna_reference`` bit for bit: ties (away from zero, both signs),
    subnormals and their ties, the largest finite values (rounding up to
    inf or not), inf, NaNs with payloads, signed zeros and 20,000 random
    bit patterns (every exponent, NaNs among them)."""
    one = np.float32(1.0)
    special = [1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11),
               -(1 + 5 * 2.0 ** -11), 1 + 2.0 ** -11 + 2.0 ** -23,
               1 + 2.0 ** -11 - 2.0 ** -23, 3.0, -0.1, 1e-40, -1e-40,
               2.0 ** -137, 3 * 2.0 ** -137, 2.0 ** -149, -2.0 ** -149,
               2.0 ** -126 - 2.0 ** -149, 2.0 ** -126, 65504.0, 1e30,
               np.inf, -np.inf, 0.0, -0.0]
    x = np.asarray(special, np.float32)
    extra = np.array([0x7F7FFFFF, 0x7F7FEFFF, 0x7F7FF000, 0xFF7FFFFF,
                      0x7FC00000, 0x7F800001, 0xFFC00001, 0x7FFFFFFF],
                     np.uint32).view(np.float32)
    rand = np.random.RandomState(0).randint(
        0, 2 ** 32, 20_000, dtype=np.uint64).astype(np.uint32).view(
            np.float32)
    x = np.concatenate([x, extra, rand, one[None]])
    got = tfa._tf32_rna(torch.from_numpy(x)).numpy()
    want = _rna_reference(x)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    finite = np.isfinite(got)
    assert not (_bits(got)[finite] & 0x1FFF).any()
    # ties go away from zero
    assert got[0] == 1 + 2.0 ** -10 and got[2] == -(1 + 2.0 ** -10)
    assert got[1] == 1 + 2.0 ** -9 and got[3] == -(1 + 3 * 2.0 ** -10)


def test_tf32_split_reconstructs_x():
    """hi + lo is x within 2^-22 of |x| over float32's normal range away
    from its ends, both parts TF32 (13 low bits zero), and hi is x's TF32
    rounding."""
    rng = np.random.RandomState(1)
    x = (rng.randn(50_000) * 2.0 ** rng.randint(-100, 100, 50_000)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    hi, lo = tfa._tf32_split(xt)
    for part in (hi, lo):
        assert not (_bits(part.numpy()) & 0x1FFF).any()
    assert torch.equal(hi, tfa._tf32_rna(xt))
    err = np.abs(hi.double().numpy() + lo.double().numpy()
                 - x.astype(np.float64))
    assert (err <= U * np.abs(x.astype(np.float64))).all(), (
        (err / np.abs(x)).max())


# ----------------------------------------- the arithmetic against Pallas
class _Tf32Attention(tfa._UpcastAttention):
    """The float32 kernel route's arithmetic in plain torch: the float32
    forward, the 3xTF32 backward (``_tf32x3_bwd`` with ``terms``).  Each
    backward records the derived bound of its gradients in ``bounds``."""

    terms = 3
    bounds = []

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, kv_lens, o, lse = ctx.saved_tensors
        g = torch.zeros_like(o) if g is None else g
        _Tf32Attention.bounds.append(_derived_bound(
            q, k, v, kv_lens, o, lse, g, g_lse, **ctx.args))
        return (*tfa._tf32x3_bwd(q, k, v, kv_lens, o, lse, g, g_lse,
                                 terms=_Tf32Attention.terms, **ctx.args),
                None, None, None, None, None)


def _tf32_attention(q, k, v, kv_lens, *, causal, scale, q_offset=0,
                    kv_offset=0, return_lse=False):
    o, lse = _Tf32Attention.apply(q, k, v, kv_lens, causal, scale, q_offset,
                                  kv_offset)
    return (o, lse) if return_lse else o


def _derived_bound(q, k, v, kv_lens, o, lse, g, g_lse, *, causal, scale,
                   q_offset=0, kv_offset=0):
    """The bound of the module docstring, elementwise, float64: [dQ, dK,
    dV] as numpy arrays."""
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    mask = tfa._visible(q.shape[1], k.shape[1], kv_lens, causal, q_offset,
                        kv_offset, q.device)
    ein = torch.einsum
    m_s = ein("bqhd,bkhd->bhqk", qd.abs(), kd.abs())
    m_dp = ein("bqhd,bkhd->bhqk", gd.abs(), vd.abs())
    s = ein("bqhd,bkhd->bhqk", qd, kd) * scale
    p = torch.exp(s - lse.double()[..., None]).masked_fill(~mask, 0.0)
    delta = (gd * o.double()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.double()
    dp_minus = ein("bqhd,bkhd->bhqk", gd, vd) - delta[..., None]
    ds = p * dp_minus
    err_p = p * torch.expm1(E * scale * m_s)
    err_ds = (err_p * dp_minus.abs() + p * E * m_dp).masked_fill(~mask, 0.0)
    return [(ein("bhqk,bkhd->bqhd", err_ds + E * ds.abs(), kd.abs())
             * scale).numpy(),
            (ein("bhqk,bqhd->bkhd", err_ds + E * ds.abs(), qd.abs())
             * scale).numpy(),
            ein("bhqk,bqhd->bkhd", err_p + E * p, gd.abs()).numpy()]


def _torch_grads(case, terms=3):
    """dQ, dK, dV of the case's loss through ``_tf32_attention`` and the
    bounds its backward derived."""
    _, _, _, causal, lens, q_off, kv_off, loss, with_lse = GRAD_CASES[case]
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in flash_tests._grad_inputs(case))
    kv_lens = torch.as_tensor(lens or [k.shape[1]] * q.shape[0],
                              dtype=torch.int32)
    _Tf32Attention.terms = terms
    _Tf32Attention.bounds.clear()
    try:
        out, lse = _tf32_attention(q, k, v, kv_lens, causal=causal,
                                   scale=q.shape[-1] ** -0.5,
                                   q_offset=q_off, kv_offset=kv_off,
                                   return_lse=True)
        obj = (out ** 2).sum() if loss == "square" else torch.sin(out).sum()
        if with_lse:
            obj = obj + torch.tanh(lse).sum()
        grads = [g.numpy() for g in torch.autograd.grad(obj, (q, k, v))]
    finally:
        _Tf32Attention.terms = 3
    (bounds,) = _Tf32Attention.bounds
    return grads, bounds


def _excess(got, want, bound) -> float:
    """The largest |got - want| over its limit: bound + 1e-5 + 1e-5
    |want|."""
    limit = bound + F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(want)
    return float((np.abs(got - want) / limit).max())


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_tf32x3_backward_matches_pallas_interpret(case):
    """``_tf32x3_bwd`` (through the float32 forward) against ``jax.grad``
    through the JAX package's Pallas kernels under the interpreter, at
    float32, on the cases of ``test_flash_grads_match_jax`` (causal,
    kv_lens with junk past each length, cross, offset, the LSE
    cotangent): every element of dQ, dK and dV within the derived bound;
    masked KV rows get exactly zero gradient."""
    got, bounds = _torch_grads(case)
    want = flash_tests._jax_grads(case, "interpret")
    for name, g, w, b in zip(("dQ", "dK", "dV"), got, want, bounds):
        assert _excess(g, w, b) <= 1.0, (case, name, _excess(g, w, b))
    lens = GRAD_CASES[case][4]
    for b, n in enumerate(lens or ()):
        assert not got[1][b, n:].any() and not got[2][b, n:].any()


def test_one_tf32_product_fails_the_bound():
    """The planted fault of the card's check: ``terms=1`` (every product
    one TF32 product, hi . hi) fails the derived bound on every gradient,
    on inputs where the intact ``_tf32x3_bwd`` holds it: a head of 64 so
    each product sums enough terms to show TF32's 2^-11."""
    case = "tf32_fault"
    GRAD_CASES[case] = ((1, 48, 2, 64), (1, 48, 2, 64), 1.0, True, None, 0,
                        0, "square", False)
    flash_tests._JAX_BLOCKS.setdefault("tf32", 16)
    try:
        want = flash_tests._jax_grads(case, "interpret")
        got, bounds = _torch_grads(case)
        bad, _ = _torch_grads(case, terms=1)
    finally:
        del GRAD_CASES[case]
    for name, g, x, w, b in zip(("dQ", "dK", "dV"), got, bad, want, bounds):
        assert _excess(g, w, b) <= 1.0, (name, _excess(g, w, b))
        assert _excess(x, w, b) > 1.0, (name, _excess(x, w, b))


def _bwd64(q, k, v, kv_lens, o, lse, g, *, causal, scale):
    """The backward in float64 (the same masks and delta), no rounding
    of the kernels' kind: the exact side of the row readings."""
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    mask = tfa._visible(q.shape[1], k.shape[1], kv_lens, causal, 0, 0,
                        q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    p = torch.exp(s - lse.double()[..., None]).masked_fill(~mask, 0.0)
    delta = (gd * o.double()).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gd, vd) - delta[..., None])
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kd) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, qd) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, gd))


def test_one_tf32_product_fails_the_row_limit():
    """Where the card's row limit comes from (chip_smoke.py's
    TF32_ROW_Q99_TOL): at [2, 256, 2, 128], causal, random normal inputs,
    each gradient row's error against the float64 backward over its norm
    (floored at 2^-7 of the median row norm, as ``_row_errs`` does).
    ``_tf32x3_bwd``'s 99th percentile sits at or below 2^-19 and one TF32
    product's at or above 2^-12, so the card's 2^-16 lies eight times
    clear of each (readings: 3xTF32 at most 1.10e-6, one product 7.3e-4
    at the least)."""
    smoke = _load("_chip_smoke_tf32",
                  os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    rng = np.random.RandomState(5)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 256, 2, 128).astype(
        np.float32)) for _ in range(4))
    lens = torch.full((2,), 256, dtype=torch.int32)
    kw = dict(causal=True, scale=128 ** -0.5)
    o, lse = tfa._torch_attention(q, k, v, lens, return_lse=True, **kw)
    exact = _bwd64(q, k, v, lens, o, lse, g, **kw)

    def q99(a, ref):
        norms = torch.linalg.vector_norm(ref, dim=-1)
        floor = smoke.TF32_ROW_TOL * norms.median().item()
        rows = (torch.linalg.vector_norm(a.double() - ref, dim=-1)
                / norms.clamp_min(floor)).flatten()
        return torch.quantile(rows, smoke.BWD_MMA_ROW_Q).item()

    for terms, lo, hi in ((3, 0.0, 2.0 ** -19), (1, 2.0 ** -12, 1.0)):
        got = tfa._tf32x3_bwd(q, k, v, lens, o, lse, g, terms=terms, **kw)
        for name, a, r in zip(("dQ", "dK", "dV"), got, exact):
            assert lo <= q99(a, r) <= hi, (terms, name, q99(a, r))
    assert 8 * 2.0 ** -19 <= smoke.TF32_ROW_Q99_TOL <= 2.0 ** -12 / 8


# ------------------------------------------------- the slice as a whole
def test_lm_fp32_kernel_route_with_tf32x3_backward_matches_jax_pallas(
        monkeypatch):
    """The small LM of tests/test_torch_training.py (2 layers, 2 heads of
    16, T 12, a padded feed) under the default ``fp32`` policy on the
    port's kernel route (``_FlashAttention``), kernel 1 stood in for by
    the float32 plain forward and both backward kernels by
    ``_tf32x3_bwd``, against the JAX package on its Pallas kernels under
    the interpreter: logits, loss and every parameter gradient within
    1e-5, as the plain route is held."""
    import jax

    training = _load("_torch_training_cases",
                     os.path.join(HERE, "test_torch_training.py"))
    calls = []

    def fwd(q, k, v, kv_lens, *, causal, scale, q_offset=0, kv_offset=0):
        calls.append(("fwd", q.dtype))
        return tfa._torch_attention_upcast(
            q, k, v, kv_lens, causal=causal, scale=scale, q_offset=q_offset,
            kv_offset=kv_offset, return_lse=True)

    def bwd(which):
        def run(q, k, v, g, lse, delta, kv_lens, **kw):
            calls.append((which, g.dtype))
            # O = 0 and g_lse = -delta: _tf32x3_bwd's delta is the wrapper's
            dq, dk, dv = tfa._tf32x3_bwd(q, k, v, kv_lens, torch.zeros_like(q),
                                         lse, g, -delta, **kw)
            return dq if which == "dq" else (dk, dv)
        return run

    monkeypatch.setattr(jfa, "default_impl", lambda: "interpret")
    monkeypatch.setattr(tfa, "resolve_impl", lambda impl, t: "cuda")
    monkeypatch.setattr(tfa, "flash_fwd_cuda", fwd)
    monkeypatch.setattr(tfa, "flash_bwd_dq_cuda", bwd("dq"))
    monkeypatch.setattr(tfa, "flash_bwd_dkdv_cuda", bwd("dkdv"))
    ttopo, jtopo = training._lm_both(**training.SMALL)
    jparams = training.pj.parameters.create(jtopo)
    tparams = training._cross(jparams, ttopo)
    feed = training._feed(True)

    def jloss(values):
        outs, _ = jtopo.forward(values, {}, feed, train=True,
                                outputs=["cost", "logits"])
        return outs["cost"], outs["logits"]

    (jcost, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams.values)
    tr = training.pt.trainer.SGD(ttopo, tparams,
                                 training.pt.optimizer.Adam())
    tcost, tgrads = tr.forward_backward(feed)
    np.testing.assert_allclose(float(tcost), float(jcost), **F32_TOL)
    assert sorted(tgrads) == sorted(jgrads)
    for lname, ps in tgrads.items():
        for pname, g in ps.items():
            np.testing.assert_allclose(
                g.numpy(), np.asarray(jgrads[lname][pname]), atol=1e-5,
                rtol=0, err_msg=f"{lname}.{pname}")
    assert {c for c in calls} == {("fwd", torch.float32),
                                  ("dq", torch.float32),
                                  ("dkdv", torch.float32)}
    assert calls.count(("dq", torch.float32)) == training.SMALL["num_layers"]


# ------------------------------------------------ bounds and the routes
def test_bounds_at_the_tf32_peak():
    """The pair's bounds at the LM's training shape [8, 4096, 4, 128],
    causal: three TF32 products at the 495 TFLOP/s dense TF32 peak, 1.666
    ms for dK/dV (274.9 GFLOP) and 1.250 ms for dQ (206.2), against the
    FMA floors 4.104 and 3.078 ms at 67 TFLOP/s; both bound by
    operations."""
    from paddle_tpu_torch.tools import timing

    b, t, h, d = 8, 4096, 4, 128
    pairs = b * h * t * (t + 1) // 2
    row, vec = 4.0 * b * t * h * d, 4.0 * b * h * t
    work = {"dkdv": (8.0 * d * pairs, 6 * row + 2 * vec + 4 * b),
            "dq": (6.0 * d * pairs, 5 * row + 2 * vec + 4 * b)}
    assert work["dkdv"][0] == pytest.approx(274.9e9, rel=1e-3)
    assert work["dq"][0] == pytest.approx(206.2e9, rel=1e-3)
    assert timing.PEAK_TF32_FLOPS == 495e12
    for name, tf32_ms, fma_ms in (("dkdv", 1.666, 4.104),
                                  ("dq", 1.250, 3.078)):
        flops, nbytes = work[name]
        ms, by = timing.bound(3 * flops, nbytes, timing.PEAK_TF32_FLOPS)
        assert (round(ms, 3), by) == (tf32_ms, "operations")
        ms, by = timing.bound(flops, nbytes)
        assert (round(ms, 3), by) == (fma_ms, "operations")


def test_cpu_route_keeps_the_plain_backward(monkeypatch):
    """On CPU tensors ``flash_attention`` at float32 differentiates the
    plain version by autograd, bit for bit, and never reaches a kernel
    wrapper or the 3xTF32 arithmetic."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU route reached a kernel's path")

    for name in ("flash_fwd_cuda", "flash_bwd_dq_cuda",
                 "flash_bwd_dkdv_cuda", "_tf32x3_bwd"):
        monkeypatch.setattr(tfa, name, refuse)
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 20, 2, 8).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    out = tfa.flash_attention(q, k, v, causal=True, kv_lens=[20, 11])
    got = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    lens = torch.tensor([20, 11], dtype=torch.int32)
    ref_out = tfa._torch_attention(q, k, v, lens, causal=True,
                                   scale=8 ** -0.5)
    want = torch.autograd.grad((ref_out ** 2).sum(), (q, k, v))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
