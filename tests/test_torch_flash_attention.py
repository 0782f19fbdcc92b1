"""Flash attention forward of the PyTorch port (paddle_tpu_torch/ops/
flash_attention.py) against the JAX package: the port's plain version
(``_torch_attention``, ``flash_attention(impl="torch")`` and the CPU route of
``impl=None``) on the same numpy-seeded inputs as JAX ``impl="xla"`` and the
Pallas kernel under the interpreter (``impl="interpret"``).  Float32
throughout; tolerance 1e-5, the float32 rounding of two sums taken in a
different order.  Then the backward (float32, then the two bf16
semantics, each with its limits), and the tensor-core bf16 kernels'
arithmetic (``_mma_fwd``, ``_mma_bwd``) held to their roundings'
bounds."""

import functools
import importlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.config import NEG_INF
from paddle_tpu_torch.ops import flash_attention as tfa

# the JAX package's ops/__init__ re-exports the function under the module's
# name, so the module itself comes from importlib
jfa = importlib.import_module("paddle_tpu.ops.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)
B, H, D = 2, 2, 8

# geometry -> (lq, lk, causal, kv_lens, q_offset, kv_offset)
CASES = {
    "causal": (24, 24, True, None, 0, 0),
    "noncausal": (24, 24, False, None, 0, 0),
    "kv_lens": (24, 24, True, [24, 13], 0, 0),
    "kv_lens_noncausal": (16, 24, False, [9, 24], 0, 0),
    "offset_chunk_longer_cache": (8, 40, True, None, 20, 0),
    "q_and_kv_offset": (16, 24, True, None, 16, 8),
    "fully_masked_rows": (8, 16, True, None, 0, 5),
}


def _inputs(lq, lk, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, lq, H, D).astype(np.float32),
            rng.randn(B, lk, H, D).astype(np.float32),
            rng.randn(B, lk, H, D).astype(np.float32))


def _assert_lse_close(got, want):
    """Rows that see no key carry a sentinel LSE (-1e30 on the plain path,
    NEG_INF/LOG2E + log(1e-30) in the kernel): compare the rows that see
    a key, and require the others to stay below -1e29 on both sides."""
    got, want = np.asarray(got), np.asarray(want)
    dead = want < -1e29
    assert (got[dead] < -1e29).all()
    np.testing.assert_allclose(got[~dead], want[~dead], **TOL)


@pytest.mark.parametrize("jimpl", ["xla", "interpret"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_jax(case, jimpl):
    lq, lk, causal, kv_lens, q_off, kv_off = CASES[case]
    q, k, v = _inputs(lq, lk, seed=len(case))
    jo, jl = jfa.flash_attention(q, k, v, causal=causal, kv_lens=kv_lens,
                                 q_offset=q_off, kv_offset=kv_off,
                                 return_lse=True, impl=jimpl)
    to, tl = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 kv_lens=kv_lens, q_offset=q_off,
                                 kv_offset=kv_off, return_lse=True,
                                 impl="torch")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _assert_lse_close(tl.numpy(), jl)
    if case == "fully_masked_rows":
        # q rows 0..4 see no key (kv_offset 5 > q position): O = 0
        assert np.abs(to.numpy()[:, :kv_off - q_off]).max() == 0.0


def test_torch_attention_is_the_xla_reference():
    """``_torch_attention`` itself against ``_xla_attention``, with an
    explicit scale, kv_lens and both offsets."""
    q, k, v = _inputs(12, 20, seed=5)
    lens = np.array([20, 7], np.int32)
    jo, jl = jfa._xla_attention(q, k, v, lens, causal=True, scale=0.3,
                                q_offset=10, kv_offset=2, return_lse=True)
    to, tl = tfa._torch_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), causal=True, scale=0.3, q_offset=10,
        kv_offset=2, return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _assert_lse_close(tl.numpy(), jl)


def test_cpu_tensors_route_to_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(8, 8, seed=2))
    lens = torch.full((B,), 8, dtype=torch.int32)
    want = tfa._torch_attention(q, k, v, lens, causal=True, scale=D ** -0.5)
    before = tfa.flash_fwd_cuda.launches
    got = tfa.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, want)
    assert tfa.flash_fwd_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        tfa.flash_attention(q, k, v, impl="pallas")


def test_kernel_wrapper_refuses_what_it_cannot_take():
    """Shape, head-width and dtype checks fire before any build."""
    q = torch.zeros(1, 4, 1, 132)
    lens = torch.full((1,), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_fwd_cuda(q, q, q, lens, causal=True, scale=1.0)
    q = torch.zeros(1, 4, 1, 8, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        tfa.flash_fwd_cuda(q, q, q, lens, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_fwd_cuda(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 1, 8),
                           torch.zeros(1, 4, 1, 8), lens, causal=True,
                           scale=1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_partial_matches_jax(seed):
    """The logaddexp fold of two partial results, including a partial
    whose rows saw nothing (sentinel LSE: merge weight 0)."""
    rng = np.random.RandomState(seed)
    o1 = rng.randn(2, 5, 3, 8).astype(np.float32)
    o2 = rng.randn(2, 5, 3, 8).astype(np.float32)
    l1 = rng.randn(2, 3, 5).astype(np.float32)
    l2 = rng.randn(2, 3, 5).astype(np.float32)
    l2[:, :, 0] = NEG_INF
    jo, jl = jfa.merge_partial(o1, l1, o2, l2)
    to, tl = tfa.merge_partial(*(torch.from_numpy(a)
                                 for a in (o1, l1, o2, l2)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


# ------------------------------------------------------------ the backward
# The gradient cases of tests/test_flash_attention.py, one case each:
# name -> (shape of q, shape of k/v, input scale, causal, kv_lens,
#          q_offset, kv_offset, loss, LSE term)
GRAD_CASES = {
    "grads_noncausal": ((1, 32, 2, 8), (1, 32, 2, 8), 1.0, False, None, 0,
                        0, "square", False),
    "grads_causal": ((1, 32, 2, 8), (1, 32, 2, 8), 1.0, True, None, 0, 0,
                     "square", False),
    "kv_lens_noncausal": ((3, 24, 2, 8), (3, 24, 2, 8), 1.0, False,
                          [24, 10, 17], 0, 0, "square", False),
    "kv_lens_causal": ((3, 24, 2, 8), (3, 24, 2, 8), 1.0, True,
                       [24, 10, 17], 0, 0, "square", False),
    "cross_40x8": ((2, 40, 2, 8), (2, 8, 2, 8), 1.0, False, None, 0, 0,
                   "sin", False),
    "cross_40x8_causal": ((2, 40, 2, 8), (2, 8, 2, 8), 1.0, True, None, 0,
                          0, "sin", False),
    "cross_8x40": ((2, 8, 2, 8), (2, 40, 2, 8), 1.0, False, None, 0, 0,
                   "sin", False),
    "cross_8x40_causal": ((2, 8, 2, 8), (2, 40, 2, 8), 1.0, True, None, 0,
                          0, "sin", False),
    "cross_37x21": ((2, 37, 2, 8), (2, 21, 2, 8), 1.0, False, None, 0, 0,
                    "sin", False),
    "cross_37x21_causal": ((2, 37, 2, 8), (2, 21, 2, 8), 1.0, True, None,
                           0, 0, "sin", False),
    "offset_kv_ahead": ((1, 64, 2, 8), (1, 32, 2, 8), 0.5, True, None, 0,
                        32, "sin", False),
    "offset_q_ahead": ((1, 64, 2, 8), (1, 32, 2, 8), 0.5, True, None, 32, 0,
                       "sin", False),
    "offset_aligned": ((1, 64, 2, 8), (1, 32, 2, 8), 0.5, True, None, 24,
                       24, "sin", False),
    "offset_fully_masked": ((1, 64, 2, 8), (1, 32, 2, 8), 0.5, True, None,
                            0, 200, "sin", False),
    "lse_cotangent": ((2, 16, 2, 8), (2, 16, 2, 8), 0.4, True, None, 0, 0,
                      "square", True),
}
# JAX block sizes of each source test (the kernel's tiling, not the math)
_JAX_BLOCKS = {"grads": 16, "kv_lens": 8, "cross": 16, "offset": 8,
               "lse": 8}


def _grad_inputs(case):
    qs, ks, mul, _, lens, *_ = GRAD_CASES[case]
    rng = np.random.RandomState(sorted(GRAD_CASES).index(case))
    q, k, v = ((rng.randn(*s) * mul).astype(np.float32)
               for s in (qs, ks, ks))
    if lens is not None:
        # junk past each row's length must stay invisible
        for b, n in enumerate(lens):
            k[b, n:] = 77.0
            v[b, n:] = -55.0
    return q, k, v


def _jax_grads(case, impl):
    import jax
    import jax.numpy as jnp

    _, _, _, causal, lens, q_off, kv_off, loss, with_lse = GRAD_CASES[case]
    blk = next(b for p, b in _JAX_BLOCKS.items() if case.startswith(p))

    def f(q, k, v):
        out, lse = jfa.flash_attention(
            q, k, v, causal=causal, kv_lens=lens, impl=impl, block_q=blk,
            block_k=blk, q_offset=q_off, kv_offset=kv_off, return_lse=True)
        obj = jnp.sum(out ** 2) if loss == "square" else jnp.sum(
            jnp.sin(out))
        return obj + jnp.sum(jnp.tanh(lse)) if with_lse else obj

    # jitted: one compile of the forward and both backward kernels
    return [np.asarray(g) for g in
            jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*_grad_inputs(case))]


def _torch_grads(case, **kw):
    _, _, _, causal, lens, q_off, kv_off, loss, with_lse = GRAD_CASES[case]
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _grad_inputs(case))
    out, lse = tfa.flash_attention(q, k, v, causal=causal, kv_lens=lens,
                                   q_offset=q_off, kv_offset=kv_off,
                                   return_lse=True, **kw)
    obj = (out ** 2).sum() if loss == "square" else torch.sin(out).sum()
    if with_lse:
        obj = obj + torch.tanh(lse).sum()
    return [g.numpy() for g in torch.autograd.grad(obj, (q, k, v))]


@pytest.mark.parametrize("jimpl", ["xla", "interpret"])
@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_flash_grads_match_jax(case, jimpl):
    """dQ, dK, dV of the port's CPU route (autograd through the plain
    version) against ``jax.grad`` through the JAX package's xla path and
    its Pallas kernels under the interpreter, at 1e-5."""
    want = _jax_grads(case, jimpl)
    got = _torch_grads(case)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    lens = GRAD_CASES[case][4]
    for b, n in enumerate(lens or ()):
        # masked KV rows receive exactly zero gradient
        assert not got[1][b, n:].any() and not got[2][b, n:].any()


def _kernel_math_fwd(q, k, v, kv_lens, *, causal, scale, q_offset=0,
                     kv_offset=0):
    """What csrc/flash_fwd.cu returns, from the plain version."""
    return tfa._torch_attention(q, k, v, kv_lens, causal=causal, scale=scale,
                                q_offset=q_offset, kv_offset=kv_offset,
                                return_lse=True)


def _kernel_math_p(q, k, lse, kv_lens, causal, scale, q_offset, kv_offset):
    """P as the backward kernels recompute it from q, k and the LSE, under
    the same mask: [B, H, Lq, Lk]."""
    lq, lk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    kpos = torch.arange(lk)
    mask = kpos[None, None, None, :] < kv_lens[:, None, None, None]
    if causal:
        qpos = torch.arange(lq)
        mask = mask & (kv_offset + kpos[None, :]
                       <= q_offset + qpos[:, None])[None, None]
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0)


def _kernel_math_dkdv(q, k, v, g, lse, delta, kv_lens, *, causal, scale,
                      q_offset=0, kv_offset=0):
    p = _kernel_math_p(q, k, lse, kv_lens, causal, scale, q_offset,
                       kv_offset)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    ds = p * (dp - delta[..., None])
    return (torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, g))


def _kernel_math_dq(q, k, v, g, lse, delta, kv_lens, *, causal, scale,
                    q_offset=0, kv_offset=0):
    p = _kernel_math_p(q, k, lse, kv_lens, causal, scale, q_offset,
                       kv_offset)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", g, v) - delta[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale


@pytest.mark.parametrize("case", ["grads_causal", "kv_lens_causal",
                                  "cross_37x21_causal", "offset_q_ahead",
                                  "offset_fully_masked", "lse_cotangent"])
def test_kernel_route_autograd_matches_jax(case, monkeypatch):
    """The kernel route's autograd wiring (``_FlashAttention``: saved
    tensors, delta = rowsum(dO * O) - g_lse, the two backward launches),
    with each kernel replaced by the formula it implements, against
    ``jax.grad`` through the JAX package's xla path, at 1e-5."""
    calls = []

    def spy(fn, name):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfa, "resolve_impl", lambda impl, t: "cuda")
    monkeypatch.setattr(tfa, "flash_fwd_cuda",
                        spy(_kernel_math_fwd, "fwd"))
    monkeypatch.setattr(tfa, "flash_bwd_dkdv_cuda",
                        spy(_kernel_math_dkdv, "dkdv"))
    monkeypatch.setattr(tfa, "flash_bwd_dq_cuda",
                        spy(_kernel_math_dq, "dq"))
    got = _torch_grads(case)
    assert calls == ["fwd", "dq", "dkdv"]
    for g, w in zip(got, _jax_grads(case, "xla")):
        np.testing.assert_allclose(g, w, **TOL)


def test_backward_wrappers_refuse_what_they_cannot_take():
    """The backward wrappers' checks fire before any build."""
    q = torch.zeros(1, 4, 1, 8)
    lse = torch.zeros(1, 1, 4)
    lens = torch.full((1,), 4, dtype=torch.int32)
    kw = dict(causal=True, scale=1.0)
    for fn in (tfa.flash_bwd_dkdv_cuda, tfa.flash_bwd_dq_cuda):
        with pytest.raises(ValueError, match="dO"):
            fn(q, q, q, torch.zeros(1, 5, 1, 8), lse, lse, lens, **kw)
        with pytest.raises(ValueError, match="delta"):
            fn(q, q, q, q, lse, torch.zeros(1, 1, 5), lens, **kw)
        with pytest.raises(TypeError, match="float32"):
            fn(q, q, q, q.double(), lse, lse, lens, **kw)
        with pytest.raises(ValueError, match="head dim"):
            z = torch.zeros(1, 4, 1, 6)
            fn(z, z, z, z, lse, lse, lens, **kw)
    assert tfa.flash_bwd_dkdv_cuda.launches == 0
    assert tfa.flash_bwd_dq_cuda.launches == 0


# ----------------------------------------------------------- bf16 backward
# bf16 limits, set from readings over every GRAD_CASES geometry: each
# gradient element within 2^-8 * max(1, max |ref|) (one bf16 ulp at the
# top of the range; readings 0 to 2.4e-4) and each gradient row within
# 2^-7 of its norm (a row one ulp off in every element; readings 0 to
# 1.7e-3); O within 2^-8 * max(1, max |ref|), the LSE within 1e-5
BF16_ELEM, BF16_ROW = 2.0 ** -8, 2.0 ** -7
# the 16-bit operand types of the tensor-core kernels' tests, by name:
# (torch dtype, element limit, row limit, the rounding model's unit
# below).  float16 keeps 11 significant bits where bf16 keeps 8, so its
# element limit and unit are bf16's over 8; its row limit is bf16's over
# 4, 2^-9: where a row's few terms cancel (D 8), the rounding of P and of
# O, each up to 2^-11 of a term or of the element, reach past 2^-10 of
# the row's norm (readings up to 1.22e-3, in ``_mma_fwd``'s noncausal
# case, which the elementwise model holds at 0.5 of its bound).
HALF = {"bfloat16": (torch.bfloat16, BF16_ELEM, BF16_ROW, 2.0 ** -8),
        "float16": (torch.float16, 2.0 ** -11, 2.0 ** -9, 2.0 ** -11)}


def _half_params(cases):
    """``(case, dt)`` parameters: every case at bf16 under its own id, then
    at float16 under ``f16-<case>``."""
    return ([pytest.param(c, "bfloat16", id=c) for c in cases]
            + [pytest.param(c, "float16", id=f"f16-{c}") for c in cases])


def _bf16_grad_inputs(case, dt="bfloat16"):
    """``_grad_inputs`` rounded once to bf16 (or ``dt``), as float32 numpy
    arrays."""
    import jax.numpy as jnp

    return [np.array(jnp.asarray(a, dt).astype(jnp.float32))
            for a in _grad_inputs(case)]


@functools.lru_cache(maxsize=None)
def _bf16_jax(case, impl, dt="bfloat16"):
    """O, LSE and dQ, dK, dV of the JAX package on the bf16 (``dt``)
    inputs, through ``impl`` ("xla" or "interpret": ``_flash_bwd`` under
    the Pallas interpreter), the objective taken on O upcast to float32.
    Cached: the upcast and tensor-core references share it (callers
    only read the arrays)."""
    import jax
    import jax.numpy as jnp

    _, _, _, causal, lens, q_off, kv_off, loss, with_lse = GRAD_CASES[case]
    blk = next(b for p, b in _JAX_BLOCKS.items() if case.startswith(p))

    def run(q, k, v):
        return jfa.flash_attention(
            q, k, v, causal=causal, kv_lens=lens, impl=impl, block_q=blk,
            block_k=blk, q_offset=q_off, kv_offset=kv_off, return_lse=True)

    def f(q, k, v):
        out, lse = run(q, k, v)
        out = out.astype(jnp.float32)
        obj = jnp.sum(out ** 2) if loss == "square" else jnp.sum(
            jnp.sin(out))
        return obj + jnp.sum(jnp.tanh(lse)) if with_lse else obj

    args = [jnp.asarray(a, dt) for a in _bf16_grad_inputs(case, dt)]
    grad = jax.grad(f, argnums=(0, 1, 2))
    if impl == "interpret":
        # the Pallas kernels jitted: one compile each, not one an op of
        # their interpreted bodies (the xla path stays eager: under jit a
        # fully masked row's dQ at bf16 is another number)
        run, grad = jax.jit(run), jax.jit(grad)
    out, lse = run(*args)
    grads = grad(*args)
    assert all(g.dtype == jnp.dtype(dt) for g in grads)
    return ([np.asarray(out.astype(jnp.float32)), np.asarray(lse)]
            + [np.asarray(g.astype(jnp.float32)) for g in grads])


def _bf16_torch(case, attention, dt="bfloat16"):
    """The same through the port's ``attention`` (``_torch_attention`` or
    ``_torch_attention_upcast``) with its autograd."""
    _, _, _, causal, lens, q_off, kv_off, loss, with_lse = GRAD_CASES[case]
    tdt = HALF[dt][0]
    q, k, v = (torch.from_numpy(a).to(tdt).requires_grad_(True)
               for a in _bf16_grad_inputs(case, dt))
    kv_lens = torch.as_tensor(
        lens if lens is not None else [k.shape[1]] * k.shape[0],
        dtype=torch.int32)
    out, lse = attention(q, k, v, kv_lens, causal=causal,
                         scale=q.shape[-1] ** -0.5, q_offset=q_off,
                         kv_offset=kv_off, return_lse=True)
    assert out.dtype == tdt and lse.dtype == torch.float32
    of = out.float()
    obj = (of ** 2).sum() if loss == "square" else torch.sin(of).sum()
    if with_lse:
        obj = obj + torch.tanh(lse).sum()
    grads = torch.autograd.grad(obj, (q, k, v))
    assert all(g.dtype == tdt for g in grads)
    return ([of.detach().numpy(), lse.detach().numpy()]
            + [g.float().numpy() for g in grads])


def _assert_bf16_close(got, want, what, dt="bfloat16"):
    assert np.abs(got - want).max() <= HALF[dt][1] * max(
        1.0, np.abs(want).max()), what
    _assert_rows_close(got, want, what, dt)


def _assert_rows_close(got, want, what, dt="bfloat16"):
    """Each row (last axis) within BF16_ROW (``dt``'s row limit) of its
    norm."""
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    norms = np.linalg.norm(w, axis=1)
    live = norms > 0
    rel = np.linalg.norm(g - w, axis=1)[live] / norms[live]
    assert rel.max(initial=0.0) <= HALF[dt][2], (what, rel.max())


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_bf16_plain_backward_matches_jax_xla(case):
    """At bf16, the port's plain route (autograd through
    ``_torch_attention``, P rounded to bf16 before P . V) against
    ``jax.grad`` through ``_xla_attention``: O, the LSE and dQ, dK, dV
    (bf16 both sides), within the bf16 limits above."""
    got, want = _bf16_torch(case, tfa._torch_attention), _bf16_jax(case,
                                                                   "xla")
    for name, g, w in zip(("O", "LSE", "dQ", "dK", "dV"), got, want):
        if name == "LSE":
            _assert_lse_close(g, w)
        else:
            _assert_bf16_close(g, w, f"{case} {name}")


# ------------------------------------------- the tensor-core bf16 backward
# The tensor-core kernels' arithmetic (``_mma_bwd``) rounds P and dS to
# bf16 before dV = P^T dO, dK = dS^T Q and dQ = dS K, where the Pallas
# kernels keep them float32: each term of a gradient element moves by at
# most 2^-8 of itself (bf16's unit roundoff), so the element moves by at
# most 2^-8 of M, the sum of its terms' magnitudes, and each side's one
# rounding of the output adds at most half an ulp, 2^-8 of the element.
# Held against the Pallas interpreter: |got - want| <= 2^-8 (M + 2 |want|)
# + 2^-16 max(1, max |want|) elementwise, the last term the float32
# rounding of dP - delta where the two cancel (a query row that sees one
# key has dS = 0 up to that rounding, on both sides).  Readings: at most
# 0.67 of the limit over GRAD_CASES; the planted k-step fault 220x to
# 240x.  The flat limits
# above do not bound this arithmetic at D 8, where a row's few terms
# cancel: readings up to 1.8x BF16_ELEM and 1.3x BF16_ROW.  At float16
# the same model with f16's unit, 2^-11 (``HALF``), P and dS rounded to
# float16: the tensor-core kernels' float16 instances.
MMA_UNIT, MMA_F32_FLOOR = 2.0 ** -8, 2.0 ** -16


class _MmaAttention(tfa._UpcastAttention):
    """The kernel route's arithmetic at bf16 in plain torch: the Pallas
    forward's (``_torch_attention_upcast``), the backward of the
    tensor-core kernels (``_mma_bwd``).  Each backward records its
    operands' term magnitudes in ``terms``."""

    terms = []

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, kv_lens, o, lse = ctx.saved_tensors
        g = torch.zeros_like(o) if g is None else g
        _MmaAttention.terms.append(_term_magnitudes(
            q, k, v, kv_lens, o, lse, g, g_lse, **ctx.args))
        return (*tfa._mma_bwd(q, k, v, kv_lens, o, lse, g, g_lse,
                              **ctx.args), None, None, None, None, None)


def _mma_attention(q, k, v, kv_lens, *, causal, scale, q_offset=0,
                   kv_offset=0, return_lse=False):
    o, lse = _MmaAttention.apply(q, k, v, kv_lens, causal, scale, q_offset,
                                 kv_offset)
    return (o, lse) if return_lse else o


def _term_magnitudes(q, k, v, kv_lens, o, lse, g, g_lse, *, causal, scale,
                     q_offset=0, kv_offset=0):
    """M of every element of dQ, dK and dV: scale |dS| |K|, scale
    |dS|^T |Q| and P^T |dO|, from the float32 P and dS of the backward."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p, ds = tfa._p_and_ds(qf, kf, vf, gf, kv_lens, o, lse, g_lse, causal,
                          scale, q_offset, kv_offset, qf)
    ds = ds.abs()
    return [torch.einsum("bhqk,bkhd->bqhd", ds, kf.abs()).numpy() * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, qf.abs()).numpy() * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, gf.abs()).numpy()]


def _assert_mma_close(got, want, m, what, dt="bfloat16"):
    limit = (HALF[dt][3] * (m + 2 * np.abs(want))
             + MMA_F32_FLOOR * max(1.0, np.abs(want).max()))
    err = np.abs(got - want)
    assert (err <= limit).all(), (what, (err / limit).max())


def _assert_mma_matches_pallas(got, want, terms, case, dt="bfloat16"):
    """O and the LSE (the forward's) within the bf16 (``dt``) limits
    above; dQ, dK and dV within the rounding model's bound."""
    _assert_bf16_close(got[0], want[0], f"{case} O", dt)
    _assert_lse_close(got[1], want[1])
    for name, g, w, m in zip(("dQ", "dK", "dV"), got[2:], want[2:], terms):
        _assert_mma_close(g, w, m, f"{case} {name}", dt)


@functools.lru_cache(maxsize=None)
def _kstep_jax(dt):
    """``_kstep_case``'s inputs and the JAX package's gradients under the
    interpreter, jitted and computed once a dtype (the intact and the
    faulty case share them)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(7)
    jargs = [jnp.asarray(rng.randn(1, 32, 2, 32), dt) for _ in range(3)]

    def f(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=True, impl="interpret",
                                  block_q=16, block_k=16)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    want = [np.asarray(g.astype(jnp.float32)) for g in
            jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*jargs)]
    return jargs, want


def _kstep_case(drop, dt="bfloat16"):
    """q, k, v [1, 32, 2, 32] bf16 (or ``dt``; two 16-deep k-steps),
    causal: dQ, dK, dV of sum(O^2) through ``_mma_bwd`` with k-step
    ``drop`` of the score product left out (None: none), the term
    magnitudes, and the JAX package's gradients under the interpreter."""
    import jax.numpy as jnp

    jargs, want = _kstep_jax(dt)
    q, k, v = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        HALF[dt][0]) for a in jargs)
    lens = torch.full((1,), 32, dtype=torch.int32)
    kw = dict(causal=True, scale=32 ** -0.5)
    o, lse = tfa._torch_attention_upcast(q, k, v, lens, return_lse=True,
                                         **kw)
    g = (2 * o.float()).to(HALF[dt][0])
    got = tfa._mma_bwd(q, k, v, lens, o, lse, g, drop_score_kstep=drop,
                       **kw)
    terms = _term_magnitudes(q, k, v, lens, o, lse, g, None, **kw)
    return [x.float().numpy() for x in got], terms, want


def _mma_wrappers(calls, terms):
    """Stand-ins for the bf16 kernels with the wrappers' signatures: the
    forward by ``_torch_attention_upcast``, each backward kernel by
    ``_mma_bwd`` (O = 0 and g_lse = -delta make its delta the wrapper's
    delta); the dQ stand-in records the term magnitudes."""
    def fwd(q, k, v, kv_lens, *, causal, scale, q_offset=0, kv_offset=0):
        calls.append("fwd")
        return tfa._torch_attention_upcast(
            q, k, v, kv_lens, causal=causal, scale=scale, q_offset=q_offset,
            kv_offset=kv_offset, return_lse=True)

    def bwd(which):
        def run(q, k, v, g, lse, delta, kv_lens, **kw):
            calls.append(which)
            assert q.dtype == g.dtype and q.dtype in (torch.bfloat16,
                                                      torch.float16)
            assert delta.dtype == torch.float32
            args = (q, k, v, kv_lens, torch.zeros_like(q), lse, g, -delta)
            if which == "dq":
                terms.append(_term_magnitudes(*args, **kw))
            dq, dk, dv = tfa._mma_bwd(*args, **kw)
            return dq if which == "dq" else (dk, dv)
        return run

    return fwd, bwd("dq"), bwd("dkdv")


# -------------------------------------------- the tensor-core bf16 forward
# ``_mma_fwd`` rounds each tile's P to bf16 before O += P V, where the
# Pallas forward keeps it float32: each term p_k v_k / l moves by at most
# 2^-8 of itself, so an element of O by at most 2^-8 of M = sum_k p_k
# |v_k| / l, and each side's one rounding of O adds at most 2^-8 of the
# element.  Held against the Pallas interpreter: each row of O within
# BF16_ROW of its norm, and each element within the model's bound
# (``_assert_mma_close``: 2^-8 (M + 2 |want|) + 2^-16 max(1, max |want|)).
# The flat BF16_ELEM does not bound this arithmetic where an element is
# a few terms that cancel (readings up to 1.47x it at D 8, 1.13x at D
# 32); readings over MMA_FWD_CASES at most 0.65 of the model's bound and
# 0.83 of BF16_ROW; the planted k-step fault 280x and 109x.  The LSE
# is float32 on both sides (l sums the unrounded p), within
# ``_assert_lse_close``'s 1e-5.  Both tiles: the kernel's 64 keys (one
# tile at these sizes) and 8, so that the running max and the rescale of
# earlier tiles run.
MMA_FWD_CASES = dict(CASES, cross_ragged=(37, 21, False, [21, 9], 0, 0))


def _bf16_fwd_inputs(lq, lk, seed, dt="bfloat16"):
    """``_inputs`` rounded once to bf16 (or ``dt``): (numpy float32
    arrays, the same as torch tensors of that dtype)."""
    import jax.numpy as jnp

    arrs = [np.array(jnp.asarray(a, dt).astype(jnp.float32))
            for a in _inputs(lq, lk, seed)]
    return arrs, [torch.from_numpy(a).to(HALF[dt][0]) for a in arrs]


def _pallas_bf16_fwd(arrs, causal, kv_lens, q_off, kv_off, block=8,
                     dt="bfloat16"):
    """O (as float32) and the LSE of the JAX package's Pallas forward
    under the interpreter on bf16 (``dt``) operands."""
    import jax.numpy as jnp

    o, lse = jfa.flash_attention(
        *(jnp.asarray(a, dt) for a in arrs), causal=causal,
        kv_lens=kv_lens, q_offset=q_off, kv_offset=kv_off, block_q=block,
        block_k=block, return_lse=True, impl="interpret")
    assert o.dtype == jnp.dtype(dt)
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


def _fwd_term_magnitudes(q, k, v, kv_lens, *, causal, scale, q_offset=0,
                         kv_offset=0):
    """M = sum_k p_k |v_k| / l of every element of O, [B, Lq, H, D], from
    the float32 probabilities of the upcast operands (0 on rows that see
    no key)."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    mask = tfa._visible(q.shape[1], k.shape[1], kv_lens, causal, q_offset,
                        kv_offset, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), -1).masked_fill(~mask,
                                                                      0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf.abs()).numpy()


def _assert_mma_fwd_close(o, want, m, what, dt="bfloat16"):
    """O (float32 numpy) within BF16_ROW (``dt``'s row limit) per row and
    the rounding model's bound per element."""
    _assert_rows_close(o, want, what, dt)
    _assert_mma_close(o, want, m, what, dt)


@pytest.mark.parametrize("case,dt", _half_params(sorted(MMA_FWD_CASES)))
def test_bf16_mma_forward_matches_pallas_interpret(case, dt):
    """``_mma_fwd``, the arithmetic of the tensor-core forward's bf16 (and
    float16) instance (P rounded to the operands' dtype before P . V, the
    LSE float32), against the JAX package's Pallas forward under the
    interpreter on the same bf16 (float16) inputs: O per row within that
    dtype's row limit of its norm and per element within the rounding
    model's bound, the LSE within 1e-5; rows that see no key give O = 0
    and the sentinel LSE."""
    lq, lk, causal, kv_lens, q_off, kv_off = MMA_FWD_CASES[case]
    arrs, (q, k, v) = _bf16_fwd_inputs(lq, lk, seed=len(case), dt=dt)
    want_o, want_lse = _pallas_bf16_fwd(arrs, causal, kv_lens, q_off,
                                        kv_off, dt=dt)
    lens = torch.as_tensor(kv_lens or [lk] * B, dtype=torch.int32)
    kw = dict(causal=causal, scale=D ** -0.5, q_offset=q_off,
              kv_offset=kv_off)
    m = _fwd_term_magnitudes(q, k, v, lens, **kw)
    for block_k in (64, 8):
        o, lse = tfa._mma_fwd(q, k, v, lens, block_k=block_k, **kw)
        assert o.dtype == HALF[dt][0] and lse.dtype == torch.float32
        _assert_mma_fwd_close(o.float().numpy(), want_o, m,
                              f"{case} O, block_k {block_k}", dt)
        _assert_lse_close(lse.numpy(), want_lse)
    if case == "fully_masked_rows":
        assert not o[:, :kv_off - q_off].float().any()


@pytest.mark.parametrize("dt", list(HALF))
def test_mma_forward_planted_kstep_fault_fails_the_limits(dt):
    """The planted fault of the card's check: ``_mma_fwd`` with one
    16-deep k-step of the score product left out fails the O limits
    against the Pallas interpreter, on inputs the intact version holds
    (q, k, v [1, 32, 2, 32] bf16 or float16: two k-steps)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(7)
    arrs = [np.array(jnp.asarray(rng.randn(1, 32, 2, 32), dt)
                     .astype(jnp.float32)) for _ in range(3)]
    want_o, _ = _pallas_bf16_fwd(arrs, True, None, 0, 0, block=16, dt=dt)
    q, k, v = (torch.from_numpy(a).to(HALF[dt][0]) for a in arrs)
    lens = torch.full((1,), 32, dtype=torch.int32)
    kw = dict(causal=True, scale=32 ** -0.5)
    m = _fwd_term_magnitudes(q, k, v, lens, **kw)
    o, _ = tfa._mma_fwd(q, k, v, lens, **kw)
    _assert_mma_fwd_close(o.float().numpy(), want_o, m, "intact", dt)
    bad, _ = tfa._mma_fwd(q, k, v, lens, drop_score_kstep=1, **kw)
    for check in (functools.partial(_assert_rows_close, dt=dt),
                  functools.partial(_assert_mma_close, m=m, dt=dt)):
        with pytest.raises(AssertionError):
            check(bad.float().numpy(), want_o, what="k-step left out")


@pytest.mark.parametrize("case,dt", _half_params([
    "grads_causal", "kv_lens_causal", "cross_37x21_causal", "offset_q_ahead",
    "offset_fully_masked", "lse_cotangent"]))
def test_bf16_kernel_route_with_mma_forward_matches_pallas(case, dt,
                                                           monkeypatch):
    """The kernel route's wiring at bf16 with all three kernels stood in
    for by the tensor-core arithmetic (the forward by ``_mma_fwd``, both
    backward kernels by ``_mma_bwd``): O within the forward's limits and
    the LSE within 1e-5 of the JAX package under the Pallas interpreter
    at bf16, and dQ, dK, dV those of ``_mma_bwd`` on ``_mma_fwd``'s own O
    and LSE with the objective's cotangents, within 1e-5.  (The
    gradients are held to the Pallas backward by
    ``test_bf16_mma_backward_matches_pallas_interpret``; here O differs
    from the Pallas forward's by the forward's rounding, which reaches
    the gradients through dO and delta, outside that test's bound.)"""
    calls, terms = [], []
    _, dq, dkdv = _mma_wrappers(calls, terms)

    def fwd(q, k, v, kv_lens, **kw):
        calls.append("fwd")
        return tfa._mma_fwd(q, k, v, kv_lens, **kw)

    monkeypatch.setattr(tfa, "resolve_impl", lambda impl, t: "cuda")
    monkeypatch.setattr(tfa, "flash_fwd_cuda", fwd)
    monkeypatch.setattr(tfa, "flash_bwd_dq_cuda", dq)
    monkeypatch.setattr(tfa, "flash_bwd_dkdv_cuda", dkdv)

    def route(q, k, v, kv_lens, **kw):
        return tfa.flash_attention(q, k, v, kv_lens=kv_lens, **kw)

    got = _bf16_torch(case, route, dt)
    assert calls == ["fwd", "dq", "dkdv"]
    want = _bf16_jax(case, "interpret", dt)
    _, _, _, causal, lens, q_off, kv_off, loss, with_lse = GRAD_CASES[case]
    q, k, v = (torch.from_numpy(a).to(HALF[dt][0])
               for a in _bf16_grad_inputs(case, dt))
    kv_lens = torch.as_tensor(lens or [k.shape[1]] * k.shape[0],
                              dtype=torch.int32)
    kw = dict(causal=causal, scale=q.shape[-1] ** -0.5, q_offset=q_off,
              kv_offset=kv_off)
    _assert_mma_fwd_close(got[0], want[0],
                          _fwd_term_magnitudes(q, k, v, kv_lens, **kw),
                          f"{case} O", dt)
    _assert_lse_close(got[1], want[1])
    o, lse = tfa._mma_fwd(q, k, v, kv_lens, **kw)
    of = o.float()
    g = (2 * of if loss == "square" else torch.cos(of)).to(HALF[dt][0])
    g_lse = 1 - torch.tanh(lse) ** 2 if with_lse else None
    for name, a, r in zip(("dQ", "dK", "dV"), got[2:],
                          tfa._mma_bwd(q, k, v, kv_lens, o, lse, g, g_lse,
                                       **kw)):
        np.testing.assert_allclose(a, r.float().numpy(), **TOL,
                                   err_msg=f"{case} {name}")
