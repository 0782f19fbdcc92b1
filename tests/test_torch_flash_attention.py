"""Flash attention forward of the PyTorch port (paddle_tpu_torch/ops/
flash_attention.py) against the JAX package: the port's plain version
(``_torch_attention``, ``flash_attention(impl="torch")`` and the CPU route of
``impl=None``) on the same numpy-seeded inputs as JAX ``impl="xla"`` and the
Pallas kernel under the interpreter (``impl="interpret"``).  Float32
throughout; tolerance 1e-5, the float32 rounding of two sums taken in a
different order."""

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

    return [np.asarray(g) for g in
            jax.grad(f, argnums=(0, 1, 2))(*_grad_inputs(case))]


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


def _bf16_grad_inputs(case):
    """``_grad_inputs`` rounded once to bf16, as float32 numpy arrays."""
    import jax.numpy as jnp

    return [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in _grad_inputs(case)]


def _bf16_jax(case, impl):
    """O, LSE and dQ, dK, dV of the JAX package on the bf16 inputs,
    through ``impl`` ("xla" or "interpret": ``_flash_bwd`` under the
    Pallas interpreter), the objective taken on O upcast to float32."""
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

    args = [jnp.asarray(a, jnp.bfloat16) for a in _bf16_grad_inputs(case)]
    out, lse = run(*args)
    grads = jax.grad(f, argnums=(0, 1, 2))(*args)
    assert all(g.dtype == jnp.bfloat16 for g in grads)
    return ([np.asarray(out.astype(jnp.float32)), np.asarray(lse)]
            + [np.asarray(g.astype(jnp.float32)) for g in grads])


def _bf16_torch(case, attention):
    """The same through the port's ``attention`` (``_torch_attention`` or
    ``_torch_attention_upcast``) with its autograd."""
    _, _, _, causal, lens, q_off, kv_off, loss, with_lse = GRAD_CASES[case]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
               for a in _bf16_grad_inputs(case))
    kv_lens = torch.as_tensor(
        lens if lens is not None else [k.shape[1]] * k.shape[0],
        dtype=torch.int32)
    out, lse = attention(q, k, v, kv_lens, causal=causal,
                         scale=q.shape[-1] ** -0.5, q_offset=q_off,
                         kv_offset=kv_off, return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    of = out.float()
    obj = (of ** 2).sum() if loss == "square" else torch.sin(of).sum()
    if with_lse:
        obj = obj + torch.tanh(lse).sum()
    grads = torch.autograd.grad(obj, (q, k, v))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    return ([of.detach().numpy(), lse.detach().numpy()]
            + [g.float().numpy() for g in grads])


def _assert_bf16_close(got, want, what):
    assert np.abs(got - want).max() <= BF16_ELEM * max(
        1.0, np.abs(want).max()), what
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    norms = np.linalg.norm(w, axis=1)
    live = norms > 0
    rel = np.linalg.norm(g - w, axis=1)[live] / norms[live]
    assert rel.max(initial=0.0) <= BF16_ROW, (what, rel.max())


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


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_bf16_upcast_reference_matches_pallas_interpret(case):
    """``_torch_attention_upcast``, the yardstick of the bf16 kernels on
    the card, against the JAX package's Pallas forward and ``_flash_bwd``
    under the interpreter at bf16 (causal, kv_lens, both offsets and an
    LSE cotangent among the cases), within the bf16 limits above."""
    got = _bf16_torch(case, tfa._torch_attention_upcast)
    want = _bf16_jax(case, "interpret")
    for name, g, w in zip(("O", "LSE", "dQ", "dK", "dV"), got, want):
        if name == "LSE":
            _assert_lse_close(g, w)
        else:
            _assert_bf16_close(g, w, f"{case} {name}")
    lens = GRAD_CASES[case][4]
    for b, n in enumerate(lens or ()):
        # masked KV rows receive exactly zero gradient
        assert not got[3][b, n:].any() and not got[4][b, n:].any()


def test_upcast_reference_is_the_float32_path_at_float32():
    """At float32 the upcast reference computes what the plain version
    computes: O, LSE and gradients within float32 rounding."""
    case = "lse_cotangent"
    want = _torch_grads(case, impl="torch")
    _, _, _, causal, lens, q_off, kv_off, _, _ = GRAD_CASES[case]
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _grad_inputs(case))
    kv_lens = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32)
    out, lse = tfa._torch_attention_upcast(
        q, k, v, kv_lens, causal=causal, scale=q.shape[-1] ** -0.5,
        return_lse=True)
    obj = (out ** 2).sum() + torch.tanh(lse).sum()
    for g, w in zip(torch.autograd.grad(obj, (q, k, v)), want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
