"""Flash attention backward of the PyTorch port at bf16 and float16
against the JAX package: the upcast reference against the Pallas
backward under the interpreter, the tensor-core backward kernels'
arithmetic (``_mma_bwd``) held to its roundings' bounds, a planted
k-step fault that those bounds catch, and the kernel route's autograd
with the tensor-core backward.  The cases, inputs, limits and helpers are
``test_torch_flash_attention.py``'s (the forward, the float32 backward
and the bf16 plain backward stay there); the two files are one suite,
split so that the runner can spread it."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as tfa
from test_torch_flash_attention import (
    GRAD_CASES,
    HALF,
    TOL,
    _MmaAttention,
    _assert_bf16_close,
    _assert_lse_close,
    _assert_mma_close,
    _assert_mma_matches_pallas,
    _bf16_jax,
    _bf16_torch,
    _grad_inputs,
    _half_params,
    _kstep_case,
    _mma_attention,
    _mma_wrappers,
    _torch_grads)


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


@pytest.mark.parametrize("case,dt", _half_params(sorted(GRAD_CASES)))
def test_bf16_mma_backward_matches_pallas_interpret(case, dt):
    """``_mma_bwd``, the arithmetic of the tensor-core backward kernels'
    bf16 (and float16) instances (P and dS rounded to the operands' dtype
    before the three gradient products), against the JAX package's Pallas
    forward and ``_flash_bwd`` under the interpreter on the same bf16
    (float16) inputs, within the rounding model's bound at that dtype's
    unit; masked KV rows get exactly zero gradient."""
    _MmaAttention.terms.clear()
    got = _bf16_torch(case, _mma_attention, dt)
    (terms,) = _MmaAttention.terms
    _assert_mma_matches_pallas(got, _bf16_jax(case, "interpret", dt), terms,
                               case, dt)
    lens = GRAD_CASES[case][4]
    for b, n in enumerate(lens or ()):
        assert not got[3][b, n:].any() and not got[4][b, n:].any()


@pytest.mark.parametrize("dt", list(HALF))
def test_mma_backward_planted_kstep_fault_fails_the_limits(dt):
    """The planted fault of the card's check: ``_mma_bwd`` with one
    16-deep k-step of the score product left out fails the bound against
    the Pallas interpreter on every gradient, on inputs the intact
    version holds, at bf16 and at float16."""
    got, terms, want = _kstep_case(None, dt)
    for name, g, w, m in zip(("dQ", "dK", "dV"), got, want, terms):
        _assert_mma_close(g, w, m, name, dt)
    bad, _, _ = _kstep_case(1, dt)
    for name, g, w, m in zip(("dQ", "dK", "dV"), bad, want, terms):
        with pytest.raises(AssertionError):
            _assert_mma_close(g, w, m, name, dt)


@pytest.mark.parametrize("case", ["grads_causal", "kv_lens_causal",
                                  "cross_37x21_causal", "offset_q_ahead",
                                  "offset_fully_masked", "lse_cotangent"])
def test_bf16_kernel_route_with_mma_backward_matches_pallas(case,
                                                            monkeypatch):
    """The kernel route's wiring at bf16 (``_FlashAttention``: bf16 q, k,
    v and dO with a float32 delta into both backward launches), the
    kernels stood in for by their plain versions with the tensor-core
    backward's arithmetic, against the JAX package under the Pallas
    interpreter at bf16, within the rounding model's bound."""
    calls, terms = [], []
    fwd, dq, dkdv = _mma_wrappers(calls, terms)
    monkeypatch.setattr(tfa, "resolve_impl", lambda impl, t: "cuda")
    monkeypatch.setattr(tfa, "flash_fwd_cuda", fwd)
    monkeypatch.setattr(tfa, "flash_bwd_dq_cuda", dq)
    monkeypatch.setattr(tfa, "flash_bwd_dkdv_cuda", dkdv)

    def route(q, k, v, kv_lens, **kw):
        return tfa.flash_attention(q, k, v, kv_lens=kv_lens, **kw)

    got = _bf16_torch(case, route)
    assert calls == ["fwd", "dq", "dkdv"]
    _assert_mma_matches_pallas(got, _bf16_jax(case, "interpret"), terms[0],
                               case)
