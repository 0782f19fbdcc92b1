"""The long-sequence claim of the port's attention, on the CPU.

The JAX package windows its flash calls past 32768 rows (VMEM): the dK/dV
kernel's q rows over several calls (``_DKDV_MAX_ROWS``) and the KV rows
merged by the ring's logaddexp fold (``_KV_MAX_ROWS``).  The port's
kernels stream from device memory and window nothing.  Here both caps are
forced far below the test length, as tests/test_flash_attention.py's
``test_bwd_q_windowing_matches_oracle`` and
``test_kv_windowing_matches_oracle`` force them, and the JAX package's
windowed Pallas kernels (under the interpreter) are held against the
port's unwindowed ``flash_attention`` from the same inputs: the output,
the LSE and the gradients of q, k and v, causal and with ``kv_lens``,
within 2e-4 absolute and relative (those tests' limit against the same
computation unwindowed).
"""

import importlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.flash_attention import flash_attention

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, b, length, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, length, h, d)).astype(np.float32)
            for _ in range(3)]


def _port(q, k, v, lens, causal, with_lse):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o, lse = flash_attention(tq, tk, tv, causal=causal, kv_lens=lens,
                             return_lse=True)
    loss = (o ** 2).sum()
    if with_lse:
        loss = loss + torch.where(torch.isfinite(lse), lse,
                                  torch.zeros_like(lse)).sum()
    loss.backward()
    return (float(loss), o.detach().numpy(), lse.detach().numpy(),
            [t.grad.numpy() for t in (tq, tk, tv)])


def _jax(fa_mod, q, k, v, lens, causal, with_lse):
    import jax
    import jax.numpy as jnp

    def f(q, k, v):
        o, lse = fa_mod.flash_attention(
            q, k, v, causal=causal, kv_lens=lens, impl="interpret",
            block_q=16, block_k=16, return_lse=True)
        loss = (o.astype(jnp.float32) ** 2).sum()
        if with_lse:
            loss = loss + jnp.where(jnp.isfinite(lse), lse, 0.0).sum()
        return loss, (o, lse)

    (loss, (o, lse)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return (float(loss), np.asarray(o), np.asarray(lse),
            [np.asarray(g) for g in grads])


@pytest.mark.parametrize("window", ["dkdv_q_rows", "kv_rows"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_unwindowed_port_matches_the_windowed_jax_kernels(monkeypatch,
                                                          window, causal):
    fa_mod = importlib.import_module("paddle_tpu.ops.flash_attention")
    if window == "dkdv_q_rows":
        monkeypatch.setattr(fa_mod, "_DKDV_MAX_ROWS", 16)
        b, length, lens, seed = 2, 72, [72, 50], 11
    else:
        monkeypatch.setattr(fa_mod, "_KV_MAX_ROWS", 32)
        b, length, lens, seed = 2, 80, [80, 40], 12
    q, k, v = _inputs(seed, b, length, 2, 8)
    lens = np.array(lens, np.int32)
    with_lse = window == "kv_rows"
    jl, jo, jlse, jg = _jax(fa_mod, q, k, v, lens, causal, with_lse)
    tl, to, tlse, tg = _port(q, k, v, lens, causal, with_lse)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(to, jo, **TOL)
    assert tlse.shape == jlse.shape
    np.testing.assert_allclose(tlse, jlse, **TOL)
    for name, a, want in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, want, err_msg=f"d{name}", **TOL)
