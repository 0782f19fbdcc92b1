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
