"""The forward ablation sweep of the PyTorch port (paddle_tpu_torch/ops/
flash_variants.py, paddle_tpu_torch/tools/flash_variants.py) against the
JAX package's ``tools/flash_variants.py``, and kernel 1 on bf16 operands
against the JAX package's ``flash_attention``.

The JAX tool's Pallas kernels run under the interpreter: the test points
``jax.experimental.pallas.pallas_call`` at ``interpret=True`` for its own
duration.  Inputs are numpy-seeded values rounded to bf16 once, so both
packages see the same bf16 numbers.  Tolerances: O within
2^-6 * max(1, max |ref|) (one bf16 ulp at the largest output and one more
for the order of the sums) and each of its rows within 2^-7 of the row's
norm (a row one ulp off in every element), LSE within
1e-4 * max(1, max |ref|)."""

import functools
import importlib
import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import flash_variants as tfv
from paddle_tpu_torch.tools import flash_variants as ttool

jtool = importlib.import_module("tools.flash_variants")
jfa = importlib.import_module("paddle_tpu.ops.flash_attention")

O_TOL = 2.0 ** -6
O_ROW_TOL = 2.0 ** -7
LSE_TOL = 1e-4

# every flag set run_fwd accepts: bf16_dots x use_exp2 x split_loop, and
# the pipelined kernel (which has all three)
FLAGS = {
    f"{'bf16' if b else 'f32'}{'_exp2' if e else ''}{'_split' if s else ''}":
        dict(bf16_dots=b, use_exp2=e, split_loop=s)
    for b in (False, True) for e in (False, True) for s in (False, True)}
FLAGS["pipelined"] = dict(pipelined=True)

# name -> (B, L, Lk, H, D, block_q, block_k)
GEOMETRIES = {
    "self": (2, 64, 64, 2, 16, 16, 16),
    "cross_longer_kv": (1, 32, 64, 2, 32, 16, 32),
    "cross_longer_q": (1, 64, 32, 2, 32, 32, 16),
}


def _bf16_inputs(b, l, lk, h, d, seed):
    """The same bf16 values as jax arrays and as torch tensors."""
    rng = np.random.RandomState(seed)
    arrs = [jnp.asarray(rng.randn(b, n, h, d).astype(np.float32),
                        jnp.bfloat16) for n in (l, lk, lk)]
    return arrs, [torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in arrs]


def _assert_close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _assert_rows_close(got, want):
    """Each row of O (over its last axis) within O_ROW_TOL of its norm."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = (np.linalg.norm(got - want, axis=-1)
           / np.maximum(np.linalg.norm(want, axis=-1), 1e-30))
    assert err.max() <= O_ROW_TOL, err.max()


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_run_fwd_matches_the_jax_tool(flags, geometry, causal,
                                      interpret_pallas):
    b, l, lk, h, d, bq, bk = GEOMETRIES[geometry]
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(
        b, l, lk, h, d, seed=sorted(GEOMETRIES).index(geometry))
    kw = dict(causal=causal, block_q=bq, block_k=bk, **FLAGS[flags])
    jo, jl = jtool.run_fwd(jq, jk, jv, **kw)
    to, tl = ttool.run_fwd(tq, tk, tv, impl="torch", **kw)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    assert tuple(tl.shape) == (b * h, l, 1)
    _assert_close(to.float().numpy(), jo.astype(jnp.float32), O_TOL)
    _assert_rows_close(to.float().numpy(), jo.astype(jnp.float32))
    _assert_close(tl.numpy(), jl, LSE_TOL)


# kernel 1 on bf16 operands: name -> (lq, lk, causal, kv_lens, q_offset,
# kv_offset)
BF16_CASES = {
    "causal": (32, 32, True, None, 0, 0),
    "noncausal_kv_lens": (24, 32, False, [32, 11], 0, 0),
    "offset_chunk": (16, 48, True, None, 24, 0),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_flash_attention_matches_jax(case):
    """The port's plain route on bf16 q/k/v against the JAX package's xla
    path on the same values (the same algorithm, rounding at the same
    places: within one bf16 ulp of the largest output) and against its
    Pallas kernel under the interpreter, which upcasts before its dots, at
    the JAX package's own bf16 tolerance (0.06, test_bf16_inputs)."""
    lq, lk, causal, kv_lens, q_off, kv_off = BF16_CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(2, lq, lk, 2, 16, seed=7)
    kw = dict(causal=causal, kv_lens=kv_lens, q_offset=q_off,
              kv_offset=kv_off, return_lse=True)
    to, tl = tfa.flash_attention(tq, tk, tv, impl="torch", **kw)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    jo, jl = jfa.flash_attention(jq, jk, jv, impl="xla", **kw)
    _assert_close(to.float().numpy(), jo.astype(jnp.float32), 2.0 ** -7)
    _assert_rows_close(to.float().numpy(), jo.astype(jnp.float32))
    _assert_close(tl.numpy(), jl, LSE_TOL)
    ko = jfa.flash_attention(jq, jk, jv, impl="interpret", block_q=8,
                             block_k=8, **kw)[0]
    assert ko.dtype == jnp.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(ko, np.float32), rtol=0.06,
                               atol=0.06)


def test_variant_wrapper_refuses_before_any_build():
    """dtype, tile, divisibility and device checks fire before a build."""
    q = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    kw = dict(causal=True, block_q=128, block_k=64, bf16_dots=True,
              use_exp2=False, split_loop=False, pipelined=False)
    with pytest.raises(TypeError, match="bfloat16"):
        tfv.run_fwd_cuda(q.float(), q.float(), q.float(), **kw)
    with pytest.raises(ValueError, match="no tensor-core instance"):
        tfv.run_fwd_cuda(q, q, q, **dict(kw, block_q=32))
    with pytest.raises(ValueError, match="no tensor-core instance"):
        tfv.run_fwd_cuda(q, q, q, **dict(kw, block_k=128))   # B at bk 128
    z = torch.zeros(1, 128, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no tensor-core instance"):
        tfv.run_fwd_cuda(z, z, z, **kw)                       # head dim 32
    with pytest.raises(ValueError, match="f32-dot instances"):
        tfv.run_fwd_cuda(q, q, q, **dict(kw, bf16_dots=False))
    with pytest.raises(ValueError, match="block_q"):
        tfv.run_fwd_cuda(q[:, :96], q[:, :96], q[:, :96], **kw)
    with pytest.raises(ValueError, match="block_k"):
        tfv.run_fwd_cuda(q, q[:, :96], q[:, :96], **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tfv.run_fwd_cuda(q, q, q, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        ttool.run_fwd(q, q, q, impl="cuda")
    assert tfv.run_fwd_cuda.launches == 0


def test_kernel_one_takes_bf16_and_refuses_float16():
    """Kernel 1's wrapper takes bf16 (O in q's dtype); float16 and mixed
    dtypes are refused before any build, by the forward and by both
    backward wrappers (whose bf16 instances the precision policy
    brought)."""
    lens = torch.full((1,), 4, dtype=torch.int32)
    q = torch.zeros(1, 4, 1, 8, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        tfa.flash_fwd_cuda(q, q, q, lens, causal=True, scale=1.0)
    b = q.to(torch.bfloat16)
    with pytest.raises(TypeError, match="share a dtype"):
        tfa.flash_fwd_cuda(b, b.float(), b, lens, causal=True, scale=1.0)
    lse = torch.zeros(1, 1, 4)
    for fn in (tfa.flash_bwd_dkdv_cuda, tfa.flash_bwd_dq_cuda):
        with pytest.raises(TypeError, match="float32"):
            fn(q, q, q, q, lse, lse, lens, causal=True, scale=1.0)
        with pytest.raises(TypeError, match="share a dtype"):
            fn(b, b, b, b.float(), lse, lse, lens, causal=True, scale=1.0)
    assert tfa.flash_fwd_cuda.launches == 0


def test_bf16_backward_raises_for_the_precision_policy(monkeypatch):
    """The kernel route's backward on bf16, which raised until the bf16
    precision policy was ported, now hands the bf16 instances bf16 q, k,
    v and dO with a float32 delta, and returns bf16 gradients; a float16
    operand still raises, naming the ROADMAP row of its instances.  The
    kernels are stood in for by the upcast plain version's backward."""
    seen = []

    def fwd(q, k, v, kv_lens, *, causal, scale, q_offset=0, kv_offset=0):
        o, lse = tfa._torch_attention_upcast(
            q, k, v, kv_lens, causal=causal, scale=scale, return_lse=True)
        return o, lse

    def bwd(which):
        def run(q, k, v, g, lse, delta, kv_lens, *, causal, scale,
                q_offset=0, kv_offset=0):
            seen.append((which, q.dtype, g.dtype, delta.dtype))
            # O = 0 and g_lse = -delta: the reference's delta is delta
            o = torch.zeros_like(q)
            dq, dk, dv = tfa._upcast_bwd(q, k, v, kv_lens, o, lse, g,
                                         -delta, causal=causal, scale=scale)
            return dq if which == "dq" else (dk, dv)
        return run

    monkeypatch.setattr(tfa, "resolve_impl", lambda impl, t: "cuda")
    monkeypatch.setattr(tfa, "flash_fwd_cuda", fwd)
    monkeypatch.setattr(tfa, "flash_bwd_dq_cuda", bwd("dq"))
    monkeypatch.setattr(tfa, "flash_bwd_dkdv_cuda", bwd("dkdv"))
    _, (q, k, v) = _bf16_inputs(1, 8, 8, 2, 8, seed=3)
    q.requires_grad_(True)
    out = tfa.flash_attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    (dq,) = torch.autograd.grad(out.float().sum(), (q,))
    assert dq.dtype == torch.bfloat16
    assert seen == [(w, torch.bfloat16, torch.bfloat16, torch.float32)
                    for w in ("dq", "dkdv")]
    h = q.detach().half()
    with pytest.raises(TypeError, match="ROADMAP.md section 2, K5"):
        tfa.check_kernel_operand("q", h, h.device, tfa.KERNEL_DTYPES)


def test_cpu_run_fwd_routes_to_the_plain_version():
    _, (q, k, v) = _bf16_inputs(1, 32, 32, 2, 16, seed=4)
    before = tfv.run_fwd_cuda.launches
    got = ttool.run_fwd(q, k, v, block_q=16, block_k=16, bf16_dots=True)
    want = tfv._torch_run_fwd(q, k, v, causal=True, block_q=16,
                              block_k=16, bf16_dots=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tfv.run_fwd_cuda.launches == before
    # default tiles: the kernel's (128 x 64 for bf16 dots), which 32 rows
    # do not divide
    with pytest.raises(ValueError, match="block_q"):
        ttool.run_fwd(q, k, v, bf16_dots=True)


def test_split_and_causal_bound_do_not_change_the_plain_result():
    """The plain version masks every block; the split and the causal
    bound only skip work, so its flags that change no arithmetic give the
    same bits."""
    _, (q, k, v) = _bf16_inputs(1, 64, 64, 2, 16, seed=5)
    kw = dict(causal=True, block_q=16, block_k=16, bf16_dots=True,
              use_exp2=True)
    a = tfv._torch_run_fwd(q, k, v, **kw)
    b = tfv._torch_run_fwd(q, k, v, split_loop=True, **kw)
    c = tfv._torch_run_fwd(q, k, v, pipelined=True, **kw)
    for x, y in ((a, b), (a, c)):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


def test_sweep_runs_every_row_on_the_cpu():
    """The sweep's ten rows on plain versions at a small shape: the rows
    and their names, each row's output near row A's (bf16 dots round P,
    so the bound is loose)."""
    _, (q, k, v) = _bf16_inputs(1, 128, 128, 2, 64, seed=6)
    rows = ttool.sweep(q, k, v, timed=False)
    assert [r["name"][0] for r in rows] == list("ABCDFFGGGG")
    assert len({r["name"] for r in rows}) == 10
    for r in rows:
        assert r["ms"] is None and 0.0 <= r["max_abs_err_vs_A"] < 0.1
        assert r["peak"] == ("float32" if r["name"][0] == "A" else "bf16")
    assert rows[0]["max_abs_err_vs_A"] == 0.0
    assert ttool.flops(8, 8, 4096, 64) == pytest.approx(137.4e9, rel=1e-3)


def test_instance_table_matches_the_cuda_source():
    """The wrapper refuses exactly what csrc/flash_variants.cu has no
    instance for: its FLASH_VARIANT_INSTANCES table is VARIANT_INSTANCES."""
    import os
    import re

    src = os.path.join(os.path.dirname(tfv.__file__), "csrc",
                       "flash_variants.cu")
    with open(src) as f:
        rows = re.findall(r"^\s*X\((\d+), (\d+), (\d), (\d), (\d)\)", f.read(),
                          re.M)
    assert {tuple(int(x) for x in r) for r in rows} == tfv.VARIANT_INSTANCES
    assert len(rows) == len(tfv.VARIANT_INSTANCES)


SASS = """
Fatbin elf code:
================
arch = sm_90a
\tcode for sm_90a
\t\tFunction : _Z6kernAPKf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
        /*0010*/                   EXIT ;                   /* 0x000000000000794d */
\t\t..........

\t\tFunction : _Z6kernBPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
        /*0010*/                   EXIT ;                   /* 0x000000000000794d */
\t\t..........
"""


def test_sass_diff_reads_and_compares_cuobjdump_listings():
    """The SASS comparison takes each kernel's lines from a cuobjdump
    listing by a part of its name and finds the first line that differs,
    scheduling bits included."""
    from paddle_tpu_torch.tools import sass_diff

    table = sass_diff.kernels(SASS)
    assert sorted(table) == ["_Z6kernAPKf", "_Z6kernBPKf"]
    a, b = sass_diff.pick(table, "kernA"), sass_diff.pick(table, "kernB")
    assert len(a) == 4 and len(b) == 3
    assert sass_diff.first_difference(a, a) is None
    assert sass_diff.first_difference(a[1:], b)[0] == 1
    with pytest.raises(SystemExit, match="2 kernels match"):
        sass_diff.pick(table, "kern")


def test_sass_base_holds_the_float32_sources_before_the_bf16_instances(
        tmp_path):
    """chip_smoke.py compares the float32 instances of flash_bwd.cu and
    rnn_step.cu with a build of SASS_BASE: every file there is, by its git
    blob id (computed as ``git hash-object`` does), SASS_BASE_REV's."""
    import os

    from paddle_tpu_torch.tools import sass_diff

    hello = tmp_path / "hello"
    hello.write_bytes(b"hello\n")
    assert (sass_diff.git_blob_id(str(hello))
            == "ce013625030ba8dba906f756967f9e9ca394464a")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    base = os.path.join(repo, smoke.SASS_BASE)
    assert sorted(os.listdir(base)) == sorted(smoke.SASS_BASE_BLOBS)
    for name, blob in smoke.SASS_BASE_BLOBS.items():
        assert sass_diff.git_blob_id(os.path.join(base, name)) == blob
    assert ({src for src, _, _ in smoke.SASS_KERNELS}
            <= set(smoke.SASS_BASE_BLOBS))


def test_bound_is_set_by_the_slower_of_operations_and_bytes():
    """At the sweep's shape: 137.4 GFLOP over ~135 MB is bound by
    operations on float32 FMAs (2.05 ms) and on bf16 tensor cores
    (0.139 ms); a copy is bound by bytes."""
    from paddle_tpu_torch.tools import timing

    work = ttool.flops(8, 8, 4096, 64)
    nbytes = 4 * 8 * 4096 * 8 * 64 * 2 + 8 * 8 * 4096 * 4
    ms, by = timing.bound(work, nbytes)
    assert by == "operations" and ms == pytest.approx(2.051, rel=1e-3)
    ms, by = timing.bound(work, nbytes, timing.PEAK_BF16_FLOPS)
    assert by == "operations" and ms == pytest.approx(0.139, rel=1e-2)
    ms, by = timing.bound(0.0, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
