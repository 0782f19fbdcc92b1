"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward) and
``csrc/flash_bwd.cu`` (dK/dV and dQ), and their plain PyTorch versions.

The kernels take float32, bf16 or float16 q/k/v (and dO), as
``_flash_fwd`` and ``_flash_bwd`` do: O comes back in q's dtype and the
LSE in float32; dQ, dK and dV in q's, k's and v's dtype; delta is
float32.  The arithmetic:
- float32 operands: every product of the forward and the backward split
  TF32 on the tensor cores (3xTF32: each operand x = hi + lo, both parts
  rounded to TF32 to nearest with ties away from zero, and a . b = lo_a .
  hi_b + hi_a . lo_b + hi_a . hi_b summed in float32, within 3 * 2^-22 of
  |a||b|, where the Pallas kernels upcast and take float32 products); the
  forward scales q by scale * log2(e) in float32 before its product, as
  the Pallas kernel does;
- bf16 and float16 operands: the tensor cores, one kernel template on
  either 16-bit type.  S = QK^T (and in the backward dP = dO V^T) take
  the 16-bit operands with float32 accumulation (exact products, so only
  the order of the sums differs from the Pallas kernels); the forward
  rounds P once to the operands' dtype before O += P V, its row sum and
  LSE staying float32; the backward rounds P and dS once to it before
  dV = P^T dO, dK = dS^T Q and dQ = dS K, accumulated in float32; each
  output is rounded once.

Six plain versions, for the two bf16 semantics of the JAX package and
the tensor-core kernels:
``_torch_attention`` is the counterpart of ``_xla_attention`` (on bf16 the
probabilities are rounded to bf16 before P . V), the CPU route and the
``attention_impl="torch"`` route; ``_torch_attention_upcast`` does the
Pallas kernels' arithmetic (float32 throughout on the upcast operands,
outputs rounded once to the operands' dtype), the yardstick the 16-bit
kernels are held against on the card; ``_mma_fwd`` and ``_mma_bwd`` are
the 16-bit kernels' own arithmetic (the forward's online softmax over key
tiles with P rounded to the operands' dtype; P and dS rounded to it in
the backward), and ``_tf32x3_fwd`` and ``_tf32x3_bwd`` the float32
kernels' (every product as three TF32 products),
which the CPU tests hold to the Pallas kernels within their rounding's
bounds and the card's check holds the kernels to within tighter limits.

Counterpart of ``paddle_tpu/ops/flash_attention.py``.  Layout [B, L, H, D]
as there.  ``impl=None`` routes by where the tensors lie: a CUDA tensor
runs the kernels (or raises), a CPU tensor takes the plain version, whose
gradient is autograd through it.  ``impl="torch"`` forces the plain version
on any device (the reference ``chip_smoke.py`` holds the kernels against).
On the kernel route ``_FlashAttention`` (the counterpart of the custom-vjp
``_flash``) runs the forward kernel and, for the backward, computes
``delta = rowsum(dO * O) - g_lse`` in plain torch ops before launching the
two backward kernels: LSE is a differentiable output, as in JAX.

The TPU wrapper's KV windowing past 32768 rows and the dK/dV kernel's q
windowing past 32768 rows work around VMEM; the CUDA kernels stream from
device memory and need neither.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.core.config import LOG2E, NEG_INF
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build, count_launch

IMPLS = ("cuda", "torch")
D_MAX = 128                            # csrc/flash_fwd.cu kDMax


def resolve_impl(impl: Optional[str], t: torch.Tensor) -> str:
    """``None`` -> the kernel for a CUDA tensor, the plain version for a
    CPU one; an explicit ``"cuda"`` on a CPU tensor raises."""
    if impl is None:
        return "cuda" if t.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs tensors on a CUDA device")
    return impl


KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # q, k, v, dO
FP16_ROW = ("this kernel has no float16 instance for these operands "
            "(ROADMAP.md section 2, K5: kernel 4 and row T at float16 are "
            "still to port)")


def check_dtype(name: str, t: torch.Tensor, dtypes) -> None:
    """TypeError unless t is one of ``dtypes``; a float16 one names the
    rows of K5 still to port."""
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name}: the CUDA kernel takes {names}, got "
                        f"{t.dtype}"
                        + (f"; {FP16_ROW}" if t.dtype == torch.float16
                           else ""))


def check_kernel_operand(name: str, t: torch.Tensor, device,
                         dtypes=(torch.float32,)) -> None:
    """What the vector loads of the kernels need: one of ``dtypes``
    (float32 alone by default) on the launch device, unit inner stride, strides that are multiples of 4
    elements, 16-byte aligned data."""
    check_dtype(name, t, dtypes)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]):
        raise ValueError(
            f"{name}: the CUDA kernel needs a unit inner stride and outer "
            f"strides that are multiples of 4, got {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data is not 16-byte aligned")


def _visible(lq, lk, kv_lens, causal, q_offset, kv_offset, device):
    """[B, 1, Lq, Lk] (or [B, 1, 1, Lk]) bool: query q sees key k when
    k < kv_lens[b] and, causal, kv_offset + k <= q_offset + q."""
    kpos = torch.arange(lk, device=device)
    mask = kpos[None, None, None, :] < kv_lens[:, None, None, None]
    if causal:
        qpos = torch.arange(lq, device=device)
        cm = kv_offset + kpos[None, :] <= q_offset + qpos[:, None]
        mask = mask & cm[None, None]
    return mask


def _torch_attention(q, k, v, kv_lens, *, causal: bool, scale: float,
                     q_offset=0, kv_offset=0, return_lse: bool = False):
    """The plain version (counterpart of ``_xla_attention``): dense
    scores, one mask for kv_lens and the offset causal rule."""
    lq, lk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = _visible(lq, lk, kv_lens, causal, q_offset, kv_offset, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)   # masked rows -> 0
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    if not return_lse:
        return out
    m = s.amax(dim=-1)
    lse = m + torch.log(torch.clamp(
        torch.exp(s - m[..., None]).sum(dim=-1), min=1e-30))  # [B,H,Lq]
    return out, lse


def _upcast_bwd(q, k, v, kv_lens, o, lse, g, g_lse=None, *, causal: bool,
                scale: float, q_offset=0, kv_offset=0):
    """The backward of the Pallas kernels ``_bwd_dkdv_kernel`` and
    ``_bwd_dq_kernel`` in plain torch: q, k, v, dO and O upcast to
    float32, P recomputed from the scores and the natural-log LSE under
    the same masks, delta = rowsum(dO * O) - g_lse in float32, every
    product float32; dQ, dK and dV returned in q's, k's and v's dtype."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p, ds = _p_and_ds(qf, kf, vf, gf, kv_lens, o, lse, g_lse, causal,
                      scale, q_offset, kv_offset, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _p_and_ds(qf, kf, vf, gf, kv_lens, o, lse, g_lse, causal, scale,
              q_offset, kv_offset, q_score):
    """P recomputed from the scores of ``q_score`` and k and the
    natural-log LSE under the masks, and dS = P * (dO V^T - delta) with
    delta = rowsum(dO * O) - g_lse, both [B, H, Lq, Lk] float32."""
    mask = _visible(qf.shape[1], kf.shape[1], kv_lens, causal, q_offset,
                    kv_offset, qf.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q_score, kf) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    delta = (gf * o.float()).sum(-1).transpose(1, 2)           # [B, H, Lq]
    if g_lse is not None:
        delta = delta - g_lse.float()
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vf) - delta[..., None])
    return p, ds


def _mma_bwd(q, k, v, kv_lens, o, lse, g, g_lse=None, *, causal: bool,
             scale: float, q_offset=0, kv_offset=0,
             drop_score_kstep: Optional[int] = None):
    """The arithmetic of the 16-bit backward kernels (the tensor-core
    ``flash_bwd_{dkdv,dq}_mma_kernel`` of ``csrc/flash_bwd.cu``) in plain
    torch: ``_upcast_bwd``'s steps, with P rounded to the operands' dtype
    (bf16 or float16) before P^T dO and dS rounded to it before dS^T Q
    and dS K, every product
    accumulated in float32, dQ, dK and dV rounded once to q's, k's and
    v's dtype.  Never on the kernel route: the tests hold it against the
    JAX package, ``chip_smoke.py`` the kernels against it.

    ``drop_score_kstep=j`` leaves head columns 16j to 16j+15 out of the
    score product S = QK^T, one 16-deep step of the kernels' mma: a
    planted fault, which the checks must catch."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    q_score = qf
    if drop_score_kstep is not None:
        q_score = qf.clone()
        q_score[..., 16 * drop_score_kstep:16 * drop_score_kstep + 16] = 0
    p, ds = _p_and_ds(qf, kf, vf, gf, kv_lens, o, lse, g_lse, causal,
                      scale, q_offset, kv_offset, q_score)
    p, ds = (x.to(q.dtype).float() for x in (p, ds))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _tf32_rna(x):
    """float32 ``x`` rounded to TF32 (float32's exponent, 10 mantissa
    bits), to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
    rounds it: on the bit pattern, half a unit of the 13 dropped bits added
    to the magnitude, then those bits cleared.  A value past TF32's largest
    becomes inf, a subnormal rounds on the same bits, a NaN comes back as
    it was."""
    bits = x.contiguous().view(torch.int32)
    mag = torch.clamp(bits & 0x7FFFFFFF, max=0x7F800000)
    out = ((mag + 0x1000) & -0x2000) | (bits & -0x80000000)
    return torch.where(torch.isnan(x), x, out.view(torch.float32))


def _tf32_split(x):
    """(hi, lo): hi = x rounded to TF32, lo = (x - hi) rounded to TF32
    (``_tf32_rna``); x - hi is exact, and hi + lo is x within 2^-22 of
    |x|."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _tf32x3(spec, a, b, terms=3):
    """``torch.einsum(spec, a, b)`` on float32 as the 3xTF32 kernels take
    it: each operand split (``_tf32_split``), lo_a . hi_b + hi_a . lo_b +
    hi_a . hi_b, each product of TF32 parts exact in float32 and summed in
    float32.  ``terms=1`` keeps hi_a . hi_b alone: one TF32 product, the
    planted fault."""
    a_hi, a_lo = _tf32_split(a)
    b_hi, b_lo = _tf32_split(b)
    big = torch.einsum(spec, a_hi, b_hi)
    if terms == 1:
        return big
    return (torch.einsum(spec, a_lo, b_hi)
            + torch.einsum(spec, a_hi, b_lo)) + big


def _tf32x3_bwd(q, k, v, kv_lens, o, lse, g, g_lse=None, *, causal: bool,
                scale: float, q_offset=0, kv_offset=0, terms: int = 3):
    """The arithmetic of the float32 backward kernels (the 3xTF32
    ``flash_bwd_{dkdv,dq}_tf32_kernel`` of ``csrc/flash_bwd.cu``) in plain
    torch: every product (S = QK^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q,
    dQ = dS K) as ``_tf32x3``, P = exp2(S * scale * log2(e) - LSE *
    log2(e)) and dS = P * (dP - delta) in float32, both zero outside
    ``_visible``'s masks, delta = rowsum(dO * O) - g_lse; dK and dQ scaled
    after their products.  Never on the kernel route: the tests hold it
    against the JAX package, ``chip_smoke.py`` the kernels against it.

    ``terms=1`` takes every product as one TF32 product (hi . hi): a
    planted fault, which the checks must catch."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    mask = _visible(qf.shape[1], kf.shape[1], kv_lens, causal, q_offset,
                    kv_offset, qf.device)

    def x3(spec, a, b):
        return _tf32x3(spec, a, b, terms)

    s = x3("bqhd,bkhd->bhqk", qf, kf)
    p = torch.exp2(s * (scale * LOG2E) - lse[..., None] * LOG2E)
    p = p.masked_fill(~mask, 0.0)
    del s
    delta = (gf * o.float()).sum(-1).transpose(1, 2)           # [B, H, Lq]
    if g_lse is not None:
        delta = delta - g_lse.float()
    ds = (p * (x3("bqhd,bkhd->bhqk", gf, vf) - delta[..., None])
          ).masked_fill(~mask, 0.0)
    dv = x3("bhqk,bqhd->bkhd", p, gf)
    del p
    dq = x3("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = x3("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _tf32x3_fwd(q, k, v, kv_lens, *, causal: bool, scale: float,
                q_offset=0, kv_offset=0, block_k: int = 32, terms: int = 3):
    """The arithmetic of the float32 forward kernel (the 3xTF32
    ``flash_fwd_tf32_kernel`` of ``csrc/flash_fwd.cu``) in plain torch: q
    scaled by scale * log2(e) in float32, then S = QK^T as ``_tf32x3`` (in
    the log2 domain as it leaves the product); the online softmax over key
    tiles of ``block_k`` (the kernel's 32-key sub-tiles) under
    ``_visible``'s masks, each tile's p = 2^(s - m) with m the running row
    max, the row sum l adding p, and O = O * corr + P V with P V as
    ``_tf32x3`` on the float32 p; O = acc / max(l, 1e-30) and the
    natural-log LSE m / log2(e) + log(max(l, 1e-30)), float32 [B, H, Lq].
    Returns (O, LSE).  Never on the kernel route: the tests hold it against
    the JAX package, ``chip_smoke.py`` the kernel against it.

    ``terms=1`` takes both products as one TF32 product (hi . hi): a
    planted fault, which the checks must catch."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    qs = (q.float() * (scale * LOG2E)).transpose(1, 2)
    kf, vf = (t.float().transpose(1, 2) for t in (k, v))
    mask = _visible(lq, lk, kv_lens, causal, q_offset, kv_offset, q.device)
    acc = torch.zeros(b, h, lq, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    lsum = torch.zeros_like(m)
    for k0 in range(0, lk, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        mt = mask[..., k0:k0 + block_k]
        s = torch.where(mt, _tf32x3("bhqd,bhkd->bhqk", qs, kt, terms),
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mt, torch.exp2(s - m_new), 0.0)
        corr = torch.exp2(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _tf32x3("bhqk,bhkd->bhqd", p, vt, terms)
        m = m_new
    l_safe = torch.clamp(lsum, min=1e-30)
    o = (acc / l_safe).transpose(1, 2)
    lse = (m * (1.0 / LOG2E) + torch.log(l_safe))[..., 0]
    return o, lse


def _mma_fwd(q, k, v, kv_lens, *, causal: bool, scale: float, q_offset=0,
             kv_offset=0, block_k: int = 64,
             drop_score_kstep: Optional[int] = None):
    """The arithmetic of the 16-bit forward kernel (the tensor-core
    ``flash_fwd_mma_kernel`` of ``csrc/flash_fwd.cu``) in plain torch:
    S = QK^T as a float32 product of the upcast operands, times scale *
    log2(e); the online softmax over key tiles of ``block_k`` (the
    kernel's 64) in the exp2 domain under ``_visible``'s masks, each
    tile's p = 2^(s - m) with m the running row max; the row sum l adds
    the float32 p and O += P V takes p rounded to q's dtype (bf16 or
    float16); O = acc /
    max(l, 1e-30) rounded once to q's dtype and the natural-log LSE
    m / log2(e) + log(max(l, 1e-30)), float32 [B, H, Lq].  Returns
    (O, LSE).  Never on the kernel route: the tests hold it against the
    JAX package, ``chip_smoke.py`` the kernel against it.

    ``drop_score_kstep=j`` leaves head columns 16j to 16j+15 out of the
    score product, one 16-deep step of the kernel's mma: a planted
    fault, which the checks must catch."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    if drop_score_kstep is not None:
        qf = qf.clone()
        qf[..., 16 * drop_score_kstep:16 * drop_score_kstep + 16] = 0
    mask = _visible(lq, lk, kv_lens, causal, q_offset, kv_offset, q.device)
    acc = torch.zeros(b, h, lq, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    lsum = torch.zeros_like(m)
    for k0 in range(0, lk, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        mt = mask[..., k0:k0 + block_k]
        s = torch.where(mt, qf @ kt.transpose(-1, -2) * (scale * LOG2E),
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mt, torch.exp2(s - m_new), 0.0)
        corr = torch.exp2(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(q.dtype).float() @ vt
        m = m_new
    l_safe = torch.clamp(lsum, min=1e-30)
    o = (acc / l_safe).to(q.dtype).transpose(1, 2)
    lse = (m * (1.0 / LOG2E) + torch.log(l_safe))[..., 0]
    return o, lse


class _UpcastAttention(torch.autograd.Function):
    """``_torch_attention_upcast`` with its gradient: the float32 forward
    on the upcast operands, O rounded to q's dtype; the backward is
    ``_upcast_bwd`` on that rounded O, as the kernels' is."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, scale, q_offset, kv_offset):
        o, lse = _torch_attention(q.float(), k.float(), v.float(), kv_lens,
                                  causal=causal, scale=scale,
                                  q_offset=q_offset, kv_offset=kv_offset,
                                  return_lse=True)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, kv_lens, o, lse)
        ctx.args = dict(causal=causal, scale=scale, q_offset=q_offset,
                        kv_offset=kv_offset)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, kv_lens, o, lse = ctx.saved_tensors
        g = torch.zeros_like(o) if g is None else g
        return (*_upcast_bwd(q, k, v, kv_lens, o, lse, g, g_lse,
                             **ctx.args), None, None, None, None, None)


def _torch_attention_upcast(q, k, v, kv_lens, *, causal: bool,
                            scale: float, q_offset=0, kv_offset=0,
                            return_lse: bool = False):
    """The plain version of the Pallas kernels' arithmetic: every operand
    upcast to float32, the float32 forward and backward, O (and each
    gradient) rounded once to its operand's dtype; the LSE float32.  At
    float32 it computes what ``_torch_attention`` computes."""
    o, lse = _UpcastAttention.apply(q, k, v, kv_lens, causal, scale,
                                    q_offset, kv_offset)
    return (o, lse) if return_lse else o


_FWD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])
# every entry of csrc/flash_fwd.cu: kernel 1 at float32 and bf16, and the
# forward sweep's f32-dot rows (ops/flash_variants.py), which add the exp2
# and split flags
_SIGNATURES = {"flash_fwd_f32": _FWD_ARGS, "flash_fwd_bf16": _FWD_ARGS,
               "flash_fwd_f16": _FWD_ARGS,
               "flash_fwd_f32dots_bf16": _FWD_ARGS + [ctypes.c_int] * 2,
               "flash_fwd_mma_resources": [ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int)],
               "flash_fwd_f32_resources": [ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int)]}
# the C entries' suffix by operand dtype
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}


def flash_fwd_cuda(q, k, v, kv_lens, *, causal: bool, scale: float,
                   q_offset: int = 0, kv_offset: int = 0):
    """Launch ``csrc/flash_fwd.cu``: returns (O [B,Lq,H,D] in q's dtype,
    float32, bf16 or float16; LSE [B,H,Lq] float32).  float32 operands run
    the 3xTF32 tensor-core kernel (``_tf32x3_fwd``'s arithmetic), bf16 and
    float16 ones the 16-bit tensor-core kernel (``_mma_fwd``'s).
    ``q_offset``/``kv_offset`` are host ints
    (no device sync); ``kv_lens`` is an int32 tensor [B] on the same
    device."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_fwd wants q [B,Lq,H,D], k/v [B,Lk,H,D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if d > D_MAX or d % 4:
        raise ValueError(f"head dim {d}: the kernel takes D <= {D_MAX}, "
                         f"a multiple of 4")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_kernel_operand(name, t, q.device, KERNEL_DTYPES)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if (kv_lens.dtype != torch.int32 or kv_lens.shape != (b,)
            or kv_lens.device != q.device or not kv_lens.is_contiguous()):
        raise ValueError("kv_lens must be a contiguous int32 [B] tensor on "
                         "the device of q")
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _build.load("flash_fwd", _SIGNATURES)
    err = getattr(lib, f"flash_fwd_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, lq, lk, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(q_offset), int(kv_offset), int(bool(causal)),
        float(scale * LOG2E),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_fwd")
    count_launch(flash_fwd_cuda, q.dtype)
    _add_work("flash_fwd", 4.0, q, k, kv_lens, causal, q_offset, kv_offset)
    return o, lse


# every launch, and those of the bf16 and float16 instances alone
flash_fwd_cuda.launches = flash_fwd_cuda.launches_bf16 = 0
flash_fwd_cuda.launches_f16 = 0

_DKDV_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
              + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
              + [ctypes.c_float, ctypes.c_void_p])
_DQ_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p])
_BWD_SIGNATURES = {
    **{f"flash_bwd_dkdv_{sfx}": _DKDV_ARGS for sfx in _SUFFIX.values()},
    **{f"flash_bwd_dq_{sfx}": _DQ_ARGS for sfx in _SUFFIX.values()},
    "flash_bwd_mma_resources": [ctypes.c_int] * 3
                               + [ctypes.POINTER(ctypes.c_int)] * 2,
    "flash_bwd_f32_resources": [ctypes.c_int] * 2
                               + [ctypes.POINTER(ctypes.c_int)] * 2}


def _check_bwd_operands(q, k, v, g, lse, delta, kv_lens):
    """What both backward kernels take: the forward's operands and dO
    shaped like q, all float32, all bf16 or all float16, and contiguous
    float32 LSE
    and delta [B, H, Lq]."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash backward wants q [B,Lq,H,D], k/v "
                         f"[B,Lk,H,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, lq, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if g.shape != q.shape:
        raise ValueError(f"dO {tuple(g.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if d > D_MAX or d % 4:
        raise ValueError(f"head dim {d}: the kernels take D <= {D_MAX}, "
                         f"a multiple of 4")
    for name, t in (("q", q), ("k", k), ("v", v), ("dO", g)):
        check_kernel_operand(name, t, q.device, KERNEL_DTYPES)
    if len({q.dtype, k.dtype, v.dtype, g.dtype}) != 1:
        raise TypeError(f"q, k, v and dO must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {g.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (b, h, lq)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[B, H, Lq] tensor on the device of q")
    if (kv_lens.dtype != torch.int32 or kv_lens.shape != (b,)
            or kv_lens.device != q.device or not kv_lens.is_contiguous()):
        raise ValueError("kv_lens must be a contiguous int32 [B] tensor on "
                         "the device of q")


def _add_work(name, per_pair, q, k, kv_lens, causal, q_offset, kv_offset):
    """Report a launch's work while a count is open: ``per_pair`` x D
    operations for each visible (query, key) pair of each head (the
    forward's two products 4 D, dK/dV's four 8 D, dQ's three 6 D; the
    bounds of ``PERF.md``).  Reading ``kv_lens`` is the count's one host
    read, made only while counting."""
    if not ops.work_recording():
        return
    b, lq, h, d = q.shape
    pairs = ops.visible_pairs(lq, k.shape[1], causal, int(q_offset),
                              int(kv_offset), kv_lens.tolist())
    ops.add_work(name, per_pair * d * h * pairs)


def _bwd_args(q, k, v, g, causal, scale, q_offset, kv_offset):
    """The C entries' arguments after the pointers."""
    b, lq, h, d = q.shape
    return (b, lq, k.shape[1], h, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *g.stride()[:3], int(q_offset),
            int(kv_offset), int(bool(causal)), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_bwd_dkdv_cuda(q, k, v, g, lse, delta, kv_lens, *, causal: bool,
                        scale: float, q_offset: int = 0,
                        kv_offset: int = 0):
    """Launch the dK/dV kernel of ``csrc/flash_bwd.cu``: returns (dK, dV)
    [B, Lk, H, D] in the operands' dtype.  float32 operands run the 3xTF32
    tensor-core kernel (``_tf32x3_bwd``'s arithmetic), bf16 and float16
    ones the 16-bit tensor-core kernel (``_mma_bwd``'s).  ``g`` is dO [B, Lq, H, D]; ``lse`` the
    forward's natural-log LSE and ``delta`` = rowsum(dO * O) - g_lse, both
    [B, H, Lq] float32."""
    _check_bwd_operands(q, k, v, g, lse, delta, kv_lens)
    # every key tile's block writes all of its rows (zeros where no query
    # sees them), so the outputs need no clearing
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    if dk.numel() == 0 or q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    lib = _build.load("flash_bwd", _BWD_SIGNATURES)
    err = getattr(lib, f"flash_bwd_dkdv_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), kv_lens.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        *_bwd_args(q, k, v, g, causal, scale, q_offset, kv_offset))
    _build.check(lib, err, "flash_bwd_dkdv")
    count_launch(flash_bwd_dkdv_cuda, q.dtype)
    _add_work("flash_bwd_dkdv", 8.0, q, k, kv_lens, causal, q_offset,
              kv_offset)
    return dk, dv


flash_bwd_dkdv_cuda.launches = flash_bwd_dkdv_cuda.launches_bf16 = 0
flash_bwd_dkdv_cuda.launches_f16 = 0


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, kv_lens, *, causal: bool,
                      scale: float, q_offset: int = 0, kv_offset: int = 0):
    """Launch the dQ kernel of ``csrc/flash_bwd.cu``: returns dQ
    [B, Lq, H, D] in q's dtype (operands and the two instances as
    ``flash_bwd_dkdv_cuda``)."""
    _check_bwd_operands(q, k, v, g, lse, delta, kv_lens)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0 or k.shape[1] == 0:
        return dq.zero_()
    lib = _build.load("flash_bwd", _BWD_SIGNATURES)
    err = getattr(lib, f"flash_bwd_dq_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), kv_lens.data_ptr(),
        dq.data_ptr(),
        *_bwd_args(q, k, v, g, causal, scale, q_offset, kv_offset))
    _build.check(lib, err, "flash_bwd_dq")
    count_launch(flash_bwd_dq_cuda, q.dtype)
    _add_work("flash_bwd_dq", 6.0, q, k, kv_lens, causal, q_offset,
              kv_offset)
    return dq


flash_bwd_dq_cuda.launches = flash_bwd_dq_cuda.launches_bf16 = 0
flash_bwd_dq_cuda.launches_f16 = 0


def fwd_mma_resources(dtype=torch.bfloat16) -> dict:
    """Registers and local memory (bytes a thread; nonzero means the
    kernel spills or keeps a stack) of the tensor-core forward's
    ``dtype`` instance (bf16 or float16) at each head tile, from
    ``cudaFuncGetAttributes``: ``{"fwd_d64": (regs, local_bytes),
    "fwd_d128": ...}``.  Needs a card."""
    lib = _build.load("flash_fwd", _SIGNATURES)
    half = int(dtype == torch.float16)
    return {f"fwd_d{dt}": _build.resources(
        lib, lib.flash_fwd_mma_resources, dt, half) for dt in (64, 128)}


def fwd_f32_resources() -> dict:
    """Registers and local memory (bytes a thread; nonzero means the
    kernel spills or keeps a stack) of the float32 (3xTF32) forward at
    each head tile, from ``cudaFuncGetAttributes``: ``{"fwd_d64": (regs,
    local_bytes), "fwd_d128": ...}``.  Needs a card."""
    lib = _build.load("flash_fwd", _SIGNATURES)
    return {f"fwd_d{dt}": _build.resources(
        lib, lib.flash_fwd_f32_resources, dt) for dt in (64, 128)}


def bwd_mma_resources(dtype=torch.bfloat16) -> dict:
    """Registers and local memory (bytes a thread; nonzero means the
    kernel spills or keeps a stack) of the tensor-core kernels' ``dtype``
    instances (bf16 or float16) at each head tile, from
    ``cudaFuncGetAttributes``: ``{"dkdv_d64": (regs, local_bytes), ...}``.
    Needs a card."""
    lib = _build.load("flash_bwd", _BWD_SIGNATURES)
    half = int(dtype == torch.float16)
    return {f"{name}_d{dt}": _build.resources(
        lib, lib.flash_bwd_mma_resources, dkdv, dt, half)
        for name, dkdv in (("dkdv", 1), ("dq", 0)) for dt in (64, 128)}


def bwd_f32_resources() -> dict:
    """Registers and local memory (bytes a thread; nonzero means the
    kernel spills or keeps a stack) of the float32 (3xTF32) backward
    kernels at each head tile, from ``cudaFuncGetAttributes``:
    ``{"dkdv_d64": (regs, local_bytes), ...}``.  Needs a card."""
    lib = _build.load("flash_bwd", _BWD_SIGNATURES)
    return {f"{name}_d{dt}": _build.resources(
        lib, lib.flash_bwd_f32_resources, dkdv, dt)
        for name, dkdv in (("dkdv", 1), ("dq", 0)) for dt in (64, 128)}


class _FlashAttention(torch.autograd.Function):
    """The kernel route with its gradient (counterpart of ``_flash`` and
    its custom vjp): returns (O, LSE); both outputs are differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, scale, q_offset, kv_offset):
        o, lse = flash_fwd_cuda(q, k, v, kv_lens, causal=causal,
                                scale=scale, q_offset=q_offset,
                                kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, kv_lens, o, lse)
        ctx.args = dict(causal=causal, scale=scale, q_offset=q_offset,
                        kv_offset=kv_offset)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, kv_lens, o, lse = ctx.saved_tensors
        g = torch.zeros_like(o) if g is None else g.contiguous()
        # delta = rowsum(dO * O) - g_lse, [B, H, Lq], in float32 whatever
        # the operands' dtype: the LSE output's cotangent folds in here
        # (d lse / d s = p)
        delta = (g.float() * o.float()).sum(-1).transpose(1, 2)
        if g_lse is not None:
            delta = delta - g_lse
        delta = delta.contiguous()
        dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, kv_lens, **ctx.args)
        dk, dv = flash_bwd_dkdv_cuda(q, k, v, g, lse, delta, kv_lens,
                                     **ctx.args)
        return dq, dk, dv, None, None, None, None, None


def merge_partial(o_acc, lse_acc, o_new, lse_new):
    """logaddexp fold of two normalized partial softmax results.
    o: [B, L, H, D] (accumulator float32); lse: [B, H, L] natural-log."""
    lse_m = torch.logaddexp(lse_acc, lse_new)
    w_old = torch.exp(lse_acc - lse_m).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_new - lse_m).transpose(1, 2)[..., None]
    return o_acc * w_old + o_new.float() * w_new, lse_m


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, kv_lens=None,
                    q_offset: int = 0, kv_offset: int = 0,
                    return_lse: bool = False, impl: Optional[str] = None):
    """Fused attention forward. q: [B, Lq, H, D], k/v: [B, Lk, H, D] ->
    [B, Lq, H, D] (and the natural-log LSE [B, H, Lq] with
    ``return_lse``).

    kv_lens: optional [B] per-sample true KV length; keys at positions
    >= kv_lens[b] are masked.  q_offset / kv_offset: global positions of
    q[:, 0] / k[:, 0] for the causal rule ``kv_offset + k <= q_offset +
    q``.  impl: ``"cuda"`` (the kernels), ``"torch"`` (plain version) or
    None (by the device of ``q``).  Differentiable on both routes: the
    kernel route's forward and backward (``csrc/flash_fwd.cu``,
    ``csrc/flash_bwd.cu``) run on the tensor cores at float32 (split TF32),
    bf16 or float16; q, k and v share a dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kv_lens is None:
        kv_lens = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                             device=q.device)
    else:
        kv_lens = torch.as_tensor(kv_lens, dtype=torch.int32,
                                  device=q.device)
    if resolve_impl(impl, q) == "torch":
        return _torch_attention(q, k, v, kv_lens, causal=causal,
                                scale=scale, q_offset=q_offset,
                                kv_offset=kv_offset, return_lse=return_lse)
    out, lse = _FlashAttention.apply(q, k, v, kv_lens, causal, scale,
                                     int(q_offset), int(kv_offset))
    return (out, lse) if return_lse else out
