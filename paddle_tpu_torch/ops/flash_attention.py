"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward) and
``csrc/flash_bwd.cu`` (dK/dV and dQ), and their plain PyTorch versions.

The kernels take float32 or bf16 q/k/v (and dO), as ``_flash_fwd`` and
``_flash_bwd`` do: O comes back in q's dtype and the LSE in float32; dQ,
dK and dV in q's, k's and v's dtype; delta is float32.  All arithmetic is
float32 (the kernels convert bf16 as they stage the tiles), as in the
Pallas kernels, which upcast before every product.  float16 raises
(``ROADMAP.md`` section 2, K5).

Two plain versions, for the two bf16 semantics of the JAX package:
``_torch_attention`` is the counterpart of ``_xla_attention`` (on bf16 the
probabilities are rounded to bf16 before P . V), the CPU route and the
``attention_impl="torch"`` route; ``_torch_attention_upcast`` does the
Pallas kernels' arithmetic (float32 throughout on the upcast operands,
outputs rounded once to the operands' dtype), the yardstick the bf16
kernels are held against on the card.

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
from paddle_tpu_torch.ops import _build

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


KERNEL_DTYPES = (torch.float32, torch.bfloat16)   # q, k, v and dO
FP16_ROW = ("float16 operands wait for the __half instances "
            "(ROADMAP.md section 2, K5)")


def check_kernel_operand(name: str, t: torch.Tensor, device,
                         dtypes=(torch.float32,)) -> None:
    """What the vector loads of the kernels need: one of ``dtypes``
    (float32 alone by default) on the launch device, unit inner stride, strides that are multiples of 4
    elements, 16-byte aligned data."""
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name}: the CUDA kernel takes {names}, got "
                        f"{t.dtype}"
                        + (f"; {FP16_ROW}" if t.dtype == torch.float16
                           else ""))
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]):
        raise ValueError(
            f"{name}: the CUDA kernel needs a unit inner stride and outer "
            f"strides that are multiples of 4, got {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data is not 16-byte aligned")


def _torch_attention(q, k, v, kv_lens, *, causal: bool, scale: float,
                     q_offset=0, kv_offset=0, return_lse: bool = False):
    """The plain version (counterpart of ``_xla_attention``): dense
    scores, one mask for kv_lens and the offset causal rule."""
    lq, lk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    kpos = torch.arange(lk, device=q.device)
    mask = kpos[None, None, None, :] < kv_lens[:, None, None, None]
    if causal:
        qpos = torch.arange(lq, device=q.device)
        cm = kv_offset + kpos[None, :] <= q_offset + qpos[:, None]
        mask = mask & cm[None, None]
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
    lq, lk = q.shape[1], k.shape[1]
    kpos = torch.arange(lk, device=q.device)
    mask = kpos[None, None, None, :] < kv_lens[:, None, None, None]
    if causal:
        qpos = torch.arange(lq, device=q.device)
        cm = kv_offset + kpos[None, :] <= q_offset + qpos[:, None]
        mask = mask & cm[None, None]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    delta = (gf * o.float()).sum(-1).transpose(1, 2)           # [B, H, Lq]
    if g_lse is not None:
        delta = delta - g_lse.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vf) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
               "flash_fwd_f32dots_bf16": _FWD_ARGS + [ctypes.c_int] * 2}


def flash_fwd_cuda(q, k, v, kv_lens, *, causal: bool, scale: float,
                   q_offset: int = 0, kv_offset: int = 0):
    """Launch ``csrc/flash_fwd.cu``: returns (O [B,Lq,H,D] in q's dtype,
    float32 or bf16; LSE [B,H,Lq] float32).  ``q_offset``/``kv_offset``
    are host ints (no device sync); ``kv_lens`` is an int32 tensor [B] on
    the same device."""
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
    entry = (lib.flash_fwd_f32 if q.dtype == torch.float32
             else lib.flash_fwd_bf16)
    err = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, lq, lk, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(q_offset), int(kv_offset), int(bool(causal)),
        float(scale * LOG2E),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_fwd")
    flash_fwd_cuda.launches += 1
    flash_fwd_cuda.launches_bf16 += q.dtype == torch.bfloat16
    return o, lse


# every launch, and those of the bf16 instance alone
flash_fwd_cuda.launches = flash_fwd_cuda.launches_bf16 = 0

_DKDV_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
              + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
              + [ctypes.c_float, ctypes.c_void_p])
_DQ_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p])
_BWD_SIGNATURES = {"flash_bwd_dkdv_f32": _DKDV_ARGS,
                   "flash_bwd_dkdv_bf16": _DKDV_ARGS,
                   "flash_bwd_dq_f32": _DQ_ARGS,
                   "flash_bwd_dq_bf16": _DQ_ARGS}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_bwd_operands(q, k, v, g, lse, delta, kv_lens):
    """What both backward kernels take: the forward's operands and dO
    shaped like q, all float32 or all bf16, and contiguous float32 LSE
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
    [B, Lk, H, D] in the operands' dtype (float32 or bf16).  ``g`` is dO
    [B, Lq, H, D]; ``lse`` the forward's natural-log LSE and ``delta`` =
    rowsum(dO * O) - g_lse, both [B, H, Lq] float32."""
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
    flash_bwd_dkdv_cuda.launches += 1
    flash_bwd_dkdv_cuda.launches_bf16 += q.dtype == torch.bfloat16
    return dk, dv


flash_bwd_dkdv_cuda.launches = flash_bwd_dkdv_cuda.launches_bf16 = 0


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, kv_lens, *, causal: bool,
                      scale: float, q_offset: int = 0, kv_offset: int = 0):
    """Launch the dQ kernel of ``csrc/flash_bwd.cu``: returns dQ
    [B, Lq, H, D] in q's dtype (operands as ``flash_bwd_dkdv_cuda``)."""
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
    flash_bwd_dq_cuda.launches += 1
    flash_bwd_dq_cuda.launches_bf16 += q.dtype == torch.bfloat16
    return dq


flash_bwd_dq_cuda.launches = flash_bwd_dq_cuda.launches_bf16 = 0


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
    kernel route's backward is ``csrc/flash_bwd.cu``, at float32 or bf16
    (q, k and v share a dtype)."""
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
