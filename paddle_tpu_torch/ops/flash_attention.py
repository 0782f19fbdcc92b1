"""Flash attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version.

Counterpart of ``paddle_tpu/ops/flash_attention.py``.  Layout [B, L, H, D]
as there.  ``impl=None`` routes by where the tensors lie: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
``impl="torch"`` forces the plain version on any device (the reference
``chip_smoke.py`` holds the kernel against).  The backward kernels come
with the training slice; this module is forward-only.

The TPU wrapper's KV windowing past 32768 rows works around VMEM; the
CUDA kernel streams K/V from device memory and needs none.
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


def check_kernel_operand(name: str, t: torch.Tensor, device) -> None:
    """What the float4 loads of both kernels need: float32 on the launch
    device, unit inner stride, 16-byte aligned rows."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
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


_SIGNATURES = {"flash_fwd_f32": (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])}


def flash_fwd_cuda(q, k, v, kv_lens, *, causal: bool, scale: float,
                   q_offset: int = 0, kv_offset: int = 0):
    """Launch ``csrc/flash_fwd.cu``: returns (O [B,Lq,H,D], LSE [B,H,Lq]),
    both float32.  ``q_offset``/``kv_offset`` are host ints (no device
    sync); ``kv_lens`` is an int32 tensor [B] on the same device."""
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
        check_kernel_operand(name, t, q.device)
    if (kv_lens.dtype != torch.int32 or kv_lens.shape != (b,)
            or kv_lens.device != q.device or not kv_lens.is_contiguous()):
        raise ValueError("kv_lens must be a contiguous int32 [B] tensor on "
                         "the device of q")
    o = torch.empty((b, lq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _build.load("flash_fwd", _SIGNATURES)
    err = lib.flash_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, lq, lk, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(q_offset), int(kv_offset), int(bool(causal)),
        float(scale * LOG2E),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_fwd")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


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
    q``.  impl: ``"cuda"`` (the kernel), ``"torch"`` (plain version) or
    None (by the device of ``q``)."""
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
    out, lse = flash_fwd_cuda(q, k, v, kv_lens, causal=causal, scale=scale,
                              q_offset=q_offset, kv_offset=kv_offset)
    return (out, lse) if return_lse else out
