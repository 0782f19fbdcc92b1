"""The forward ablation sweep's kernels and their plain PyTorch version.

Counterpart of the Pallas kernels of ``tools/flash_variants.py``
(``_fwd_kernel_v2`` and ``_fwd_kernel_pipe``, launched by ``run_fwd``):
attention forward variants over bf16 q/k/v [B, L, H, D], each turning on
one idea of a fast forward - bf16 operands for both products accumulated
in float32 (``bf16_dots``), the exp2 domain (``use_exp2``), an unmasked
interior loop split from the masked boundary (``split_loop``), and a
software pipeline that issues tile j+1's score product before tile j's
softmax (``pipelined``, which implies the other three, as the TPU kernel
has them).  Both routes return ``(out [B, L, H, D] in q's dtype,
lse [B*H, L, 1] float32)``, the TPU tool's shapes, with kv_lens = Lk and
offsets 0, and need L % block_q == 0 and Lk % block_k == 0 (no padding).

The kernel route (``run_fwd_cuda``):
- bf16 dots: ``csrc/flash_variants.cu``, tensor cores (``mma.sync``), at
  the tiles of ``VARIANT_INSTANCES`` with block_q 64 or 128;
- f32 dots: the <EXP2, SPLIT> instances of kernel 1's body in
  ``csrc/flash_fwd.cu`` (CUDA-core FMAs), at its own 64 x 64 tile.
The TPU tool's 512 to 2048-row blocks do not fit a block's shared memory
here; the sweep's block-size rows run at these tiles instead.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.config import LOG2E, NEG_INF
from paddle_tpu_torch.ops import _build, count_launch
from paddle_tpu_torch.ops.flash_attention import (FP16_ROW, _SIGNATURES,
                                                  check_kernel_operand)

# (head dim, block_k, exp2, split, pipelined): the instances of
# csrc/flash_variants.cu (its FLASH_VARIANT_INSTANCES); block_q is 64 or 128
VARIANT_INSTANCES = frozenset(
    (d, bk, e, s, p) for d in (64, 128) for (bk, e, s, p) in (
        (64, 0, 0, 0), (64, 1, 0, 0), (64, 0, 1, 0), (64, 1, 1, 0),
        (64, 1, 1, 1), (128, 1, 1, 0), (128, 1, 1, 1)))
VARIANT_BLOCK_Q = (64, 128)
F32DOT_TILE = (64, 64)                 # csrc/flash_fwd.cu kBq, kBk
F32DOT_D_MAX = 128                     # csrc/flash_fwd.cu kDMax
DEFAULT_TILE = {True: (128, 64), False: F32DOT_TILE}   # by bf16 dots

_VARIANT_SIGNATURES = {"flash_variant_bf16": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
    + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 5
    + [ctypes.c_void_p])}


def variant_flags(bf16_dots, use_exp2, split_loop, pipelined):
    """(bf16_dots, use_exp2, split_loop, pipelined) as the kernel runs
    them: the pipelined kernel has bf16 dots, exp2 and the split."""
    if pipelined:
        return True, True, True, True
    return bool(bf16_dots), bool(use_exp2), bool(split_loop), False


def _check_shapes(q, k, v, block_q, block_k):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"run_fwd wants q [B,L,H,D], k/v [B,Lk,H,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, l, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if l % block_q or k.shape[1] % block_k:
        raise ValueError(f"run_fwd needs L % block_q == 0 and Lk % block_k "
                         f"== 0 (no padding), got L {l}, Lk {k.shape[1]}, "
                         f"block_q {block_q}, block_k {block_k}")


def run_fwd_cuda(q, k, v, *, causal: bool, block_q: int, block_k: int,
                 bf16_dots: bool, use_exp2: bool, split_loop: bool,
                 pipelined: bool):
    """Launch one variant on bf16 CUDA tensors q [B, L, H, D], k/v
    [B, Lk, H, D] with unit inner stride.  Returns (out [B, L, H, D] bf16,
    lse [B*H, L, 1] float32).  Raises on an operand, tile or flag set it
    has no instance for; never falls back."""
    _check_shapes(q, k, v, block_q, block_k)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: run_fwd_cuda takes bfloat16, got "
                            f"{t.dtype}"
                            + (f"; {FP16_ROW}" if t.dtype == torch.float16
                               else ""))
    bf16_dots, exp2, split, pipe = variant_flags(bf16_dots, use_exp2,
                                                 split_loop, pipelined)
    b, l, h, d = q.shape
    lk = k.shape[1]
    if bf16_dots:
        key = (d, block_k, int(exp2), int(split), int(pipe))
        if key not in VARIANT_INSTANCES or block_q not in VARIANT_BLOCK_Q:
            raise ValueError(
                f"no tensor-core instance for head dim {d}, block_q "
                f"{block_q}, block_k {block_k}, exp2 {exp2}, split {split}, "
                f"pipelined {pipe} (block_q in {VARIANT_BLOCK_Q}; "
                f"(D, block_k, exp2, split, pipelined) in "
                f"{sorted(VARIANT_INSTANCES)})")
    elif (block_q, block_k) != F32DOT_TILE or d > F32DOT_D_MAX or d % 4:
        raise ValueError(f"the f32-dot instances run at (block_q, block_k) "
                         f"= {F32DOT_TILE} with D <= {F32DOT_D_MAX}, a "
                         f"multiple of 4; got ({block_q}, {block_k}), D {d}")
    if not q.is_cuda:
        raise ValueError(f"run_fwd_cuda needs CUDA tensors, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_kernel_operand(name, t, q.device, (torch.bfloat16,))
        if bf16_dots and any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: the tensor-core kernel copies 16 "
                             f"bytes at a time and needs strides that are "
                             f"multiples of 8, got {t.stride()}")
    out = torch.empty((b, l, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b * h, l, 1), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    scale = d ** -0.5
    scale_s = scale * LOG2E if exp2 else scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if bf16_dots:
        lib = _build.load("flash_variants", _VARIANT_SIGNATURES)
        err = lib.flash_variant_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, l, lk, h, d, *strides, int(bool(causal)),
            float(scale_s), block_q, block_k, int(exp2), int(split),
            int(pipe), stream)
        _build.check(lib, err, "flash_variant")
    else:
        # kernel 1's body: LSE [B, H, L] is [B*H, L, 1] in memory
        lens = torch.full((b,), lk, dtype=torch.int32, device=q.device)
        lib = _build.load("flash_fwd", _SIGNATURES)
        err = lib.flash_fwd_f32dots_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, l, lk, h, d, *strides, 0, 0,
            int(bool(causal)), float(scale_s), stream, int(exp2),
            int(split))
        _build.check(lib, err, "flash_fwd_f32dots")
    count_launch(run_fwd_cuda)
    return out, lse


run_fwd_cuda.launches = 0


def _torch_run_fwd(q, k, v, *, causal: bool, block_q: int, block_k: int,
                   bf16_dots: bool = False, use_exp2: bool = False,
                   split_loop: bool = False, pipelined: bool = False):
    """The plain version of one variant, on any device and any tile that
    divides: the TPU kernels' online softmax over KV blocks of ``block_k``,
    with their casts (a bf16 dot is a float32 product of the upcast bf16
    values; P rounds to v's dtype before P . V) and masks.  All q rows go
    at once and every block is masked: a block a row cannot see adds
    exactly nothing (p = 0, rescale 1), so the causal bound and the split,
    which only skip work or a test, do not change the result."""
    _check_shapes(q, k, v, block_q, block_k)
    bf16_dots, exp2, _, _ = variant_flags(bf16_dots, use_exp2, split_loop,
                                          pipelined)
    b, l, h, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5
    exp = torch.exp2 if exp2 else torch.exp

    def to_bh(x):
        return x.transpose(1, 2).reshape(b * h, x.shape[1], d)

    qt, kt, vt = to_bh(q), to_bh(k), to_bh(v)
    qf = qt.float() if bf16_dots else qt.float() * scale
    qpos = torch.arange(l, device=q.device)[:, None]
    o = torch.zeros(b * h, l, d, dtype=torch.float32, device=q.device)
    m = torch.full((b * h, l, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    lsum = torch.zeros_like(m)
    for j in range(lk // block_k):
        kb = kt[:, j * block_k:(j + 1) * block_k]
        vb = vt[:, j * block_k:(j + 1) * block_k]
        s = qf @ kb.float().transpose(1, 2)
        if bf16_dots:
            s = s * (scale * (LOG2E if exp2 else 1.0))
        elif exp2:
            s = s * LOG2E
        kpos = j * block_k + torch.arange(block_k, device=q.device)
        mask = (kpos < lk)[None, :]
        if causal:
            mask = mask & (kpos[None, :] <= qpos)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, exp(s - m_new), 0.0)
        corr = exp(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
        if bf16_dots:
            p = p.to(v.dtype).float()
        o = o * corr + p @ vb.float()
        m = m_new
    l_safe = torch.clamp(lsum, min=1e-30)
    out = (o / l_safe).to(q.dtype).reshape(b, h, l, d).transpose(1, 2)
    lse = m * (1.0 / LOG2E) + torch.log(l_safe) if exp2 else (
        m + torch.log(l_safe))
    return out, lse
