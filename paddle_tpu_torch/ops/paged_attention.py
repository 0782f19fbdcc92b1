"""Paged decode attention: the CUDA kernel ``csrc/paged_decode.cu`` and its
plain PyTorch version.

Counterpart of ``paddle_tpu/ops/paged_attention.py``.  Layout as there:
``q`` [S, heads, dh], pool ``[num_blocks, block_size, heads, dh]``,
``table`` [S, max_blocks] int32, ``pos`` [S] int32 - sequence ``i`` attends
logical positions ``<= pos[i]``.  A SlotDecoder slab ``[S, t_max, heads,
dh]`` is the degenerate pool (block_size == t_max, identity table), so one
kernel serves both decode surfaces.

The plain version IS ``paged_gather`` + ``slot_decode_attention``, as the
JAX ``impl="xla"`` path is.  ``impl=None`` routes by device: the kernel
for CUDA tensors, the plain version for CPU ones.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.core.config import LOG2E
from paddle_tpu_torch.layers.attention import (paged_gather,
                                               slot_decode_attention)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.flash_attention import (D_MAX,
                                                  check_kernel_operand,
                                                  merge_partial,
                                                  resolve_impl)


def _default_kv_splits(mb: int) -> int:
    """Flash-decode split count: enough splits to spread a long row's KV
    blocks over the card, never fewer than 8 blocks a split."""
    return max(1, min(8, mb // 8))


_SIGNATURES = {"paged_decode_f32": (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p])}


def paged_decode_cuda(q, pk, pv, table, pos, *, scale: float,
                      kv_splits: int):
    """Launch ``csrc/paged_decode.cu`` over ``kv_splits`` splits and fold
    the per-split partials with ``merge_partial``.  Returns [S, H, D]
    float32."""
    s, h, d = q.shape
    mb = table.shape[1]
    if pk.shape != pv.shape or pk.shape[2:] != (h, d):
        raise ValueError(f"pool {tuple(pk.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if d > D_MAX or d % 4:
        raise ValueError(f"head dim {d}: the kernel takes D <= {D_MAX}, "
                         f"a multiple of 4")
    for name, t in (("q", q), ("pk", pk), ("pv", pv)):
        check_kernel_operand(name, t, q.device)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t, shape in (("table", table, (s, mb)), ("pos", pos, (s,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 {shape} "
                             f"tensor on the device of q")
    g = max(1, min(int(kv_splits), mb))
    o_part = torch.empty((s, g, h, d), dtype=torch.float32, device=q.device)
    lse_part = torch.empty((s, g, h), dtype=torch.float32, device=q.device)
    if s == 0:
        return o_part[:, 0]
    lib = _build.load("paged_decode", _SIGNATURES)
    err = lib.paged_decode_f32(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(),
        pos.data_ptr(), o_part.data_ptr(), lse_part.data_ptr(), s, h, d,
        pk.shape[1], mb, g, float(scale * LOG2E),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "paged_decode")
    paged_decode_cuda.launches += 1
    return fold_splits(o_part, lse_part)


paged_decode_cuda.launches = 0


def fold_splits(o_part, lse_part):
    """Fold the kernel's per-split partials (O [S, G, H, D], natural-log
    LSE [S, G, H]) into [S, H, D] with ``merge_partial``.  The splits
    ride merge_partial's L axis and fold pairwise, halves against halves:
    ceil(log2 G) merges instead of the TPU wrapper's G - 1 sequential
    ones (each merge is a handful of small launches on the host's
    critical path)."""
    o, lse = o_part, lse_part.transpose(1, 2)         # [S,G,H,D], [S,H,G]
    while o.shape[1] > 1:
        half = o.shape[1] // 2
        mo, ml = merge_partial(o[:, :half], lse[..., :half],
                               o[:, half:2 * half], lse[..., half:2 * half])
        if o.shape[1] % 2:                            # odd one rides along
            mo = torch.cat([mo, o[:, 2 * half:]], dim=1)
            ml = torch.cat([ml, lse[..., 2 * half:]], dim=-1)
        o, lse = mo, ml
    return o[:, 0]


def paged_decode_attention(q, pk, pv, table, pos, *,
                           scale: Optional[float] = None,
                           t_max: Optional[int] = None,
                           impl: Optional[str] = None,
                           kv_splits: Optional[int] = None):
    """Single-query attention per sequence against its paged KV prefix.
    Returns [S, heads, dh].

    t_max: logical axis length of the plain version (the model's
    max_len; defaults to max_blocks * block_size) - the kernel masks by
    position and never builds the logical view.  kv_splits: splits over
    a row's KV blocks (default ``_default_kv_splits``).  impl:
    ``"cuda"``, ``"torch"`` or None (by the device of ``q``)."""
    if q.ndim != 3 or pk.ndim != 4 or torch.as_tensor(table).ndim != 2:
        raise ValueError(
            f"paged_decode_attention wants q [S,H,D], pool [NB,BS,H,D], "
            f"table [S,MB]; got {tuple(q.shape)}, {tuple(pk.shape)}, "
            f"{tuple(torch.as_tensor(table).shape)}")
    table = torch.as_tensor(table, dtype=torch.int32, device=q.device)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mb, bs = table.shape[1], pk.shape[1]
    if t_max is None:
        t_max = mb * bs
    if resolve_impl(impl, q) == "torch":
        gk = paged_gather(pk, table, t_max)
        gv = paged_gather(pv, table, t_max)
        return slot_decode_attention(q, gk, gv, pos, scale)
    if kv_splits is None:
        kv_splits = _default_kv_splits(mb)
    return paged_decode_cuda(q, pk, pv, table, pos, scale=scale,
                             kv_splits=kv_splits)
