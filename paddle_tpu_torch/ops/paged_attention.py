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

The kernel cuts each row's live blocks into ``kv_splits`` splits and folds
them itself, in split order, so a call is one launch.  ``_split_bounds``
(its cut) and ``fold_splits`` (its fold) are the plain model of that
split arithmetic, which the CPU tests hold against the JAX package; they
are not on the card path.
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
                                                  resolve_impl)


def _default_kv_splits(mb: int) -> int:
    """Flash-decode split count: enough splits to spread a long row's KV
    blocks over the card, never fewer than 8 blocks a split."""
    return max(1, min(8, mb // 8))


_SIGNATURES = {
    "paged_decode_f32": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_void_p]),
    "paged_decode_resources": [ctypes.POINTER(ctypes.c_int)] * 2,
}
# per (device, stream): the kernel's arrival counters, one a (sequence,
# head), zero between launches (the launch that uses them puts them back)
_ARRIVED: dict = {}


def _arrived(dev, stream: int, n: int):
    buf = _ARRIVED.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _ARRIVED[(dev, stream)] = buf
    return buf


def paged_decode_cuda(q, pk, pv, table, pos, *, scale: float,
                      kv_splits: int):
    """Launch ``csrc/paged_decode.cu`` over ``kv_splits`` splits (at most
    max_blocks) of each row's live blocks; the kernel folds the splits
    itself, so a call is one launch and no torch op after it.  Returns
    [S, H, D] float32."""
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
    out = torch.empty((s, h, d), dtype=torch.float32, device=q.device)
    if s == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = arrived = None
    if g > 1:
        # each split's state: acc [D], then its (m, l)
        part = torch.empty((s, g, h, d + 2), dtype=torch.float32,
                           device=q.device)
        arrived = _arrived(q.device, stream, s * h)
    lib = _build.load("paged_decode", _SIGNATURES)
    err = lib.paged_decode_f32(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(),
        pos.data_ptr(), out.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in (part, arrived)),
        s, h, d, pk.shape[1], mb, g, float(scale * LOG2E), stream)
    _build.check(lib, err, "paged_decode")
    paged_decode_cuda.launches += 1
    return out


paged_decode_cuda.launches = 0


def paged_decode_resources() -> tuple:
    """(registers, local bytes a thread) of the kernel, from
    ``cudaFuncGetAttributes``; local bytes past 0 mean it spills.  Needs a
    card."""
    lib = _build.load("paged_decode", _SIGNATURES)
    return _build.resources(lib, lib.paged_decode_resources)


def _split_bounds(pos, bs: int, mb: int, g: int):
    """The kernel's cut (``split_blocks`` in ``csrc/paged_decode.cu``):
    row s's live blocks [0, n), n = min(mb, pos[s] // bs + 1), split j
    takes blocks [j n // g, (j + 1) n // g).  Returns the splits' key
    bounds [S, g, 2] (lo, hi), hi cut at pos[s] + 1; lo >= hi is an empty
    split."""
    pos = torch.as_tensor(pos, dtype=torch.int64)
    n = torch.clamp(pos // bs + 1, max=mb)[:, None]
    edges = torch.arange(g + 1) * n // g                  # [S, g + 1]
    return torch.stack([edges[:, :-1] * bs,
                        torch.minimum(edges[:, 1:] * bs, pos[:, None] + 1)],
                       dim=-1)


def fold_splits(o_part, lse_part):
    """The kernel's fold of the per-split partials, as a plain model (the
    card path folds inside the kernel): O [S, G, H, D] normalised per
    split, natural-log LSE [S, G, H] -> [S, H, D].  With m the largest
    LSE, split j weighs exp(LSE_j - m), and the weighted sums run in split
    order, j = 0 .. G-1; an empty split (LSE about -1e30) weighs 0."""
    w = torch.exp(lse_part - lse_part.max(dim=1, keepdim=True).values)
    num = torch.zeros_like(o_part[:, 0])
    den = torch.zeros_like(lse_part[:, 0])
    for j in range(o_part.shape[1]):
        num = num + o_part[:, j] * w[:, j, :, None]
        den = den + w[:, j]
    return num / den[..., None]


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
    a row's live KV blocks, at most max_blocks (default
    ``_default_kv_splits``).  impl:
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
