"""Convolutions with the batch-norm statistics in their epilogue: the CUDA
kernels ``csrc/conv_bn.cu`` (kernel 8, the 1x1 conv as a product; kernel
9, the 3x3 stride-1 SAME conv) and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/conv_bn.py``, with its layouts: NHWC
activations, HWIO kernels.  Each forward returns (y, s, ss): y and its
per-channel sum and sum of squares, float32 [Co], taken in the kernel
while y is in registers, so the batch norm that follows needs no pass of
its own over y.

The autograd Functions mirror the JAX package's custom vjps: the
backward folds the statistics' cotangents into one effective dy (d sum /
dy = 1, d sum y^2 / dy = 2 y) and then runs the products of a plain
backward - ``torch.matmul`` for the 1x1, ``torch.nn.grad.conv2d_input`` /
``conv2d_weight`` for the 3x3 - which the JAX package leaves to XLA.

``impl`` takes the JAX package's names or the port's, as in
``ops/fused_bn.py``: ``"pallas"`` and None route by where x lies (a CUDA
tensor launches the kernel, or raises; a CPU tensor takes the plain
version), ``"xla"``, ``"interpret"`` and ``"torch"`` take the plain
version on any device, ``"cuda"`` launches the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.fused_bn import resolve

_BM = 128    # output pixels a block of the kernels owns


def conv2d_nhwc(x, w, stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                groups=1):
    """``F.conv2d`` on NHWC x and an HWIO kernel, NHWC out (the plain conv:
    ``lax.conv_general_dilated`` in the JAX package).  Symmetric padding
    (ph, pw)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                 stride, padding, dilation, groups)
    return y.permute(0, 2, 3, 1)


# ----------------------------------------------------------- plain versions
def _matmul_stats_ref(x2, w2):
    y = x2 @ w2
    return y, y.sum(dim=0), (y * y).sum(dim=0)


def _conv3x3_stats_ref(x4, w4):
    y = conv2d_nhwc(x4, w4, padding=(1, 1)).contiguous()
    return y, y.sum(dim=(0, 1, 2)), (y * y).sum(dim=(0, 1, 2))


# ------------------------------------------------------------------ kernels
_SIGNATURES = {
    "matmul_stats_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p] * 5,
    "conv3x3_stats_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p] * 5,
}


def _check(name, t, device, shape):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                        f"{t.dtype} (bf16 instances: ROADMAP.md section 2, "
                        f"K4; float16: K5)")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous "
                         f"tensor")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} elements overflow the "
                         f"kernel's 32-bit indices")


def _vec(ci, co, *tensors) -> int:
    """1 where the kernel may use 16-byte loads and stores."""
    return int(ci % 4 == 0 and co % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _outputs(rows, co, shape, device):
    y = torch.empty(shape, device=device)
    s = torch.zeros(co, device=device)
    ss = torch.zeros(co, device=device)
    part = torch.empty(2, -(-rows // _BM), co, device=device)
    return y, s, ss, part


def matmul_stats_cuda(x2, w2):
    """Kernel 8: (y = x2 @ w2, sum y, sum y^2) for x2 [P, Ci], w2 [Ci, Co].
    One call is two launches (the product with its partial statistics,
    then their fixed-order sum), counted as one."""
    p, ci = x2.shape
    co = w2.shape[1]
    dev = x2.device
    _check("x", x2, dev, (p, ci))
    _check("w", w2, dev, (ci, co))
    y, s, ss, part = _outputs(p, co, (p, co), dev)
    if p == 0 or co == 0:
        return y, s, ss
    lib = _build.load("conv_bn", _SIGNATURES)
    err = lib.matmul_stats_f32(
        x2.data_ptr(), w2.data_ptr(), p, ci, co, _vec(ci, co, x2, w2, y),
        y.data_ptr(), part.data_ptr(), s.data_ptr(), ss.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "matmul_stats")
    matmul_stats_cuda.launches += 1
    return y, s, ss


matmul_stats_cuda.launches = 0


def conv3x3_stats_cuda(x4, w4):
    """Kernel 9: the 3x3 stride-1 SAME conv of x4 [N, H, W, Ci] with w4
    [3, 3, Ci, Co], with sum y and sum y^2 per channel.  Two launches,
    counted as one."""
    n, h, w, ci = x4.shape
    co = w4.shape[-1]
    dev = x4.device
    _check("x", x4, dev, (n, h, w, ci))
    _check("w", w4, dev, (3, 3, ci, co))
    y, s, ss, part = _outputs(n * h * w, co, (n, h, w, co), dev)
    if y.numel() == 0:
        return y, s, ss
    lib = _build.load("conv_bn", _SIGNATURES)
    err = lib.conv3x3_stats_f32(
        x4.data_ptr(), w4.data_ptr(), n, h, w, ci, co,
        _vec(ci, co, x4, w4, y), y.data_ptr(), part.data_ptr(),
        s.data_ptr(), ss.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "conv3x3_stats")
    conv3x3_stats_cuda.launches += 1
    return y, s, ss


conv3x3_stats_cuda.launches = 0


def _dy_eff(dy, ds, dss, y):
    """dy with the statistics' cotangents folded in (channel last)."""
    g = torch.zeros_like(y) if dy is None else dy
    if ds is not None:
        g = g + ds
    if dss is not None:
        g = g + 2.0 * y * dss
    return g


# --------------------------------------------------------------- autograd
class _MatmulStats(torch.autograd.Function):
    """(y, s, ss) = (x2 @ w2, column sums, column sums of squares) with the
    JAX package's vjp (``_matmul_stats_bwd_rule``)."""

    @staticmethod
    def forward(ctx, x2, w2, route):
        y, s, ss = (matmul_stats_cuda(x2.contiguous(), w2.contiguous())
                    if route == "cuda" else _matmul_stats_ref(x2, w2))
        ctx.save_for_backward(x2, w2, y)
        ctx.set_materialize_grads(False)
        return y, s, ss

    @staticmethod
    def backward(ctx, dy, ds, dss):
        x2, w2, y = ctx.saved_tensors
        g = _dy_eff(dy, ds, dss, y)
        return g @ w2.t(), x2.t() @ g, None


class _Conv3x3Stats(torch.autograd.Function):
    """The 3x3 stride-1 SAME conv and its statistics, with the JAX
    package's vjp (``_conv3x3_bwd_rule``): the conv's own transposes."""

    @staticmethod
    def forward(ctx, x4, w4, route):
        y, s, ss = (conv3x3_stats_cuda(x4.contiguous(), w4.contiguous())
                    if route == "cuda" else _conv3x3_stats_ref(x4, w4))
        ctx.save_for_backward(x4, w4, y)
        ctx.set_materialize_grads(False)
        return y, s, ss

    @staticmethod
    def backward(ctx, dy, ds, dss):
        x4, w4, y = ctx.saved_tensors
        g = _dy_eff(dy, ds, dss, y).permute(0, 3, 1, 2)
        xn, wn = x4.permute(0, 3, 1, 2), w4.permute(3, 2, 0, 1)
        dx = torch.nn.grad.conv2d_input(xn.shape, wn, g, padding=1)
        dw = torch.nn.grad.conv2d_weight(xn, wn.shape, g, padding=1)
        return (dx.permute(0, 2, 3, 1).contiguous(),
                dw.permute(2, 3, 1, 0).contiguous(), None)


def matmul_stats(x2, w2, impl: Optional[str] = None):
    """Differentiable (y, s, ss) = (x2 @ w2, sum y, sum y^2) per column."""
    return _MatmulStats.apply(x2, w2, resolve(impl, x2))


def conv1x1_stats(x4, w4, impl: Optional[str] = None):
    """1x1 stride-1 conv + statistics. x4 [N, H, W, Ci], w4 [1, 1, Ci, Co]
    -> (y4 [N, H, W, Co], s [Co], ss [Co])."""
    n, h, w, ci = x4.shape
    co = w4.shape[-1]
    y2, s, ss = matmul_stats(x4.reshape(n * h * w, ci), w4.reshape(ci, co),
                             impl)
    return y2.reshape(n, h, w, co), s, ss


def conv3x3_stats(x4, w4, impl: Optional[str] = None):
    """Differentiable 3x3 stride-1 SAME conv + statistics. x4 [N, H, W,
    Ci], w4 [3, 3, Ci, Co] -> (y4, s [Co], ss [Co])."""
    return _Conv3x3Stats.apply(x4, w4, resolve(impl, x4))
