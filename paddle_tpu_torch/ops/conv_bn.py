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

Dtypes, as in the JAX package: x and w are float32 or, under the bf16
(fp16) policy, both bf16 (float16).  y is computed in float32 (16-bit
products are exact in float32, the sums float32), s and ss are taken from
that unrounded y, and only then is y rounded to x's dtype (at float16 a
y past 65504 becomes inf, as in the JAX package).  The backward folds the
statistics' cotangents in float32, casts the effective dy to x's dtype,
and runs the products on operands of that dtype, so dx and dw come back
in x's and w's.  The CUDA kernels have an instance for each: float32,
bf16 or float16 operands.  The bf16 and float16 instances of both
kernels run on the tensor cores (16-bit products accumulated in float32:
the same y up to the order of the sums); the float32 instances of both
run there too, as split TF32 (3xTF32: every product three TF32 products
of the operands' hi and lo parts, within 3 * 2^-22 of |a||b|;
``_tf32x3_matmul_stats`` and ``_tf32x3_conv3x3_stats`` in plain torch).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.flash_attention import _tf32x3, count_launch
from paddle_tpu_torch.ops.fused_bn import (_F32, KERNEL_DTYPES,
                                           check_operand, on_card, resolve)

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
    y = x2.float() @ w2.float()
    return y.to(x2.dtype), y.sum(dim=0), (y * y).sum(dim=0)


def _conv3x3_stats_ref(x4, w4):
    y = conv2d_nhwc(x4.float(), w4.float(), padding=(1, 1)).contiguous()
    return y.to(x4.dtype), y.sum(dim=(0, 1, 2)), (y * y).sum(dim=(0, 1, 2))


def _tf32x3_matmul_stats(x2, w2, terms: int = 3):
    """The arithmetic of kernel 8's float32 instance (the 3xTF32
    ``conv_tf32_stats_kernel<1, W>`` of ``csrc/conv_bn.cu``) in plain
    torch: y = x2 [P, Ci] times w2 [Ci, Co], both float32, the product as
    ``_tf32x3``; the sums of y and y^2 per column from that unrounded y.
    Never on the kernel route: the tests hold it against the JAX package,
    ``chip_smoke.py`` the kernel against it.  ``terms=1`` takes the product
    as one TF32 product (hi . hi): a planted fault, which the checks must
    catch."""
    y = _tf32x3("pk,kc->pc", x2.float(), w2.float(), terms)
    return y, y.sum(dim=0), (y * y).sum(dim=0)


def _tf32x3_conv3x3_stats(x4, w4, terms: int = 3):
    """The arithmetic of kernel 9's float32 instance (the 3xTF32
    ``conv_tf32_stats_kernel<9, W>`` of ``csrc/conv_bn.cu``) in plain torch:
    y = the im2col patches of float32 x4 [N, H, W, Ci] (3x3, SAME, column
    (dh * 3 + dw) * Ci + ci, zeros outside the image) times w4 [3, 3, Ci,
    Co] read as [9 Ci, Co], the product as ``_tf32x3``; the sums of y and
    y^2 per channel from that unrounded y.  Never on the kernel route: the
    tests hold it against the JAX package, ``chip_smoke.py`` the kernel
    against it.  ``terms=1`` takes the product as one TF32 product (hi .
    hi): a planted fault, which the checks must catch."""
    n, h, w, ci = x4.shape
    co = w4.shape[-1]
    xp = F.pad(x4.float(), (0, 0, 1, 1, 1, 1))
    patches = torch.cat([xp[:, dh:dh + h, dw:dw + w] for dh in range(3)
                         for dw in range(3)], dim=-1)
    y = _tf32x3("pk,kc->pc", patches.reshape(n * h * w, 9 * ci),
                w4.float().reshape(9 * ci, co), terms)
    return y.reshape(n, h, w, co), y.sum(dim=0), (y * y).sum(dim=0)


# ------------------------------------------------------------------ kernels
_SIGNATURES = {
    **{f"matmul_stats_{sfx}": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
       + [ctypes.c_void_p] * 5 for sfx in KERNEL_DTYPES.values()},
    **{f"conv3x3_stats_{sfx}": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
       + [ctypes.c_void_p] * 5 for sfx in KERNEL_DTYPES.values()},
    "conv_mma_resources": [ctypes.c_int] * 3
                          + [ctypes.POINTER(ctypes.c_int)] * 2,
    "conv_tf32_resources": [ctypes.c_int] * 2
                           + [ctypes.POINTER(ctypes.c_int)] * 2,
}
# the 16-bit instances: elements a copy, for _vec(wide=True) = 2, 1, 0
CONV_MMA_WIDTHS = (8, 4, 1)
# the float32 instances: floats a copy, for _vec() = 1, 0
CONV_TF32_WIDTHS = (4, 1)
# the A operand of every instance: taps gathered a pixel (kernel 8's dense
# x, kernel 9's 3x3 patches)
CONV_MMA_TAPS = {"matmul": 1, "conv3x3": 9}


def _check(name, t, device, shape, dtypes=tuple(KERNEL_DTYPES)):
    check_operand(name, t, device, shape, dtypes)
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} elements overflow the "
                         f"kernel's 32-bit indices")


def _vec(ci, co, *tensors, wide: bool = False) -> int:
    """How the kernel may stage its operands: 1 where it may move 4
    elements a load and store (16 bytes of float32, 8 of bf16 or float16),
    Ci and Co multiples of 4 and every operand aligned to 4 elements, else
    0 (one element at a time).  With ``wide`` (the 16-bit instances, whose
    cp.async copies also take 16 bytes of 16-bit elements) 2 where Ci and Co are
    multiples of 8 and every operand is aligned to 8 elements."""
    def fits(n):
        align = n * tensors[0].element_size()
        return (ci % n == 0 and co % n == 0
                and all(t.data_ptr() % align == 0 for t in tensors))

    if wide and fits(8):
        return 2
    return int(fits(4))


def _outputs(rows, co, shape, device, dtype, extra: int = 0):
    """y, the two sums and the kernels' scratch: the [2, R, Co] partial
    statistics and ``extra`` floats after them."""
    y = torch.empty(shape, device=device, dtype=dtype)
    s = torch.zeros(co, device=device)
    ss = torch.zeros(co, device=device)
    part = torch.empty(2 * -(-rows // _BM) * co + extra, device=device)
    return y, s, ss, part


def _w_planes_floats(ci, co, taps) -> int:
    """Scratch of the float32 instances after their partial statistics:
    up to 3 floats to a 16-byte boundary, then w's two TF32 planes [taps,
    Co rounded up to 64, Ci rounded up to 32]."""
    return 4 + 2 * taps * (-(-co // 64) * 64) * (-(-ci // 32) * 32)


def matmul_stats_cuda(x2, w2):
    """Kernel 8: (y = x2 @ w2, sum y, sum y^2) for x2 [P, Ci], w2 [Ci, Co],
    both float32, bf16 or float16; y in their dtype, the sums float32 of
    the unrounded y.  float32 runs the 3xTF32 tensor-core kernel
    (``_tf32x3_matmul_stats``' arithmetic), copying 16 bytes or one float
    at a time as ``_vec`` finds; bf16 and float16 the 16-bit tensor-core
    kernel, copying 16 bytes, 8 or one element at a time as
    ``_vec(wide=True)`` finds.  Three launches (the product with its
    partial statistics, then their fixed-order sum over chunks of rows and
    over the chunks; at float32 a fourth first, which splits w into TF32
    planes in the scratch after the partials), counted as one."""
    p, ci = x2.shape
    co = w2.shape[1]
    dev = x2.device
    _check("x", x2, dev, (p, ci))
    _check("w", w2, dev, (ci, co), dtypes=(x2.dtype,))
    on_card(x2)
    y, s, ss, part = _outputs(
        p, co, (p, co), dev, x2.dtype,
        _w_planes_floats(ci, co, 1) if x2.dtype == _F32 else 0)
    if p == 0 or co == 0:
        return y, s, ss
    lib = _build.load("conv_bn", _SIGNATURES)
    err = getattr(lib, f"matmul_stats_{KERNEL_DTYPES[x2.dtype]}")(
        x2.data_ptr(), w2.data_ptr(), p, ci, co,
        _vec(ci, co, x2, w2, y, wide=x2.dtype != _F32), y.data_ptr(),
        part.data_ptr(), s.data_ptr(), ss.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "matmul_stats")
    count_launch(matmul_stats_cuda, x2.dtype)
    return y, s, ss


# every launch, and those of the bf16 and float16 instances alone
matmul_stats_cuda.launches = matmul_stats_cuda.launches_bf16 = 0
matmul_stats_cuda.launches_f16 = 0


def conv3x3_stats_cuda(x4, w4):
    """Kernel 9: the 3x3 stride-1 SAME conv of x4 [N, H, W, Ci] with w4
    [3, 3, Ci, Co] (both float32, bf16 or float16; y in their dtype),
    with sum y and sum y^2 per channel, float32.  float32 runs the 3xTF32
    tensor-core kernel (``_tf32x3_conv3x3_stats``' arithmetic), copying 16
    bytes or one float at a time as ``_vec`` finds; bf16 and float16 the
    16-bit tensor-core kernel, copying 16 bytes, 8 or one element at a
    time as ``_vec(wide=True)`` finds.  Three launches (the product with
    its partial statistics, then their fixed-order sum over chunks of rows
    and over the chunks; at float32 a fourth first, which splits w into
    TF32 planes in the scratch after the partials), counted as one."""
    n, h, w, ci = x4.shape
    co = w4.shape[-1]
    dev = x4.device
    _check("x", x4, dev, (n, h, w, ci))
    _check("w", w4, dev, (3, 3, ci, co), dtypes=(x4.dtype,))
    on_card(x4)
    y, s, ss, part = _outputs(
        n * h * w, co, (n, h, w, co), dev, x4.dtype,
        _w_planes_floats(ci, co, 9) if x4.dtype == _F32 else 0)
    if y.numel() == 0:
        return y, s, ss
    lib = _build.load("conv_bn", _SIGNATURES)
    err = getattr(lib, f"conv3x3_stats_{KERNEL_DTYPES[x4.dtype]}")(
        x4.data_ptr(), w4.data_ptr(), n, h, w, ci, co,
        _vec(ci, co, x4, w4, y, wide=x4.dtype != _F32), y.data_ptr(),
        part.data_ptr(), s.data_ptr(), ss.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "conv3x3_stats")
    count_launch(conv3x3_stats_cuda, x4.dtype)
    return y, s, ss


conv3x3_stats_cuda.launches = conv3x3_stats_cuda.launches_bf16 = 0
conv3x3_stats_cuda.launches_f16 = 0


def conv_mma_resources(dtype=torch.bfloat16) -> dict:
    """Registers and local memory (bytes a thread; nonzero means the
    kernel spills or keeps a stack) of the tensor-core instances of
    kernels 8 and 9 on ``dtype`` (bf16 or float16) at each copy width,
    from ``cudaFuncGetAttributes``: ``{"matmul_w8": (regs, local_bytes),
    ..., "conv3x3_w1": ...}``.  Needs a card."""
    lib = _build.load("conv_bn", _SIGNATURES)
    half = int(dtype == torch.float16)
    return {f"{name}_w{width}": _build.resources(
        lib, lib.conv_mma_resources, taps, width, half)
        for name, taps in CONV_MMA_TAPS.items()
        for width in CONV_MMA_WIDTHS}


def conv_tf32_resources() -> dict:
    """Registers and local memory (bytes a thread; nonzero means the
    kernel spills or keeps a stack) of the float32 (3xTF32) instances of
    kernels 8 and 9 at each copy width, from ``cudaFuncGetAttributes``:
    ``{"matmul_w4": (regs, local_bytes), ..., "conv3x3_w1": ...}``.  Needs
    a card."""
    lib = _build.load("conv_bn", _SIGNATURES)
    return {f"{name}_w{width}": _build.resources(
        lib, lib.conv_tf32_resources, taps, width)
        for name, taps in CONV_MMA_TAPS.items()
        for width in CONV_TF32_WIDTHS}


def _dy_eff(dy, ds, dss, y, dtype):
    """dy with the statistics' cotangents folded in (channel last), in
    float32, then cast to the operands' ``dtype``."""
    g = torch.zeros_like(y, dtype=torch.float32) if dy is None else dy.float()
    if ds is not None:
        g = g + ds
    if dss is not None:
        g = g + 2.0 * y.float() * dss
    return g.to(dtype)


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
        g = _dy_eff(dy, ds, dss, y, x2.dtype)
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
        g = _dy_eff(dy, ds, dss, y, x4.dtype).permute(0, 3, 1, 2)
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
