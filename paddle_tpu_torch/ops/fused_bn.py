"""Training batch norm with a folded activation, and its two statistic
passes: the CUDA kernels ``csrc/bn_stats.cu`` (kernels 7a and 7b) and
their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/fused_bn.py``.  ``bn_act_train`` is the
train-mode BN(+relu or linear) whose backward recomputes the activation's
mask from x and per-channel scalars, so the post-BN tensor is never saved:
its residuals are x, scale, bias, mean and inv, as in the JAX package.
The forward needs per-channel sum x and sum x^2 (``_fwd_stats``), the
backward sum dy and sum dy * xhat (``_bwd_stats``), each one pass over
the activation.

``impl`` takes the JAX package's names or the port's: ``"pallas"`` and
None route the statistics by where x lies (a CUDA tensor launches the
kernels, or raises; a CPU tensor takes the plain version); ``"xla"``,
``"interpret"`` and ``"torch"`` take the plain version on any device;
``"cuda"`` launches the kernels.  Ranks other than 2 and 4 take the plain
version, as the JAX package routes them.

Dtypes, as in the JAX package: x is float32 or, under the bf16 (fp16)
policy, bf16 (float16); scale, bias and the statistics are float32.  y = act(x * w + b) is
in x's dtype, w and b cast to it first (``_fold``); mean and var are
float32 sums of the upcast x.  At bf16 the JAX package's two routes
differ in the backward's sums, and each has its plain version here:
``"xla"`` and ``"torch"`` reproduce the JAX "xla" branch (x-hat and
dy * x-hat computed in bf16, summed in float32; ``_bwd_stats_xla``),
while ``_fwd_stats_ref`` and ``_bwd_stats_ref`` reproduce the Pallas
kernels' arithmetic (x and dout upcast, x-hat in float32; the relu mask
on the fold in x's dtype, ``_fold``) and are the kernels' yardstick, taken on a CPU
tensor under ``"pallas"`` or None and under ``"interpret"`` (the JAX
package's name for running its kernels' arithmetic off the TPU).  At
float32 the two are the same arithmetic; at float16 they differ as at
bf16.  The CUDA kernels take x (and dout) float32, bf16 or float16, the
rest float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.core import config
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.flash_attention import (check_dtype, count_launch,
                                                  resolve_impl)

JAX_IMPLS = {"pallas": None, "xla": "torch", "interpret": "torch"}
_CH = 32              # channels a block of the statistic kernels owns
_TARGET_BLOCKS = 1056  # 8 blocks of 256 threads on each of 132 SMs


# ----------------------------------------------------------- plain versions
def _fold(x, w, b):
    """x * w + b in x's own dtype, w and b cast to it first, as the JAX
    package's jitted steps evaluate it (the kernel's relu mask matches
    it): two rounded ops, except at float16, where XLA's CPU backend
    contracts the two into one float32 multiply-add rounded once (the
    product of two float16 values is exact in float32)."""
    if x.dtype == torch.float16:
        return (x.float() * w.to(x.dtype).float()
                + b.to(x.dtype).float()).to(x.dtype)
    return x * w.to(x.dtype) + b.to(x.dtype)


def _fwd_stats_ref(x2):
    """sum x and sum x^2 over the rows of x2 [P, C], float32 on the upcast
    x (the JAX package's kernel and its "xla" branch alike)."""
    xf = x2.float()
    return xf.sum(dim=0), (xf * xf).sum(dim=0)


def _relu_dy(dout2, x2, w, b, relu: bool):
    """dout where the fold is > 0 (relu), or dout (linear)."""
    if not relu:
        return dout2
    return torch.where(_fold(x2, w, b) > 0, dout2, torch.zeros_like(dout2))


def _bwd_stats_ref(dout2, x2, w, b, mean, inv, relu: bool):
    """sum dy and sum dy * xhat over the rows of [P, C] as the Pallas
    kernel takes them: the mask on the fold in x's dtype, then dout and x
    upcast, xhat float32."""
    dy = _relu_dy(dout2, x2, w, b, relu).float()
    xhat = (x2.float() - mean) * inv
    return dy.sum(dim=0), (dy * xhat).sum(dim=0)


def _bwd_stats_xla(dout2, x2, w, b, mean, inv, relu: bool):
    """The same two sums as the JAX package's "xla" branch takes them:
    xhat and dy * xhat in x's dtype, each sum accumulated in float32."""
    dy = _relu_dy(dout2, x2, w, b, relu)
    xhat = (x2 - mean.to(x2.dtype)) * inv.to(x2.dtype)
    return (dy.sum(dim=0, dtype=torch.float32),
            (dy * xhat).sum(dim=0, dtype=torch.float32))


# ------------------------------------------------------------------ kernels
_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16
# the activation's dtype (x and dout here; x and w in ops/conv_bn.py) ->
# the C entries' suffix; per-channel vectors and statistics are float32
KERNEL_DTYPES = {_F32: "f32", _BF16: "bf16", _F16: "f16"}
_SIGNATURES = {
    **{f"bn_fwd_stats_{sfx}": [ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int,
                               ctypes.c_longlong] + [ctypes.c_void_p] * 4
       for sfx in KERNEL_DTYPES.values()},
    **{f"bn_bwd_stats_{sfx}": [ctypes.c_void_p] * 6
       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
          ctypes.c_longlong] + [ctypes.c_void_p] * 4
       for sfx in KERNEL_DTYPES.values()},
}


def _slabs(p: int, c: int):
    """(R, rows a slab): R slabs of rows, so that the grid holds about
    _TARGET_BLOCKS blocks (and at most 65535 slabs)."""
    ch_blocks = -(-c // _CH)
    r = max(1, min(-(-_TARGET_BLOCKS // ch_blocks), -(-p // 64), 65535))
    slab = -(-p // r)
    return -(-p // slab), slab


def check_operand(name, t, device, shape=None, dtypes=(_F32,)):
    """What the statistic and conv kernels take: one of ``dtypes`` on the
    launch device, of ``shape`` when given, contiguous."""
    check_dtype(name, t, dtypes)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous "
                         f"tensor")


def on_card(x) -> None:
    """Raise unless x (to whose device the other operands were held) lies
    on a CUDA device: the launch wrappers never take a CPU tensor."""
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernel takes tensors on a CUDA device, "
                         f"got {x.device}")


def bn_fwd_stats_cuda(x2):
    """Kernel 7a on x2 [P, C], float32, bf16 or float16: (sum x, sum x^2),
    float32
    [C] each.  One call is two launches (partials, then their fixed-order
    sum), counted as one."""
    p, c = x2.shape
    check_operand("x", x2, x2.device, dtypes=tuple(KERNEL_DTYPES))
    on_card(x2)
    s = torch.zeros(c, device=x2.device)
    sq = torch.zeros(c, device=x2.device)
    if p == 0 or c == 0:
        return s, sq
    r, slab = _slabs(p, c)
    part = torch.empty(2, r, c, device=x2.device)
    lib = _build.load("bn_stats", _SIGNATURES)
    err = getattr(lib, f"bn_fwd_stats_{KERNEL_DTYPES[x2.dtype]}")(
        x2.data_ptr(), p, c, r, slab, part.data_ptr(), s.data_ptr(),
        sq.data_ptr(), torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(lib, err, "bn_fwd_stats")
    count_launch(bn_fwd_stats_cuda, x2.dtype)
    return s, sq


# every launch, and those of the bf16 and float16 instances alone
bn_fwd_stats_cuda.launches = bn_fwd_stats_cuda.launches_bf16 = 0
bn_fwd_stats_cuda.launches_f16 = 0


def bn_bwd_stats_cuda(dout2, x2, w, b, mean, inv, relu: bool):
    """Kernel 7b on dout2, x2 [P, C] (both float32, bf16 or float16) with
    per-channel float32 w, b, mean, inv [C]: (sum dy, sum dy * xhat),
    float32 [C] each; dy = dout where the fold x * w + b, in x's dtype, is
    > 0 (relu) or everywhere (linear).  Two launches, counted as one."""
    p, c = x2.shape
    dev = x2.device
    check_operand("x", x2, dev, dtypes=tuple(KERNEL_DTYPES))
    check_operand("dout", dout2, dev, (p, c), dtypes=(x2.dtype,))
    for name, t in (("w", w), ("b", b), ("mean", mean), ("inv", inv)):
        check_operand(name, t, dev, (c,))
    on_card(x2)
    sdy = torch.zeros(c, device=dev)
    sdyx = torch.zeros(c, device=dev)
    if p == 0 or c == 0:
        return sdy, sdyx
    r, slab = _slabs(p, c)
    part = torch.empty(2, r, c, device=dev)
    lib = _build.load("bn_stats", _SIGNATURES)
    err = getattr(lib, f"bn_bwd_stats_{KERNEL_DTYPES[x2.dtype]}")(
        dout2.data_ptr(), x2.data_ptr(), w.data_ptr(), b.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), p, c, int(relu), r, slab,
        part.data_ptr(), sdy.data_ptr(), sdyx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "bn_bwd_stats")
    count_launch(bn_bwd_stats_cuda, x2.dtype)
    return sdy, sdyx


bn_bwd_stats_cuda.launches = bn_bwd_stats_cuda.launches_bf16 = 0
bn_bwd_stats_cuda.launches_f16 = 0


def fwd_stats(x2, *, impl: Optional[str] = None):
    """(sum x, sum x^2) over the rows of x2 [P, C]; impl as in the module
    docstring (None: by the device of x2)."""
    if resolve(impl, x2) == "torch":
        return _fwd_stats_ref(x2)
    return bn_fwd_stats_cuda(x2)


def bwd_stats(dout2, x2, w, b, mean, inv, relu: bool, *,
              impl: Optional[str] = None):
    """(sum dy, sum dy * xhat) over the rows of [P, C]; impl as
    ``fwd_stats``, "xla" and "torch" with the JAX "xla" branch's
    arithmetic (``_bwd_stats_xla``)."""
    if resolve(impl, x2) == "cuda":
        return bn_bwd_stats_cuda(dout2, x2, w, b, mean, inv, relu)
    if impl in ("xla", "torch"):
        return _bwd_stats_xla(dout2, x2, w, b, mean, inv, relu)
    return _bwd_stats_ref(dout2, x2, w, b, mean, inv, relu)


# --------------------------------------------------------------- public op
def resolve(impl, x) -> str:
    """The JAX package's impl names (``"pallas"``, ``"xla"``,
    ``"interpret"``) or the port's (None, ``"cuda"``, ``"torch"``) ->
    ``"cuda"`` or ``"torch"`` for tensor x."""
    return resolve_impl(JAX_IMPLS.get(impl, impl), x)


def _check_impl(impl, x) -> str:
    """bn_act_train's route for tensor x: ``"cuda"`` (the kernels),
    ``"interpret"`` (their plain versions) or ``"xla"`` (the JAX "xla"
    branch's arithmetic); ranks other than 2 and 4 take ``"xla"``, the JAX
    package's routing, not a fallback."""
    route = resolve(impl, x)
    if x.ndim not in (2, 4) or impl in ("xla", "torch"):
        return "xla"
    return route if route == "cuda" else "interpret"


def _fwd_stats(x, impl):
    """(mean, E[x^2]) per channel of x [..., C]."""
    c = x.shape[-1]
    n = x.numel() // c
    s, sq = fwd_stats(x.contiguous().view(-1, c), impl=impl)
    return s / n, sq / n


def _bwd_stats(dout, x, w, b, mean, inv, act, impl):
    c = x.shape[-1]
    return bwd_stats(dout.contiguous().view(-1, c),
                     x.contiguous().view(-1, c), w, b, mean, inv,
                     act == "relu", impl=impl)


def _act_apply(act, y):
    return torch.relu(y) if act == "relu" else y


class _BnActTrain(torch.autograd.Function):
    """act(bn(x)) -> (y, mean, var) with the JAX package's custom vjp
    (``_bn_act_fwd`` / ``_bn_act_bwd``) and its dtypes: y and dx in x's,
    mean and var float32, dscale and dbias in the scale's."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, act, impl):
        mean, mean2 = _fwd_stats(x, impl)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        w = scale.float() * inv
        b = bias.float() - mean * w
        y = _act_apply(act, _fold(x, w, b))
        ctx.save_for_backward(x, scale, bias, mean, inv)
        ctx.act, ctx.impl = act, impl
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dout, dmean, dvar):
        x, scale, bias, mean, inv = ctx.saved_tensors
        act = ctx.act
        n = x.numel() // x.shape[-1]
        if dout is None:
            dout = torch.zeros_like(x)
        w = scale.float() * inv
        b = bias.float() - mean * w
        sum_dy, sum_dy_xhat = _bwd_stats(dout, x, w, b, mean, inv, act,
                                         ctx.impl)
        # dx: one elementwise pass in x's dtype, dy recomputed here
        dy = _relu_dy(dout, x, w, b, act == "relu")
        xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        c1 = (sum_dy / n).to(x.dtype)
        c2 = (sum_dy_xhat / n).to(x.dtype)
        dx = w.to(x.dtype) * (dy - c1 - xhat * c2)
        # the mean and var outputs' cotangents (None in a train step)
        if dmean is not None:
            dx = dx + (dmean / n).to(x.dtype)
        if dvar is not None:
            dx = dx + ((2.0 / n) * dvar).to(x.dtype) * (x - mean.to(x.dtype))
        return (dx, sum_dy_xhat.to(scale.dtype), sum_dy.to(scale.dtype),
                None, None, None)


def bn_act_train(x, scale, bias, eps: float, act: str,
                 impl: Optional[str] = None):
    """Training BN with folded activation: act(bn(x)) -> (y, mean, var).

    x [..., C] float32, bf16 or float16 (y in x's dtype; mean and var
    float32);
    scale and bias float32; act ``"linear"`` or ``"relu"``; impl as in the
    module docstring.  Biased variance E[x^2] - mean^2, clamped at 0; eps
    under the rsqrt."""
    if act not in ("linear", "relu"):
        raise ValueError(f"bn_act_train folds 'linear' or 'relu', got "
                         f"{act!r}")
    return _BnActTrain.apply(x, scale, bias, float(eps), act,
                             _check_impl(impl, x))


def default_impl() -> str:
    """The ``fused_bn_impl`` option, else ``"xla"``: BN takes the plain
    statistics unless asked for the kernels, the JAX package's default.
    (The JAX package's ``PADDLE_TPU_FUSED_BN`` environment variable is not
    read.)"""
    return config.get_option("fused_bn_impl") or "xla"
