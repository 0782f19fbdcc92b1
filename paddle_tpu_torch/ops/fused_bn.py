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
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.core import config
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.flash_attention import resolve_impl

JAX_IMPLS = {"pallas": None, "xla": "torch", "interpret": "torch"}
_CH = 32              # channels a block of the statistic kernels owns
_TARGET_BLOCKS = 1056  # 8 blocks of 256 threads on each of 132 SMs


# ----------------------------------------------------------- plain versions
def _fold(x, w, b):
    """x * w + b as two rounded ops (the kernel's relu mask matches it)."""
    return x * w + b


def _fwd_stats_ref(x2):
    """sum x and sum x^2 over the rows of x2 [P, C]."""
    return x2.sum(dim=0), (x2 * x2).sum(dim=0)


def _bwd_stats_ref(dout2, x2, w, b, mean, inv, relu: bool):
    """sum dy and sum dy * xhat over the rows of [P, C], dy the activation's
    backward of dout."""
    dy = (torch.where(_fold(x2, w, b) > 0, dout2, torch.zeros_like(dout2))
          if relu else dout2)
    xhat = (x2 - mean) * inv
    return dy.sum(dim=0), (dy * xhat).sum(dim=0)


# ------------------------------------------------------------------ kernels
_SIGNATURES = {
    "bn_fwd_stats_f32": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_int, ctypes.c_longlong]
                        + [ctypes.c_void_p] * 4,
    "bn_bwd_stats_f32": [ctypes.c_void_p] * 6
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_longlong]
                        + [ctypes.c_void_p] * 4,
}


def _slabs(p: int, c: int):
    """(R, rows a slab): R slabs of rows, so that the grid holds about
    _TARGET_BLOCKS blocks (and at most 65535 slabs)."""
    ch_blocks = -(-c // _CH)
    r = max(1, min(-(-_TARGET_BLOCKS // ch_blocks), -(-p // 64), 65535))
    slab = -(-p // r)
    return -(-p // slab), slab


def _check(name, t, device, shape=None):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                        f"{t.dtype} (bf16 instances: ROADMAP.md section 2, "
                        f"K3; float16: K5)")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous "
                         f"tensor")


def bn_fwd_stats_cuda(x2):
    """Kernel 7a on x2 [P, C]: (sum x, sum x^2), float32 [C] each.  One
    call is two launches (partials, then their fixed-order sum), counted
    as one."""
    p, c = x2.shape
    _check("x", x2, x2.device)
    s = torch.zeros(c, device=x2.device)
    sq = torch.zeros(c, device=x2.device)
    if p == 0 or c == 0:
        return s, sq
    r, slab = _slabs(p, c)
    part = torch.empty(2, r, c, device=x2.device)
    lib = _build.load("bn_stats", _SIGNATURES)
    err = lib.bn_fwd_stats_f32(
        x2.data_ptr(), p, c, r, slab, part.data_ptr(), s.data_ptr(),
        sq.data_ptr(), torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(lib, err, "bn_fwd_stats")
    bn_fwd_stats_cuda.launches += 1
    return s, sq


bn_fwd_stats_cuda.launches = 0


def bn_bwd_stats_cuda(dout2, x2, w, b, mean, inv, relu: bool):
    """Kernel 7b on dout2, x2 [P, C] with per-channel w, b, mean, inv [C]:
    (sum dy, sum dy * xhat), float32 [C] each; dy = dout where the fold
    x * w + b is > 0 (relu) or everywhere (linear).  Two launches, counted
    as one."""
    p, c = x2.shape
    dev = x2.device
    _check("x", x2, dev)
    _check("dout", dout2, dev, (p, c))
    for name, t in (("w", w), ("b", b), ("mean", mean), ("inv", inv)):
        _check(name, t, dev, (c,))
    sdy = torch.zeros(c, device=dev)
    sdyx = torch.zeros(c, device=dev)
    if p == 0 or c == 0:
        return sdy, sdyx
    r, slab = _slabs(p, c)
    part = torch.empty(2, r, c, device=dev)
    lib = _build.load("bn_stats", _SIGNATURES)
    err = lib.bn_bwd_stats_f32(
        dout2.data_ptr(), x2.data_ptr(), w.data_ptr(), b.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), p, c, int(relu), r, slab,
        part.data_ptr(), sdy.data_ptr(), sdyx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "bn_bwd_stats")
    bn_bwd_stats_cuda.launches += 1
    return sdy, sdyx


bn_bwd_stats_cuda.launches = 0


def fwd_stats(x2, *, impl: Optional[str] = None):
    """(sum x, sum x^2) over the rows of x2 [P, C]; impl as in the module
    docstring (None: by the device of x2)."""
    if resolve(impl, x2) == "torch":
        return _fwd_stats_ref(x2)
    return bn_fwd_stats_cuda(x2)


def bwd_stats(dout2, x2, w, b, mean, inv, relu: bool, *,
              impl: Optional[str] = None):
    """(sum dy, sum dy * xhat) over the rows of [P, C]; impl as
    ``fwd_stats``."""
    if resolve(impl, x2) == "torch":
        return _bwd_stats_ref(dout2, x2, w, b, mean, inv, relu)
    return bn_bwd_stats_cuda(dout2, x2, w, b, mean, inv, relu)


# --------------------------------------------------------------- public op
def resolve(impl, x) -> str:
    """The JAX package's impl names (``"pallas"``, ``"xla"``,
    ``"interpret"``) or the port's (None, ``"cuda"``, ``"torch"``) ->
    ``"cuda"`` or ``"torch"`` for tensor x."""
    return resolve_impl(JAX_IMPLS.get(impl, impl), x)


def _check_impl(impl, x) -> str:
    """``resolve``, with ranks other than 2 and 4 on the plain route (the
    JAX package's routing, not a fallback)."""
    route = resolve(impl, x)
    return route if x.ndim in (2, 4) else "torch"


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
    (``_bn_act_fwd`` / ``_bn_act_bwd``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, act, impl):
        mean, mean2 = _fwd_stats(x, impl)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        w = scale * inv
        b = bias - mean * w
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
        w = scale * inv
        b = bias - mean * w
        sum_dy, sum_dy_xhat = _bwd_stats(dout, x, w, b, mean, inv, act,
                                         ctx.impl)
        # dx: one elementwise pass, dy recomputed here
        dy = (torch.where(_fold(x, w, b) > 0, dout, torch.zeros_like(dout))
              if act == "relu" else dout)
        xhat = (x - mean) * inv
        dx = w * (dy - sum_dy / n - xhat * (sum_dy_xhat / n))
        # the mean and var outputs' cotangents (None in a train step)
        if dmean is not None:
            dx = dx + dmean / n
        if dvar is not None:
            dx = dx + (2.0 / n) * dvar * (x - mean)
        return dx, sum_dy_xhat, sum_dy, None, None, None


def bn_act_train(x, scale, bias, eps: float, act: str,
                 impl: Optional[str] = None):
    """Training BN with folded activation: act(bn(x)) -> (y, mean, var).

    x [..., C] float32; act ``"linear"`` or ``"relu"``; impl as in the
    module docstring.  Biased variance
    E[x^2] - mean^2, clamped at 0; eps under the rsqrt."""
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
