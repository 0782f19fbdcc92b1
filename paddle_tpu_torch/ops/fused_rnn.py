"""One LSTM step and one GRU step: the CUDA kernels ``csrc/rnn_step.cu``
and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/fused_rnn.py``, with its layouts: LSTM
gates ``[input, forget, candidate, output]``, each a block of H columns of
``x_t`` [B, 4H], ``w`` [H, 4H] and ``b`` [4H]; GRU ``x_t`` [B, 3H] as
``[z | r | c]``, ``w_g`` [H, 2H] (z's columns, then r's), ``w_c`` [H, H],
``b`` [3H] split ``[2H | H]``.  ``m_t`` is a [B, 1] float mask: a row with
``m_t == 0`` keeps its old state exactly (a select, not a blend).

``impl=None`` routes by where the tensors lie: a CUDA tensor runs the
kernel (or raises), a CPU tensor takes the plain version; ``impl="torch"``
forces the plain version on any device.  On the kernel route
``_LstmStep`` / ``_GruStep`` (the counterparts of the custom-vjp
``_lstm_step`` / ``_gru_step``) launch the kernel forward and, for the
backward, recompute through the plain step with autograd, as the JAX
package's backward is XLA through its oracle: the residuals are the
step's inputs, and ``m_t`` gets no gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.flash_attention import resolve_impl


# --------------------------------------------------------------------- LSTM
def _lstm_step_ref(x_t, h, c, w, b, m_t):
    """The plain version: the LSTM layer's step without peephole."""
    g = x_t + h @ w + b
    gi, gf, gc, go = g.chunk(4, dim=-1)
    c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gc)
    h_new = torch.sigmoid(go) * torch.tanh(c_new)
    live = m_t > 0
    return torch.where(live, h_new, h), torch.where(live, c_new, c)


# ---------------------------------------------------------------------- GRU
def _gru_step_ref(x_t, h, w_g, w_c, b, m_t):
    """The plain version: the GRU layer's step."""
    hd = h.shape[1]
    zr = torch.sigmoid(x_t[:, :2 * hd] + h @ w_g + b[:2 * hd])
    z, r = zr[:, :hd], zr[:, hd:]
    cand = torch.tanh(x_t[:, 2 * hd:] + (r * h) @ w_c + b[2 * hd:])
    return torch.where(m_t > 0, (1.0 - z) * h + z * cand, h)


# ------------------------------------------------------------------ kernels
_SIGNATURES = {
    "lstm_step_f32": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                     + [ctypes.c_void_p],
    "gru_step_f32": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p],
}


def _check_operands(device, **operands) -> None:
    """Every kernel operand: contiguous float32 of the stated shape on the
    launch device."""
    for name, (t, shape) in operands.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                            f"{t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes a contiguous "
                             f"tensor")


def lstm_step_cuda(x_t, h, c, w, b, m_t):
    """Launch the LSTM step of ``csrc/rnn_step.cu``: returns (h', c'),
    float32 [B, H] each."""
    bsz, hd = h.shape
    _check_operands(h.device, x_t=(x_t, (bsz, 4 * hd)), h=(h, (bsz, hd)),
                    c=(c, (bsz, hd)), w=(w, (hd, 4 * hd)), b=(b, (4 * hd,)),
                    m_t=(m_t, (bsz, 1)))
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    if h.numel() == 0:
        return h_out, c_out
    lib = _build.load("rnn_step", _SIGNATURES)
    err = lib.lstm_step_f32(
        x_t.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(),
        b.data_ptr(), m_t.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        bsz, hd, torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, "lstm_step")
    lstm_step_cuda.launches += 1
    return h_out, c_out


lstm_step_cuda.launches = 0


def gru_step_cuda(x_t, h, w_g, w_c, b, m_t):
    """Launch the GRU step of ``csrc/rnn_step.cu`` (its two kernels, gates
    then candidate, through [B, H] scratch for z and r*h): returns h',
    float32 [B, H].  One call counts one launch."""
    bsz, hd = h.shape
    _check_operands(h.device, x_t=(x_t, (bsz, 3 * hd)), h=(h, (bsz, hd)),
                    w_g=(w_g, (hd, 2 * hd)), w_c=(w_c, (hd, hd)),
                    b=(b, (3 * hd,)), m_t=(m_t, (bsz, 1)))
    h_out = torch.empty_like(h)
    if h.numel() == 0:
        return h_out
    z, rh = torch.empty_like(h), torch.empty_like(h)
    lib = _build.load("rnn_step", _SIGNATURES)
    err = lib.gru_step_f32(
        x_t.data_ptr(), h.data_ptr(), w_g.data_ptr(), w_c.data_ptr(),
        b.data_ptr(), m_t.data_ptr(), z.data_ptr(), rh.data_ptr(),
        h_out.data_ptr(), bsz, hd,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, "gru_step")
    gru_step_cuda.launches += 1
    return h_out


gru_step_cuda.launches = 0


def _recompute_grads(ref, inputs, m_t, grads):
    """Gradients of ``ref(*inputs, m_t)`` for the output cotangents
    ``grads``, by autograd through the plain step."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        outs = ref(*leaves, m_t)
        return torch.autograd.grad(outs, leaves, grads)


class _LstmStep(torch.autograd.Function):
    """The kernel route with its gradient: the forward launches the
    kernel; the backward recomputes through ``_lstm_step_ref``."""

    @staticmethod
    def forward(ctx, x_t, h, c, w, b, m_t):
        ctx.save_for_backward(x_t, h, c, w, b, m_t)
        return lstm_step_cuda(x_t, h, c, w, b, m_t)

    @staticmethod
    def backward(ctx, gh, gc):
        x_t, h, c, w, b, m_t = ctx.saved_tensors
        return (*_recompute_grads(_lstm_step_ref, (x_t, h, c, w, b), m_t,
                                  (gh, gc)), None)


class _GruStep(torch.autograd.Function):
    """The kernel route with its gradient: the forward launches the
    kernel; the backward recomputes through ``_gru_step_ref``."""

    @staticmethod
    def forward(ctx, x_t, h, w_g, w_c, b, m_t):
        ctx.save_for_backward(x_t, h, w_g, w_c, b, m_t)
        return gru_step_cuda(x_t, h, w_g, w_c, b, m_t)

    @staticmethod
    def backward(ctx, g):
        x_t, h, w_g, w_c, b, m_t = ctx.saved_tensors
        return (*_recompute_grads(_gru_step_ref, (x_t, h, w_g, w_c, b), m_t,
                                  (g,)), None)


def lstm_step(x_t, h, c, w, b, m_t, *, impl: Optional[str] = None):
    """One LSTM step.  x_t: [B, 4H] pre-projected input; h, c: [B, H];
    w: [H, 4H]; b: [4H]; m_t: [B, 1] validity mask.  Returns (h', c').
    impl: ``"cuda"``, ``"torch"`` or None (by the device of ``x_t``)."""
    if resolve_impl(impl, x_t) == "torch":
        return _lstm_step_ref(x_t, h, c, w, b, m_t)
    return _LstmStep.apply(x_t, h, c, w, b, m_t)


def gru_step(x_t, h, w_g, w_c, b, m_t, *, impl: Optional[str] = None):
    """One GRU step.  x_t: [B, 3H]; h: [B, H]; w_g: [H, 2H]; w_c: [H, H];
    b: [3H]; m_t: [B, 1].  Returns h'.  impl as ``lstm_step``."""
    if resolve_impl(impl, x_t) == "torch":
        return _gru_step_ref(x_t, h, w_g, w_c, b, m_t)
    return _GruStep.apply(x_t, h, w_g, w_c, b, m_t)
