"""One LSTM step and one GRU step: the CUDA kernels ``csrc/rnn_step.cu``
and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/fused_rnn.py``, with its layouts: LSTM
gates ``[input, forget, candidate, output]``, each a block of H columns of
``x_t`` [B, 4H], ``w`` [H, 4H] and ``b`` [4H]; GRU ``x_t`` [B, 3H] as
``[z | r | c]``, ``w_g`` [H, 2H] (z's columns, then r's), ``w_c`` [H, H],
``b`` [3H] split ``[2H | H]``.  ``m_t`` is a [B, 1] float mask: a row with
``m_t == 0`` keeps its old state exactly (a select, not a blend).

Operand dtypes: the kernels have an instance for every combination the
JAX package reaches under its policies (``KERNEL_DTYPES``): all float32,
and under ``bf16`` / ``mixed`` (``fp16``) the x projection in bf16
(float16; an fc output) with h, c, the weights and the bias float32, and
the mask float32 (from an ``@len`` feed) or in x's dtype (no ``@len``:
the recurrence's ones).  All arithmetic is float32, as in the Pallas
kernels, which upcast every operand; h' and c' come back in h's and c's
dtype, float32.  Any other combination on a CUDA tensor raises
TypeError.  Both products run on the tensor cores as split TF32 (3xTF32:
every product three TF32 products of the operands' hi and lo parts,
within 3 * 2^-22 of |a||b|; ``_tf32x3_lstm_step`` and
``_tf32x3_gru_step`` in plain torch), at every dtype: they read only
float32 h and W.

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

from paddle_tpu_torch.ops import _build, add_work, count_launch
from paddle_tpu_torch.ops.flash_attention import (FP16_ROW, _tf32x3,
                                                  resolve_impl)
from paddle_tpu_torch.ops.paged_attention import _arrived


# --------------------------------------------------------------------- LSTM
def _lstm_step_ref(x_t, h, c, w, b, m_t):
    """The plain version: the LSTM layer's step without peephole."""
    return _lstm_cell(x_t + h @ w + b, h, c, m_t)


def _lstm_cell(g, h, c, m_t):
    """The step from its gate pre-activations g [B, 4H]: (h', c'), the
    masked rows h and c themselves."""
    gi, gf, gc, go = g.chunk(4, dim=-1)
    c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gc)
    h_new = torch.sigmoid(go) * torch.tanh(c_new)
    live = m_t > 0
    return torch.where(live, h_new, h), torch.where(live, c_new, c)


def _tf32x3_lstm_step(x_t, h, c, w, b, m_t, terms: int = 3):
    """The arithmetic of the LSTM kernel (the 3xTF32 ``lstm_tf32_kernel``
    of ``csrc/rnn_step.cu``) in plain torch: ``_lstm_step_ref`` with h W
    as ``_tf32x3`` (x_t and m_t in any of ``KERNEL_DTYPES``' dtypes, the
    rest float32).  Never on the kernel route: the tests hold it against
    the JAX package, ``chip_smoke.py`` the kernel against it.  ``terms=1``
    takes the product as one TF32 product (hi . hi): a planted fault, which
    the checks must catch."""
    return _lstm_cell(x_t.float() + _tf32x3("bk,kn->bn", h, w, terms) + b,
                      h, c, m_t)


# ---------------------------------------------------------------------- GRU
def _gru_step_ref(x_t, h, w_g, w_c, b, m_t):
    """The plain version: the GRU layer's step."""
    hd = h.shape[1]
    zr = torch.sigmoid(x_t[:, :2 * hd] + h @ w_g + b[:2 * hd])
    z, r = zr[:, :hd], zr[:, hd:]
    cand = torch.tanh(x_t[:, 2 * hd:] + (r * h) @ w_c + b[2 * hd:])
    return torch.where(m_t > 0, (1.0 - z) * h + z * cand, h)


def _tf32x3_gru_step(x_t, h, w_g, w_c, b, m_t, terms: int = 3):
    """The arithmetic of the GRU kernel (the 3xTF32 ``gru_tf32_kernel`` of
    ``csrc/rnn_step.cu``) in plain torch: ``_gru_step_ref`` with both
    products, h W_g and (r h) W_c, as ``_tf32x3`` (x_t and m_t in any of
    ``KERNEL_DTYPES``' dtypes, the rest float32).  Never on the kernel
    route: the tests hold it against the JAX package, ``chip_smoke.py`` the
    kernel against it.  ``terms=1`` takes each product as one TF32 product
    (hi . hi): a planted fault, which the checks must catch."""
    hd = h.shape[1]
    x = x_t.float()
    zr = torch.sigmoid(x[:, :2 * hd] + _tf32x3("bk,kn->bn", h, w_g, terms)
                       + b[:2 * hd])
    z, r = zr[:, :hd], zr[:, hd:]
    cand = torch.tanh(x[:, 2 * hd:] + _tf32x3("bk,kn->bn", r * h, w_c, terms)
                      + b[2 * hd:])
    return torch.where(m_t > 0, (1.0 - z) * h + z * cand, h)


# ------------------------------------------------------------------ kernels
_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16
# (x dtype, mask dtype) -> the C entries' suffix, for both steps; every
# other operand is float32
KERNEL_DTYPES = {(_F32, _F32): "f32", (_BF16, _F32): "bf16",
                 (_BF16, _BF16): "bf16_mbf16", (_F16, _F32): "f16",
                 (_F16, _F16): "f16_mf16"}
_SIGNATURES = {
    **{f"lstm_step_{sfx}": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
       + [ctypes.c_void_p] for sfx in KERNEL_DTYPES.values()},
    **{f"gru_step_{sfx}": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
       + [ctypes.c_void_p] for sfx in KERNEL_DTYPES.values()},
    "lstm_tf32_resources": [ctypes.c_int]
                           + [ctypes.POINTER(ctypes.c_int)] * 2,
    "gru_tf32_resources": [ctypes.c_int] * 2
                          + [ctypes.POINTER(ctypes.c_int)] * 2,
}
# the kernels' geometry (csrc/rnn_step.cu): a block's batch rows and
# product columns, the depth of a slice, the slices a split of K takes at
# most (its W panel's shared memory); the LSTM's hidden units a block
# (the four gates' columns of each)
RNN_ROWS, RNN_COLS, RNN_SLICE, RNN_MAX_SLICES = 128, 64, 32, 4
LSTM_UNITS = RNN_COLS // 4


def _splits(hd: int) -> int:
    """The splits of K (= H) of both kernels (the GRU's two launches and
    the LSTM's one): as few as the kernels' shared memory allows,
    RNN_MAX_SLICES 32-deep slices each, the last the rest.  Each split
    more adds a block's partial sums to write and to fold, and on the H100
    more splits (more blocks, each with fewer slices) were slower at the
    GRU's B 256, H 512."""
    return -(-(-(-hd // RNN_SLICE)) // RNN_MAX_SLICES)


def _lstm_grid(bsz: int, hd: int) -> tuple:
    """The LSTM kernel's grid: (tiles, splits), a tile 128 batch rows and
    LSTM_UNITS hidden units (their four gates' columns), K as ``_splits``
    says; the launch is tiles x splits blocks, one an SM (the panels'
    shared memory), 128 at the route's B 128, H 512."""
    return -(-bsz // RNN_ROWS) * -(-hd // LSTM_UNITS), _splits(hd)


def _vec(x_t, *floats) -> int:
    """1 when the kernel may take 16-byte copies: H a multiple of 4 (the
    last dim of every float32 operand's rows), x aligned to 4 of its
    elements and every float32 operand to 16 bytes."""
    return int(floats[0].shape[-1] % 4 == 0
               and x_t.data_ptr() % (4 * x_t.element_size()) == 0
               and all(t.data_ptr() % 16 == 0 for t in floats))


def _entry(kind: str, x_t, m_t, floats) -> str:
    """The C entry for these operand dtypes: x_t and m_t as
    ``KERNEL_DTYPES`` lists them, every tensor of ``floats`` float32;
    anything else raises TypeError."""
    for name, t in floats.items():
        if t.dtype != _F32:
            raise TypeError(
                f"{kind}: {name} must be float32, got {t.dtype}"
                + (f"; {FP16_ROW}" if t.dtype == torch.float16 else ""))
    sfx = KERNEL_DTYPES.get((x_t.dtype, m_t.dtype))
    if sfx is None:
        fp16 = torch.float16 in (x_t.dtype, m_t.dtype)
        raise TypeError(
            f"{kind}: no CUDA instance for x_t {x_t.dtype} with m_t "
            f"{m_t.dtype}; the kernel takes (x_t, m_t) in "
            f"{sorted((str(a), str(b)) for a, b in KERNEL_DTYPES)}"
            + (f"; {FP16_ROW}" if fp16 else ""))
    return f"{kind}_{sfx}"


def _check_operands(device, **operands) -> None:
    """Every kernel operand: contiguous, of the stated shape, on the
    launch device (dtypes: ``_entry``)."""
    for name, (t, shape) in operands.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes a contiguous "
                             f"tensor")


def lstm_step_cuda(x_t, h, c, w, b, m_t):
    """Launch the LSTM step of ``csrc/rnn_step.cu`` (one launch over
    ``_lstm_grid``'s tiles and splits, the split sums through scratch and
    the stream's arrival counters): returns (h', c'),
    float32 [B, H] each.  x_t and m_t float32, bf16 or float16
    (``KERNEL_DTYPES``), the rest float32."""
    bsz, hd = h.shape
    entry = _entry("lstm_step", x_t, m_t, dict(h=h, c=c, w=w, b=b))
    _check_operands(h.device, x_t=(x_t, (bsz, 4 * hd)), h=(h, (bsz, hd)),
                    c=(c, (bsz, hd)), w=(w, (hd, 4 * hd)), b=(b, (4 * hd,)),
                    m_t=(m_t, (bsz, 1)))
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    if h.numel() == 0:
        return h_out, c_out
    tiles, splits = _lstm_grid(bsz, hd)
    part = torch.empty(tiles * splits * RNN_ROWS * RNN_COLS, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    arrived = _arrived(h.device, stream, tiles)
    lib = _build.load("rnn_step", _SIGNATURES)
    err = getattr(lib, entry)(
        x_t.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(),
        b.data_ptr(), m_t.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        part.data_ptr(), arrived.data_ptr(), bsz, hd, _vec(x_t, h, c, w, b),
        splits, stream)
    _build.check(lib, err, "lstm_step")
    count_launch(lstm_step_cuda, x_t.dtype)
    # h @ W, [B, H] x [H, 4H]: the product of its bound in PERF.md
    add_work("lstm_step", 2.0 * bsz * hd * 4 * hd)
    return h_out, c_out


# every launch, and those of the bf16 and float16 instances alone
lstm_step_cuda.launches = lstm_step_cuda.launches_bf16 = 0
lstm_step_cuda.launches_f16 = 0


def gru_step_cuda(x_t, h, w_g, w_c, b, m_t):
    """Launch the GRU step of ``csrc/rnn_step.cu`` (its kernel's two
    phases, gates then candidate, through [B, H] scratch for z and r*h,
    K split as ``_splits`` says, the split sums through scratch sized
    for the gates' [B, 2H] tiles and the stream's arrival counters):
    returns h', float32 [B, H].  One call counts one launch, at every
    dtype.  Operand dtypes as ``lstm_step_cuda``."""
    bsz, hd = h.shape
    entry = _entry("gru_step", x_t, m_t, dict(h=h, w_g=w_g, w_c=w_c, b=b))
    _check_operands(h.device, x_t=(x_t, (bsz, 3 * hd)), h=(h, (bsz, hd)),
                    w_g=(w_g, (hd, 2 * hd)), w_c=(w_c, (hd, hd)),
                    b=(b, (3 * hd,)), m_t=(m_t, (bsz, 1)))
    h_out = torch.empty_like(h)
    if h.numel() == 0:
        return h_out
    z, rh = torch.empty_like(h), torch.empty_like(h)
    splits = _splits(hd)
    tiles = -(-bsz // RNN_ROWS) * -(-2 * hd // RNN_COLS)
    part = torch.empty(tiles * splits * RNN_ROWS * RNN_COLS, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    arrived = _arrived(h.device, stream, tiles)
    lib = _build.load("rnn_step", _SIGNATURES)
    err = getattr(lib, entry)(
        x_t.data_ptr(), h.data_ptr(), w_g.data_ptr(), w_c.data_ptr(),
        b.data_ptr(), m_t.data_ptr(), z.data_ptr(), rh.data_ptr(),
        h_out.data_ptr(), part.data_ptr(), arrived.data_ptr(), bsz, hd,
        _vec(x_t, h, w_g, w_c, b), splits, stream)
    _build.check(lib, err, "gru_step")
    count_launch(gru_step_cuda, x_t.dtype)
    # the gates' [H, 2H] and the candidate's [H, H] products
    add_work("gru_step", 2.0 * bsz * hd * 3 * hd)
    return h_out


gru_step_cuda.launches = gru_step_cuda.launches_bf16 = 0
gru_step_cuda.launches_f16 = 0


def lstm_tf32_resources() -> dict:
    """Registers and local memory (bytes a thread; nonzero means the
    kernel spills or keeps a stack) of the LSTM kernel's float32 instance
    at each copy width, from ``cudaFuncGetAttributes``: ``{"w4": (regs,
    local_bytes), "w1": ...}``.  Needs a card."""
    lib = _build.load("rnn_step", _SIGNATURES)
    return {f"w{width}": _build.resources(lib, lib.lstm_tf32_resources,
                                          width) for width in (4, 1)}


def gru_tf32_resources() -> dict:
    """Registers and local memory (bytes a thread; nonzero means the
    kernel spills or keeps a stack) of the GRU kernel's float32 instances,
    each phase at each copy width, from ``cudaFuncGetAttributes``:
    ``{"gates_w4": (regs, local_bytes), ..., "cand_w1": ...}``.  Needs a
    card."""
    lib = _build.load("rnn_step", _SIGNATURES)
    return {f"{name}_w{width}": _build.resources(
        lib, lib.gru_tf32_resources, phase, width)
        for phase, name in enumerate(("gates", "cand")) for width in (4, 1)}


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
