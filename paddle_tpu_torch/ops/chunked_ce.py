"""Chunked LM-head cross-entropy: fc + softmax-CE fused, never keeping the
[N, V] logits (counterpart of ``paddle_tpu/ops/chunked_ce.py``).

``classification_cost``'s ``_SoftmaxNLL`` saves the logits for its
backward: 4.2 GB at [65536, 32000] bf16, the residual that caps a
single-card context.  ``lm_head_nll`` computes the loss in row chunks:
the forward keeps each chunk's logits only while it reduces them and
saves the [N] logsumexp; the backward recomputes each chunk's logits from
(x, w, b) and forms dlogits -> (dx, dw, db) on the fly.  One more head
product in the backward buys an O(N) residual instead of O(N V).

The products are library GEMMs (this is no Pallas kernel in the JAX
package either: there it is a ``lax.scan`` of ``jnp.dot``).  Their
dtypes follow the JAX ``preferred_element_type=jnp.float32`` dots: the
logits are float32 whatever x's dtype is.  With 16-bit x and w, a 16-bit
GEMM that returns 16-bit logits and is then upcast is another function
(each logit rounded to 8 bits of mantissa before the softmax), so the
product here is ``torch.mm(a, b, out_dtype=torch.float32)`` on the card:
cuBLAS's 16-bit GEMM with float32 accumulation and a float32 result, one
rounding fewer, which is what ``preferred_element_type`` asks of the MXU.
On the CPU (no ``aten::mm.dtype`` kernel there) the same function is the
float32 product of the upcast operands: the products of 16-bit values are
exact in float32, so only the summation order differs.  ``dx`` and the
``dw`` contributions use the same product; ``dx`` is rounded to x's dtype
once, after it, and ``dw`` and ``db`` accumulate in float32 and leave in
``w``'s and ``b``'s own dtypes, as the JAX vjp returns them (under bf16
``dw`` reaches the float32 master weight rounded to bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in and returned as float32 (the module
    docstring says which product and why)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _pad_rows(a: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-a.shape[0]) % mult
    if pad == 0:
        return a
    return F.pad(a, (0, 0) * (a.ndim - 1) + (0, pad))


def chunk_rows(chunk: int, n: int) -> int:
    """The rows a chunk takes (the JAX rule: at least 8, at most n)."""
    return min(chunk, max(8, n))


class _LmHeadNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, labels, chunk):
        n = x.shape[0]
        chunk = chunk_rows(chunk, n)
        labels = labels.long()
        xp = _pad_rows(x, chunk)
        lp = _pad_rows(labels, chunk)
        bf = b.float()
        lse = torch.empty(xp.shape[0], dtype=torch.float32, device=x.device)
        ll = torch.empty_like(lse)
        for r in range(0, xp.shape[0], chunk):
            logits = mm_f32(xp[r:r + chunk], w).add_(bf)
            m = logits.amax(dim=-1)
            ll[r:r + chunk] = logits.gather(
                -1, lp[r:r + chunk, None])[:, 0]
            logits.sub_(m[:, None]).exp_()
            lse[r:r + chunk] = m + torch.log(logits.sum(dim=-1))
            del logits
        lse, ll = lse[:n], ll[:n]
        ctx.chunk = chunk
        ctx.save_for_backward(x, w, b, labels, lse)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        n = x.shape[0]
        xp = _pad_rows(x, chunk)
        lp = _pad_rows(labels, chunk)
        lsep = _pad_rows(lse, chunk)
        gp = _pad_rows(g.float(), chunk)   # padded rows carry g = 0
        bf = b.float()
        wt = w.t()
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        dx = torch.empty(xp.shape, dtype=x.dtype, device=x.device)
        for r in range(0, xp.shape[0], chunk):
            x_c = xp[r:r + chunk]
            dl = mm_f32(x_c, w).add_(bf)
            dl.sub_(lsep[r:r + chunk, None]).exp_()          # p
            rows = torch.arange(dl.shape[0], device=dl.device)
            dl[rows, lp[r:r + chunk]] -= 1.0                 # p - onehot
            dl.mul_(gp[r:r + chunk, None])
            dlc = dl.to(x.dtype)
            dx[r:r + chunk] = mm_f32(dlc, wt)
            dw.add_(mm_f32(x_c.t(), dlc))
            db.add_(dl.sum(dim=0))
            del dl, dlc
        return dx[:n], dw.to(w.dtype), db.to(b.dtype), None, None


def lm_head_nll(x, w, b, labels, chunk: int = 8192) -> torch.Tensor:
    """Per-row nll of softmax(x @ w + b) at ``labels``.

    x: [N, D]; w: [D, V]; b: [V]; labels: [N] int -> nll [N] float32.
    chunk: rows per step of the loop."""
    return _LmHeadNLL.apply(x, w, b, labels, int(chunk))
