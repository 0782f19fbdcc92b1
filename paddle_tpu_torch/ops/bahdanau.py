"""One decoder step of additive (Bahdanau) attention with a recompute
backward (counterpart of ``paddle_tpu/ops/bahdanau.py``).

The reference has no Pallas kernel here: its ``custom_vjp`` exists so that
a decoder loop does not keep each step's [B, Te, H] tanh row for the
backward.  ``_BahdanauStep`` makes the same trade: the forward saves only
the [B, Te] attention weights, and the backward recomputes the tanh row
from (enc_proj, state) and follows the reference's ``_bwd`` line for line.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.config import NEG_INF


def _tanh_row(enc_proj, state, w_dp):
    return torch.tanh(enc_proj + (state @ w_dp)[:, None, :])   # [B, Te, H]


def _weights(enc_proj, state, w_dp, v, mask):
    """softmax over the real steps of v . tanh(...); all-pad rows give
    zeros."""
    scores = torch.einsum("bth,h->bt", _tanh_row(enc_proj, state, w_dp), v)
    live = mask > 0
    w = torch.softmax(scores.masked_fill(~live, NEG_INF), dim=-1)
    return w.masked_fill(~live, 0.0)


class _BahdanauStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc, enc_proj, state, w_dp, v, mask):
        w = _weights(enc_proj, state, w_dp, v, mask)
        ctx.save_for_backward(enc, enc_proj, state, w_dp, v, w)
        return torch.einsum("bt,btd->bd", w, enc)

    @staticmethod
    def backward(ctx, g):
        enc, enc_proj, state, w_dp, v, w = ctx.saved_tensors
        dw_att = torch.einsum("bd,btd->bt", g, enc)               # [B, Te]
        d_enc = w[:, :, None] * g[:, None, :]
        dscores = w * (dw_att - (dw_att * w).sum(-1, keepdim=True))
        # only the tanh row is recomputed - the weights w are a residual
        c = _tanh_row(enc_proj, state, w_dp)
        dpre = (dscores[:, :, None] * v) * (1.0 - c * c)         # [B, Te, H]
        ddp = dpre.sum(1)                                         # [B, H]
        dv = torch.einsum("bth,bt->h", c, dscores)
        return (d_enc, dpre, ddp @ w_dp.T, state.T @ ddp, dv, None)


def bahdanau_step(enc, enc_proj, state, w_dp, v, mask):
    """ctx_b = sum_t softmax_t(v . tanh(enc_proj_bt + state_b @ w_dp)) enc_bt

    enc: [B, Te, De]; enc_proj: [B, Te, H]; state: [B, Hs]; w_dp: [Hs, H];
    v: [H]; mask: float [B, Te] (1 = real step).  Returns ctx [B, De]."""
    return _BahdanauStep.apply(enc, enc_proj, state, w_dp, v, mask)
