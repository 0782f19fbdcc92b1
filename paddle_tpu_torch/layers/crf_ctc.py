"""Linear-chain CRF and CTC: the structured-prediction losses as dynamic
programs over the padded time axis (counterpart of
``paddle_tpu/layers/crf_ctc.py``).

Reference: paddle/gserver/layers/LinearChainCRF.{h,cpp} (a (C + 2, C)
weight: row 0 start, row 1 end, rows 2.. the transitions), CRFLayer.cpp,
CRFDecodingLayer.cpp, LinearChainCTC.cpp and WarpCTCLayer.cpp.  Where the
JAX package runs each recurrence as one ``lax.scan`` with the carry frozen
on masked steps, here it is an eager loop over T under autograd with the
same freeze (``torch.where`` on the step's mask), batched over B.  The
emissions are float32 under every policy, and the impossible score is the
finite ``_NEG`` as in the JAX package: ``torch.logaddexp`` of two ``-inf``
has a NaN gradient.  ``ctc_greedy_decode`` and ``edit_distance`` run on
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.ir import ParamSpec
from paddle_tpu_torch.core.registry import register_layer
from paddle_tpu_torch.layers.sequence import SeqLayerDef

_NEG = -1e30


def _ones_mask(x):
    return torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)


def _crf_params(params, ctx, attrs):
    """The layer's own transition weight, or another CRF layer's
    (``param_layer``: decoding shares the cost layer's, as
    CRFDecodingLayer shares the CRFLayer parameter)."""
    share = attrs.get("param_layer")
    if share:
        return ctx.params_tree[share]["w"]
    return params["w"]


def _label_2d(label):
    if label.ndim == 3 and label.shape[-1] == 1:
        label = label[..., 0]
    return label.long()


@register_layer
class LinearChainCRFCost(SeqLayerDef):
    """The negative log-likelihood of a linear-chain CRF: logZ(x) -
    score(x, y), score = start[y0] + sum emit[t, y_t] + sum trans[y_{t-1},
    y_t] + end[y_last], logZ by the forward algorithm; the batch mean, or
    the mean weighted by a third input."""

    kind = "crf_cost"
    out_is_seq = False

    def infer_shape(self, attrs, in_shapes):
        return ()

    def param_specs(self, attrs, in_shapes):
        c = in_shapes[0][-1]
        return [ParamSpec("w", (c + 2, c), "uniform")]

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, y = inputs[0].float(), _label_2d(inputs[1])
        mask = masks[0] if masks[0] is not None else _ones_mask(x)
        w = _crf_params(params, ctx, attrs)
        nll = crf_nll(x, y, mask, w[0], w[1], w[2:])
        if len(inputs) > 2:
            wv = inputs[2].reshape(nll.shape).float()
            return torch.sum(nll * wv) / torch.clamp(torch.sum(wv),
                                                     min=1e-12)
        return torch.mean(nll)


def crf_nll(x, y, mask, start, end, trans):
    """Per-sequence negative log-likelihood. x [B, T, C], y [B, T] int,
    mask [B, T] -> [B]."""
    b, t, c = x.shape
    emit = torch.gather(x, 2, y[..., None])[..., 0]                # [B, T]
    score = start[y[:, 0]] + torch.sum(emit * mask, 1)
    if t > 1:
        score = score + torch.sum(trans[y[:, :-1], y[:, 1:]] * mask[:, 1:],
                                  1)
    last = torch.clamp(torch.sum(mask, 1).long() - 1, min=0)
    y_last = torch.gather(y, 1, last[:, None])[:, 0]
    score = score + end[y_last]
    alpha = start[None, :] + x[:, 0]                                 # [B, C]
    for s in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], 1) + x[:, s]
        alpha = torch.where(mask[:, s, None] > 0, new, alpha)
    log_z = torch.logsumexp(alpha + end[None, :], 1)
    return log_z - score


def viterbi(x, mask, start, end, trans):
    """The best tag path [B, T] (int64, 0 on padded steps): the max-product
    forward with backpointers, an identity backpointer on padded steps,
    ``argmax`` taking the first maximum as ``jnp.argmax`` does."""
    b, t, c = x.shape
    alpha = start[None, :] + x[:, 0]
    ident = torch.arange(c, device=x.device)[None, :].expand(b, c)
    bps = []
    for s in range(1, t):
        sc = alpha[:, :, None] + trans[None]                # [B, Cp, Cn]
        best, arg = torch.max(sc, 1)
        on = mask[:, s, None] > 0
        alpha = torch.where(on, best + x[:, s], alpha)
        bps.append(torch.where(on, arg, ident))
    tag = torch.argmax(alpha + end[None, :], 1)
    path = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], 1)
    return path * mask.long()


@register_layer
class CRFDecodingLayer(SeqLayerDef):
    """Viterbi decoding to the best tag sequence [B, T] (reference:
    CRFDecodingLayer.cpp); with ``param_layer`` it reads that crf_cost
    layer's weight.  With a label input it emits the 0/1 per-step error
    indicator instead of the path (float32, 0 on padded steps)."""

    kind = "crf_decoding"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0][:-1]

    def param_specs(self, attrs, in_shapes):
        if attrs.get("param_layer"):
            return []
        c = in_shapes[0][-1]
        return [ParamSpec("w", (c + 2, c), "uniform")]

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x = inputs[0].float()
        mask = masks[0] if masks[0] is not None else _ones_mask(x)
        w = _crf_params(params, ctx, attrs)
        with torch.no_grad():
            path = viterbi(x.detach(), mask, w[0].detach(), w[1].detach(),
                           w[2:].detach())
        if len(inputs) > 1:
            err = (path != _label_2d(inputs[1])).float()
            return err * mask
        return path.to(torch.int32)


@register_layer
class CTCCost(SeqLayerDef):
    """CTC loss on logits (reference: WarpCTCLayer, LinearChainCTC): the
    logit sequence [B, T, C] (C counts the blank), the label sequence
    [B, S] with its own mask; attrs ``blank`` (0) and ``norm_by_times``."""

    kind = "ctc_cost"
    out_is_seq = False

    def infer_shape(self, attrs, in_shapes):
        return ()

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        logits = inputs[0].float()
        label = _label_2d(inputs[1])
        tmask = masks[0] if masks[0] is not None else _ones_mask(logits)
        lmask = (masks[1] if len(masks) > 1 and masks[1] is not None
                 else torch.ones(label.shape, dtype=torch.float32,
                                 device=label.device))
        nll = ctc_loss(logits, tmask, label, lmask,
                       blank=attrs.get("blank", 0))
        if attrs.get("norm_by_times", False):
            nll = nll / torch.clamp(torch.sum(tmask, 1), min=1.0)
        return torch.mean(nll)


def ctc_loss(logits, tmask, label, lmask, blank: int = 0):
    """Per-sequence CTC negative log-likelihood: the forward recurrence
    over the extended label [blank, l1, blank, l2, ..., blank], one step a
    frame, every shape static.  logits [B, T, C], tmask [B, T], label
    [B, S], lmask [B, S] -> [B]."""
    b, t, c = logits.shape
    s = label.shape[1]
    e = 2 * s + 1
    dev = logits.device
    lp = torch.log_softmax(logits, -1)
    ext = torch.full((b, e), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = label.long()
    lab_len = torch.sum(lmask, 1).long()
    ext_len = 2 * lab_len + 1
    pos = torch.arange(e, device=dev)[None, :]
    ext_valid = pos < ext_len[:, None]
    ext_m2 = torch.cat([torch.full((b, 2), -1, dtype=torch.long,
                                   device=dev), ext[:, :-2]], 1)
    skip_ok = (ext != blank) & (ext != ext_m2) & (pos >= 2)
    neg = torch.full((), _NEG, device=dev)
    neg1 = torch.full((b, 1), _NEG, device=dev)
    neg2 = torch.full((b, 2), _NEG, device=dev)
    alpha = torch.where((pos <= 1) & ext_valid,
                        torch.gather(lp[:, 0], 1, ext), neg)
    for step in range(1, t):
        emit = torch.gather(lp[:, step], 1, ext)
        a1 = torch.cat([neg1, alpha[:, :-1]], 1)
        a2 = torch.where(skip_ok, torch.cat([neg2, alpha[:, :-2]], 1), neg)
        tot = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
        new = torch.where(ext_valid, tot + emit, neg)
        alpha = torch.where(tmask[:, step, None] > 0, new, alpha)
    fin_blank = torch.gather(alpha, 1,
                             torch.clamp(ext_len - 1, min=0)[:, None])[:, 0]
    fin_label = torch.gather(alpha, 1,
                             torch.clamp(ext_len - 2, min=0)[:, None])[:, 0]
    fin_label = torch.where(lab_len > 0, fin_label, neg)
    return -torch.logaddexp(fin_blank, fin_label)


def ctc_greedy_decode(ids, blank: int = 0):
    """Collapse repeats, then drop blanks (host side). ids: 1-D."""
    out = []
    prev = None
    for i in ids:
        i = int(i)
        if i != prev and i != blank:
            out.append(i)
        prev = i
    return out


def edit_distance(a, b) -> int:
    """Levenshtein distance (host side; reference: EditDistance in
    CTCErrorEvaluator.cpp)."""
    m, n = len(a), len(b)
    d = np.arange(n + 1)
    for i in range(1, m + 1):
        prev = d.copy()
        d[0] = i
        for j in range(1, n + 1):
            d[j] = min(prev[j] + 1, d[j - 1] + 1,
                       prev[j - 1] + (a[i - 1] != b[j - 1]))
    return int(d[n])
