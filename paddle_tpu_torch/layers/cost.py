"""Cost (loss) layers: ``classification_cost`` and ``sum_cost`` (the part
of ``paddle_tpu/layers/cost.py`` the ported models need).

All costs reduce to per-sample losses, then a (weighted) mean over the
batch.  ``classification_cost`` takes logits and fuses log-softmax and NLL
in ``_SoftmaxNLL``, which saves the logits and the [N] logsumexp, never a
log-prob matrix: at the LM's full width (32768 tokens x 32000 classes)
``F.cross_entropy`` would keep another 4.2 GB float32 log-softmax for the
backward.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import LayerDef, register_layer


def _weighted_mean(per_sample, weight=None):
    if weight is not None:
        w = weight.reshape(per_sample.shape)
        return (per_sample * w).sum() / torch.clamp(w.sum(), min=1e-12)
    return per_sample.mean()


class _CostBase(LayerDef):
    def infer_shape(self, attrs, in_shapes):
        return ()          # scalar


class _SoftmaxNLL(torch.autograd.Function):
    """Per-sample softmax cross-entropy (counterpart of the custom-vjp
    ``_softmax_nll``): forward = two reductions over the logits; backward =
    one elementwise pass, dlogits = (softmax - onehot) * g, built in place
    in one [N, V] buffer."""

    @staticmethod
    def forward(ctx, logits, labels):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        ll = lf.gather(-1, labels[:, None])[:, 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        d = torch.sub(logits.float(), lse[:, None]).exp_()
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, labels] -= 1.0
        d.mul_(g[:, None].to(d.dtype))
        return d.to(logits.dtype), None


@register_layer
class ClassificationCost(_CostBase):
    """softmax cross-entropy on logits (+ optional per-sample weight)."""

    kind = "classification_cost"

    def apply(self, attrs, params, inputs, ctx):
        logits, label = inputs[0], inputs[1]
        weight = inputs[2] if len(inputs) > 2 else None
        label = label.reshape(-1).long()
        if attrs.get("input_is_prob"):
            # input already softmax-ed (the reference's prob-space idiom)
            logp = torch.log(torch.clamp(logits.float(), min=1e-10))
            nll = -logp.gather(-1, label[:, None])[:, 0]
        else:
            nll = _SoftmaxNLL.apply(logits, label)
        return _weighted_mean(nll, weight)


@register_layer
class SumCost(_CostBase):
    """sum of the input over the batch's rows, divided by their count
    (reference: SumCostLayer)."""

    kind = "sum_cost"

    def apply(self, attrs, params, inputs, ctx):
        return torch.sum(inputs[0].float()) / inputs[0].shape[0]
